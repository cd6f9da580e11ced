"""Core algorithms of the port: packed symmetric storage, TN Strassen, ATA."""

from repro_torch.core.symmetric import SymmetricMatrix, default_block_size, sym_tile
from repro_torch.core.strassen import strassen_tn
from repro_torch.core.ata import ata, ata_batched

__all__ = [
    "SymmetricMatrix",
    "default_block_size",
    "sym_tile",
    "strassen_tn",
    "ata",
    "ata_batched",
]
