"""Deterministic, resumable synthetic-token data pipeline.

Production properties we reproduce without external data:

* **Step-indexed determinism** — batch ``i`` is a pure function of
  ``(seed, i)`` (counter-based PRNG), so a restart at step ``i`` regenerates
  exactly the stream a crashed run would have seen: the checkpoint only needs
  the integer step, never pipeline buffers.
* **Per-host sharding** — each host materializes only its slice of the
  global batch (``host_slice``), as each host of a multi-host run would.
* **Prefetch** — a background thread keeps ``prefetch`` batches ready.

The token distribution is a Zipfian mixture with a Markov flavor so the
cross-entropy of a real model decreases measurably during the example
training runs (pure uniform tokens would pin loss at log V).

A copy of ``repro.data.pipeline``: the batches are numpy arrays, bitwise
equal to the reference's by ``(seed, step)``; the train loop moves them to
its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["SyntheticLM", "make_batch"]


def _batch_rng(seed: int, step: int) -> np.random.Generator:
    # counter-based: independent stream per (seed, step)
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(
    cfg: ModelConfig,
    shape: ShapeConfig,
    seed: int,
    step: int,
    host_index: int = 0,
    host_count: int = 1,
    seq_len: Optional[int] = None,
    batch: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Materialize this host's slice of global batch ``step``."""
    b = batch if batch is not None else shape.global_batch
    s = seq_len if seq_len is not None else shape.seq_len
    if b % host_count:
        raise ValueError(f"global batch {b} not divisible by {host_count} hosts")
    b_local = b // host_count
    rng = _batch_rng(seed, step)
    # skip ahead deterministically to this host's slice
    v = cfg.vocab_size

    def sample_tokens(r, shape_):
        # Zipf-ish: x ~ floor(v * u^3) puts mass on small ids
        u = r.random(shape_)
        base = np.minimum((v * u**3).astype(np.int64), v - 1)
        # Markov flavor: with p=0.3, repeat the previous token + 1 (mod v)
        rep = r.random(shape_) < 0.3
        shifted = np.roll(base, 1, axis=-1)
        out = np.where(rep, (shifted + 1) % v, base)
        return out.astype(np.int32)

    # one independent generator per host slice keeps slices uncorrelated
    host_rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, host_index])
    )
    if cfg.num_codebooks > 1:
        toks = sample_tokens(host_rng, (b_local, s, cfg.num_codebooks))
    else:
        toks = sample_tokens(host_rng, (b_local, s))
    out: Dict[str, np.ndarray] = {"tokens": toks}
    if cfg.modality == "vision_text":
        n_img = min(cfg.num_patches, max(s - 8, 0))
        out["tokens"] = toks[:, : s - n_img] if toks.ndim == 2 else toks
        out["image_embeds"] = host_rng.standard_normal(
            (b_local, n_img, cfg.d_model)
        ).astype(np.float32) * 0.02
        out["labels"] = out["tokens"]
    else:
        out["labels"] = toks
    return out


class SyntheticLM:
    """Prefetching iterator over deterministic synthetic batches."""

    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        seed: int = 0,
        start_step: int = 0,
        host_index: int = 0,
        host_count: int = 1,
        prefetch: int = 2,
        seq_len: Optional[int] = None,
        batch: Optional[int] = None,
    ):
        self.cfg, self.shape = cfg, shape
        self.seed = seed
        self.step = start_step
        self.host_index, self.host_count = host_index, host_count
        self._seq_len, self._batch = seq_len, batch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = make_batch(
                self.cfg, self.shape, self.seed, step,
                self.host_index, self.host_count,
                seq_len=self._seq_len, batch=self._batch,
            )
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def state(self) -> dict:
        """Resumable state — just the next step index."""
        return {"seed": self.seed, "next_step": self.step}

    def close(self):
        self._stop.set()
