"""Serving steps: prefill (cache construction + first logits) and decode
(one token per sequence against the KV/SSM cache), plus sampling (port of
``repro.train.serve_step``).

The steps run eagerly under ``torch.no_grad()``; the reference's are
traced by ``jax.jit`` in the caller. Decode updates the cache in place
(``models.transformer.forward_decode``).

Departure: :func:`sample_logits` draws with ``torch.multinomial`` from an
explicit ``torch.Generator`` where the reference draws with
``jax.random.categorical`` from a key. The two streams differ; the mask of
padded vocab, greedy decoding (``temperature <= 0``, the first maximum in
both) and the distribution are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward_decode, forward_train

__all__ = ["make_prefill_step", "make_decode_step", "sample_logits"]


def sample_logits(
    logits: torch.Tensor, generator=None, temperature: float = 1.0,
    vocab_real: Optional[int] = None,
) -> torch.Tensor:
    """Temperature sampling over the last position. logits: (B, 1, [K,] V).
    Returns int32 ids of shape ``logits.shape[:-1]``. ``generator`` is a
    ``torch.Generator`` on the logits' device (or None for the default)."""
    lg = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if vocab_real is not None and lg.shape[-1] > vocab_real:
        mask = torch.arange(lg.shape[-1], device=lg.device) >= vocab_real
        lg = torch.where(mask, -1e30, lg)
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    probs = torch.softmax(lg / temperature, dim=-1)
    ids = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return ids.reshape(lg.shape[:-1]).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, mesh=None, compute_dtype=torch.bfloat16,
                      cache_len: Optional[int] = None):
    """prefill(params, batch) -> (last_logits, cache). The cache is laid out
    for the decode step (absolute slots; ring buffers for SWA layers)."""

    @torch.no_grad()
    def prefill(params, batch):
        logits, _aux, cache = forward_train(
            params, batch, cfg, mesh,
            compute_dtype=compute_dtype, return_cache=True, cache_len=cache_len,
        )
        return logits[:, -1:], cache

    return prefill


def make_decode_step(cfg: ModelConfig, mesh=None, compute_dtype=torch.bfloat16):
    """decode(params, tokens, cache, pos) -> (logits, cache), the cache
    updated in place."""

    @torch.no_grad()
    def decode(params, tokens, cache, pos):
        return forward_decode(params, tokens, cache, pos, cfg, mesh,
                              compute_dtype=compute_dtype)

    return decode
