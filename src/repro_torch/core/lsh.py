"""Signed-random-projection LSH signatures (mirrors `repro/core/lsh.py`).

Signatures pack 32 bits per word; PyTorch stores them as int32 tensors
holding the uint32 bits (`np.ndarray.view(np.int32)` of the reference's
arrays). Bit `i` of a word is projection `32 * word + i`.
"""
from __future__ import annotations

import torch

WORD_BITS = 32


def make_lsh_projections(dim: int, n_bits: int = 256, *,
                         generator: torch.Generator | None = None,
                         device=None) -> torch.Tensor:
    """Gaussian projection matrix (dim, n_bits). Its draws differ from
    `jax.random`'s; parity tests pass the reference's matrix instead."""
    proj = torch.randn((dim, n_bits), generator=generator,
                       dtype=torch.float32)
    return proj.to(device) if device is not None else proj


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., n_bits) {0,1} -> (..., n_bits/32) int32 (uint32 bits)."""
    *lead, n_bits = bits.shape
    if n_bits % WORD_BITS:
        raise ValueError(f"pack_bits: {n_bits} bits is not a multiple of 32")
    words = bits.reshape(*lead, n_bits // WORD_BITS, WORD_BITS).to(torch.int64)
    weights = 1 << torch.arange(WORD_BITS, dtype=torch.int64,
                                device=bits.device)
    packed = (words * weights).sum(-1)  # 0 .. 2**32 - 1
    # wrap to the int32 holding the same 32 bits
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of pack_bits -> (..., n_bits) int32 in {0,1}."""
    *lead, n_words = words.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*lead, n_words * WORD_BITS)[..., :n_bits]


def lsh_signature(x: torch.Tensor, projections: torch.Tensor) -> torch.Tensor:
    """SRP signature of x (..., dim) -> packed (..., n_bits/32) int32."""
    return pack_bits(x @ projections >= 0.0)
