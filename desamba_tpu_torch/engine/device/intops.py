"""Integer helpers shared by the port's device stages.

They restate, on torch tensors, the integer semantics the JAX package
gets for free (see the package docstring): uint32 arithmetic on
``int32`` bit patterns, JAX's clamping gathers, and the SWAR popcount of
``textwalk._popc``. JAX's dropping scatters are masked where they occur
(``compaction.compact_rows``, ``fm._interval_sa``).
"""
from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF


def u32(x):
    """uint32 view of an int32 bit pattern (or any int tensor), as int64
    in [0, 2^32)."""
    return x.to(I64) & M32


def i32(x):
    """Wrap an integer tensor to int32 (two's complement), like a JAX
    ``astype(int32)`` of a uint32."""
    x = x.to(I64) & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(I32)


def popc(v):
    """Popcount of uint32 values held as int64 in [0, 2^32); int32 out."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & M32) >> 24).to(I32)


def _norm(idx, n):
    idx = idx.to(I64)
    return torch.where(idx < 0, idx + n, idx)


def take(t, idx):
    """``t[idx]`` along dim 0 with JAX gather semantics: negative indices
    wrap once, then every index clamps into range."""
    n = t.shape[0]
    return t[_norm(idx, n).clamp(0, n - 1)]


def take2(t, i, j):
    """``t[i, j]`` with JAX gather semantics on both leading dims."""
    ni, nj = t.shape[0], t.shape[1]
    return t[_norm(i, ni).clamp(0, ni - 1), _norm(j, nj).clamp(0, nj - 1)]


def argsort_stable(key, dim=-1):
    """Stable ascending argsort, int32 indices (``jnp.argsort(stable=True)``)."""
    return torch.sort(key, dim=dim, stable=True).indices.to(I32)
