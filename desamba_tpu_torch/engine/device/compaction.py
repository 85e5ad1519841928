"""Lane compaction (counterpart of desamba_tpu/engine/device/compaction.py).

JAX drops out-of-bounds scatters silently (``compaction.py`` parks empty
slots at index B); torch ``index_put_`` raises on them, so the port masks
the scatter explicitly instead of clamping.
"""
from __future__ import annotations

import torch

from .intops import I32


def compact_rows(mask, k: int):
    """Indices of the first k True lanes of ``mask``, ascending.

    Returns (rows_g, rows_s, valid): gather indices (0 at empty slots),
    scatter indices (B at empty slots) and the live-slot mask, each (k,)."""
    B = mask.shape[0]
    pos = torch.cumsum(mask.to(I32), dim=0, dtype=I32) - 1
    take = mask & (pos < k)
    rows_s = torch.full((k,), B, dtype=I32, device=mask.device)
    rows_s[pos[take].long()] = torch.arange(
        B, dtype=I32, device=mask.device)[take]
    valid = rows_s < B
    rows_g = torch.where(valid, rows_s, 0)
    return rows_g, rows_s, valid
