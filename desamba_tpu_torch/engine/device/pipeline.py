"""13-mer prefix values (counterpart of desamba_tpu/engine/device/pipeline.py
``pre13_values``)."""
from __future__ import annotations

import torch

from desamba_tpu.constants import L_PRE_IDX, PRE_IDX_MASK

from .intops import I32, I64


def pre13_values(codes, l_ek: int):
    """13-mer prefix value for the e-kmer ending at each position.

    codes: (B, L) uint8; returns (B, L - l_ek + 1) int32
    (kmer & PRE_IDX_MASK)."""
    B, L = codes.shape
    n_k = L - l_ek + 1
    c64 = codes.to(I64)
    pre = torch.zeros((B, n_k), dtype=I64, device=codes.device)
    for j in range(L_PRE_IDX):
        off = l_ek - L_PRE_IDX + j
        pre = pre | (c64[:, off : off + n_k] << (2 * (L_PRE_IDX - 1 - j)))
    return (pre & PRE_IDX_MASK).to(I32)
