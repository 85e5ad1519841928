"""Device islands stage: batched e-kmer existence probe.

Counterpart of ``desamba_tpu/engine/device/islands.py``. The rolling
e-kmer and the two 64-bit hashes use native int64 in place of the JAX
package's (hi, lo) uint32 pairs (``u64ops.py``): int64 adds, multiplies
and left shifts wrap exactly like uint64, and every right shift is
masked to make it logical. Island segmentation stays the shared native
C call (``desamba_tpu.io.native.islands_batch``); ``segment_islands`` is
its pure-Python fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from desamba_tpu.constants import FORWARD, STEP_EK

from .intops import I32, I64, i32, take


def _shr(k, n: int):
    """Logical right shift of a uint64 held in int64."""
    return (k >> n) & ((1 << (64 - n)) - 1)


def hash64_1(k):
    """Thomas Wang mix #1 (reference src/lib/utils.c:1067-1078)."""
    k = (~k) + (k << 21)
    k = k ^ _shr(k, 24)
    k = (k + (k << 3)) + (k << 8)
    k = k ^ _shr(k, 14)
    k = (k + (k << 2)) + (k << 4)
    k = k ^ _shr(k, 28)
    return k + (k << 31)


def hash64_2(k):
    """Mix #2 (reference src/lib/utils.c:1081-1092)."""
    k = k + ~(k << 32)
    k = k ^ _shr(k, 22)
    k = k + ~(k << 13)
    k = k ^ _shr(k, 8)
    k = k + (k << 3)
    k = k ^ _shr(k, 15)
    k = k + ~(k << 27)
    return k ^ _shr(k, 31)


def ekmer_probe_indices(codes, lengths, l_ek: int, single_base_max: int,
                        mask_bits: int):
    """Per-position existence-probe addresses for a padded read batch.

    codes: (B, L) uint8 2-bit reads; lengths: (B,) int32.
    Returns (byte1, bit1, byte2, bit2, valid), each (B, L - l_ek + 1)."""
    B, L = codes.shape
    n_k = L - l_ek + 1
    c64 = codes.to(I64)
    kmer = torch.zeros((B, n_k), dtype=I64, device=codes.device)
    for j in range(l_ek):
        kmer = kmer | (c64[:, j : j + n_k] << (2 * (l_ek - 1 - j)))
    # low-complexity filter: any single base >= single_base_max in window
    bad = torch.zeros((B, n_k), dtype=torch.bool, device=codes.device)
    for b in range(4):
        cs0 = torch.nn.functional.pad(
            torch.cumsum((codes == b).to(I32), dim=1, dtype=I32), (1, 0))
        cnt = cs0[:, l_ek : n_k + l_ek] - cs0[:, :n_k]
        bad = bad | (cnt >= single_base_max)
    mask64 = (1 << mask_bits) - 1

    def addr(h):
        h = h & mask64
        return i32(_shr(h, 3)), 7 - (h & 7).to(I32)

    b1, s1 = addr(hash64_1(kmer))
    b2, s2 = addr(hash64_2(kmer))
    pos = torch.arange(n_k, dtype=I32, device=codes.device)[None, :]
    valid = ~bad & (kmer != 0) & (pos < (lengths[:, None] - l_ek + 1))
    return b1, s1, b2, s2, valid


def bloom_hit_kernel(codes, lengths, ek0, ek1, l_ek: int,
                     single_base_max: int, mask_bits: int):
    """(B, L - l_ek + 1) bool: e-kmer passes the complexity filter and both
    existence-table probes. The port keeps this boolean matrix (the JAX
    ``classifier._bloom_packed`` bit-packs it only to save relay bytes)."""
    b1, s1, b2, s2, valid = ekmer_probe_indices(
        codes, lengths, l_ek, single_base_max, mask_bits)
    hit1 = ((take(ek0, b1.reshape(-1)).reshape(b1.shape).to(I32) >> s1)
            & 1).bool()
    hit2 = ((take(ek1, b2.reshape(-1)).reshape(b2.shape).to(I32) >> s2)
            & 1).bool()
    return hit1 & hit2 & valid


def segment_islands(hit_row: np.ndarray, n_kmers: int, direction: int) -> list:
    """Arithmetic per-run island walk, equivalent to the reference scan
    (the host fallback when the native library is unavailable)."""
    hv = hit_row[:n_kmers]
    d = np.diff(np.concatenate([[0], hv.view(np.int8), [0]]))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    seeds = []
    if direction == FORWARD:
        p = STEP_EK - 1
        for a, b in zip(starts, ends):
            while True:
                if p < a:
                    p = a + (-(a - p)) % STEP_EK
                if p >= b:
                    break
                o = max(a, p - 2)
                ln = min(61, b - o)
                seeds.append([int(o), int(ln), 0])
                p = o + ln + STEP_EK
        return seeds
    p = n_kmers - STEP_EK
    for a, b in zip(starts[::-1], ends[::-1]):
        while True:
            if p > b - 1:
                p = (b - 1) - (-(p - (b - 1))) % STEP_EK
            if p < a:
                break
            top = min(b - 1, p + 2)
            ln = min(61, top - a + 1)
            seeds.append([int(top - ln + 1), int(ln), 0])
            p = top - ln - STEP_EK
    return seeds
