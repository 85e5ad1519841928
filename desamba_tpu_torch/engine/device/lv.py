"""Batched Landau-Vishkin edit distance (<= 4 errors, <= 12 bp windows).

Counterpart of ``desamba_tpu/engine/device/lv.py``: the same fixed
35-step unrolled DP of (N,) vector ops, with the per-diagonal match run
as a 14-bit agreement mask plus count-trailing-zeros.
"""
from __future__ import annotations

import torch

from ...constants import LV_ERROR

from .intops import I32, I64, M32, popc

LV_BASE = LV_ERROR          # 4
SENT_REF = 254
SENT_QRY = 255
NQ = 14                     # query indices 0..13 (12 chars + sentinel slot)
OFF = LV_BASE + 1           # mn[j] lives at column OFF + j


def _ctz32(x):
    """Count trailing zeros of a uint32 (int64 in [0, 2^32)); 32 for 0."""
    low = x & ((~x + 1) & M32)
    return popc((low - 1) & M32)


def lv_batch(ref, qry, length):
    """ref, qry: (N, 13) uint8 (only [:length] used); length: (N,) 0..12.
    Returns (N,) int32 edit distance (gold lv_extd(ref, l, qry, l))."""
    N = ref.shape[0]
    dev = ref.device
    length = length.to(I32)
    m_idx = torch.arange(NQ, dtype=I32, device=dev)[None, :]

    def padded(x, sent):
        x14 = torch.nn.functional.pad(x.to(I32), (0, NQ - x.shape[1]))
        return torch.where(m_idx == length[:, None], sent, x14)

    rp = padded(ref, SENT_REF)
    qp = padded(qry, SENT_QRY)

    masks = {}
    for d in range(-LV_BASE, LV_BASE + 1):
        mr = m_idx + d
        valid = (m_idx <= length[:, None]) & (mr >= 0) & (mr <= length[:, None])
        if d >= 0:
            r_sh = torch.cat([rp[:, d:], torch.zeros((N, d), dtype=I32,
                                                      device=dev)], dim=1)
        else:
            r_sh = torch.cat([torch.full((N, -d), -1, dtype=I32, device=dev),
                              rp[:, :d]], dim=1)
        agree = (valid & (r_sh == qp)).to(I64)
        masks[d] = torch.sum(agree << m_idx.to(I64), dim=1)

    mn = torch.cat([torch.full((N, 2 * OFF + 1), -1, dtype=I32, device=dev),
                    torch.zeros((N, 2), dtype=I32, device=dev)], dim=1)
    ed = torch.cat([
        torch.arange(-OFF, OFF + 1, dtype=I32, device=dev).abs()[None, :]
        .expand(N, -1),
        torch.zeros((N, 2), dtype=I32, device=dev)], dim=1).contiguous()
    best = length.clone()
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    zeros64 = torch.zeros((N,), dtype=I64, device=dev)

    for i in range(LV_ERROR + 1):
        prev_mn = torch.full((N,), -1, dtype=I32, device=dev)
        cur_mn = torch.full((N,), i - 1, dtype=I32, device=dev)
        next_mn = mn[:, OFF - i + 1].clone()
        prev_ed = torch.full((N,), i + 1, dtype=I32, device=dev)
        cur_ed = torch.full((N,), i, dtype=I32, device=dev)
        next_ed = ed[:, OFF - i + 1].clone()
        for j in range(-i, LV_ERROR + 1):
            take_ext = cur_mn + j < length - 1
            a_mn = cur_mn + 1
            a_ed = cur_ed + 1
            a_max = cur_mn + 1 - cur_ed
            usen = a_max < next_mn + 1 - next_ed
            a_mn = torch.where(usen, next_mn + 1, a_mn)
            a_ed = torch.where(usen, next_ed + 1, a_ed)
            a_max = torch.where(usen, next_mn - next_ed, a_max)
            usep = a_max < prev_mn - prev_ed
            a_mn = torch.where(usep, prev_mn + 1, a_mn)
            a_ed = torch.where(usep, prev_ed + 1, a_ed)
            b_mn = cur_mn
            b_ed = cur_ed + 1
            b_max = cur_mn - cur_ed
            usep = b_max < prev_mn - prev_ed
            b_mn = torch.where(usep, prev_mn, b_mn)
            b_ed = torch.where(usep, prev_ed + 1, b_ed)
            b_max = torch.where(usep, prev_mn - prev_ed, b_max)
            usen = b_max < next_mn + 1 - next_ed
            b_mn = torch.where(usen, next_mn + 1, b_mn)
            b_ed = torch.where(usen, next_ed + 1, b_ed)

            new_mn = torch.where(take_ext, a_mn, b_mn)
            new_ed = torch.where(take_ext, a_ed, b_ed)
            new_mn = torch.minimum(new_mn, length)
            new_mn = torch.minimum(new_mn, length - j)
            mask = masks[j] if abs(j) <= LV_BASE else zeros64
            sh = new_mn.clamp(0, 31).to(I64)
            run = _ctz32(~(mask >> sh) & M32)
            run = torch.where(new_mn >= 0, run, 0)
            new_mn = new_mn + run
            hit = (new_mn == length) | (new_mn + j == length)
            new_best = torch.where(hit, torch.minimum(new_ed - 1, best), best)
            new_done = done | (hit & (j <= i + 1))
            best = torch.where(done, best, new_best)
            done = new_done
            mn[:, OFF + j] = torch.where(done, mn[:, OFF + j], new_mn)
            ed[:, OFF + j] = torch.where(done, ed[:, OFF + j], new_ed)
            prev_mn, cur_mn, next_mn = cur_mn, next_mn, mn[:, OFF + j + 2].clone()
            prev_ed, cur_ed, next_ed = cur_ed, next_ed, ed[:, OFF + j + 2].clone()
    return best
