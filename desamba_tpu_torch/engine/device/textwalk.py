"""Position-space walk primitives over the unitig text.

Counterpart of ``desamba_tpu/engine/device/textwalk.py``: packed 2-bit
LCEs, bitmap bit scans and the SP_SET position-interval set. Each JAX
``lax.while_loop`` becomes an eager loop that syncs with the host once
per trip on the same live condition. Packed words are uint32 values
held as int64 in [0, 2^32) while they are computed on.
"""
from __future__ import annotations

import torch

from ...constants import SP_SET_CAP

from .intops import I32, I64, M32, popc, u32

IV_CAP = 512


def pack2(ch):
    """(N, L) uint8 chars -> (N, ceil(L/16)) int32 bit patterns, char j of
    a word at bits 2j..2j+1 (little-endian char order)."""
    N, L = ch.shape
    pad = (-L) % 16
    c = torch.nn.functional.pad(ch.to(I64), (0, pad)).reshape(N, -1, 16)
    sh = (torch.arange(16, dtype=I64, device=ch.device) * 2)[None, None, :]
    w = torch.sum(c << sh, dim=2)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(I32)


def _funnel(g0, g1, sh):
    """(g0 >> sh) | (g1 << (32 - sh)) on u32 values, g0 where sh == 0."""
    return torch.where(sh == 0, g0, ((g0 >> sh) | (g1 << (32 - sh))) & M32)


def _word16_1d(pk, base):
    """16-char packed value (u32 as int64) from a (1, W) packed row; base
    may be negative (chars below 0 read as zeros)."""
    b = base.clamp(min=0)
    w0 = b >> 4
    sh = ((b & 15) << 1).to(I64)
    kw = pk.shape[1]
    g0 = u32(pk[0, w0.clamp(0, kw - 1).long()])
    g1 = u32(pk[0, (w0 + 1).clamp(0, kw - 1).long()])
    v = _funnel(g0, g1, sh)
    neg = (-base).clamp(0, 15).to(I64)
    return torch.where(base < 0, (v << (neg << 1)) & M32, v)


def _word16_rows(pk, rows, base):
    """16-char packed value from per-lane packed rows."""
    b = base.clamp(min=0)
    w0 = b >> 4
    sh = ((b & 15) << 1).to(I64)
    kw = pk.shape[1]
    rows = rows.long()
    g0 = u32(pk[rows, w0.clamp(0, kw - 1).long()])
    g1 = u32(pk[rows, (w0 + 1).clamp(0, kw - 1).long()])
    v = _funnel(g0, g1, sh)
    neg = (-base).clamp(0, 15).to(I64)
    return torch.where(base < 0, (v << (neg << 1)) & M32, v)


def _bits16(bits, lo):
    """16 bitmap bits for positions [lo, lo+15], LSB = position lo."""
    b = lo.clamp(min=0)
    w0 = b >> 5
    sh = (b & 31).to(I64)
    W = bits.shape[0]
    g0 = u32(bits[w0.clamp(0, W - 1).long()])
    g1 = u32(bits[(w0 + 1).clamp(0, W - 1).long()])
    v = _funnel(g0, g1, sh)
    neg = (-lo).clamp(0, 16).to(I64)
    v = torch.where(lo < 0, (v << neg) & M32, v)
    return v & 0xFFFF


def _spread16(x):
    """Move bit j of a 16-bit value to bit 2j."""
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def lce_backward(text_pk, sep_any, codes_pk, rows, col_off, q_hi, t_hi,
                 cap, active):
    """Backward match run: codes[rows, col_off + q_hi - k] vs
    text[t_hi - k] for k = 0.., stopping at the first mismatch, any text
    separator, q_hi - k < 0, t_hi - k < 0, or cap. (N,) int32."""
    n = torch.zeros_like(q_hi, dtype=I32)
    run = active & (cap > 0)
    while bool(run.any()):
        qi = col_off + q_hi - n
        ti = t_hi - n
        qw = _word16_rows(codes_pk, rows, qi - 15)
        tw = _word16_1d(text_pk, ti - 15)
        y = qw ^ tw
        y = (y | (y >> 1)) & 0x55555555
        y = y | _spread16(_bits16(sep_any, ti - 15))
        s = y | (y >> 2)
        s = s | (s >> 4)
        s = s | (s >> 8)
        s = s | (s >> 16)
        m = 16 - popc(s & 0x55555555)
        q_rem = (q_hi - n + 1).clamp(min=0)
        t_rem = (ti + 1).clamp(min=0)
        lim = torch.minimum(torch.minimum(q_rem, t_rem), cap - n).clamp(min=0)
        adv = torch.minimum(m, lim.clamp(max=16))
        n = torch.where(run, n + adv, n)
        run = run & (adv == 16) & (n < cap)
    return n


def collect_backward(text_pk, sep_any, t_hi, width: int):
    """Chars text[t_hi], text[t_hi - 1], ... as (N, width) uint8 with
    separators and positions < 0 as 4."""
    tw = _word16_1d(text_pk, t_hi - 15)
    sep = _bits16(sep_any, t_hi - 15)
    k = torch.arange(width, dtype=I64, device=t_hi.device)[None, :]
    ch = ((tw[:, None] >> ((15 - k) * 2)) & 3).to(torch.uint8)
    bad = (((sep[:, None] >> (15 - k)) & 1) == 1) | ((t_hi[:, None] - k) < 0)
    return torch.where(bad, torch.full_like(ch, 4), ch)


def _range_masks(word, lo, hi, base):
    b_lo = (lo - base).clamp(0, 32).to(I64)
    b_hi = (hi - base).clamp(-1, 31).to(I64)
    one = torch.ones_like(b_lo)
    m_lo = torch.where(b_lo >= 32, 0, ((one * M32) << b_lo) & M32)
    m_hi = torch.where(b_hi < 0, 0,
                       torch.where(b_hi >= 31, M32,
                                   (one << (b_hi + 1).clamp(min=0)) - 1))
    return word & m_lo & m_hi


def find_bit_low(bits, lo, hi, active):
    """Smallest position q in [lo, hi] with bits[q] set: (q, found)."""
    W = bits.shape[0]
    w = lo.clamp(min=0) >> 5
    w_hi = hi.clamp(min=0) >> 5
    q = torch.zeros_like(lo, dtype=I32)
    found = torch.zeros_like(active)
    run = active & (hi >= lo) & (hi >= 0)
    while bool(run.any()):
        word = u32(bits[w.clamp(0, W - 1).long()])
        base = w << 5
        masked = _range_masks(word, lo, hi, base)
        hit = run & (masked != 0)
        low = popc(((masked & ((~masked + 1) & M32)) - 1) & M32)
        q = torch.where(hit, base + low, q)
        found = found | hit
        run = run & ~hit & (w < w_hi)
        w = torch.where(run, w + 1, w)
    return q, found


def find_bit_high(bits, lo, hi, active):
    """Largest position q in [lo, hi] with bits[q] set: (q, found)."""
    W = bits.shape[0]
    w = hi.clamp(min=0) >> 5
    w_lo = lo.clamp(min=0) >> 5
    q = torch.zeros_like(lo, dtype=I32)
    found = torch.zeros_like(active)
    run = active & (hi >= lo) & (hi >= 0)
    while bool(run.any()):
        word = u32(bits[w.clamp(0, W - 1).long()])
        base = w << 5
        m = _range_masks(word, lo, hi, base)
        hit = run & (m != 0)
        m = m | (m >> 1)
        m = m | (m >> 2)
        m = m | (m >> 4)
        m = m | (m >> 8)
        m = m | (m >> 16)
        q = torch.where(hit, base + popc(m) - 1, q)
        found = found | hit
        run = run & ~hit & (w > w_lo)
        w = torch.where(run, w - 1, w)
    return q, found


# ---- SP_SET as disjoint position intervals --------------------------------
def ivset_init(n, cap: int = IV_CAP, device="cpu"):
    """iv (n, cap, 2) int32 [lo, hi] (empty = [0, -1]) and cnt (n, 3)
    int32 = [intervals used, total positions, overflowed]. cap < IV_CAP is
    a hot tier whose overflow sets the sticky bit instead of storing."""
    iv = torch.zeros((n, cap, 2), dtype=I32, device=device)
    iv[:, :, 1] = -1
    return iv, torch.zeros((n, 3), dtype=I32, device=device)


def _covered_point(iv, p):
    return ((iv[:, :, 0] <= p[:, None]) & (p[:, None] <= iv[:, :, 1])).any(1)


def _covered_max_in(iv, a, b):
    c = torch.minimum(iv[:, :, 1], b[:, None])
    ok = (c >= iv[:, :, 0]) & (c >= a[:, None])
    best = torch.where(ok, c, -1).amax(dim=1)
    return best, best >= 0


def ivset_walk(iv, cnt, p, nat, do):
    """The reference's insert sequence for one row walk (see the JAX
    ``ivset_walk``). Updates ``iv`` in place; returns
    (iv, cnt, dup0, abort, wlen)."""
    N, cap = iv.shape[0], iv.shape[1]
    niv, size, ovf = cnt[:, 0], cnt[:, 1], cnt[:, 2]
    reset0 = do & (size == SP_SET_CAP)
    iv[reset0, :, 0] = 0
    iv[reset0, :, 1] = -1
    niv = torch.where(reset0, 0, niv)
    size = torch.where(reset0, 0, size)

    dup0 = do & _covered_point(iv, p)
    walk = do & ~dup0
    s1 = size + 1
    j_r = SP_SET_CAP + 1 - s1
    qd, has = _covered_max_in(iv, p - nat, p - 1)
    j_dup = p - qd
    dup_real = walk & has & (j_dup < j_r) & (nat > 0)
    wlen = torch.where(dup_real, j_dup - 1, nat)
    midreset = walk & ~dup_real & (nat >= j_r)

    iv[midreset, :, 0] = 0
    iv[midreset, :, 1] = -1
    new_lo = torch.where(midreset, p - nat, p - wlen)
    new_hi = torch.where(midreset, p - j_r, p)
    slot = torch.where(midreset, 0, niv.clamp(max=cap - 1)).long()
    lanes = torch.arange(N, device=iv.device)
    w = walk.nonzero().squeeze(1)
    iv[lanes[w], slot[w], 0] = new_lo[w]
    iv[lanes[w], slot[w], 1] = new_hi[w]
    ovf = ovf | (walk & ~midreset & (niv >= cap)).to(I32)
    niv = torch.where(walk, torch.where(midreset, 1, niv + 1), niv)
    size = torch.where(walk, torch.where(midreset, nat - j_r + 1, s1 + wlen),
                       size)
    return iv, torch.stack([niv, size, ovf], dim=1).to(I32), dup0, dup_real, \
        wlen
