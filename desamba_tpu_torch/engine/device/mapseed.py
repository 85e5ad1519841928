"""Batched map_seed: locate + LV extend + reference fan-out.

Counterpart of ``desamba_tpu/engine/device/mapseed.py``. One lane = one
MemRst to map; every JAX ``lax.while_loop`` is an eager loop on the same
live condition. Positions and lengths are int32; the reference's uint32
wrap quirks go through ``intops.u32`` exactly where the JAX code casts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from desamba_tpu.constants import LV_L, MIN_S_1, MIN_S_2, MIN_UNI_L, SA_MASK

from .intops import I32, I64, M32, popc, take, take2, u32
from .lv import lv_batch
from .textwalk import _word16_rows, collect_backward, find_bit_high

GARBAGE = 200

# anchor record field order (int32 columns)
A_FIELDS = (
    "mtch_len", "score", "left_len", "left_ed", "rigt_len", "rigt_ed",
    "direction", "global_offset", "ref_id", "ref_offset", "index_in_read",
    "seed_id",
)
A_NF = len(A_FIELDS)


class IndexRefs(NamedTuple):
    """Device index tensors used by map_seed (a subset of DeviceIndex)."""
    lf: torch.Tensor
    lfc: torch.Tensor
    row_char: torch.Tensor
    row_pos: torch.Tensor
    uni_start: torch.Tensor
    uni_len: torch.Tensor
    uni_ref_list: torch.Tensor
    rp_global_off: torch.Tensor
    rp_ref_id: torch.Tensor
    ref_off: torch.Tensor
    ref_bin: torch.Tensor
    ref_pk: torch.Tensor
    text_pk: torch.Tensor
    sep_any: torch.Tensor
    sep_hash: torch.Tensor
    samp_bits: torch.Tensor
    isa: torch.Tensor
    pos2uni: torch.Tensor
    text_len: int
    n_uni: int
    n_bases: int


def _ar13(device):
    return torch.arange(LV_L + 1, dtype=I32, device=device)[None, :]


def qslice13(codes_pk, buf_len, ridx, start, step):
    """13-char read-buffer window (gold qslice; GARBAGE outside buffer)."""
    ar = _ar13(start.device)
    base = start if step > 0 else start - LV_L
    v = _word16_rows(codes_pk, ridx, base)
    ch = ((v[:, None] >> (ar.to(I64) * 2)) & 3).to(torch.uint8)
    if step < 0:
        ch = ch.flip(1)
    idx = start[:, None] + step * ar
    ok = (idx >= 0) & (idx < buf_len[ridx.long()][:, None])
    return torch.where(ok, ch, torch.full_like(ch, GARBAGE))


def get_ref13(ix: IndexRefs, offset, length, forward: bool):
    """13-char packed-reference window (gold get_ref semantics): chars
    beyond ``length`` are 0; positions outside the reference replicate its
    first/last char."""
    ref_pk, n_bases = ix.ref_pk, ix.n_bases
    off = offset.clamp(min=0)
    ar = _ar13(offset.device)
    start = off if forward else off - LV_L
    v16 = _word16_rows(ref_pk, torch.zeros_like(off), start)
    v = ((v16[:, None] >> (ar.to(I64) * 2)) & 3).to(torch.uint8)
    idx = start[:, None] + ar
    first = (u32(ref_pk[0, 0]) & 3).to(torch.uint8)
    last = ((u32(ref_pk[0, (n_bases - 1) >> 4]) >> (((n_bases - 1) & 15) * 2))
            & 3).to(torch.uint8)
    v = torch.where(idx < 0, first, v)
    v = torch.where(idx >= n_bases, last, v)
    chars = v if forward else v.flip(1)
    return torch.where(ar < length[:, None], chars, torch.zeros_like(chars))


def _leading_matches(t, q, limit):
    """Count of leading positions where t == q, capped at limit (N,)."""
    ar = _ar13(t.device)
    agree = ((t == q) & (ar < limit[:, None])).to(I64)
    mask = torch.sum(agree << ar.to(I64), dim=1)
    low = (~mask) & (mask + 1)
    return torch.minimum(popc((low - 1) & M32), limit)


def get_uni(ix: IndexRefs, row, search_l, active):
    """gold Locator.get_uni: (row, search_l) -> (uni, uni_offset, g_off),
    through the direct pos2uni table."""
    row = row.to(I32)
    L = ix.text_len
    p1 = (take(ix.row_pos, row) - 1) % L
    q = p1 + search_l + 1
    walked = active & (search_l > 0)
    u_w = ix.pos2uni[q.clamp(0, L - 1).long()]
    uoff_w = q - take(ix.uni_start, u_w)
    bump = uoff_w == take(ix.uni_len, u_w)
    u_w = torch.where(bump, u_w + 1, u_w)
    uoff_w = torch.where(bump, -1, uoff_w)
    u0 = ix.pos2uni[p1.long()]
    uoff0 = p1 - take(ix.uni_start, u0) + search_l + 1
    u = torch.where(walked, u_w, u0)
    uoff = torch.where(walked, uoff_w, uoff0)
    g = take(ix.rp_global_off, take(ix.uni_ref_list, u)) + uoff
    return u, uoff, g


def get_new_ed(ix: IndexRefs, codes_pk, buf_len, ridx, base, q_off, t_off,
               l_read, is_fwd: bool, active, q_lv):
    """gold get_new_ed: re-extension against the true reference.
    Returns (ed, length, l_mem_ext), each (N,) int32."""
    if is_fwd:
        q_off = q_off.clamp(min=0)
        max_len = q_off
    else:
        max_len = l_read - q_off
    length = max_len.clamp(max=LV_L)
    l_ext = torch.zeros_like(q_off)

    def gather_q(q_off_c, l_ext_c):
        if is_fwd:
            return qslice13(codes_pk, buf_len, ridx, base + q_off_c, -1)
        return qslice13(codes_pk, buf_len, ridx, base + q_off_c + l_ext_c, 1)

    q = gather_q(q_off, l_ext)
    t = get_ref13(ix, t_off, length, not is_fwd)
    run = active & (length > 0) & (t[:, 0] == q[:, 0])
    while bool(run.any()):
        mtc = _leading_matches(t, q, length)
        adv = run & ~(mtc <= 0)
        l_ext = torch.where(adv, l_ext + mtc, l_ext)
        max_len = torch.where(adv, max_len - mtc, max_len)
        length = torch.where(adv, max_len.clamp(max=LV_L), length)
        if is_fwd:
            q_off = torch.where(adv, q_off - mtc, q_off)
        t_off = torch.where(adv, t_off + (-mtc if is_fwd else mtc), t_off)
        qn = gather_q(q_off, l_ext)
        tn = get_ref13(ix, t_off, length, not is_fwd)
        q = torch.where(adv[:, None], qn, q)
        t = torch.where(adv[:, None], tn, t)
        run = adv & (length > 0)
    ed = lv_batch(t, q, length.clamp(0, LV_L))
    return ed, length, l_ext


def map_seed_lanes(ix: IndexRefs, codes_pk, buf_len, q_mem, q_lv,
                   ridx, base, read_len, direction, seed_id,
                   sp_row, l_m0, sa_ok, sa_row, sa_l, q_off, active,
                   anchors, a_cnt, a_cap: int, rows=None):
    """One map_seed per lane. Writes lane i's anchors into
    ``anchors[rows[i]]`` (``rows`` defaults to the lane itself) IN PLACE
    and returns (anchors, a_cnt, max_s) like the JAX function."""
    N = ridx.shape[0]
    dev = ridx.device
    wlanes = torch.arange(N, dtype=I32, device=dev) if rows is None else rows
    l_m = l_m0.to(I32)
    nq = q_mem.shape[0]

    # ---- step 1: prefix ---------------------------------------------------
    l_pre0 = (q_off + 1).clamp(max=LV_L)
    q_pre = qslice13(codes_pk, buf_len, ridx, base + q_off, -1)
    need_walk = active & ~sa_ok
    b_p = sp_row.to(I32)
    hash_hit = (b_p & SA_MASK) == 0
    L_t = ix.isa.shape[0]
    p0 = ix.row_pos[b_p.clamp(0, L_t - 1).long()]
    do_pre = need_walk & ~hash_hit
    cap_pre = l_pre0.clamp(min=1)
    qs_pre, fs_pre = find_bit_high(ix.samp_bits, p0 - cap_pre, p0 - 1, do_pre)
    k_samp = torch.where(fs_pre, p0 - qs_pre, 1 << 30)
    qh_pre, fh_pre = find_bit_high(ix.sep_hash, p0 - cap_pre, p0 - 1, do_pre)
    t_hash = torch.where(fh_pre, p0 - qh_pre, 1 << 30)
    s_l = torch.where(do_pre,
                      torch.minimum(torch.minimum(cap_pre, k_samp), t_hash - 1),
                      0)
    wch = collect_backward(ix.text_pk, ix.sep_any, p0 - 1, LV_L + 1)
    walk_chars = torch.where(do_pre[:, None] & (_ar13(dev) < s_l[:, None]),
                             wch, torch.zeros_like(wch))
    b_p = torch.where(do_pre, ix.isa[(p0 - s_l).clamp(0, L_t - 1).long()], b_p)
    walk_sampled = hash_hit | (fs_pre & (s_l == k_samp))

    loc_row = torch.where(sa_ok, sa_row.to(I32), b_p)
    loc_sl = torch.where(sa_ok, sa_l, s_l)
    have_uni1 = active & (sa_ok | walk_sampled)
    uni, u_off, t_off = get_uni(ix, loc_row, loc_sl, have_uni1)

    dead = have_uni1 & (take(ix.uni_len, uni.clamp(max=ix.n_uni)) < MIN_UNI_L)
    l_pre = torch.where(have_uni1, torch.minimum(l_pre0, u_off), s_l)
    t_pre_ref = get_ref13(ix, t_off - 1, l_pre, False)
    t_pre = torch.where(have_uni1[:, None], t_pre_ref, walk_chars)
    d_pre = lv_batch(t_pre, q_pre, l_pre.clamp(0, LV_L))
    q_pre_lv = take2(q_lv, d_pre, l_pre)
    s = q_mem[l_m.clamp(0, nq - 1).long()] + q_pre_lv
    dead = dead | (active & (s < MIN_S_1) & (l_pre == LV_L) & ~have_uni1)

    # ---- step 2: continue the walk to a sample for uni-less lanes ---------
    need_walk2 = active & ~dead & ~have_uni1
    p2 = p0 - s_l
    zero = torch.zeros((N,), dtype=I32, device=dev)
    q2, f2 = find_bit_high(ix.samp_bits, zero, p2 - 1, need_walk2)
    q2w, f2w = find_bit_high(ix.samp_bits, p2, zero + L_t - 1,
                             need_walk2 & ~f2)
    steps2 = torch.where(f2, p2 - q2, p2 + (L_t - q2w))
    qf = torch.where(f2, q2, q2w)
    b_p = torch.where(need_walk2, ix.isa[qf.clamp(0, L_t - 1).long()], b_p)
    s_l = torch.where(need_walk2, s_l + steps2, s_l)
    uni2, u_off2, t_off2 = get_uni(ix, b_p, s_l, need_walk2)
    uni = torch.where(need_walk2, uni2, uni)
    u_off = torch.where(need_walk2, u_off2, u_off)
    t_off = torch.where(need_walk2, t_off2, t_off)
    dead = dead | (need_walk2
                   & (take(ix.uni_len, uni.clamp(max=ix.n_uni)) < MIN_UNI_L))

    # ---- suffix greedy extension + LV -------------------------------------
    live = active & ~dead
    q_off_r = q_off + l_m + 1
    uml = u32(take(ix.uni_len, uni.clamp(max=ix.n_uni)) - u_off - l_m)
    rml = u32(read_len - q_off_r)
    lms = torch.minimum(uml, rml)                    # l_max_suf, u32
    has_suf = live & (lms != 0)
    l_suf = torch.where(has_suf, lms.clamp(max=LV_L).to(I32), 0)
    q_i = q_off_r
    t_suf = get_ref13(ix, t_off + l_m, l_suf, True)
    q_suf = qslice13(codes_pk, buf_len, ridx, base + q_i, 1)
    run = has_suf & (l_suf > 0) & (t_suf[:, 0] == q_suf[:, 0])
    while bool(run.any()):
        mtc = _leading_matches(t_suf, q_suf, l_suf)
        adv = run & (mtc > 0)
        l_m = torch.where(adv, l_m + mtc, l_m)
        s = torch.where(adv, q_mem[l_m.clamp(0, nq - 1).long()] + q_pre_lv, s)
        lms = torch.where(adv, (lms - mtc.to(I64)) & M32, lms)
        l_suf = torch.where(adv, lms.clamp(max=LV_L).to(I32), l_suf)
        q_i = torch.where(adv, q_i + mtc, q_i)
        t_n = get_ref13(ix, t_off + l_m, l_suf, True)
        q_n = qslice13(codes_pk, buf_len, ridx, base + q_i, 1)
        t_suf = torch.where(adv[:, None], t_n, t_suf)
        q_suf = torch.where(adv[:, None], q_n, q_suf)
        run = adv & (l_suf > 0)

    d_suf = lv_batch(t_suf, q_suf, l_suf.clamp(0, LV_L))
    d_suf = torch.where(has_suf, d_suf, 0)
    l_suf = torch.where(has_suf, l_suf, 0)
    s = torch.where(has_suf, s + take2(q_lv, d_suf, l_suf), s)
    dead = dead | (live & (s <= MIN_S_2) & (l_suf == LV_L))

    # ---- fan out over reference occurrences -------------------------------
    live = active & ~dead & (s > 0)
    uni_c = uni.clamp(max=ix.n_uni)
    rl_s = take(ix.uni_ref_list, uni_c)
    rl_e = take(ix.uni_ref_list, (uni_c + 1).clamp(max=ix.n_uni))
    n_occ = rl_e - rl_s
    huge = live & (n_occ > 50) & (n_occ >= 1000)
    fan = live & ~huge
    ref_search_l = (l_pre < LV_L) | (d_pre == 0)
    ref_search_r = (l_suf < LV_L) | (d_suf == 0)
    any_research = ref_search_l | ref_search_r
    max_s = torch.zeros((N,), dtype=I32, device=dev)
    n_rp = ix.rp_global_off.shape[0]
    a_rows = anchors.shape[0]
    ci = rl_s
    run = fan & (n_occ > 0)
    while bool(run.any()):
        cic = ci.clamp(0, n_rp - 1).long()
        g_off = ix.rp_global_off[cic]
        ed_l, len_l, lx_l = get_new_ed(
            ix, codes_pk, buf_len, ridx, base, q_off, g_off + u_off - 1,
            read_len, True, run & ref_search_l, q_lv)
        lx_l = torch.where(ref_search_l, lx_l, 0)
        a_ll = torch.where(ref_search_l, len_l, l_pre)
        a_le = torch.where(ref_search_l, ed_l, d_pre)
        ed_r, len_r, lx_r = get_new_ed(
            ix, codes_pk, buf_len, ridx, base, q_off + l_m + 1,
            g_off + u_off + l_m, read_len, False, run & ref_search_r, q_lv)
        a_rl = torch.where(ref_search_r, len_r, l_suf)
        a_re = torch.where(ref_search_r, ed_r, d_suf)
        a_mtch = torch.where(any_research,
                             l_m + lx_l + torch.where(ref_search_r, lx_r, 0),
                             l_m)
        nl0, nl1 = q_lv.shape
        a_score = torch.where(
            any_research,
            q_mem[a_mtch.clamp(0, nq - 1).long()]
            + q_lv[a_le.clamp(0, nl0 - 1).long(), a_ll.clamp(0, nl1 - 1).long()]
            + q_lv[a_re.clamp(0, nl0 - 1).long(), a_rl.clamp(0, nl1 - 1).long()],
            s)
        emit = run & ~(any_research & (a_score < MIN_S_2))
        max_s = torch.where(emit, torch.maximum(max_s, a_score), max_s)
        ref_id = ix.rp_ref_id[cic]
        glob = g_off + u_off - torch.where(ref_search_l, lx_l, 0)
        rec = torch.stack([
            a_mtch, a_score, a_ll, a_le, a_rl, a_re, direction, glob, ref_id,
            glob - take(ix.ref_off, ref_id),
            q_off + 1 - torch.where(ref_search_l, lx_l, 0), seed_id], dim=1)
        write = emit & (a_cnt < a_cap)
        wr = wlanes[write].long()
        ok = wr < a_rows
        anchors[wr[ok], a_cnt[write].long()[ok]] = rec[write][ok].to(I32)
        a_cnt = torch.where(emit, a_cnt + 1, a_cnt)
        ci = ci + 1
        run = run & (ci < rl_e)
    max_s = torch.where(huge, 50, max_s)
    return anchors, a_cnt, max_s
