"""Batched FM rank + backward MEM search (counterpart of
desamba_tpu/engine/device/fm.py ``mem_probe``).

The interval phase resolves lanes whose initial 13-mer bucket holds at
most ``SA_CAP`` rows in position space (``_interval_sa``: one packed LCE
per bucket row plus closed-form stop resolution); larger buckets take
the rank chase (``_interval_rank_chase``). The per-row walks run in
position space with the SP_SET interval set (textwalk.py). Parity
contract: identical MemRst sets and SP_SET state to the JAX function.
"""
from __future__ import annotations

import torch

from desamba_tpu.constants import L_PRE_IDX

from . import textwalk
from .arrays import BLOCK
from .compaction import compact_rows
from .intops import I32, I64, M32, i32, take, u32
from .textwalk import find_bit_low, ivset_init, ivset_walk, lce_backward

SA_CAP = 16
BIG = 1 << 30


def _rank_from_blocks(fm_blocks, r, c):
    """occ(c, r): count of char c in rows [0, r), as u32 in int64."""
    blk = torch.div(r, BLOCK, rounding_mode="floor")
    within = r - blk * BLOCK
    got = u32(take(fm_blocks, blk))                  # (N, 9)
    base = got[:, 0]
    for k in range(1, 5):
        base = torch.where(c == k, got[:, k], base)
    words = got[:, 5:9]
    x = words ^ ((c.to(I64) * 0x11111111) & M32)[:, None]
    y = ~(x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111
    nib_start = torch.arange(4, dtype=I32, device=r.device)[None, :] * 8
    tk = (within[:, None] - nib_start).clamp(0, 8).to(I64)
    mask = torch.where(tk >= 8, 0x11111111,
                       (torch.ones_like(tk) << (tk * 4)) - 1)
    y = y & mask
    y = y + (y >> 16)
    y = y + (y >> 8)
    y = y + (y >> 4)
    return (base + torch.sum(y & 0xF, dim=1)) & M32


def spset_init(n, cap: int | None = None, device="cpu"):
    """Fresh per-lane SP_SET state; cap selects a hot tier, None = full
    IV_CAP (never overflows)."""
    return ivset_init(n, cap if cap is not None else textwalk.IV_CAP,
                      device=device)


def _interval_rank_chase(fm_blocks, rank6, codes, str_idx, sp0, ep0,
                         active, max_rst: int, l_min_mth: int, col_off,
                         rows):
    """The reference's occ-chase interval loop, lane-lockstep: the path of
    lanes whose 13-mer interval exceeds SA_CAP rows. sp/ep are u32 in
    int64. Returns (match_len, str_i, n_sp, n_ep, fail)."""
    L = codes.shape[1]
    match_len = torch.full_like(str_idx, L_PRE_IDX)
    str_i = str_idx - L_PRE_IDX
    l_max = str_idx
    sp, ep = sp0.clone(), ep0.clone()
    n_sp = torch.zeros_like(sp0)
    n_ep = torch.zeros_like(sp0)
    fail = torch.zeros_like(active)
    rank = u32(rank6)
    running = active.clone()
    rows = rows.long()
    while bool(running.any()):
        ci = (col_off + str_i).clamp(0, L - 1).long()
        c = codes[rows, ci].to(I32)
        offbuf = str_i < 0
        c = torch.where(offbuf, 0, c)
        r_c = rank[c.long()]
        nsp = (r_c + _rank_from_blocks(fm_blocks, i32(sp), c)) & M32
        nep = (r_c + _rank_from_blocks(fm_blocks, i32(ep), c)) & M32
        ge_min = match_len >= l_min_mth - 1
        stop_a = ge_min & (((nsp + max_rst) & M32) >= nep)
        stop_b = ge_min & ~stop_a & (match_len >= l_max)
        stop_c = ~stop_a & ~stop_b & (((nsp + 1) & M32) >= nep)
        stop = stop_a | stop_b | stop_c | offbuf
        this_fail = stop_b | offbuf | (stop & (nsp >= nep))
        upd = running & stop
        fail = torch.where(upd, this_fail, fail)
        n_sp = torch.where(upd, nsp, n_sp)
        n_ep = torch.where(upd, nep, n_ep)
        cont = running & ~stop
        sp = torch.where(cont, nsp, sp)
        ep = torch.where(cont, nep, ep)
        match_len = torch.where(cont, match_len + 1, match_len)
        str_i = torch.where(running, str_i - 1, str_i)
        running = cont
    return match_len, str_i, n_sp, n_ep, fail


def _interval_sa(ixr, codes_pk, str_idx, sp0, n0, active, max_rst: int,
                 l_min_mth: int, col_off, rows, sa_cap: int):
    """Position-space interval phase for lanes with n0 <= SA_CAP.
    Returns (match_len, str_i, fail, n_rows, w_pos, w_valid)."""
    N = str_idx.shape[0]
    C = sa_cap
    dev = str_idx.device
    slot = torch.arange(C, dtype=I32, device=dev)[None, :]
    rvalid = active[:, None] & (slot < n0[:, None])
    fg, fs, fvalid = compact_rows(rvalid.reshape(-1), 2 * N)
    f_lane = torch.div(fg, C, rounding_mode="floor").long()
    f_slot = fg - f_lane.to(I32) * C
    rowix = i32(sp0[f_lane]) + f_slot
    n_text = ixr.isa.shape[0]
    p = ixr.row_pos[rowix.clamp(0, n_text - 1).long()]
    cap_l = (str_idx - L_PRE_IDX + 1).clamp(min=0)
    lce = lce_backward(ixr.text_pk, ixr.sep_any, codes_pk, rows[f_lane],
                       col_off[f_lane], str_idx[f_lane] - L_PRE_IDX,
                       p - 1, cap_l[f_lane], fvalid)
    # scatter back to dense (N, C); empty compact slots (index N*C) drop
    keep = fs < N * C
    dst = fs[keep].long()
    lden = torch.full((N * C,), -1, dtype=I32, device=dev)
    lden[dst] = torch.where(fvalid, lce, -1)[keep]
    lden = lden.reshape(N, C)
    pden = torch.zeros((N * C,), dtype=I32, device=dev)
    pden[dst] = p[keep]
    pden = pden.reshape(N, C)

    lsort = torch.sort(lden, dim=1, descending=True).values
    zero = torch.zeros((N,), dtype=I32, device=dev)
    a_m1 = lsort[:, max_rst].clamp(min=0) if max_rst + 1 <= C else zero
    a_2 = lsort[:, 1].clamp(min=0) if C >= 2 else zero

    gmin_k = l_min_mth - 1 - L_PRE_IDX
    l_max = str_idx
    k_a = a_m1.clamp(min=gmin_k)
    k_b0 = (l_max - L_PRE_IDX).clamp(min=gmin_k)
    k_b = torch.where(k_b0 < a_m1, k_b0, BIG)
    k_c = torch.where(a_2 < gmin_k, a_2, BIG)
    k_star = torch.minimum(torch.minimum(k_a, k_b), k_c)
    k_off = str_idx - L_PRE_IDX + 1
    fail_off = k_star >= k_off
    is_b = (k_star == k_b) & ~fail_off
    k_eff = torch.minimum(k_star, k_off)

    surv = rvalid & (lden >= (k_eff + 1)[:, None])
    n_new = surv.sum(dim=1, dtype=I32)
    fail = fail_off | is_b | (n_new == 0)
    match_len = L_PRE_IDX + k_eff
    str_i = str_idx - L_PRE_IDX - (k_eff + 1)
    n_rows = torch.where(active & ~fail, n_new.clamp(max=max_rst), 0)

    # dense-pack survivor positions in row order (column C is a dump)
    dpos = torch.cumsum(surv.to(I32), dim=1, dtype=I32) - 1
    dest = torch.where(surv & (dpos < C), dpos, C).long()
    w_pos = torch.zeros((N, C + 1), dtype=I32, device=dev)
    lanes2 = torch.arange(N, device=dev)[:, None].expand(N, C)
    w_pos[lanes2[surv], dest[surv]] = (pden - (k_eff + 1)[:, None])[surv]
    w_valid = slot < n_rows[:, None]
    return match_len, str_i, fail, n_rows, w_pos[:, :C], w_valid


def mem_probe(ixr, fm_blocks, rank6, hash13, codes, codes_pk, str_idx,
              pre_v, active, spset, spcount, max_rst: int, l_min_mth: int,
              col_off=None, row_idx=None, sa_cap: int = SA_CAP):
    """One backward MEM probe per lane (bwt_MEM_search,
    src/cly.c:1388-1447). Same arguments and results as the JAX
    ``mem_probe``: (res_len, res_sp, res_sa, res_sa_ok, res_sa_l,
    res_valid, spset, spcount); res_sp/res_sa are u32 bit patterns in
    int32. ``spset``/``spcount`` are not modified; fresh ones return."""
    N = str_idx.shape[0]
    dev = str_idx.device
    lanes = torch.arange(N, dtype=I32, device=dev)
    if col_off is None:
        col_off = torch.zeros((N,), dtype=I32, device=dev)
    rows = lanes if row_idx is None else row_idx
    n_text = ixr.isa.shape[0]

    # ---- interval phase ----------------------------------------------------
    sp0 = u32(take(hash13, pre_v))
    ep0 = u32(take(hash13, pre_v + 1))
    n0 = i32(ep0 - sp0)
    big = active & (n0 > sa_cap)
    sa_act = active & ~big
    n_eff = torch.where(sa_act, n0.clamp(max=sa_cap), 0)
    fit = torch.cumsum(n_eff, dim=0, dtype=I32) <= 2 * N
    big = big | (sa_act & ~fit)
    sa_act = sa_act & fit

    z = torch.zeros((N,), dtype=I32, device=dev)
    if sa_cap > 0:
        ml_s, si_s, fail_s, nr_s, wpos_s, _ = _interval_sa(
            ixr, codes_pk, str_idx, sp0, n0, sa_act, max_rst, l_min_mth,
            col_off, rows, sa_cap)
    else:  # chase-only (test/fallback mode)
        ml_s, si_s, nr_s = z, z, z
        fail_s = torch.zeros((N,), dtype=torch.bool, device=dev)
        wpos_s = torch.zeros((N, 1), dtype=I32, device=dev)
    if bool(big.any()):
        ml_b, si_b, nsp_b, nep_b, fail_b = _interval_rank_chase(
            fm_blocks, rank6, codes, str_idx, sp0, ep0, big, max_rst,
            l_min_mth, col_off, rows)
    else:
        zu = torch.zeros((N,), dtype=I64, device=dev)
        ml_b, si_b, nsp_b, nep_b = z, z, zu, zu
        fail_b = torch.zeros((N,), dtype=torch.bool, device=dev)

    match_len = torch.where(big, ml_b, ml_s)
    str_i = torch.where(big, si_b, si_s)
    fail = torch.where(big, fail_b, fail_s)
    ok = active & ~fail
    nr_b = torch.where(big & ok, i32(nep_b - nsp_b), 0)
    n_rows = torch.where(big, nr_b.clamp(max=max_rst), nr_s)

    # ---- per-row walks in position space (bwt_single_search) --------------
    R = max_rst
    res_len = torch.zeros((N, R), dtype=I32, device=dev)
    res_sp = torch.zeros((N, R), dtype=I32, device=dev)
    res_sa = torch.zeros((N, R), dtype=I32, device=dev)
    res_sa_ok = torch.zeros((N, R), dtype=torch.bool, device=dev)
    res_sa_l = torch.zeros((N, R), dtype=I32, device=dev)
    res_valid = torch.zeros((N, R), dtype=torch.bool, device=dev)
    wmax = (str_idx - match_len).clamp(min=0)
    iv, cnt = spset.clone(), spcount.clone()
    kmax = int(torch.where(ok, n_rows, 0).max()) if N else 0
    for k in range(kmax):
        do = ok & (k < n_rows)
        row_b = i32(nsp_b + k)
        p_b = ixr.row_pos[row_b.clamp(0, n_text - 1).long()]
        p_s = wpos_s[:, min(k, wpos_s.shape[1] - 1)]
        p = torch.where(big, p_b, p_s)
        nat = lce_backward(ixr.text_pk, ixr.sep_any, codes_pk, rows, col_off,
                           str_i, p - 1, wmax, do)
        iv, cnt, dup0, abort, wlen = ivset_walk(iv, cnt, p, nat, do)
        do_walk = do & ~dup0
        T = torch.where(abort | (wlen < wmax), wlen, wmax - 1)
        qs, found = find_bit_low(ixr.samp_bits, p - T, p,
                                 do_walk & (T >= 0))
        sa = torch.where(found, ixr.isa[qs.clamp(0, n_text - 1).long()], 0)
        sa_l = torch.where(found, (p - qs) - T, -(T + 1))
        end_row = ixr.isa[(p - wlen).clamp(0, n_text - 1).long()]
        total = torch.where(abort, -1000, wlen) + match_len + 1
        res_len[:, k] = torch.where(do_walk, total, 0)
        res_sp[:, k] = torch.where(do_walk, end_row, 0)
        res_sa[:, k] = torch.where(do_walk & found, sa, 0)
        res_sa_ok[:, k] = do_walk & found
        res_sa_l[:, k] = torch.where(do_walk, sa_l, 0)
        res_valid[:, k] = do_walk & (total >= l_min_mth)
    return (res_len, res_sp, res_sa, res_sa_ok, res_sa_l, res_valid, iv, cnt)
