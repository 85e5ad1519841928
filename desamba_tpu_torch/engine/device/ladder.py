"""Fast / slow classify ladders (src/cly.c:1478-1611).

Counterpart of ``desamba_tpu/engine/device/ladder.py``. Each ladder is an
eager torch loop over the ``cond``/``body`` of the JAX ``while_loop``: it
syncs with the host once per trip (``active.any()``) and runs until the
same live condition fails, never a fixed worst-case trip count.

The JAX ladder compacts at most ``bl`` active lanes per trip (a TPU cost
knob); every lane's trajectory is independent of the trip it runs in, so
the port takes ALL active lanes each trip (``bl`` = the live count). The
results are the same lane for lane; only the trip count differs.
"""
from __future__ import annotations

import torch

from ...constants import (
    MEM_SEARCH_FAST,
    MEM_SEARCH_SLOW,
    MIN_MEM_LEN_FAST,
    MIN_MEM_LEN_SLOW,
    PRE_IDX_MASK,
)

from . import fm as dev_fm
from .intops import I32, argsort_stable
from .mapseed import A_NF, map_seed_lanes
from .textwalk import pack2

# SP_SET hot-tier size (overflowing groups re-run at full IV_CAP)
IV_HOT = 32
# slow-mode collected MEM record: (match_len, sp, sa_row, sa_ok, sa_l, str_idx)
M_NF = 6


def pack_anchors(anchors, a_cnt, pack_cap: int):
    """Compact per-lane anchor buffers into one flat (pack_cap, A_NF+1)
    array; column 12 is the per-island anchor_useless mark. Returns
    (packed, base, overflow) with base = exclusive prefix of a_cnt."""
    N, A, F = anchors.shape
    dev = anchors.device
    cnt = a_cnt.clamp(max=A)
    slot = torch.arange(A, dtype=I32, device=dev)[None, :]
    valid = slot < cnt[:, None]
    top = torch.where(valid, anchors[:, :, 1], 35).amax(dim=1).clamp(min=35)
    useless = (anchors[:, :, 1] < top[:, None]).to(I32)
    anchors13 = torch.cat([anchors, useless[:, :, None]], dim=2)
    base = torch.cumsum(cnt, dim=0, dtype=I32) - cnt
    dest = base[:, None] + slot
    ok = valid & (dest < pack_cap)
    packed = torch.zeros((pack_cap, F + 1), dtype=I32, device=dev)
    packed[dest[ok].long()] = anchors13[ok]
    overflow = bool((base + cnt > pack_cap).any())
    return packed, base, overflow


def pack_info(base, acnt, skip, ivovf):
    """(N, 4) int32 row [base, acnt, skip, iv_ovf] for the host."""
    return torch.stack([base.to(I32), acnt.to(I32), skip.to(I32),
                        ivovf.to(I32)], dim=1)


def _unpack_lanes(lane_args):
    """lane_args: (8, N) int32 [ridx, base, read_len, dir, sid, seed_off,
    seed_len, lane_on]."""
    c = lane_args
    return (c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7] != 0)


def _probe(ixr, fm_blocks, rank6, hash13, codes_fr, codes_pk, pre13_fr,
           l_ek, rg, j, spset, spcount, ridx, base, seed_off, max_rst,
           l_min):
    """The per-trip MEM probe over the active lanes ``rg``."""
    ridx_c, base_c = ridx[rg], base[rg]
    j_c = j[rg]
    ki = seed_off[rg] + j_c
    str_idx = ki + l_ek - 1
    W = pre13_fr.shape[1]
    pre_v = pre13_fr[ridx_c.long(), (base_c + ki).clamp(0, W - 1).long()]
    pre_v = pre_v & PRE_IDX_MASK
    act_c = torch.ones_like(j_c, dtype=torch.bool)
    out = dev_fm.mem_probe(
        ixr, fm_blocks, rank6, hash13, codes_fr, codes_pk, str_idx, pre_v,
        act_c, spset[rg], spcount[rg], max_rst, l_min, col_off=base_c,
        row_idx=ridx_c)
    return j_c, str_idx, out


def fast_ladder(ixr, fm_blocks, rank6, hash13, codes_fr, buf_len, pre13_fr,
                q_mem, q_lv, lane_args, *, l_ek: int, a_cap: int,
                pack_cap: int, iv_cap: int | None = None):
    """Run the full fast ladder for every lane; returns
    (packed_anchors, info, pack_overflow) with info (N, 4) int32 =
    [a_base, a_cnt, skip_flag, iv_ovf], as the JAX ``fast_ladder``."""
    (ridx, base, read_len, direction, sid, seed_off, seed_len,
     lane_on) = _unpack_lanes(lane_args)
    N = ridx.shape[0]
    dev = ridx.device
    min_index = MIN_MEM_LEN_FAST - l_ek
    codes_pk = pack2(codes_fr)
    anchors = torch.zeros((N, a_cap, A_NF), dtype=I32, device=dev)
    a_cnt = torch.zeros((N,), dtype=I32, device=dev)
    spset, spcount = dev_fm.spset_init(N, iv_cap, device=dev)
    j = seed_len - 1
    active = lane_on & (j >= min_index)
    skip_flag = torch.zeros((N,), dtype=torch.bool, device=dev)
    while True:
        rg = active.nonzero().squeeze(1)
        if rg.numel() == 0:
            break
        j_c, str_idx, out = _probe(
            ixr, fm_blocks, rank6, hash13, codes_fr, codes_pk, pre13_fr,
            l_ek, rg, j, spset, spcount, ridx, base, seed_off,
            MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1)
        r_len, r_sp, r_sa, r_sa_ok, r_sa_l, r_valid, sps_c, spc_c = out
        has_mem = r_valid.any(dim=1)
        ac_c = a_cnt[rg]
        max_score = torch.zeros_like(j_c)
        occ = torch.arange(1, r_valid.shape[1] + 1, dtype=I32, device=dev)
        kmap = int(torch.where(r_valid, occ[None, :], 0).max())
        ridx_c, base_c = ridx[rg], base[rg]
        for k in range(kmap):
            mk = r_valid[:, k]
            anchors, ac_c, ms = map_seed_lanes(
                ixr, codes_pk, buf_len, q_mem, q_lv, ridx_c, base_c,
                read_len[rg], direction[rg], sid[rg], r_sp[:, k],
                r_len[:, k], r_sa_ok[:, k], r_sa[:, k], r_sa_l[:, k],
                str_idx - r_len[:, k], mk, anchors, ac_c, a_cap=a_cap,
                rows=rg)
            max_score = torch.where(mk, torch.maximum(max_score, ms),
                                    max_score)
        j2 = torch.where(has_mem,
                         j_c - 3 - (max_score > 35).to(I32) * 7, j_c - 2)
        active[rg] = ~(max_score > 256) & (j2 >= min_index)
        skip_flag[rg] = skip_flag[rg] | (max_score > 512)
        j[rg] = j2
        spset[rg] = sps_c
        spcount[rg] = spc_c
        a_cnt[rg] = ac_c
    packed, a_base, p_ovf = pack_anchors(anchors, a_cnt, pack_cap)
    return packed, pack_info(a_base, a_cnt, skip_flag, spcount[:, 2] > 0), \
        p_ovf


def slow_ladder(ixr, fm_blocks, rank6, hash13, codes_fr, buf_len, pre13_fr,
                q_mem, q_lv, lane_args, *, l_ek: int, a_cap: int,
                m_cap: int, pack_cap: int, iv_cap: int | None = None):
    """Slow-mode ladder: collect all MEMs (stride 2), sort by match_len
    desc, map the first 8. Returns (packed_anchors, info, pack_overflow)
    with info = [a_base, a_cnt, mem_overflow, iv_ovf]."""
    (ridx, base, read_len, direction, sid, seed_off, seed_len,
     lane_on) = _unpack_lanes(lane_args)
    N = ridx.shape[0]
    dev = ridx.device
    min_match_len = min(MIN_MEM_LEN_SLOW - 1, l_ek + 1)
    codes_pk = pack2(codes_fr)
    spset, spcount = dev_fm.spset_init(N, iv_cap, device=dev)
    mems = torch.zeros((N, m_cap, M_NF), dtype=I32, device=dev)
    m_cnt = torch.zeros((N,), dtype=I32, device=dev)
    j = seed_len - 1
    active = lane_on & (j >= 1)
    while True:
        rg = active.nonzero().squeeze(1)
        if rg.numel() == 0:
            break
        j_c, str_idx, out = _probe(
            ixr, fm_blocks, rank6, hash13, codes_fr, codes_pk, pre13_fr,
            l_ek, rg, j, spset, spcount, ridx, base, seed_off,
            MEM_SEARCH_SLOW, min_match_len)
        r_len, r_sp, r_sa, r_sa_ok, r_sa_l, r_valid, sps_c, spc_c = out
        mc_c = m_cnt[rg]
        occ = torch.arange(1, r_valid.shape[1] + 1, dtype=I32, device=dev)
        kmax = int(torch.where(r_valid, occ[None, :], 0).max())
        for k in range(kmax):
            tk = r_valid[:, k]
            rec = torch.stack([r_len[:, k], r_sp[:, k], r_sa[:, k],
                               r_sa_ok[:, k].to(I32), r_sa_l[:, k], str_idx],
                              dim=1)
            write = tk & (mc_c < m_cap)
            mems[rg[write], mc_c[write].long()] = rec[write]
            mc_c = torch.where(tk, mc_c + 1, mc_c)
        j2 = j_c - 2
        active[rg] = j2 >= 1
        j[rg] = j2
        spset[rg] = sps_c
        spcount[rg] = spc_c
        m_cnt[rg] = mc_c
    lanes = torch.arange(N, device=dev)
    overflow = m_cnt > m_cap
    stored = m_cnt.clamp(max=m_cap)
    valid = torch.arange(m_cap, dtype=I32, device=dev)[None, :] < stored[:, None]
    key = torch.where(valid, -mems[:, :, 0], 1 << 30)
    order = argsort_stable(key, dim=1)
    anchors = torch.zeros((N, a_cap, A_NF), dtype=I32, device=dev)
    a_cnt = torch.zeros((N,), dtype=I32, device=dev)
    kmap = min(int(torch.where(lane_on, stored, 0).max()) if N else 0,
               MEM_SEARCH_SLOW)
    for k in range(kmap):
        rec = mems[lanes, order[:, k].clamp(max=m_cap - 1).long()]
        ok = lane_on & (k < stored)
        anchors, a_cnt, _ = map_seed_lanes(
            ixr, codes_pk, buf_len, q_mem, q_lv, ridx, base, read_len,
            direction, sid, rec[:, 1], rec[:, 0], rec[:, 3] != 0, rec[:, 2],
            rec[:, 4], rec[:, 5] - rec[:, 0], ok, anchors, a_cnt,
            a_cap=a_cap)
    packed, a_base, p_ovf = pack_anchors(anchors, a_cnt, pack_cap)
    return packed, pack_info(a_base, a_cnt, overflow, spcount[:, 2] > 0), \
        p_ovf
