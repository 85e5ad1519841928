"""Fast / slow classify ladders (src/cly.c:1478-1611).

Counterpart of ``desamba_tpu/engine/device/ladder.py``. ``fast_ladder`` and
``slow_ladder`` are eager torch loops over the ``cond``/``body`` of the JAX
``while_loop``: each syncs with the host once per trip (``active.any()``)
and runs until the same live condition fails, never a fixed worst-case
trip count.

The JAX ladder compacts at most ``bl`` active lanes per trip (a TPU cost
knob); every lane's trajectory is independent of the trip it runs in, so
the port takes ALL active lanes each trip (``bl`` = the live count). The
results are the same lane for lane; only the trip count differs.

Each ladder is also a hand-written CUDA kernel in ``kernels/ladder.cu``
(one warp runs one lane's whole ladder): ``run_fast_ladder`` and
``run_slow_ladder`` launch them for CUDA tensors (``fast_ladder_cuda``,
``slow_ladder_cuda``) and run the eager ``fast_ladder`` and
``slow_ladder``, their plain versions, only for CPU tensors.
"""
from __future__ import annotations

import ctypes

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
from .textwalk import IV_CAP, pack2

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
    fast_ladder.runs += 1
    fast_ladder.trips = 0
    while True:
        rg = active.nonzero().squeeze(1)
        if rg.numel() == 0:
            break
        fast_ladder.trips += 1
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


# calls of the plain version, and the trips of its last call (the longest
# lane's ladder trips)
fast_ladder.runs = 0
fast_ladder.trips = 0

# LadderArgs of kernels/ladder.cuh, field for field: pointers, then ints
_ARG_PTRS = (
    "fm_blocks", "rank6", "hash13", "row_pos", "isa", "text_pk", "sep_any",
    "sep_hash", "samp_bits", "uni_start", "uni_len", "uni_ref_list",
    "rp_global_off", "rp_ref_id", "ref_off", "ref_pk", "pos2uni", "q_mem",
    "q_lv", "codes", "codes_pk", "buf_len", "pre13", "lane_args", "anchors",
    "a_cnt", "flag", "iv_ovf", "trips", "iv")
_ARG_INTS = (
    "n_blocks", "n_hash13", "n_row_pos", "n_text", "n_text_pk", "n_sep_any",
    "n_sep_hash", "n_samp", "n_uni_tab", "n_rp", "n_ref", "n_ref_pk",
    "n_q_mem", "q_lv_rows", "q_lv_cols", "text_len", "n_uni", "n_bases",
    "codes_w", "codes_pk_w", "pre13_w", "nb", "l_ek", "a_cap", "iv_cap",
    "m_cap")


class LadderArgs(ctypes.Structure):
    """The kernel's argument block: ~30 device pointers (``c_void_p``, never
    a default ctypes int, which would cut them to 32 bits) and the sizes."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _ARG_PTRS]
                + [(n, ctypes.c_int) for n in _ARG_INTS])


def ladder_launch_args(ixr, fm_blocks, rank6, hash13, codes_fr, buf_len,
                       pre13_fr, q_mem, q_lv, lane_args, *, l_ek: int,
                       a_cap: int, iv_cap: int | None = None,
                       m_cap: int = 0):
    """The kernels' LadderArgs over the inputs, on their device, with the
    outputs and scratch allocated: (args, tensors). ``tensors`` holds every
    tensor the pointers name (keep it alive until the kernel has run).
    ``m_cap`` is the slow ladder's (the fast kernel does not read it).
    Raises ValueError on an input the kernels do not take."""
    cap = IV_CAP if iv_cap is None else iv_cap
    NB = lane_args.shape[1]
    dev = lane_args.device
    t = dict(
        fm_blocks=fm_blocks, rank6=rank6, hash13=hash13,
        row_pos=ixr.row_pos, isa=ixr.isa, text_pk=ixr.text_pk,
        sep_any=ixr.sep_any, sep_hash=ixr.sep_hash, samp_bits=ixr.samp_bits,
        uni_start=ixr.uni_start, uni_len=ixr.uni_len,
        uni_ref_list=ixr.uni_ref_list, rp_global_off=ixr.rp_global_off,
        rp_ref_id=ixr.rp_ref_id, ref_off=ixr.ref_off, ref_pk=ixr.ref_pk,
        pos2uni=ixr.pos2uni, q_mem=q_mem, q_lv=q_lv, codes=codes_fr,
        codes_pk=pack2(codes_fr).contiguous(), buf_len=buf_len,
        pre13=pre13_fr, lane_args=lane_args,
        anchors=torch.zeros((NB, a_cap, A_NF), dtype=I32, device=dev),
        a_cnt=torch.empty((NB,), dtype=I32, device=dev),
        flag=torch.empty((NB,), dtype=I32, device=dev),
        iv_ovf=torch.empty((NB,), dtype=I32, device=dev),
        trips=torch.empty((NB,), dtype=I32, device=dev),
        iv=torch.empty((NB, cap, 2), dtype=I32, device=dev))
    for name, x in t.items():
        want = torch.uint8 if name == "codes" else I32
        if x.device != dev or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"ladder kernel: {name} must be a contiguous "
                             f"{want} tensor on {dev}")
    if lane_args.dim() != 2 or lane_args.shape[0] != 8:
        raise ValueError("ladder kernel: lane_args must be (8, NB)")
    if (codes_fr.dim() != 2 or pre13_fr.shape[0] != codes_fr.shape[0]
            or buf_len.shape != codes_fr.shape[:1] or fm_blocks.shape[1] != 9
            or q_lv.dim() != 2 or cap < 1 or a_cap < 1 or m_cap < 0):
        raise ValueError("ladder kernel: inconsistent batch or table shapes")
    sizes = dict(
        n_blocks=fm_blocks.shape[0], n_hash13=hash13.shape[0],
        n_row_pos=ixr.row_pos.shape[0], n_text=ixr.isa.shape[0],
        n_text_pk=ixr.text_pk.shape[-1], n_sep_any=ixr.sep_any.shape[0],
        n_sep_hash=ixr.sep_hash.shape[0], n_samp=ixr.samp_bits.shape[0],
        n_uni_tab=ixr.uni_len.shape[0], n_rp=ixr.rp_global_off.shape[0],
        n_ref=ixr.ref_off.shape[0], n_ref_pk=ixr.ref_pk.shape[-1],
        n_q_mem=q_mem.shape[0], q_lv_rows=q_lv.shape[0],
        q_lv_cols=q_lv.shape[1], text_len=ixr.text_len, n_uni=ixr.n_uni,
        n_bases=ixr.n_bases, codes_w=codes_fr.shape[1],
        codes_pk_w=t["codes_pk"].shape[1], pre13_w=pre13_fr.shape[1], nb=NB,
        l_ek=l_ek, a_cap=a_cap, iv_cap=cap, m_cap=m_cap)
    args = LadderArgs(**{n: t[n].data_ptr() for n in _ARG_PTRS},
                      **{n: int(sizes[n]) for n in _ARG_INTS})
    return args, t


def ladder_outputs(t, pack_cap: int):
    """(packed, info, pack_overflow) from a launch's output tensors, as the
    plain version returns them."""
    packed, a_base, p_ovf = pack_anchors(t["anchors"], t["a_cnt"], pack_cap)
    return packed, pack_info(a_base, t["a_cnt"], t["flag"],
                             t["iv_ovf"]), p_ovf


def _launch(entry, args, kw, pack_cap, wrapper):
    """Launch ladder kernel ``entry`` of ``ladder_lib()`` on CUDA tensors
    of one card (``ladder_launch_args`` refuses any on another) and count it
    in ``wrapper.launches``; returns (what the plain version returns, the
    lanes' trips). A refused launch raises."""
    from ...kernels.build import LAUNCH_LOCK, ladder_lib

    lane_args = args[9]
    if lane_args.device.type != "cuda":
        raise ValueError(f"{entry}: the tensors must be on a CUDA device")
    largs, t = ladder_launch_args(*args, **kw)
    lib = ladder_lib()
    if lib.ladder_args_size() != ctypes.sizeof(LadderArgs):
        raise RuntimeError("ladder kernel: LadderArgs differs from the "
                           "kernel's struct")
    with LAUNCH_LOCK:
        rc = getattr(lib, entry)(
            ctypes.addressof(largs), lane_args.device.index,
            torch.cuda.current_stream(lane_args.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {rc}")
        wrapper.launches += 1
    return ladder_outputs(t, pack_cap), t["trips"]


def fast_ladder_cuda(*args, l_ek: int, a_cap: int, pack_cap: int,
                     iv_cap: int | None = None):
    """Launch the fast-ladder kernel on CUDA tensors (``fast_ladder``'s
    arguments); returns what ``fast_ladder`` returns. The lanes' trips stay
    in ``fast_ladder_cuda.trips`` (NB,). A refused launch raises."""
    out, fast_ladder_cuda.trips = _launch(
        "ladder_fast_launch", args, dict(l_ek=l_ek, a_cap=a_cap,
                                         iv_cap=iv_cap), pack_cap,
        fast_ladder_cuda)
    return out


fast_ladder_cuda.launches = 0
fast_ladder_cuda.trips = None


def _run(kernel, plain, args, kw):
    """A ladder on its inputs' device: the kernel for CUDA tensors, the
    eager plain version for CPU tensors. There is no other path: a failed
    build or launch raises."""
    dev = args[9].device            # lane_args
    if dev.type == "cuda":
        return kernel(*args, **kw)
    if dev.type == "cpu":
        return plain(*args, **kw)
    raise ValueError(f"unsupported device {dev}")


def run_fast_ladder(*args, **kw):
    return _run(fast_ladder_cuda, fast_ladder, args, kw)


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
    slow_ladder.runs += 1
    slow_ladder.trips = 0
    while True:
        rg = active.nonzero().squeeze(1)
        if rg.numel() == 0:
            break
        slow_ladder.trips += 1
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


# calls of the plain version, and the trips of its last call
slow_ladder.runs = 0
slow_ladder.trips = 0


def slow_ladder_cuda(*args, l_ek: int, a_cap: int, m_cap: int,
                     pack_cap: int, iv_cap: int | None = None):
    """Launch the slow-ladder kernel on CUDA tensors (``slow_ladder``'s
    arguments); returns what ``slow_ladder`` returns. The lanes' trips stay
    in ``slow_ladder_cuda.trips`` (NB,). A refused launch raises."""
    out, slow_ladder_cuda.trips = _launch(
        "ladder_slow_launch", args, dict(l_ek=l_ek, a_cap=a_cap,
                                         iv_cap=iv_cap, m_cap=m_cap),
        pack_cap, slow_ladder_cuda)
    return out


slow_ladder_cuda.launches = 0
slow_ladder_cuda.trips = None


def run_slow_ladder(*args, **kw):
    return _run(slow_ladder_cuda, slow_ladder, args, kw)
