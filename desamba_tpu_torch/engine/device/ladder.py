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
``slow_ladder``, their plain versions, only for CPU tensors. Where the
gather tables are cut by row range over a mesh's ``idx`` axis
(``parallel/sharded.py``), they launch the kernels' sharded instantiations
(``fast_ladder_sharded_cuda``, ``slow_ladder_sharded_cuda``), and the
eager ladders run on the sharded tables as they are.

The two ends of each call that the JAX programs run inside their jit are
kernels too (``kernels/ladder_pack.cu``): the read codes' ``pack2``
before the launch (``pack2_cuda``) and the flat anchor pack with its info
rows after it (``anchor_pack_cuda``), so a call on the card issues three
launches and no host sync, and returns its pack overflow as a 0-dim tensor
on the card; ``textwalk.pack2``, ``pack_anchors`` and ``pack_info`` are
their plain versions, run for CPU tensors (where the overflow is a bool).
"""
from __future__ import annotations

import ctypes

import torch

from ...kernels.build import ShardTab

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


def pack2_cuda(codes):
    """``textwalk.pack2`` of a contiguous (N, L) uint8 CUDA tensor by the
    pack2 kernel of ``kernels/ladder_pack.cu``: (N, ceil(L / 16)) int32.
    Counted in ``pack2_cuda.launches``; a refused launch raises."""
    from ...kernels.build import LAUNCH_LOCK, ladder_pack_lib

    if (codes.device.type != "cuda" or codes.dtype != torch.uint8
            or codes.dim() != 2 or not codes.is_contiguous()):
        raise ValueError("pack2 kernel: codes must be a contiguous 2-D "
                         "uint8 tensor on a CUDA device")
    N, L = codes.shape
    out = torch.empty((N, (L + 15) // 16), dtype=I32, device=codes.device)
    lib = ladder_pack_lib()
    with LAUNCH_LOCK:
        rc = lib.ladder_pack2_launch(
            codes.data_ptr(), out.data_ptr(), N, L, out.shape[1],
            codes.device.index,
            torch.cuda.current_stream(codes.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ladder_pack2_launch failed: CUDA error {rc}")
        pack2_cuda.launches += 1
    return out


pack2_cuda.launches = 0


def anchor_pack_cuda(anchors, a_cnt, flag, iv_ovf, pack_cap: int):
    """``pack_anchors`` and ``pack_info`` of a ladder launch's outputs
    (contiguous int32 CUDA tensors of one card: anchors (NB, a_cap, 12),
    a_cnt, flag and iv_ovf (NB,), anchors and a_cnt 16-byte aligned as
    allocations are) by
    the anchor-pack kernel of ``kernels/ladder_pack.cu``: (packed, info,
    pack overflow), the overflow a 0-dim bool tensor on the card, so
    nothing waits for the card. Only rows below a lane's count are read.
    Counted in ``anchor_pack_cuda.launches``; a refused launch raises."""
    from ...kernels.build import LAUNCH_LOCK, ladder_pack_lib

    dev = anchors.device
    NB = a_cnt.shape[0]
    for name, x in (("anchors", anchors), ("a_cnt", a_cnt), ("flag", flag),
                    ("iv_ovf", iv_ovf)):
        if (x.device != dev or dev.type != "cuda" or x.dtype != I32
                or not x.is_contiguous()):
            raise ValueError(f"anchor pack kernel: {name} must be a "
                             f"contiguous int32 tensor on {dev}, a CUDA "
                             f"device")
    if (anchors.dim() != 3 or anchors.shape[0] != NB
            or anchors.shape[2] != A_NF or anchors.shape[1] < 1
            or flag.shape != (NB,) or iv_ovf.shape != (NB,)
            or pack_cap < 0):
        raise ValueError("anchor pack kernel: inconsistent shapes")
    if anchors.data_ptr() % 16 or a_cnt.data_ptr() % 16:
        raise ValueError("anchor pack kernel: anchors and a_cnt must be "
                         "16-byte aligned")
    packed = torch.empty((pack_cap, A_NF + 1), dtype=I32, device=dev)
    info = torch.empty((NB, 4), dtype=I32, device=dev)
    ovf = torch.empty((), dtype=torch.bool, device=dev)
    lib = ladder_pack_lib()
    with LAUNCH_LOCK:
        rc = lib.ladder_anchor_pack_launch(
            anchors.data_ptr(), a_cnt.data_ptr(), flag.data_ptr(),
            iv_ovf.data_ptr(), packed.data_ptr(), info.data_ptr(),
            ovf.data_ptr(), NB, anchors.shape[1], pack_cap, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ladder_anchor_pack_launch failed: CUDA "
                               f"error {rc}")
        anchor_pack_cuda.launches += 1
    return packed, info, ovf


anchor_pack_cuda.launches = 0


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


# the gather tables: ShardTab accessors in ShardedLadderArgs (the JAX
# package's sharded tables that the ladders read)
_ARG_TABLES = (
    "fm_blocks", "hash13", "row_pos", "isa", "text_pk", "sep_any",
    "sep_hash", "samp_bits", "uni_start", "uni_len", "uni_ref_list",
    "rp_global_off", "rp_ref_id", "ref_pk", "pos2uni")


# the tensors ladder_launch_args makes itself (the packed codes, the
# outputs and scratch): right by construction, so not checked on each call
_ARG_MADE = frozenset(("codes_pk", "anchors", "a_cnt", "flag", "iv_ovf",
                       "trips", "iv"))


class LadderArgs(ctypes.Structure):
    """The kernel's argument block: ~30 device pointers (``c_void_p``, never
    a default ctypes int, which would cut them to 32 bits) and the sizes."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _ARG_PTRS]
                + [(n, ctypes.c_int) for n in _ARG_INTS])


class ShardedLadderArgs(ctypes.Structure):
    """The sharded kernels' argument block: LadderArgs with a ShardTab (its
    shard pointers by value, the shard length and count) for each table of
    ``_ARG_TABLES``."""
    _fields_ = ([(n, ShardTab if n in _ARG_TABLES else ctypes.c_void_p)
                 for n in _ARG_PTRS]
                + [(n, ctypes.c_int) for n in _ARG_INTS])


def _sharded_tables(t) -> bool:
    """Whether the gather tables of ``t`` (name -> table) are cut into
    shards; a mix of the two layouts raises."""
    whole = [torch.is_tensor(t[n]) for n in _ARG_TABLES]
    if any(whole) and not all(whole):
        raise ValueError("ladder kernel: the gather tables must be all whole "
                         "or all sharded")
    return not whole[0]


def ladder_launch_args(ixr, fm_blocks, rank6, hash13, codes_fr, buf_len,
                       pre13_fr, q_mem, q_lv, lane_args, *, l_ek: int,
                       a_cap: int, iv_cap: int | None = None,
                       m_cap: int = 0):
    """The kernels' LadderArgs over the inputs, on their device, with the
    outputs and scratch allocated: (args, tensors). ``tensors`` holds every
    tensor the pointers name (keep it alive until the kernel has run). The
    packed codes come from ``pack2_cuda`` on a card (``pack2`` on the
    CPU); the anchor rows are left as allocated, since the kernels write
    every row below a lane's count and nothing reads the others.
    ``m_cap`` is the slow ladder's (the fast kernel does not read it).
    Gather tables cut into shards (``parallel.sharded``) give a
    ShardedLadderArgs: their shards lie on the devices of the mesh's idx
    axis, the rest on the lanes' device. Raises ValueError on an input the
    kernels do not take."""
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
        codes_pk=(pack2_cuda(codes_fr) if codes_fr.device.type == "cuda"
                  else pack2(codes_fr).contiguous()),
        buf_len=buf_len, pre13=pre13_fr, lane_args=lane_args,
        anchors=torch.empty((NB, a_cap, A_NF), dtype=I32, device=dev),
        a_cnt=torch.empty((NB,), dtype=I32, device=dev),
        flag=torch.empty((NB,), dtype=I32, device=dev),
        iv_ovf=torch.empty((NB,), dtype=I32, device=dev),
        trips=torch.empty((NB,), dtype=I32, device=dev),
        iv=torch.empty((NB, cap, 2), dtype=I32, device=dev))
    sharded = _sharded_tables(t)
    for name, x in t.items():
        if name in _ARG_MADE:
            continue
        want = torch.uint8 if name == "codes" else I32
        for y in (x.shards if sharded and name in _ARG_TABLES else [x]):
            on = y.device.type == dev.type if y is not x else y.device == dev
            if not on or y.dtype != want or not y.is_contiguous():
                raise ValueError(f"ladder kernel: {name} must be a "
                                 f"contiguous {want} tensor on {dev}")
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
    if sharded:
        from ...parallel.sharded import shard_tab

        args = ShardedLadderArgs(
            **{n: shard_tab(t[n]) if n in _ARG_TABLES else t[n].data_ptr()
               for n in _ARG_PTRS},
            **{n: int(sizes[n]) for n in _ARG_INTS})
    else:
        args = LadderArgs(**{n: t[n].data_ptr() for n in _ARG_PTRS},
                          **{n: int(sizes[n]) for n in _ARG_INTS})
    return args, t


def ladder_outputs(t, pack_cap: int):
    """(packed, info, pack_overflow) from a launch's output tensors: the
    anchor-pack kernel on a card (the overflow a 0-dim tensor there), the
    plain ``pack_anchors`` and ``pack_info`` on the CPU (a bool)."""
    if t["anchors"].device.type == "cuda":
        return anchor_pack_cuda(t["anchors"], t["a_cnt"], t["flag"],
                                t["iv_ovf"], pack_cap)
    packed, a_base, p_ovf = pack_anchors(t["anchors"], t["a_cnt"], pack_cap)
    return packed, pack_info(a_base, t["a_cnt"], t["flag"],
                             t["iv_ovf"]), p_ovf


def _launch(entry, args, kw, pack_cap, wrapper):
    """Launch ladder kernel ``entry`` of ``ladder_lib()`` on CUDA tensors
    of one card (``ladder_launch_args`` refuses any on another; a sharded
    entry reads the shards on their cards, by peer access) and count it in
    ``wrapper.launches``; returns (what the plain version returns, the
    lanes' trips). The read codes are packed before and the anchor rows
    after by the kernels of ``ladder_pack.cu``, on the same stream: nothing
    from the call to the return waits for the card, and the pack overflow
    is a 0-dim tensor on it. A refused launch raises."""
    from ...kernels.build import LAUNCH_LOCK, enable_peers, ladder_lib

    lane_args = args[9]
    if lane_args.device.type != "cuda":
        raise ValueError(f"{entry}: the tensors must be on a CUDA device")
    largs, t = ladder_launch_args(*args, **kw)
    lib = ladder_lib()
    sharded = isinstance(largs, ShardedLadderArgs)
    if sharded != ("sharded" in entry):
        raise ValueError(f"{entry}: the gather tables are "
                         f"{'sharded' if sharded else 'whole'}")
    size = (lib.ladder_sharded_args_size() if sharded
            else lib.ladder_args_size())
    if size != ctypes.sizeof(largs):
        raise RuntimeError(f"ladder kernel: {type(largs).__name__} differs "
                           f"from the kernel's struct")
    if sharded:
        enable_peers(lib, "ladder_enable_peer", lane_args.device,
                     {s.device for n in _ARG_TABLES for s in t[n].shards})
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
    arguments); returns what ``fast_ladder`` returns, the pack overflow as
    a 0-dim bool tensor on the card. The lanes' trips stay in
    ``fast_ladder_cuda.trips`` (NB,). A refused launch raises."""
    out, fast_ladder_cuda.trips = _launch(
        "ladder_fast_launch", args, dict(l_ek=l_ek, a_cap=a_cap,
                                         iv_cap=iv_cap), pack_cap,
        fast_ladder_cuda)
    return out


fast_ladder_cuda.launches = 0
fast_ladder_cuda.trips = None


def fast_ladder_sharded_cuda(*args, l_ek: int, a_cap: int, pack_cap: int,
                             iv_cap: int | None = None):
    """``fast_ladder_cuda`` over gather tables cut into shards: the kernel's
    sharded instantiation. The lanes' trips stay in
    ``fast_ladder_sharded_cuda.trips``."""
    out, fast_ladder_sharded_cuda.trips = _launch(
        "ladder_fast_sharded_launch", args, dict(l_ek=l_ek, a_cap=a_cap,
                                                 iv_cap=iv_cap), pack_cap,
        fast_ladder_sharded_cuda)
    return out


fast_ladder_sharded_cuda.launches = 0
fast_ladder_sharded_cuda.trips = None


def _run(kernels, plain, args, kw):
    """A ladder on its inputs' device: for CUDA tensors the kernel of
    ``kernels`` (whole, sharded) for the gather tables' layout, for CPU
    tensors the eager plain version. There is no other path: a failed build
    or launch raises."""
    dev = args[9].device            # lane_args
    if dev.type == "cuda":
        return kernels[not torch.is_tensor(args[1])](*args, **kw)
    if dev.type == "cpu":
        return plain(*args, **kw)
    raise ValueError(f"unsupported device {dev}")


def run_fast_ladder(*args, **kw):
    return _run((fast_ladder_cuda, fast_ladder_sharded_cuda), fast_ladder,
                args, kw)


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
    arguments); returns what ``slow_ladder`` returns, the pack overflow as
    a 0-dim bool tensor on the card. The lanes' trips stay in
    ``slow_ladder_cuda.trips`` (NB,). A refused launch raises."""
    out, slow_ladder_cuda.trips = _launch(
        "ladder_slow_launch", args, dict(l_ek=l_ek, a_cap=a_cap,
                                         iv_cap=iv_cap, m_cap=m_cap),
        pack_cap, slow_ladder_cuda)
    return out


slow_ladder_cuda.launches = 0
slow_ladder_cuda.trips = None


def slow_ladder_sharded_cuda(*args, l_ek: int, a_cap: int, m_cap: int,
                             pack_cap: int, iv_cap: int | None = None):
    """``slow_ladder_cuda`` over gather tables cut into shards: the kernel's
    sharded instantiation. The lanes' trips stay in
    ``slow_ladder_sharded_cuda.trips``."""
    out, slow_ladder_sharded_cuda.trips = _launch(
        "ladder_slow_sharded_launch", args, dict(l_ek=l_ek, a_cap=a_cap,
                                                 iv_cap=iv_cap, m_cap=m_cap),
        pack_cap, slow_ladder_sharded_cuda)
    return out


slow_ladder_sharded_cuda.launches = 0
slow_ladder_sharded_cuda.trips = None


def run_slow_ladder(*args, **kw):
    return _run((slow_ladder_cuda, slow_ladder_sharded_cuda), slow_ladder,
                args, kw)
