"""Anchor chaining on device: M2 insertion + resolve-tree sort, the M3
sort + sparse DP, and the rescore prep.

Counterpart of ``desamba_tpu/engine/device/chain.py``. The unsigned
compares go through ``_absu`` and ``intops.u32`` at exactly the points the
JAX code casts to ``U32``; every other compare is a signed int32 one.

M2 and M3 are also hand-written CUDA kernels in ``kernels/chain.cu`` (M2 a
warp per read; M3 a block of ``m3_warps`` warps per read): ``run_chain_kernel`` and ``run_m3_kernel`` launch them for
CUDA tensors (``chain_kernel_cuda``, ``m3_kernel_cuda``) and run the eager
``chain_kernel`` and ``m3_kernel``, their plain versions, only for CPU
tensors.
"""
from __future__ import annotations

import torch

from ...constants import (
    M3_ANCHOR_THRESHOLD,
    MAX_ANCHOR_OVERLAP,
    MAX_DIS_MINUS,
    MAX_WAITING_LEN,
)

from .intops import I32, argsort_stable, i32, u32

C2 = 16   # chain slots during insertion (overflow -> host)

# anchor input record
AF2 = 7
(A_IIR, A_ROFF, A_MLEN, A_SCORE, A_REF, A_DIR, A_USELESS) = range(AF2)

# chain record
CH = ("ref_id", "q_t_dis", "sum_score", "anchor_number", "direction",
      "with_top", "t_st", "t_ed", "q_st", "q_ed", "indel", "cur", "cid")
CH_NF = len(CH)
(H_REF, H_QTD, H_SUM, H_ANUM, H_DIR, H_TOP, H_TST, H_TED, H_QST, H_QED,
 H_INDEL, H_CUR, H_CID) = range(CH_NF)

# packed ladder anchor row columns (ladder.pack_anchors)
(P_MLEN, P_SCORE, P_DIR, P_GOFF, P_REF, P_ROFF, P_IIR,
 P_USELESS) = 0, 1, 6, 7, 8, 9, 10, 12

RC_CAP = 8      # rescore chain slots (rescore.C_CAP)
M3_A2 = 512     # anchor slots for the M3 sub-batch
M3_MAX_A2 = 1024    # the most the M3 kernel takes


def _absu(a, b):
    """ABS_U on uint32 values carried as int32 bit patterns (src/cly.c
    ABS_U): unsigned compare + unsigned diff, wrapped back to int32."""
    au, bu = u32(a), u32(b)
    return i32(torch.where(au > bu, au - bu, bu - au))


def _resolve_sort(ch, on, n):
    """resolve_tree sort (score, then with_top first) + truncation to the
    top 5 plus the run of with_top chains right after them."""
    score2 = (ch[:, :, H_SUM] + ((ch[:, :, H_QED] - ch[:, :, H_QST]) << 1)
              - (ch[:, :, H_INDEL] << 2))
    k2 = torch.where(on, -score2, 1 << 30)
    ord1 = argsort_stable(k2, dim=1).long()
    top1 = torch.gather(ch[:, :, H_TOP], 1, ord1)
    on1 = torch.gather(on.to(I32), 1, ord1)
    k1 = torch.where(on1 > 0, 1 - top1, 2)
    ord2 = argsort_stable(k1, dim=1).long()
    order = torch.gather(ord1, 1, ord2)
    chs = torch.gather(ch, 1, order[:, :, None].expand(-1, -1, ch.shape[2]))
    W = ch.shape[1]
    slots = torch.arange(W, dtype=I32, device=ch.device)[None, :]
    grow = (chs[:, 5:, H_TOP] > 0) & (slots[:, 5:] < n[:, None])
    run = torch.cumprod(grow.to(I32), dim=1).sum(dim=1, dtype=I32)
    rst = torch.where(n >= 5, 5 + run, n)
    return chs, torch.minimum(rst, n)


def chain_kernel(anc, n_anc):
    """anc: (B, A2, AF2) int32 in gold insertion order; n_anc: (B,).
    Returns (chains, n_out, pre, overflow) as the JAX ``chain_kernel``."""
    chain_kernel.runs += 1
    B, A2, _ = anc.shape
    dev = anc.device
    lanes = torch.arange(B, device=dev)
    slots = torch.arange(C2, dtype=I32, device=dev)[None, :]
    ch = torch.zeros((B, C2, CH_NF), dtype=I32, device=dev)
    pre = torch.full((B, A2), -1, dtype=I32, device=dev)
    nch = torch.zeros((B,), dtype=I32, device=dev)
    ovf = n_anc >= M3_ANCHOR_THRESHOLD
    amax = int(n_anc.clamp(max=A2).max()) if B else 0
    for a in range(amax):
        row = anc[:, a]
        valid = a < n_anc
        iir, roff, mlen = row[:, A_IIR], row[:, A_ROFF], row[:, A_MLEN]
        score = row[:, A_SCORE]
        dis = roff - iir
        read_r = iir + mlen
        ref_r = roff + mlen
        not_useless = (row[:, A_USELESS] == 0).to(I32)
        m = ((slots < nch[:, None])
             & (ch[:, :, H_DIR] == row[:, A_DIR, None])
             & (ch[:, :, H_REF] == row[:, A_REF, None])
             & ((dis[:, None] - ch[:, :, H_QTD]).abs() < MAX_DIS_MINUS)
             & (_absu(ch[:, :, H_TED], roff[:, None]) < MAX_WAITING_LEN))
        has = m.any(dim=1)
        first = m.to(I32).argmax(dim=1).to(I32)
        do_new = valid & ~has & (nch < C2)
        ovf = ovf | (valid & ~has & (nch >= C2))
        tgt = torch.where(has, first, nch).clamp(0, C2 - 1).long()
        old = ch[lanes, tgt]
        dis_minus = (dis - old[:, H_QTD]).abs()
        skip_upd = has & (old[:, H_QED] >= read_r)
        ins = valid & has & ~skip_upd
        topset = valid & has
        new_rec = torch.stack([
            row[:, A_REF], dis, score, torch.ones_like(dis), row[:, A_DIR],
            not_useless, roff, ref_r, iir, read_r, torch.zeros_like(dis),
            torch.full_like(dis, a), nch], dim=1)
        upd_rec = torch.stack([
            old[:, H_REF], dis, old[:, H_SUM] + score, old[:, H_ANUM] + 1,
            old[:, H_DIR], old[:, H_TOP] | not_useless, old[:, H_TST],
            i32(torch.maximum(u32(ref_r), u32(old[:, H_TED]))),
            old[:, H_QST], read_r, old[:, H_INDEL] + dis_minus,
            torch.full_like(dis, a), old[:, H_CID]], dim=1)
        skip_rec = old.clone()
        skip_rec[:, H_TOP] = old[:, H_TOP] | not_useless
        rec = torch.where(do_new[:, None], new_rec,
                          torch.where(ins[:, None], upd_rec,
                                      torch.where((topset & skip_upd)[:, None],
                                                  skip_rec, old)))
        write = do_new | topset
        ch[lanes, tgt] = torch.where(write[:, None], rec, old)
        pre[:, a] = torch.where(ins, old[:, H_CUR], pre[:, a])
        nch = torch.where(do_new, nch + 1, nch)
    n = nch.clamp(max=C2)
    chs, n_out = _resolve_sort(ch, slots < n[:, None], n)
    return chs, n_out, pre, ovf


chain_kernel.runs = 0   # calls of the plain version


def _launch(entry, wrapper, anc, n_anc, *extra):
    """Launch ``entry`` of ``chain_lib()`` on CUDA tensors and count it in
    ``wrapper.launches``: (chains, n_out, pre, ovf) as the plain versions
    return them. A refused launch raises."""
    from ...kernels.build import LAUNCH_LOCK, chain_lib

    if anc.device.type != "cuda" or n_anc.device != anc.device:
        raise ValueError(f"{entry}: the tensors must be on one CUDA device")
    if (anc.dim() != 3 or anc.shape[2] != AF2 or n_anc.shape != anc.shape[:1]
            or anc.dtype != I32 or n_anc.dtype != I32
            or not anc.is_contiguous() or not n_anc.is_contiguous()):
        raise ValueError(f"{entry}: anc must be a contiguous (B, A2, {AF2}) "
                         f"int32 tensor and n_anc a contiguous (B,) one")
    B, A2, _ = anc.shape
    dev = anc.device
    chains = torch.empty((B, C2, CH_NF), dtype=I32, device=dev)
    n_out = torch.empty((B,), dtype=I32, device=dev)
    pre = torch.empty((B, A2), dtype=I32, device=dev)
    ovf = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = chain_lib()
    with LAUNCH_LOCK:
        rc = getattr(lib, entry)(
            anc.data_ptr(), n_anc.data_ptr(), chains.data_ptr(),
            n_out.data_ptr(), pre.data_ptr(), ovf.data_ptr(), B, A2, *extra,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {rc}")
        wrapper.launches += 1
    return chains, n_out, pre, ovf


def chain_kernel_cuda(anc, n_anc):
    """Launch the M2 kernel (a warp per read) on CUDA tensors;
    returns what ``chain_kernel`` returns."""
    return _launch("chain_m2_launch", chain_kernel_cuda, anc, n_anc)


chain_kernel_cuda.launches = 0


def _run(kernel, plain, anc, n_anc):
    """A chaining function on its inputs' device: the kernel for CUDA
    tensors, the eager plain version for CPU tensors. There is no other
    path: a failed build or launch raises."""
    if anc.device.type == "cuda":
        return kernel(anc, n_anc)
    if anc.device.type == "cpu":
        return plain(anc, n_anc)
    raise ValueError(f"unsupported device {anc.device}")


def run_chain_kernel(anc, n_anc):
    return _run(chain_kernel_cuda, chain_kernel, anc, n_anc)


def _chain_info(chains, n_out, ovf):
    return torch.stack([n_out, chains[:, 0, H_ANUM], chains[:, 0, H_SUM],
                        ovf.to(I32)], dim=1)


def _gather_anchors(packed, gidx):
    """Per-read anchor rows (B, A2, AF2) from the flat ladder pack."""
    P = packed.shape[0]
    ext = torch.cat([packed, torch.zeros((1, packed.shape[1]), dtype=I32,
                                         device=packed.device)], dim=0)
    gi = torch.where(gidx >= 0, gidx, P).clamp(0, P).long()
    rows = ext[gi]
    return torch.stack([rows[:, :, P_IIR], rows[:, :, P_ROFF],
                        rows[:, :, P_MLEN], rows[:, :, P_SCORE],
                        rows[:, :, P_REF], rows[:, :, P_DIR],
                        rows[:, :, P_USELESS]], dim=2)


def chain_step(packed, gidx, n_anc):
    """Assemble per-read anchors from the ladder pack and chain them.
    Returns (chains, n_out, pre, ovf, anc3, info) as the JAX function."""
    anc = _gather_anchors(packed, gidx)
    chains, n_out, pre, ovf = run_chain_kernel(anc, n_anc)
    return chains, n_out, pre, ovf, anc[:, :, :3], \
        _chain_info(chains, n_out, ovf)


def prep_rescore(sel, chs, ns, pres, ancs):
    """Select each read's chain set (fast=0 / slow0=1 / slow1=2) and emit
    the rescore inputs: (chains_rc, n_chains, anchors4, schash, n_hash,
    over)."""
    B = sel.shape[0]
    dev = sel.device
    b = torch.arange(B, device=dev)
    s = sel.long()
    ch, n, pre, anc = chs[s, b], ns[s, b], pres[s, b], ancs[s, b]
    over = n > RC_CAP
    n = torch.where(over, 0, n.clamp(max=RC_CAP))
    slots = torch.arange(RC_CAP, dtype=I32, device=dev)[None, :]
    on = (slots < n[:, None]).to(I32)[:, :, None]
    c8 = ch[:, :RC_CAP]
    chains_rc = torch.stack(
        [c8[:, :, H_REF], c8[:, :, H_DIR], c8[:, :, H_SUM],
         c8[:, :, H_ANUM], c8[:, :, H_TST], c8[:, :, H_TED],
         c8[:, :, H_QST], c8[:, :, H_QED], c8[:, :, H_INDEL],
         c8[:, :, H_CUR]], dim=2) * on
    key_st = (c8[:, :, H_TST] - c8[:, :, H_QST]) & 0xFF
    key_ed = (c8[:, :, H_TED] - c8[:, :, H_QED]) & 0xFF
    ci = slots.expand(B, RC_CAP)
    ent_st = torch.stack([key_st, ci, torch.ones_like(ci)], dim=2)
    ent_ed = torch.stack([key_ed, ci, torch.zeros_like(ci)], dim=2)
    schash = torch.stack([ent_st, ent_ed], dim=2).reshape(B, 2 * RC_CAP, 3)
    anchors4 = torch.cat([anc, pre[:, :, None]], dim=2)
    return chains_rc, n, anchors4, schash, 2 * n, over


def m3_kernel(anc, n_anc):
    """Sort + sparse-DP chaining for >=50-anchor reads (gold
    chain_insert_m3). Returns (chains, n_out, pre, ovf) with ``pre`` in
    ORIGINAL anchor-slot space, as the JAX ``m3_kernel``."""
    m3_kernel.runs += 1
    B, A2, _ = anc.shape
    dev = anc.device
    lanes = torch.arange(B, device=dev)
    slot = torch.arange(A2, dtype=I32, device=dev)[None, :]
    valid = slot < n_anc[:, None]

    # lexicographic stable sort by (valid-first, ref, dir, roff-as-u32)
    ord_a = argsort_stable(u32(anc[:, :, A_ROFF]), dim=1).long()
    k_major = torch.where(valid, anc[:, :, A_REF] * 2 + anc[:, :, A_DIR],
                          1 << 30)
    ord_b = argsort_stable(torch.gather(k_major, 1, ord_a), dim=1).long()
    order = torch.gather(ord_a, 1, ord_b)

    def g(col):
        return torch.gather(anc[:, :, col], 1, order)

    iir, roff, mlen = g(A_IIR), g(A_ROFF), g(A_MLEN)
    score, ref, dirc = g(A_SCORE), g(A_REF), g(A_DIR)
    useless = g(A_USELESS)
    svalid = torch.gather(valid, 1, order)
    same = ((ref[:, 1:] == ref[:, :-1]) & (dirc[:, 1:] == dirc[:, :-1])
            & (u32(roff[:, 1:] - roff[:, :-1]) < 2000) & svalid[:, 1:])
    new_run = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                         ~same], dim=1)
    run_id = torch.cumsum(new_run.to(I32), dim=1, dtype=I32) - 1

    NEG = -(1 << 30)
    eff = torch.where(((useless >> 1) & 1) == 1, 1, score)
    score_v = torch.where(svalid, score, NEG)
    pre = torch.full((B, A2), -1, dtype=I32, device=dev)
    p_sum = torch.zeros((B, A2), dtype=I32, device=dev)
    p_cnt = svalid.to(I32)
    p_ind = torch.zeros((B, A2), dtype=I32, device=dev)
    p_top = torch.zeros((B, A2), dtype=I32, device=dev)
    p_qst = iir.clone()
    p_tst = roff.clone()
    roff_u = u32(roff + mlen)
    iir_u = u32(iir + mlen)
    for ci in range(1, A2):
        c_iir, c_roff, c_mlen = iir[:, ci], roff[:, ci], mlen[:, ci]
        c_on = svalid[:, ci]
        max_t = c_roff + MAX_ANCHOR_OVERLAP
        max_q = c_iir + MAX_ANCHOR_OVERLAP
        prior = (slot < ci) & (run_id == run_id[:, ci][:, None])
        mq_u, mt_u = u32(max_q)[:, None], u32(max_t)[:, None]
        pass_ov = ~(iir_u > mq_u) & ~(roff_u > mt_u)
        brk = pass_ov & ((u32(iir + 1000) < mq_u) | (u32(roff + 1000) < mt_u))
        brk_slot = torch.where(brk & prior, slot, -1).amax(dim=1)
        indel = iir - roff - (max_q - max_t)[:, None]
        ok = (prior & pass_ov & (slot > brk_slot[:, None])
              & (indel.abs() <= 200))
        new_s = (score_v + c_mlen[:, None] - (indel.abs() >> 4)
                 - i32(u32(max_q[:, None] - iir) >> 8))
        new_s = torch.where(ok, new_s, NEG)
        m = new_s.amax(dim=1)
        best = torch.where(new_s == m[:, None], slot, -1).amax(dim=1)
        tk = c_on & (m > score[:, ci])
        bb = best.clamp(0, A2 - 1).long()
        d_ind = (c_iir - iir[lanes, bb]) - (c_roff - roff[lanes, bb])
        top_me = ((useless[:, ci] & 1) == 0).to(I32)
        vals = (
            (score_v, torch.where(tk, m, score[:, ci])),
            (pre, torch.where(tk, best, -1)),
            (p_sum, torch.where(tk, p_sum[lanes, bb] + eff[:, ci], 0)),
            (p_cnt, torch.where(tk, p_cnt[lanes, bb], 0) + 1),
            (p_ind, torch.where(tk, p_ind[lanes, bb] + d_ind, 0)),
            (p_top, torch.where(tk, p_top[lanes, bb] | top_me, 0)),
            (p_qst, torch.where(tk, p_qst[lanes, bb], c_iir)),
            (p_tst, torch.where(tk, p_tst[lanes, bb], c_roff)))
        for arr, v in vals:
            arr[:, ci] = torch.where(c_on, v, arr[:, ci])
    score_v = torch.where(svalid, score_v, NEG)

    # per-run max: the FIRST node (ascending) achieving each run's max
    n_runs = torch.where(svalid, run_id, -1).amax(dim=1) + 1
    rid_c = run_id.clamp(0, A2 - 1).long()
    rmax = torch.full((B, A2), NEG, dtype=I32, device=dev)
    rmax.scatter_reduce_(1, rid_c, torch.where(svalid, score_v, NEG), "amax")
    achieves = svalid & (score_v == torch.gather(rmax, 1, rid_c))
    bslot = torch.full((B, A2), A2, dtype=I32, device=dev)
    bslot.scatter_reduce_(1, rid_c, torch.where(achieves, slot, A2), "amin")
    run_on = (slot < n_runs[:, None]) & (rmax > NEG) & (bslot < A2)
    bs = bslot.clamp(0, A2 - 1).long()

    def gb(a):
        return torch.gather(a, 1, bs)

    ch_all = torch.stack([
        gb(ref), gb(roff) - gb(iir), gb(p_sum) + gb(eff), gb(p_cnt),
        gb(dirc), gb(p_top) | ((gb(useless) & 1) == 0).to(I32),
        gb(p_tst), gb(roff) + gb(mlen), gb(p_qst), gb(iir) + gb(mlen),
        gb(p_ind), torch.gather(order, 1, bs).to(I32),
        slot.expand(B, A2)], dim=2)
    po = torch.where(pre >= 0,
                     torch.gather(order, 1, pre.clamp(0, A2 - 1).long())
                     .to(I32), -1)
    pre_orig = torch.full((B, A2), -1, dtype=I32, device=dev)
    pre_orig.scatter_(1, order, po)

    n = n_runs.clamp(max=A2)
    chs, n_out = _resolve_sort(ch_all, run_on, n)
    return chs[:, :C2], n_out.clamp(max=C2), pre_orig, n_out > C2


m3_kernel.runs = 0   # calls of the plain version


def m3_smem_bytes(A2: int) -> int:
    """Dynamic shared memory of one block of the M3 kernel (its
    ``m3_smem_bytes``): 2 A2 words of sort keys and 20 arrays of A2."""
    return 22 * A2 * 4


def m3_warps(B: int, sms: int) -> int:
    """Warps of an M3 block for a batch of B reads on a card of ``sms``
    SMs: 8 while the batch fits one wave of 8-warp blocks (4 an SM), else 4
    (5 an SM, each block slower but the wave wider)."""
    return 8 if B <= 4 * sms else 4


def m3_kernel_cuda(anc, n_anc):
    """Launch the M3 kernel (a block of ``m3_warps`` warps per read) on
    CUDA tensors; returns what ``m3_kernel`` returns."""
    A2 = anc.shape[1] if anc.dim() == 3 else 0
    if not C2 <= A2 <= M3_MAX_A2:
        raise ValueError(f"m3 kernel: {A2} anchor slots; it takes {C2} to "
                         f"{M3_MAX_A2}")
    warps = m3_warps(anc.shape[0], torch.cuda.get_device_properties(
        anc.device).multi_processor_count) if anc.is_cuda else 0
    return _launch("chain_m3_launch", m3_kernel_cuda, anc, n_anc,
                   m3_smem_bytes(A2), warps)


m3_kernel_cuda.launches = 0


def run_m3_kernel(anc, n_anc):
    return _run(m3_kernel_cuda, m3_kernel, anc, n_anc)


def m3_chain_step(packed, gidx, n_anc):
    """chain_step for the >=50-anchor sub-batch (M3_A2-wide anchors)."""
    anc = _gather_anchors(packed, gidx)
    chains, n_out, pre, ovf = run_m3_kernel(anc, n_anc)
    return chains, n_out, pre, ovf, anc[:, :, :3], \
        _chain_info(chains, n_out, ovf)
