"""DeviceClassifier: batched classify with a device-resident pipeline.

Counterpart of ``desamba_tpu/engine/device/classifier.py``; the host
logic (lane sets, gather maps, run_slow decisions, the finish closure) is
the JAX classifier's, copied, and the device stages are this package's:

  device — existence-filter probe, fast/slow ladders, M2 and M3 chaining,
           the rescore prep and the per-read 9-mer SDP rescore kernel
           (main batch at 64 anchors, M3 sub-batch at ``chain.M3_A2``).
  host   — island segmentation (native C batch call), lane and gather-map
           construction in numpy, run_slow decisions, merge/filter/primary
           and SAM, in input order so StreamState and output order match
           the reference exactly.

The gold oracle, the native library and the constants are this package's
own copies of the JAX package's modules (``engine/gold``, ``io``,
``constants``).

A read goes to the gold oracle only where the JAX classifier sends it:
ladder pack overflow, chain-slot overflow, too many anchors or chains, or
a rescore fallback. ``fallback_stats()`` counts them by cause, and
``stage_s`` holds the wall seconds spent in each stage (every stage ends
in a host fetch, which waits for the card), summed over the threads that
ran it: with batches in flight the stages overlap, and their sum may pass
the wall time.

``classify_reads`` pipelines its batches as the JAX classifier does (the
reference's kt_pipeline, src/lib/kthread.c:157-197): batch N+1's island
prep runs on a prep thread, up to ``DESAMBA_PIPE_DEPTH`` device phases (3
by default) run on worker threads, and each batch's finish runs on the
caller's thread strictly in input order, so StreamState is updated
serially and the SAM is the serial schedule's, byte for byte.
``DESAMBA_PREP_WORKERS`` (2) sets the prep threads. The threads share the
card's current stream, so the card runs their kernels one after another.
``classify_file`` parses on a reader thread and preps one batch ahead.
"""
from __future__ import annotations

import os
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...constants import (FORWARD, M3_ANCHOR_THRESHOLD, MIN_READ_LEN,
                          REVERSE, SEED_RANGE, STEP_EK)
from ...io import native
from ..gold.chain import Chain
from ..gold.classify import ClassifyEngine, Options, ReadResult, StreamState
from ..gold.rescore import (detect_primary, post_finish_native,
                            post_rescore_finish)

from . import chain as dc
from . import rescore as dr
from . import rescore_pl as drp
from .arrays import DeviceIndex
from .intops import I32
from .islands import bloom_hit_kernel
from .ladder import IV_HOT, run_fast_ladder, run_slow_ladder
from .pipeline import pre13_values

A_CAP = 96
M_CAP = 128

# fallback causes, in the order fallback_stats() reports them
CAUSES = ("ladder_pack", "anchors", "chain_slot", "m3", "rescore_chains",
          "rescore")
FB_NAMES = ("midw", "wrap", "hits", "fcap", "sms", "over")


def _bucket(n: int, lo: int = 256) -> int:
    """Round lane counts up to power-of-two buckets (the JAX classifier's
    buckets: the ladder pack capacity, and so its overflow rule, follows
    them)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _csr_expand(offs, cnts):
    """Concatenate ranges [offs[i], offs[i]+cnts[i]) as one index array."""
    total = int(cnts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(cnts)[:-1]]), cnts)
    return np.repeat(np.asarray(offs, np.int64), cnts) + within


class LaneSet:
    """Flat per-lane arrays, ordered by (read row, part, seed id)."""

    __slots__ = ("ridx", "base", "rl", "dir", "sid", "soff", "slen", "n")

    def __init__(self, ridx, base, rl, dirs, sid, soff, slen):
        self.ridx = ridx
        self.base = base
        self.rl = rl
        self.dir = dirs
        self.sid = sid
        self.soff = soff
        self.slen = slen
        self.n = len(ridx)


class DeviceClassifier:
    def __init__(self, idx, opts: Options | None = None, device="cuda",
                 batch_size: int = 2048):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceClassifier(device='cuda'): no CUDA "
                               "device is available")
        self.device = device
        self.idx = idx
        self.opts = opts or Options()
        self.dix = DeviceIndex.build(idx, device)
        self.ixr = self.dix.index_refs()
        self.ref_words = drp.ref_words(self.dix.ref_pk)
        self.gold = ClassifyEngine(idx, self.opts)  # fallback + host tables
        self.state = StreamState()
        self.batch_size = batch_size
        # the counters that device phases write from worker threads
        # (stage_s, n_slow, n_m3) change under this lock; those that the
        # finish writes stay on the caller's thread
        self._lock = threading.Lock()
        self.n_fallback = 0     # reads rescued by the gold oracle
        self.n_classified = 0
        self.n_slow = 0         # reads that ran the slow ladders
        self.n_m3 = 0           # reads rescored in the M3 sub-batch
        self.cause_counts = dict.fromkeys(CAUSES, 0)
        self.fb_bit_counts = dict.fromkeys(FB_NAMES, 0)
        self.stage_s = defaultdict(float)

    def fallback_stats(self):
        return {"fallback_reads": self.n_fallback,
                "total_reads": self.n_classified,
                "slow_path_reads": self.n_slow,
                "m3_path_reads": self.n_m3,
                "by_cause": dict(self.cause_counts),
                "rescore_fb_bits": dict(self.fb_bit_counts)}

    def _t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def _lap(self, stage, t0):
        """Add the wall time since ``t0`` to ``stage``; returns now."""
        t = time.perf_counter()
        with self._lock:
            self.stage_s[stage] += t - t0
        return t

    # ---- island stage ------------------------------------------------------
    def _islands(self, seqs):
        """Existence probe (device, bucketed by read length) + island
        segmentation (native C batch call). Returns (bufs, seeds, s_off,
        s_cnt, totals); strand 2i = forward, 2i+1 = reverse of read i."""
        idx = self.idx
        l_ek = idx.len_e_kmer
        B = len(seqs)
        if not B:
            z = np.zeros(0, np.int64)
            return [], np.zeros((0, 3), np.int32), z, z, z
        native.available()          # builds and loads the library, or raises
        lens_np = np.array([len(s) for s in seqs], np.int64)
        mat = native.encode_batch("".join(seqs).encode(), lens_np,
                                  int(lens_np.max()))
        bufs = [mat[i, : 2 * lens_np[i]] for i in range(B)]
        Lmax_all = max(len(b) // 2 for b in bufs)
        hits = np.zeros((2 * B, Lmax_all - l_ek + 1), bool)
        order = sorted(range(B), key=lambda i: len(bufs[i]))
        pos = 0
        while pos < B:
            Lc = 1024
            while len(bufs[order[pos]]) // 2 > Lc:
                Lc *= 2
            grp = []
            while pos < B and len(bufs[order[pos]]) // 2 <= Lc:
                grp.append(order[pos])
                pos += 1
            Bpad = _bucket(2 * len(grp), 64)
            strands = np.zeros((Bpad, Lc), np.uint8)
            lens = np.zeros((Bpad,), np.int32)
            for k, i in enumerate(grp):
                b = bufs[i]
                rl = len(b) // 2
                strands[2 * k, :rl] = b[:rl]
                strands[2 * k + 1, :rl] = b[rl:]
                lens[2 * k] = lens[2 * k + 1] = rl
            got = self._k_bloom(self._t(strands), self._t(lens)).cpu().numpy()
            for k, i in enumerate(grp):
                nk = len(bufs[i]) // 2 - l_ek + 1
                hits[2 * i, :nk] = got[2 * k, :nk]
                hits[2 * i + 1, :nk] = got[2 * k + 1, :nk]

        n_k_a = np.zeros((2 * B,), np.int32)
        dirs_a = np.zeros((2 * B,), np.int32)
        n_k_a[0::2] = n_k_a[1::2] = [len(s) - l_ek + 1 for s in seqs]
        dirs_a[0::2] = FORWARD
        dirs_a[1::2] = REVERSE
        seeds, s_off, s_cnt, totals = native.islands_batch(
            hits.view(np.uint8), n_k_a, dirs_a, STEP_EK, SEED_RANGE)
        return bufs, seeds, s_off, s_cnt, totals

    # ---- ladder helpers ----------------------------------------------------
    # island-length partition thresholds (the JAX classifier's groups: the
    # per-group pack capacity decides the pack-overflow fallback)
    _LEN_SPLITS = (7, 17, 1 << 30)

    def _run_ladder(self, kind, ls: LaneSet, codes_fr, buf_len, pre13):
        if ls.n == 0:
            return None
        order = np.argsort(ls.slen, kind="stable")
        bounds = np.searchsorted(ls.slen[order], np.array(self._LEN_SPLITS),
                                 "right")
        groups = []
        start = 0
        for b in bounds:
            if b > start:
                groups.append(order[start:b])
            start = b
        outs = [self._dispatch_ladder_group(kind, ls, g, codes_fr, buf_len,
                                            pre13) for g in groups]
        # SP_SET hot-tier overflow (info col 3): re-run those groups at
        # full IV_CAP, which cannot overflow, and use their results
        for gi, g in enumerate(groups):
            if outs[gi][1][: len(g), 3].any():
                outs[gi] = self._dispatch_ladder_group(
                    kind, ls, g, codes_fr, buf_len, pre13, iv_cap=None)
        base_all = np.zeros((ls.n,), np.int64)
        acnt_all = np.zeros((ls.n,), np.int32)
        skip_all = np.zeros((ls.n,), bool)
        bad_all = np.zeros((ls.n,), bool)
        packed_all = []
        offset = 0
        for g, (packed, info, NB) in zip(groups, outs):
            base = info[:, 0].astype(np.int64)
            acnt = info[:, 1]
            # per-LANE pack overflow
            bad = base + np.minimum(acnt, A_CAP) > 2 * NB
            base_all[g] = offset + base[: len(g)]
            acnt_all[g] = acnt[: len(g)]
            skip_all[g] = info[: len(g), 2].astype(bool)
            bad_all[g] = bad[: len(g)]
            packed_all.append(packed)
            offset += packed.shape[0]
        packed_dev = (packed_all[0] if len(packed_all) == 1
                      else torch.cat(packed_all, dim=0))
        return [packed_dev, base_all, acnt_all, skip_all, bad_all]

    def _dispatch_ladder_group(self, kind, ls: LaneSet, g, codes_fr,
                               buf_len, pre13, iv_cap=IV_HOT):
        N = len(g)
        NB = _bucket(N)
        cols = np.zeros((8, NB), np.int32)
        cols[0, :N] = ls.ridx[g]
        cols[1, :N] = ls.base[g]
        cols[2, :N] = ls.rl[g]
        cols[3, :N] = ls.dir[g]
        cols[4, :N] = ls.sid[g]
        cols[5, :N] = ls.soff[g]
        cols[6, :N] = ls.slen[g]
        cols[7, :N] = 1  # lane_on
        packed, info, _ovf = self._k_ladder(kind, codes_fr, buf_len, pre13,
                                            self._t(cols), NB, iv_cap=iv_cap)
        return packed, info.cpu().numpy(), NB

    # ---- device stages -----------------------------------------------------
    def _k_bloom(self, strands, lens):
        return bloom_hit_kernel(strands, lens, self.dix.ekmer0,
                                self.dix.ekmer1, self.idx.len_e_kmer,
                                self.idx.single_base_max, self.dix.mask_bits)

    def _k_ladder(self, kind, codes_fr, buf_len, pre13, lane_args, NB,
                  iv_cap=IV_HOT):
        dix = self.dix
        args = (self.ixr, dix.fm_blocks, dix.rank, dix.hash13, codes_fr,
                buf_len, pre13, dix.q_mem, dix.q_lv, lane_args)
        if kind == "fast":
            return run_fast_ladder(*args, l_ek=self.idx.len_e_kmer,
                                   a_cap=A_CAP, pack_cap=2 * NB,
                                   iv_cap=iv_cap)
        return run_slow_ladder(*args, l_ek=self.idx.len_e_kmer, a_cap=A_CAP,
                               m_cap=M_CAP, pack_cap=2 * NB, iv_cap=iv_cap)

    def _k_rescore(self, inp):
        dix = self.dix
        return drp.rescore(inp, self.ref_words, dix.ref_off, dix.ref_len_arr,
                           dix.n_bases)

    # ---- gather-map construction (vectorized) -----------------------------
    @staticmethod
    def _keep_with_skip(lane_read, flag):
        """The reference's skip_next rule (src/cly.c:1494-1534): a lane is
        dropped when the previous kept lane of the same read carried the
        >512 flag; within a run of flagged lanes inclusion alternates."""
        n = len(lane_read)
        if n == 0:
            return np.zeros(0, bool)
        h = np.zeros(n, bool)
        h[1:] = flag[:-1] & (lane_read[1:] == lane_read[:-1])
        idxs = np.arange(n)
        last_anchor = np.maximum.accumulate(np.where(~h, idxs, -1))
        return ((idxs - last_anchor) % 2) == 0

    def _flag(self, fallback, cause, rows, code):
        """Mark reads ``rows`` for the gold fallback, recording the first
        cause each one hit."""
        rows = np.asarray(rows, np.int64)
        new = rows[~fallback[rows]]
        cause[new[cause[new] == 0]] = code
        fallback[rows] = True

    def _build_gidx(self, B_pad, A2, lane_read, base, cnt, flag,
                    apply_skip, fallback_rows, cause):
        """Per-read packed-row id lists -> (gidx, nanc, wide); flags reads
        whose rows exceed M3_A2 or whose lanes overflowed in
        fallback_rows (mutated)."""
        gidx = np.full((B_pad, A2), -1, np.int32)
        nanc = np.zeros((B_pad,), np.int32)
        if len(lane_read) == 0:
            return gidx, nanc, np.zeros((B_pad,), bool)
        if apply_skip:
            keep = self._keep_with_skip(lane_read, flag)
            bad = keep & (cnt > A_CAP)
        else:
            keep = np.ones(len(lane_read), bool)
            bad = (cnt > A_CAP) | flag
        self._flag(fallback_rows, cause, lane_read[bad], 2)
        kcnt = np.where(keep & ~fallback_rows[lane_read], cnt, 0)
        tot = np.bincount(lane_read, weights=kcnt,
                          minlength=B_pad).astype(np.int64)
        # (A2, M3_A2] anchors -> the device M3 sub-batch; beyond -> host
        wide = tot > A2
        self._flag(fallback_rows, cause, np.flatnonzero(tot > dc.M3_A2), 2)
        if wide.any():
            kcnt = np.where(wide[lane_read] | fallback_rows[lane_read],
                            0, kcnt)
            tot[wide] = 0
        pre = np.cumsum(kcnt) - kcnt
        read_start = np.zeros(B_pad, np.int64)
        first = np.ones(len(lane_read), bool)
        first[1:] = lane_read[1:] != lane_read[:-1]
        read_start[lane_read[first]] = pre[first]
        within = pre - read_start[lane_read]
        rowids = _csr_expand(base, kcnt)
        dest = _csr_expand(lane_read.astype(np.int64) * A2 + within, kcnt)
        gidx.reshape(-1)[dest] = rowids
        nanc[: len(tot)] = tot
        return gidx, nanc, wide & ~fallback_rows

    def _gidx_wide(self, rows, lane_read, base, cnt, flag, apply_skip,
                   fallback_rows):
        """(len(rows), M3_A2) gather map for the M3 sub-batch reads."""
        A2w = dc.M3_A2
        Bm = len(rows)
        sub = np.zeros(int(lane_read.max(initial=-1)) + 2, np.int64) - 1
        sub[rows] = np.arange(Bm)
        gidx = np.full((Bm, A2w), -1, np.int32)
        nanc = np.zeros((Bm,), np.int32)
        if len(lane_read) == 0 or Bm == 0:
            return gidx, nanc
        if apply_skip:
            keep = self._keep_with_skip(lane_read, flag)
        else:
            keep = np.ones(len(lane_read), bool)
        m = (sub[lane_read] >= 0) & keep & ~fallback_rows[lane_read]
        lr = sub[lane_read[m]]
        kcnt = np.minimum(cnt[m], A_CAP)
        bs = base[m]
        tot = np.bincount(lr, weights=kcnt, minlength=Bm).astype(np.int64)
        pre = np.cumsum(kcnt) - kcnt
        read_start = np.zeros(Bm, np.int64)
        first = np.ones(len(lr), bool)
        first[1:] = lr[1:] != lr[:-1]
        read_start[lr[first]] = pre[first]
        within = pre - read_start[lr]
        rowids = _csr_expand(bs, kcnt)
        dest = _csr_expand(lr.astype(np.int64) * A2w + within, kcnt)
        gidx.reshape(-1)[dest] = rowids
        nanc[:] = np.minimum(tot, A2w)
        return gidx, nanc

    # ---- main entry --------------------------------------------------------
    def classify_reads(self, recs):
        """Classify records in batches of batch_size, pipelined (module
        docstring); yields ReadResults in input order. One batch runs
        serially on the caller's thread. Each batch's futures are dropped
        once their results are taken, and closing the generator early
        cancels the batches not started and joins every thread."""
        batches = [recs[i : i + self.batch_size]
                   for i in range(0, len(recs), self.batch_size)]
        if len(batches) <= 1:
            for b in batches:
                yield from self._classify_batch(b)
            return
        n = len(batches)
        depth = int(os.environ.get("DESAMBA_PIPE_DEPTH", "3"))
        prep_ex = ThreadPoolExecutor(
            int(os.environ.get("DESAMBA_PREP_WORKERS", "2")),
            thread_name_prefix="desamba-prep")
        dev_ex = ThreadPoolExecutor(depth, thread_name_prefix="desamba-dev")
        try:
            preps = {k: prep_ex.submit(self._prep_batch, batches[k])
                     for k in range(min(depth + 1, n))}
            phases = deque()

            def start(k):
                phases.append(dev_ex.submit(self._device_phase, batches[k],
                                            preps.pop(k).result()))

            for k in range(min(depth, n)):
                start(k)
            for bi in range(n):
                nxt = bi + depth
                if nxt < n:
                    start(nxt)
                    if nxt + 1 < n:
                        preps[nxt + 1] = prep_ex.submit(self._prep_batch,
                                                        batches[nxt + 1])
                finish = phases.popleft().result()
                yield from finish()
                del finish
        finally:
            for ex in (prep_ex, dev_ex):
                ex.shutdown(wait=True, cancel_futures=True)

    def classify_file(self, path):
        """Classify the records of a FASTA/FASTQ file: a reader thread
        parses batch N+1 while batch N classifies, batch N+1's island prep
        runs one batch ahead, and results come in input order. A parse
        error is raised after the batches before it."""
        from ...io.prefetch import prefetch_batches

        batches = prefetch_batches(path, self.batch_size)
        prep_ex = ThreadPoolExecutor(1, thread_name_prefix="desamba-prep")
        try:
            prev = None          # (batch, its prep future), one batch ahead
            for batch in batches:
                nxt = (batch, prep_ex.submit(self._prep_batch, batch))
                if prev is not None:
                    yield from self._classify_batch(prev[0],
                                                    prev[1].result())
                prev = nxt
            if prev is not None:
                yield from self._classify_batch(prev[0], prev[1].result())
        finally:
            batches.close()
            prep_ex.shutdown(wait=True, cancel_futures=True)

    def _classify_batch(self, recs, prep=None):
        return self._device_phase(recs, prep)()

    def _prep_batch(self, recs):
        t0 = time.perf_counter()
        todo = [i for i, r in enumerate(recs) if len(r.seq) >= MIN_READ_LEN]
        islands = self._islands([recs[i].seq for i in todo])
        self._lap("islands", t0)
        return todo, islands

    def _device_phase(self, recs, prep=None):
        idx = self.idx
        dev = self.device
        l_ek = idx.len_e_kmer
        results = [ReadResult(r.name, r.seq, r.qual, len(r.seq))
                   for r in recs]
        if prep is None:
            prep = self._prep_batch(recs)
        todo, (bufs, seeds, s_off, s_cnt, s_tot) = prep
        if not todo:
            def _finish_empty():
                self.n_classified += len(recs)
                return results
            return _finish_empty
        B = len(todo)
        rl_arr = np.array([len(recs[i].seq) for i in todo], np.int32)
        t = time.perf_counter()

        Lmax = max(len(b) for b in bufs)
        Lmax = ((Lmax + 2047) // 2048) * 2048
        B_pad = _bucket(B, 64)
        codes_np = np.zeros((B_pad, Lmax), np.uint8)
        blen_np = np.zeros((B_pad,), np.int32)
        for k in range(B):
            codes_np[k, : len(bufs[k])] = bufs[k]
            blen_np[k] = len(bufs[k])
        codes_fr = self._t(codes_np)
        buf_len = self._t(blen_np)
        pre13 = pre13_values(codes_fr, l_ek)
        rlen_np = np.zeros((B_pad,), np.int32)
        rlen_np[:B] = rl_arr

        # ---- strand metadata (read row k <-> strands 2k, 2k+1) ------------
        s_tot = s_tot.astype(np.int64)
        d0 = (s_tot[0::2] < s_tot[1::2]).astype(np.int64)  # best dir first
        t_hi = np.where(d0 == 1, s_tot[1::2], s_tot[0::2])
        t_lo = np.where(d0 == 1, s_tot[0::2], s_tot[1::2])
        both = (t_hi - t_lo) <= (t_hi >> 3)
        ar2 = np.arange(B, dtype=np.int64)
        strand_dir = np.tile(np.array([FORWARD, REVERSE], np.int32), B)
        strand_base = np.zeros(2 * B, np.int32)
        strand_base[1::2] = rl_arr
        ord_strands = np.empty(2 * B, np.int64)
        ord_strands[0::2] = 2 * ar2 + d0
        ord_strands[1::2] = 2 * ar2 + 1 - d0
        first_top = np.zeros(2 * B, bool)
        has = s_cnt > 0
        first_top[has] = seeds[s_off[has], 2] > 0

        def lanes_for(strands, seed_mask_fn):
            cnts = s_cnt[strands]
            sidx = _csr_expand(s_off[strands], cnts)
            sstr = np.repeat(strands, cnts)
            sid = (sidx - s_off[sstr]).astype(np.int32)
            m = seed_mask_fn(sidx, sstr)
            sidx, sstr, sid = sidx[m], sstr[m], sid[m]
            ridx = (sstr // 2).astype(np.int32)
            return LaneSet(ridx, strand_base[sstr], rl_arr[ridx],
                           strand_dir[sstr], sid,
                           seeds[sidx, 0], seeds[sidx, 1])

        fallback = np.zeros(B_pad, bool)
        cause = np.zeros(B_pad, np.int8)   # 1-based index into CAUSES

        # ---- fast pass (dir0 + dir1-if-both) ------------------------------
        inc_strand = np.zeros(2 * B, bool)
        inc_strand[ord_strands[0::2]] = True
        inc_strand[ord_strands[1::2]] |= both
        fast_ls = lanes_for(ord_strands,
                            lambda sidx, sstr: (seeds[sidx, 2] > 0)
                            & inc_strand[sstr])
        fast_out = self._run_ladder("fast", fast_ls, codes_fr, buf_len,
                                    pre13)
        t = self._lap("fast_ladder", t)
        if fast_out is not None and fast_out[4].any():
            self._flag(fallback, cause, fast_ls.ridx[fast_out[4]], 1)

        A2 = dr.A_CAP
        zero_set = None

        def chain_stage(packed, gidx, nanc):
            nonlocal zero_set
            if packed is None:
                if zero_set is None:
                    zero_set = (
                        torch.zeros((B_pad, dc.C2, dc.CH_NF), dtype=I32,
                                    device=dev),
                        torch.zeros((B_pad,), dtype=I32, device=dev),
                        torch.full((B_pad, A2), -1, dtype=I32, device=dev),
                        torch.zeros((B_pad,), dtype=torch.bool, device=dev),
                        torch.zeros((B_pad, A2, 3), dtype=I32, device=dev))
                return zero_set, np.zeros((B_pad,), np.int32), \
                    np.zeros((B_pad, 2), np.int32), np.zeros((B_pad,), bool)
            out = dc.chain_step(packed, self._t(gidx), self._t(nanc))
            info = out[5].cpu().numpy().copy()
            return out[:5], info[:, 0], info[:, 1:3], info[:, 3].astype(bool)

        m3_sets = [None, None, None]   # per chain stage

        def m3_stage(stage, packed, wide_mask, nanc_main, ovf_h, n_h, dec,
                     lane_read, base_a, cnt_a, flag_a, apply_skip):
            """Route >=50-anchor reads (kernel M3-threshold flag or the
            gidx wide mask) through the device M3 kernel; residual
            chain-slot overflows go to the host oracle."""
            cand = ((ovf_h & (nanc_main >= M3_ANCHOR_THRESHOLD))
                    | wide_mask) & ~fallback
            self._flag(fallback, cause, np.flatnonzero(ovf_h & ~cand), 3)
            rows = np.flatnonzero(cand)
            if len(rows) == 0 or packed is None:
                return
            gw, nw = self._gidx_wide(rows, lane_read, base_a, cnt_a,
                                     flag_a, apply_skip, fallback)
            Bm = _bucket(len(rows), 8)
            gpad = np.full((Bm, dc.M3_A2), -1, np.int32)
            gpad[: len(rows)] = gw
            npad = np.zeros((Bm,), np.int32)
            npad[: len(rows)] = nw
            chm, _nm, prem, _ovfm, anc3m, im = dc.m3_chain_step(
                packed, self._t(gpad), self._t(npad))
            infom = im.cpu().numpy()
            nm_h = infom[:, 0]
            ok = ~infom[: len(rows), 3].astype(bool)
            self._flag(fallback, cause, rows[~ok], 4)
            n_h[rows[ok]] = nm_h[: len(rows)][ok]
            dec[rows[ok]] = infom[:, 1:3][: len(rows)][ok]
            m3_sets[stage] = dict(
                map={int(k): i for i, k in enumerate(rows)},
                ok={int(k) for k in rows[ok]},
                ch=chm, n=nm_h, pre=prem, anc3=anc3m, nanc=npad)

        # ---- fast chains --------------------------------------------------
        if fast_out is not None:
            gidx_f, nanc_f, wide_f = self._build_gidx(
                B_pad, A2, fast_ls.ridx, fast_out[1], fast_out[2],
                fast_out[3], True, fallback, cause)
        else:
            gidx_f, nanc_f = None, np.zeros((B_pad,), np.int32)
            wide_f = np.zeros((B_pad,), bool)
        set_f, n_f, dec_f, ovf_f = chain_stage(
            fast_out[0] if fast_out is not None else None, gidx_f, nanc_f)
        if fast_out is not None:
            m3_stage(0, fast_out[0], wide_f, nanc_f, ovf_f, n_f, dec_f,
                     fast_ls.ridx, fast_out[1], fast_out[2], fast_out[3],
                     True)
        t = self._lap("chain", t)

        # ---- run_slow decisions + slow dir0 -------------------------------
        n0 = n_f[:B]
        run_slow = ((n0 == 0)
                    | ((dec_f[:B, 0] < 5)
                       & ~((rl_arr <= 300) & (dec_f[:B, 1] > 200))))
        run_slow &= ~fallback[:B]
        for k in np.flatnonzero(run_slow):
            results[todo[k]].fast = False
        slow_reads0 = np.flatnonzero(run_slow)
        with self._lock:
            self.n_slow += len(slow_reads0)
        str0 = (2 * slow_reads0 + d0[slow_reads0]).astype(np.int64)
        slow0_ls = lanes_for(
            str0, lambda sidx, sstr: (seeds[sidx, 1] >= 3) | first_top[sstr])
        slow0_out = self._run_ladder("slow", slow0_ls, codes_fr, buf_len,
                                     pre13)
        t = self._lap("slow_ladder", t)
        if slow0_out is not None and slow0_out[4].any():
            self._flag(fallback, cause, slow0_ls.ridx[slow0_out[4]], 1)
        if slow0_out is not None:
            gidx_s0, nanc_s0, wide_s0 = self._build_gidx(
                B_pad, A2, slow0_ls.ridx, slow0_out[1], slow0_out[2],
                slow0_out[3], False, fallback, cause)
        else:
            gidx_s0, nanc_s0 = None, np.zeros((B_pad,), np.int32)
            wide_s0 = np.zeros((B_pad,), bool)
        set_s0, n_s0, dec_s0, ovf_s0 = chain_stage(
            slow0_out[0] if slow0_out is not None else None, gidx_s0,
            nanc_s0)
        if slow0_out is not None:
            m3_stage(1, slow0_out[0], wide_s0, nanc_s0, ovf_s0, n_s0,
                     dec_s0, slow0_ls.ridx, slow0_out[1], slow0_out[2],
                     slow0_out[3], False)
        t = self._lap("chain", t)

        # ---- decide + run slow dir1 ---------------------------------------
        in_slow0 = np.zeros(B, bool)
        in_slow0[slow_reads0] = True
        want1 = in_slow0 & ~fallback[:B] & (
            both | (n_s0[:B] == 0) | (dec_s0[:B, 0] < 5))
        slow_reads1 = np.flatnonzero(want1)
        str1 = (2 * slow_reads1 + 1 - d0[slow_reads1]).astype(np.int64)
        slow1_ls = lanes_for(
            str1, lambda sidx, sstr: (seeds[sidx, 1] >= 3) | first_top[sstr])
        slow1_out = self._run_ladder("slow", slow1_ls, codes_fr, buf_len,
                                     pre13)
        t = self._lap("slow_ladder", t)
        if slow1_out is not None and slow1_out[4].any():
            self._flag(fallback, cause, slow1_ls.ridx[slow1_out[4]], 1)
        in_slow1 = np.zeros(B, bool)
        if slow1_out is not None:
            in_slow1[slow_reads1] = True
            # chain call 3 consumes slow0 + slow1 anchors per read, ordered
            # by (read, part), dir1 row ids offset past the dir0 pack
            off01 = slow0_out[0].shape[0]
            m0 = in_slow1[slow0_ls.ridx]
            lr = np.concatenate([slow0_ls.ridx[m0], slow1_ls.ridx])
            part = np.concatenate([np.zeros(int(m0.sum()), np.int8),
                                   np.ones(slow1_ls.n, np.int8)])
            bs = np.concatenate([slow0_out[1][m0], slow1_out[1] + off01])
            ct = np.concatenate([slow0_out[2][m0], slow1_out[2]])
            fl = np.concatenate([slow0_out[3][m0], slow1_out[3]])
            o = np.lexsort((part, lr))
            gidx_s1, nanc_s1, wide_s1 = self._build_gidx(
                B_pad, A2, lr[o], bs[o], ct[o], fl[o], False, fallback, cause)
            packed01 = torch.cat([slow0_out[0], slow1_out[0]], dim=0)
        else:
            gidx_s1, nanc_s1 = None, np.zeros((B_pad,), np.int32)
            wide_s1 = np.zeros((B_pad,), bool)
            packed01 = None
        set_s1, n_s1, dec_s1, ovf_s1 = chain_stage(packed01, gidx_s1,
                                                   nanc_s1)
        if packed01 is not None:
            m3_stage(2, packed01, wide_s1, nanc_s1, ovf_s1, n_s1, dec_s1,
                     lr[o], bs[o], ct[o], fl[o], False)
        t = self._lap("chain", t)

        # ---- device rescore over the whole batch --------------------------
        sel_np = np.zeros((B_pad,), np.int32)
        sel_np[:B] = np.where(in_slow1, 2, np.where(in_slow0, 1, 0))
        nanc_final = np.where(sel_np == 2, nanc_s1,
                              np.where(sel_np == 1, nanc_s0, nanc_f))
        live_np = np.zeros((B_pad,), bool)
        live_np[:B] = ~fallback[:B]
        # reads whose SELECTED stage ran the M3 kernel take the M3
        # sub-batch prep/rescore path (wide anchors)
        m3_final = []
        for k in range(B):
            st = m3_sets[sel_np[k]]
            if (not fallback[k]) and st is not None and k in st["ok"]:
                m3_final.append((k, int(sel_np[k]), st["map"][k]))
        m3_row = {k: u for u, (k, _, _) in enumerate(m3_final)}
        for k in m3_row:
            live_np[k] = False
        with self._lock:
            self.n_m3 += len(m3_final)
        chs3 = torch.stack([set_f[0], set_s0[0], set_s1[0]])
        ns3 = torch.stack([set_f[1], set_s0[1], set_s1[1]])
        pre3 = torch.stack([set_f[2], set_s0[2], set_s1[2]])
        anc3 = torch.stack([set_f[4], set_s0[4], set_s1[4]])
        chains_rc, n_rc, anchors4, schash, n_hash, over = dc.prep_rescore(
            self._t(sel_np), chs3, ns3, pre3, anc3)
        n_rc = torch.where(self._t(live_np), n_rc, 0)
        inp = dr.RescoreIn(
            chains=chains_rc, n_chains=n_rc, anchors=anchors4,
            schash=schash, n_hash=n_hash, codes_fr=codes_fr,
            buf_len=buf_len, read_len=self._t(rlen_np))
        chains_out, fb, reason, _iters = self._k_rescore(inp)
        chains_h = chains_out.cpu().numpy()
        fb_h = fb.cpu().numpy()
        reason_h = reason.cpu().numpy()
        n_h = n_rc.cpu().numpy()
        over_h = over.cpu().numpy()

        # ---- M3 sub-batch prep + rescore (M3_A2-wide anchors) --------------
        if m3_final:
            Bmu = _bucket(len(m3_final), 8)
            chU = torch.zeros((Bmu, dc.C2, dc.CH_NF), dtype=I32, device=dev)
            preU = torch.full((Bmu, dc.M3_A2), -1, dtype=I32, device=dev)
            ancU = torch.zeros((Bmu, dc.M3_A2, 3), dtype=I32, device=dev)
            nU = np.zeros((Bmu,), np.int32)
            nancU = np.zeros((Bmu,), np.int32)
            rowsU = np.zeros((Bmu,), np.int64)
            rowsU[: len(m3_final)] = [k for k, _, _ in m3_final]
            for s in (0, 1, 2):
                us = [u for u, (_, ss, _) in enumerate(m3_final) if ss == s]
                if not us:
                    continue
                js = np.array([m3_final[u][2] for u in us], np.int64)
                ua = self._t(np.array(us, np.int64))
                jt = self._t(js)
                st = m3_sets[s]
                chU[ua] = st["ch"][jt]
                preU[ua] = st["pre"][jt]
                ancU[ua] = st["anc3"][jt]
                nU[us] = st["n"][js]
                nancU[us] = st["nanc"][js]

            def three(x):
                return torch.stack([x, x, x])

            (chains_rcU, n_rcU, anchors4U, schashU, n_hashU,
             overU) = dc.prep_rescore(
                torch.zeros((Bmu,), dtype=I32, device=dev), three(chU),
                three(self._t(nU)), three(preU), three(ancU))
            liveU = np.zeros((Bmu,), bool)
            liveU[: len(m3_final)] = True
            n_rcU = torch.where(self._t(liveU), n_rcU, 0)
            ru = self._t(rowsU)
            inpU = dr.RescoreIn(
                chains=chains_rcU, n_chains=n_rcU, anchors=anchors4U,
                schash=schashU, n_hash=n_hashU, codes_fr=codes_fr[ru],
                buf_len=buf_len[ru], read_len=self._t(rlen_np[rowsU]))
            chains_oU, fbU, reasonU, _iU = self._k_rescore(inpU)
            chains_hU = chains_oU.cpu().numpy()
            fb_hU = fbU.cpu().numpy()
            reason_hU = reasonU.cpu().numpy()
            n_hU = n_rcU.cpu().numpy()
            over_hU = overU.cpu().numpy()
        self._lap("rescore", t)

        # ---- host finish, in input order ----------------------------------
        def _finish():
            t_fin = time.perf_counter()
            self.n_classified += len(recs)

            def coord(v):
                # kernel coordinates are uint32 bit patterns in int32
                return int(v) & 0xFFFFFFFF

            for k, i in enumerate(todo):
                res = results[i]
                if k in m3_row:   # M3 sub-batch outputs for this read
                    u = m3_row[k]
                    ch_k, n_k = chains_hU[u], n_hU[u]
                    fb_k, ov_k, rs_k = fb_hU[u], over_hU[u], reason_hU[u]
                    na_k = nancU[u]
                else:
                    ch_k, n_k = chains_h[k], n_h[k]
                    fb_k, ov_k, rs_k = fb_h[k], over_h[k], reason_h[k]
                    na_k = nanc_final[k]
                if fallback[k] or ov_k or (n_k > 0 and fb_k):
                    if fallback[k]:
                        self.cause_counts[CAUSES[cause[k] - 1]] += 1
                    elif ov_k:
                        self.cause_counts["rescore_chains"] += 1
                    else:
                        self.cause_counts["rescore"] += 1
                        for bit, name in enumerate(FB_NAMES):
                            if (int(rs_k) >> bit) & 1:
                                self.fb_bit_counts[name] += 1
                    g = self.gold
                    g.state = self.state
                    results[i] = g.classify_read(recs[i].name, recs[i].seq,
                                                 recs[i].qual)
                    self.n_fallback += 1
                    continue
                res.anchors = [None] * int(na_k)
                chains = []
                for ci in range(int(n_k)):
                    row = ch_k[ci]
                    chains.append(Chain(
                        ref_id=int(row[dr.C_REF]), q_t_dis=0,
                        sum_score=int(row[dr.C_SUM]),
                        anchor_number=int(row[dr.C_ANUM]),
                        direction=int(row[dr.C_DIR]), with_top_anchor=False,
                        primary=0, pri_index=0, t_st=coord(row[dr.C_TST]),
                        t_ed=coord(row[dr.C_TED]), q_st=coord(row[dr.C_QST]),
                        q_ed=coord(row[dr.C_QED]), indel=int(row[dr.C_INDEL]),
                        chain_id=ci, chain_anchor_cur=None))
                res.chains = chains
                rl = int(rl_arr[k])
                if res.chains and post_finish_native(self.idx, res.chains,
                                                     rl, self.state,
                                                     self.opts):
                    continue
                if res.chains:
                    post_rescore_finish(res.chains, rl, self.state, self.opts)
                detect_primary(res.chains, rl)
            self._lap("finish", t_fin)
            return results

        return _finish
