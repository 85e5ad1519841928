"""Top-level classify: the fast/slow mode ladder per read
(src/cly.c:3064-3132) plus driver-level options (src/cly_mt.c:482-527).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ...constants import (
    DEFAULT_L_MIN_MATCHING,
    DEFAULT_MAX_SEC_N,
    DEFAULT_MIN_SCORE,
    MIN_READ_LEN,
)
from .chain import resolve_tree
from .fastslow import fast_classify, slow_classify
from .fm import FM
from .islands import get_islands
from .mapq import mapq_tables
from .mapseed import Locator
from .rescore import delete_small_score_rst, detect_primary


@dataclass
class Options:
    filter_min_length: int = DEFAULT_L_MIN_MATCHING   # -l
    max_sec_n: int = DEFAULT_MAX_SEC_N                # -r
    filter_min_score: int = DEFAULT_MIN_SCORE         # -s
    out_format: str = "SAM"                           # -f

    @property
    def filter_min_score_lv3(self):
        return self.filter_min_score + 10


@dataclass
class StreamState:
    """Per-worker batch history (src/cly.h:157 max_read_l)."""
    max_read_l: int = 0


@dataclass
class ReadResult:
    name: str
    seq: str
    qual: str | None
    read_len: int
    chains: list = field(default_factory=list)
    anchors: list = field(default_factory=list)
    fast: bool = True


class ClassifyEngine:
    def __init__(self, idx, opts: Options | None = None):
        import threading

        self.idx = idx
        self.opts = opts or Options()
        self.fm = FM(idx)
        self.loc = Locator(idx)
        self.q_mem, self.q_lv = mapq_tables(len(idx.ref_bin) * 4)
        self._tls = threading.local()
        # reads the native row driver punted to the per-read python
        # oracle (M3 chaining / cap overflows); in-process paths only —
        # fork-pool workers count in their own process
        self.n_fallback = 0
        self.state = StreamState()
        self._pool = None
        self._pool_threads = 0

    @property
    def state(self):
        """Per-thread stream state (max_read_l): the native kernels
        release the GIL, so classify_records can fan out over threads —
        each worker thread carries its own prefix-max history."""
        s = getattr(self._tls, "state", None)
        if s is None:
            s = StreamState()
            self._tls.state = s
        return s

    @state.setter
    def state(self, v):
        self._tls.state = v

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        if getattr(self, "_tpool", None) is not None:
            self._tpool.shutdown(wait=False)
            self._tpool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def classify_records_formatted(self, recs, threads: int = 1):
        """classify_records + io.sam.format_result, with the formatting
        done inside the worker processes (strings pickle far lighter
        than ReadResult graphs and the formatting parallelizes).
        Returns the list of formatted output strings in input order."""
        from ...io.sam import format_result

        from ...io import native

        premax = []
        running = self.state.max_read_l
        for r in recs:
            premax.append(running)
            if len(r.seq) >= MIN_READ_LEN:
                running = max(running, len(r.seq))
        if native.available():
            out = self._classify_batch_native(recs, premax, threads,
                                              formatted=True)
        elif threads <= 1 or len(recs) < 32:
            out = []
            for i, r in enumerate(recs):
                self.state.max_read_l = premax[i]
                out.append(format_result(
                    self.classify_read(r.name, r.seq, r.qual),
                    self.idx.ref_name, self.opts))
        else:
            out = _classify_parallel(self, recs, premax, threads,
                                     formatted=True)
        self.state.max_read_l = running
        return out

    def classify_records(self, recs, threads: int = 1):
        """Classify a list of records, optionally in parallel — the kt_for
        analogue (src/lib/kthread.c:32-57), with one twist that makes every
        read independent: the only cross-read state, max_read_l
        (src/cly.c:2958), is derived purely from read lengths, so the value
        each read would observe in a single-thread run is a prefix-max
        computable up front. Output is therefore bit-identical to t=1
        regardless of thread count (the reference's per-worker state can
        drift with scheduling; t=1 semantics are its deterministic case).
        """
        from ...io import native

        premax = []
        running = self.state.max_read_l
        for r in recs:
            premax.append(running)
            if len(r.seq) >= MIN_READ_LEN:
                running = max(running, len(r.seq))
        out: list = [None] * len(recs)
        if native.available():
            out = self._classify_batch_native(recs, premax, threads,
                                              formatted=False)
        elif threads <= 1 or len(recs) < 32:
            for i, r in enumerate(recs):
                self.state.max_read_l = premax[i]
                out[i] = self.classify_read(r.name, r.seq, r.qual)
        else:
            out = _classify_parallel(self, recs, premax, threads)
        self.state.max_read_l = running
        return out

    def _native_dp(self):
        """Driver param block for csrc/driver.c classify_batch; pointer
        lifetimes are pinned by self._dp_keep."""
        import numpy as np

        dp = getattr(self, "_dp", None)
        if dp is not None:
            return dp
        from ...constants import (FORWARD, M3_ANCHOR_THRESHOLD,
                                  MAX_DIS_MINUS, MAX_WAITING_LEN,
                                  S_A_KMER_L, MIN_SCORE_MEM, OVER_SEARCH_M2,
                                  FILTER_MIN_SCORE_2G,
                                  FILTER_MIN_SCORE_SHORT_3G, SEED_RANGE,
                                  STEP_EK)
        from .mapseed import _ms_ctx

        idx = self.idx
        ctx = _ms_ctx(idx, self.fm, self.loc, self.q_mem, self.q_lv)
        rf = np.array([
            idx.ref_bin.ctypes.data, len(idx.ref_bin) * 4,
            idx.ref_off.ctypes.data, idx.ref_len.ctypes.data,
            0, 0, 0, FORWARD, 0,
            self.opts.filter_min_score_lv3, self.opts.filter_min_length,
            self.opts.filter_min_score, S_A_KMER_L, OVER_SEARCH_M2,
            MIN_SCORE_MEM, FILTER_MIN_SCORE_2G, FILTER_MIN_SCORE_SHORT_3G,
            0,
        ], np.int64)
        dp = np.array([
            ctx.ctypes.data, rf.ctypes.data,
            idx.ekmer0.ctypes.data, idx.ekmer1.ctypes.data,
            idx.e_hash_mask, STEP_EK, SEED_RANGE,
            M3_ANCHOR_THRESHOLD, MAX_DIS_MINUS, MAX_WAITING_LEN,
            MIN_READ_LEN,
        ], np.int64)
        self._dp_keep = (ctx, rf)
        self._dp = dp
        return dp

    def _result_from_rows(self, name, seq, qual, m, crows):
        """ReadResult from one read's driver output (meta row + final
        chain rows)."""
        from .chain import Chain

        res = ReadResult(name, seq, qual, len(seq))
        res.fast = bool(m[3])
        res.anchors = [None] * int(m[2])
        res.chains = [Chain(
            ref_id=int(r[0]), q_t_dis=0, sum_score=int(r[1]),
            anchor_number=int(r[2]), direction=int(r[3]),
            with_top_anchor=bool(r[4]), primary=int(r[12]),
            pri_index=int(r[13]), t_st=int(r[5]), t_ed=int(r[6]),
            q_st=int(r[7]), q_ed=int(r[8]), indel=int(r[9]),
            chain_id=i, chain_anchor_cur=None)
            for i, r in enumerate(crows[: int(m[1])])]
        return res

    def _classify_batch_native(self, recs, premax, threads, formatted):
        """Batch classify through the native per-read driver
        (csrc/driver.c) — the whole mode ladder runs in C with the GIL
        released, so a THREAD pool scales; only fallback reads (M3
        chaining, caps) and result/SAM assembly stay in python."""
        import numpy as np

        from ...io import native
        from ...io.sam import format_result

        dp = self._native_dp()
        fmt = self.opts.out_format
        sam_in_c = formatted and fmt in ("SAM", "SAM_FULL")
        if sam_in_c:
            blob = getattr(self, "_ref_blob", None)
            if blob is None:
                enc = [s.encode() for s in self.idx.ref_name]
                offs = np.zeros(len(enc) + 1, np.int64)
                np.cumsum([len(e) for e in enc], out=offs[1:])
                blob = (b"".join(enc), offs)
                self._ref_blob = blob
            ref_blob, ref_offs = blob

        def run(lo, hi):
            chunk = recs[lo:hi]
            lens = np.array([len(r.seq) for r in chunk], np.int64)
            effs = np.maximum(np.asarray(premax[lo:hi], np.int64), lens)
            seqs = "".join(r.seq for r in chunk).encode()
            out = []
            if sam_in_c:
                output_seq = fmt == "SAM_FULL"
                quals = None
                ok = True
                if output_seq:
                    n_q = sum(r.qual is not None for r in chunk)
                    if n_q == len(chunk):
                        quals = "".join(r.qual for r in chunk).encode()
                    elif n_q:     # mixed qual presence: python formatter
                        ok = False
                if ok:
                    names = [r.name.encode() for r in chunk]
                    name_offs = np.zeros(len(names) + 1, np.int64)
                    np.cumsum([len(e) for e in names], out=name_offs[1:])
                    meta, text, t_offs = native.classify_batch_sam(
                        dp, seqs, lens, effs, b"".join(names), name_offs,
                        quals, ref_blob, ref_offs, self.opts.max_sec_n,
                        output_seq)
                    for i, r in enumerate(chunk):
                        if meta[i, 0] < 0:
                            self.n_fallback += 1
                            self.state.max_read_l = premax[lo + i]
                            rr = self.classify_read(r.name, r.seq, r.qual)
                            out.append(format_result(rr, self.idx.ref_name,
                                                     self.opts))
                        else:
                            out.append(
                                text[t_offs[i]:t_offs[i + 1]].decode())
                    return out
            meta, chains = native.classify_batch(dp, seqs, lens, effs)
            for i, r in enumerate(chunk):
                if meta[i, 0] < 0:
                    self.n_fallback += 1
                    self.state.max_read_l = premax[lo + i]
                    rr = self.classify_read(r.name, r.seq, r.qual)
                else:
                    rr = self._result_from_rows(r.name, r.seq, r.qual,
                                                meta[i], chains[i])
                out.append(format_result(rr, self.idx.ref_name, self.opts)
                           if formatted else rr)
            return out

        n = len(recs)
        if threads <= 1 or n < 64:
            return run(0, n)
        from concurrent.futures import ThreadPoolExecutor

        if getattr(self, "_tpool", None) is None or \
                self._tpool_threads != threads:
            if getattr(self, "_tpool", None) is not None:
                self._tpool.shutdown(wait=False)
            self._tpool = ThreadPoolExecutor(max_workers=threads)
            self._tpool_threads = threads
        n_chunks = min(n, threads * 4)
        bounds = [n * j // n_chunks for j in range(n_chunks + 1)]
        futs = [self._tpool.submit(run, bounds[j], bounds[j + 1])
                for j in range(n_chunks)]
        out: list = []
        for f in futs:
            out.extend(f.result())
        return out

    def classify_read(self, name: str, seq: str, qual: str | None = None) -> ReadResult:
        from ...io import native

        if native.available():
            res = self._classify_read_rows(name, seq, qual)
            if res is not None:
                return res
        return self._classify_read_obj(name, seq, qual)

    def _classify_read_rows(self, name, seq, qual):
        """Row-level fast path: anchors and chains stay as int64 rows
        through the native kernels (lazy_islands -> classify_dir ->
        resolve_tree_m2 -> rescore_finish); python only makes the
        run_slow decisions and builds the final Chain objects. Returns
        None to fall back to the object path (M3 chaining, caps)."""
        import numpy as np

        from ...constants import (M3_ANCHOR_THRESHOLD, MAX_DIS_MINUS,
                                  MAX_WAITING_LEN)
        from ...io import native
        from .chain import Chain
        from .mapseed import _ms_ctx

        res = ReadResult(name, seq, qual, len(seq))
        if len(seq) < MIN_READ_LEN:
            return res
        idx = self.idx
        read_len = res.read_len
        dirs, both = get_islands(seq, idx)
        ctx = _ms_ctx(idx, self.fm, self.loc, self.q_mem, self.q_lv)

        def ladder(sd, mode):
            if len(sd.seeds) == 0:
                return np.zeros((0, 14), np.int64)
            seeds = np.ascontiguousarray(np.asarray(sd.seeds, np.int32))
            rows = native.classify_dir(ctx, sd.buf, sd.base, read_len,
                                       seeds, mode)
            if rows is None:
                return None
            out = np.empty((len(rows), 14), np.int64)
            out[:, :13] = rows
            out[:, 13] = sd.direction
            return out

        def resolve(segs):
            cat = segs[0] if len(segs) == 1 else np.concatenate(segs)
            rt = native.resolve_tree_m2(cat, M3_ANCHOR_THRESHOLD,
                                        MAX_DIS_MINUS, MAX_WAITING_LEN)
            if rt is None:
                return None, len(cat)
            return rt, len(cat)

        segs = []
        r0 = ladder(dirs[0], 0)
        if r0 is None:
            return None
        segs.append(r0)
        if both:
            r1 = ladder(dirs[1], 0)
            if r1 is None:
                return None
            segs.append(r1)
        rt, n_anc = resolve(segs)
        if rt is None:
            return None
        chain_rows, anc3 = rt
        run_slow = False
        if len(chain_rows) == 0:
            run_slow = True
        elif int(chain_rows[0, 2]) < 5:  # anchor_number; super_repeat==0
            run_slow = True
            if read_len <= 300 and int(chain_rows[0, 1]) > 200:
                run_slow = False
        if run_slow:
            res.fast = False
            segs = []
            s0 = ladder(dirs[0], 1)
            if s0 is None:
                return None
            segs.append(s0)
            rt, n_anc = resolve(segs)
            if rt is None:
                return None
            chain_rows, anc3 = rt
            if both or len(chain_rows) == 0 or int(chain_rows[0, 2]) < 5:
                s1 = ladder(dirs[1], 1)
                if s1 is None:
                    return None
                segs.append(s1)
                rt, n_anc = resolve(segs)
                if rt is None:
                    return None
                chain_rows, anc3 = rt
        res.anchors = [None] * n_anc
        if len(chain_rows) == 0:
            return res
        final = self._finish_rows(chain_rows, anc3, dirs[0].buf, read_len)
        if final is None:
            return None
        res.chains = [Chain(
            ref_id=int(r[0]), q_t_dis=0, sum_score=int(r[1]),
            anchor_number=int(r[2]), direction=int(r[3]),
            with_top_anchor=bool(r[4]), primary=int(r[12]),
            pri_index=int(r[13]), t_st=int(r[5]), t_ed=int(r[6]),
            q_st=int(r[7]), q_ed=int(r[8]), indel=int(r[9]),
            chain_id=i, chain_anchor_cur=None)
            for i, r in enumerate(final)]
        return res

    def _finish_rows(self, chain_rows, anc3, buf, read_len):
        """rescore_finish over row inputs; returns final rows or None."""
        import numpy as np

        from ...constants import (FORWARD, S_A_KMER_L, MIN_SCORE_MEM,
                                  OVER_SEARCH_M2, FILTER_MIN_SCORE_2G,
                                  FILTER_MIN_SCORE_SHORT_3G)
        from ...io import native

        idx = self.idx
        rows = np.ascontiguousarray(chain_rows)
        anc = (np.ascontiguousarray(anc3) if len(anc3)
               else np.zeros((1, 3), np.int64))
        eff = max(self.state.max_read_l, read_len)
        params = getattr(self._tls, "rf_params", None)
        if params is None:
            params = np.array([
                idx.ref_bin.ctypes.data, len(idx.ref_bin) * 4,
                idx.ref_off.ctypes.data, idx.ref_len.ctypes.data,
                0, 0, 0, FORWARD, 0,
                self.opts.filter_min_score_lv3, self.opts.filter_min_length,
                self.opts.filter_min_score, S_A_KMER_L, OVER_SEARCH_M2,
                MIN_SCORE_MEM, FILTER_MIN_SCORE_2G,
                FILTER_MIN_SCORE_SHORT_3G, 0,
            ], np.int64)
            self._tls.rf_params = params
        params[4] = buf.ctypes.data
        params[5] = len(buf)
        params[6] = read_len
        params[8] = eff
        n = native.rescore_finish(params, rows, anc)
        if n < 0:
            return None
        self.state.max_read_l = eff
        return rows[:n]

    def _classify_read_obj(self, name: str, seq: str, qual: str | None = None) -> ReadResult:
        res = ReadResult(name, seq, qual, len(seq))
        if len(seq) < MIN_READ_LEN:
            return res
        idx, fm, loc = self.idx, self.fm, self.loc
        q_mem, q_lv = self.q_mem, self.q_lv
        dirs, both = get_islands(seq, idx)
        anchors, chains = res.anchors, res.chains
        super_repeat = fast_classify(idx, fm, loc, q_mem, q_lv, dirs[0],
                                     res.read_len, anchors)
        if both:
            super_repeat += fast_classify(idx, fm, loc, q_mem, q_lv, dirs[1],
                                          res.read_len, anchors)
        resolve_tree(anchors, chains)
        run_slow = False
        if not chains:
            run_slow = True
        elif chains[0].anchor_number < 5 and super_repeat < 3:
            run_slow = True
            if res.read_len <= 300 and chains[0].sum_score > 200:
                run_slow = False
        if run_slow:
            anchors.clear()
            res.fast = False
            slow_classify(idx, fm, loc, q_mem, q_lv, dirs[0], res.read_len, anchors)
            resolve_tree(anchors, chains)
            if both or not chains or (chains[0].anchor_number < 5 and super_repeat < 3):
                slow_classify(idx, fm, loc, q_mem, q_lv, dirs[1], res.read_len, anchors)
                resolve_tree(anchors, chains)
        if not self._finish_native(chains, dirs, res.read_len):
            delete_small_score_rst(idx, chains, dirs, res.read_len,
                                   self.state, self.opts)
            detect_primary(chains, res.read_len)
        return res

    def _finish_native(self, chains, dirs, read_len) -> bool:
        """delete_small_score_rst + detect_primary via csrc/rescorehot.c;
        False -> caller runs the python oracle path."""
        from ...io import native

        if not chains or not native.available():
            return False
        import numpy as np

        from ...constants import (FORWARD, S_A_KMER_L, MIN_SCORE_MEM,
                                  OVER_SEARCH_M2, FILTER_MIN_SCORE_2G,
                                  FILTER_MIN_SCORE_SHORT_3G)
        from .chain import Chain

        idx = self.idx
        nc = len(chains)
        rows = np.zeros((nc, 14), np.int64)
        anc = []
        for i, c in enumerate(chains):
            a = c.chain_anchor_cur
            off = len(anc)
            while a is not None:
                anc.append((a.mtch_len, a.ref_offset, a.index_in_read))
                a = a.chain_anchor_pre
            rows[i] = (c.ref_id, c.sum_score, c.anchor_number, c.direction,
                       int(c.with_top_anchor), c.t_st, c.t_ed, c.q_st,
                       c.q_ed, c.indel, off, len(anc) - off, 0, 0)
        anc3 = (np.array(anc, np.int64) if anc
                else np.zeros((1, 3), np.int64))
        buf = dirs[0].buf
        eff = max(self.state.max_read_l, read_len)
        params = np.array([
            idx.ref_bin.ctypes.data, len(idx.ref_bin) * 4,
            idx.ref_off.ctypes.data, idx.ref_len.ctypes.data,
            buf.ctypes.data, len(buf), read_len, FORWARD, eff,
            self.opts.filter_min_score_lv3, self.opts.filter_min_length,
            self.opts.filter_min_score, S_A_KMER_L, OVER_SEARCH_M2,
            MIN_SCORE_MEM, FILTER_MIN_SCORE_2G, FILTER_MIN_SCORE_SHORT_3G,
            0,  # params[17]: reserved (debug hook)
        ], np.int64)
        n = native.rescore_finish(params, rows, anc3)
        if n < 0:
            return False
        self.state.max_read_l = eff
        chains[:] = [Chain(
            ref_id=int(r[0]), q_t_dis=0, sum_score=int(r[1]),
            anchor_number=int(r[2]), direction=int(r[3]),
            with_top_anchor=bool(r[4]), primary=int(r[12]),
            pri_index=int(r[13]), t_st=int(r[5]), t_ed=int(r[6]),
            q_st=int(r[7]), q_ed=int(r[8]), indel=int(r[9]),
            chain_id=i, chain_anchor_cur=None)
            for i, r in enumerate(rows[:n])]
        return True


# ---- process-parallel driver (fork; index shared copy-on-write) ------------
_G_ENGINE: ClassifyEngine | None = None


def _classify_chunk(args):
    lo, chunk, formatted = args
    eng = _G_ENGINE
    res = []
    if formatted:
        from ...io.sam import format_result

        for premax, name, seq, qual in chunk:
            eng.state.max_read_l = premax
            res.append(format_result(eng.classify_read(name, seq, qual),
                                     eng.idx.ref_name, eng.opts))
        return lo, res
    for premax, name, seq, qual in chunk:
        eng.state.max_read_l = premax
        r = eng.classify_read(name, seq, qual)
        # strip the anchor graph before pickling back: formatters read
        # only len(anchors) and the chain scalar fields (io/sam.py), but
        # chain_anchor_* links would drag every Anchor object through
        # the pipe
        r.anchors = [None] * len(r.anchors)
        for c in r.chains:
            c.chain_anchor_cur = None
        res.append(r)
    return lo, res


def _classify_parallel(eng, recs, premax, threads, formatted=False):
    """Parallel map over reads — the kt_for analogue.

    With the native kernels built, ~90%+ of per-read time is inside
    GIL-releasing C calls, so a THREAD pool scales and skips the fork
    pool's pickling entirely (per-thread StreamState + native scratch).
    Without the native library (pure-python oracle) the GIL forces
    fork-based processes (index shared copy-on-write)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from ...io import native

    global _G_ENGINE
    # ~4 chunks per worker for dynamic load balance (read lengths vary,
    # like kt_for's work stealing)
    n = len(recs)
    n_chunks = min(n, threads * 4)
    bounds = [n * j // n_chunks for j in range(n_chunks + 1)]
    jobs = []
    for j in range(n_chunks):
        lo, hi = bounds[j], bounds[j + 1]
        jobs.append((lo, [(premax[i], recs[i].name, recs[i].seq, recs[i].qual)
                          for i in range(lo, hi)], formatted))
    _G_ENGINE = eng
    # measured: fork beats threads even with GIL-releasing kernels (the
    # remaining per-read glue serializes threads at ~1.9k reads/s vs
    # 3.8k for processes on the demo)
    want = ("fork", threads)
    # persistent pool: spin-up costs ~0.2 s per batch otherwise
    # (the reference's kt_for threads live for the whole run too)
    if eng._pool is None or eng._pool_threads != want:
        if eng._pool is not None:
            eng._pool.shutdown(wait=False)
        if want[0] == "thread":
            eng._pool = ThreadPoolExecutor(max_workers=threads)
        else:
            ctx = mp.get_context("fork")
            eng._pool = ProcessPoolExecutor(max_workers=threads,
                                            mp_context=ctx)
        eng._pool_threads = want
    ex = eng._pool
    out: list = [None] * n
    for lo, res in ex.map(_classify_chunk, jobs):
        out[lo : lo + len(res)] = res
    return out
