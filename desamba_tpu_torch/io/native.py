"""ctypes bindings for the native runtime (the repo's csrc/*.c).

Builds one shared library on first use (cc -O3) into this package's own
``io/_build/`` (listed in .gitignore), named by a hash of the sources and
the host. Each process compiles to a temporary name of its own and then
renames it into place, so processes that build at once never write the
same file. A failed build raises: ``available()`` either returns True or
raises, and the port has no pure-Python stand-in for the library.

The port's copies of the host modules (``engine/gold``, ``index/build.py``,
``io/fastx.py``) keep the ``if native.available(): ... else: ...`` forks
of the code they were copied from, so that they stay line for line the
same as it. With this module the ``else`` arms never run: they are
unreachable by design, and a later clean-up may drop them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SRCS = [os.path.join(_CSRC, "fastx.c"), os.path.join(_CSRC, "islands.c"),
         os.path.join(_CSRC, "goldhot.c"), os.path.join(_CSRC, "rescorehot.c"),
         os.path.join(_CSRC, "buildhot.c"), os.path.join(_CSRC, "driver.c")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
_LIB = None
_LOAD_LOCK = threading.Lock()   # host threads share one build and load


def lib_path(build_dir: str = BUILD_DIR) -> str:
    """Where the library for these sources lives. -march=native code runs
    only on a CPU like the one that built it, so the CPU's model and
    feature flags are part of the hash."""
    h = hashlib.sha1()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"model name", b"flags")):
                    h.update(line)
                elif not line.strip():
                    break                # the first CPU's record is enough
    except OSError:
        pass
    return os.path.join(build_dir, f"libdesnative_{h.hexdigest()[:12]}.so")


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the library into ``build_dir`` unless it is there already;
    returns its path. Raises if the compiler fails."""
    so = lib_path(build_dir)
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    # -march=native turns the popcount tables / hash mixing into single
    # instructions where available; plain -O3 for toolchains without it
    for extra in (["-march=native", "-funroll-loops"], []):
        try:
            subprocess.run(["cc", "-O3", *extra, "-shared", "-fPIC", "-o",
                            tmp, *_SRCS, "-lz"],
                           check=True, capture_output=True)
            break
        except subprocess.CalledProcessError as e:
            if not extra:
                raise RuntimeError("cc failed to build the native library:\n"
                                   + e.stderr.decode(errors="replace")) from e
    os.replace(tmp, so)
    return so


def _load(so: str):
    lib = ctypes.CDLL(so)
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_read_batch.restype = ctypes.c_int64
    lib.fastx_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_void_p]
    lib.fastx_encode_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.islands_batch.restype = ctypes.c_int64
    lib.islands_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.lv_extd.restype = ctypes.c_int64
    lib.lv_extd.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64]
    lib.get_ref_bases.restype = None
    lib.get_ref_bases.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p]
    lib.mem_run.restype = ctypes.c_int64
    lib.mem_run.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64]
    lib.sort_unique_u64.restype = ctypes.c_int64
    lib.sort_unique_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.build_exist_tables.restype = None
    lib.build_exist_tables.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.unitig_walk.restype = ctypes.c_int64
    lib.unitig_walk.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.unitig_walk_stream.restype = ctypes.c_int64
    lib.unitig_walk_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.resolve_tree_m2.restype = ctypes.c_int64
    lib.resolve_tree_m2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64]
    lib.rescore_finish.restype = ctypes.c_int64
    lib.rescore_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.classify_dir.restype = ctypes.c_int64
    lib.classify_dir.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64]
    lib.map_seed.restype = ctypes.c_int64
    lib.map_seed.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.fm_mem_search.restype = ctypes.c_int64
    lib.fm_mem_search.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64]
    lib.store_kmers_vals.restype = None
    lib.store_kmers_vals.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.lazy_islands.restype = ctypes.c_int64
    lib.lazy_islands.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p]
    lib.exist_hits.restype = None
    lib.exist_hits.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
    lib.classify_batch.restype = ctypes.c_int64
    lib.classify_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.classify_batch_sam.restype = ctypes.c_int64
    lib.classify_batch_sam.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
    lib.sdp_match.restype = ctypes.c_int64
    lib.sdp_match.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    return lib


def available() -> bool:
    """Build (first call) and load the library; True, or raises. The host
    code calls it before every native entry point."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                _LIB = _load(build())
    return True


class NativeFastxReader:
    """Streaming batch reader over the native library."""

    def __init__(self, path: str, batch_reads: int = 5000,
                 batch_bases: int = 10_000_000):
        assert available()
        self._h = _LIB.fastx_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.batch_reads = batch_reads
        self.batch_bases = batch_bases

    def __iter__(self):
        names_cap = 1 << 22
        # contract with fastx_read_batch: one record may straddle the
        # max_bases check, so leave 16 MB slack (max supported read size)
        seq_cap = self.batch_bases + (1 << 24)
        names = ctypes.create_string_buffer(names_cap)
        seqs = ctypes.create_string_buffer(seq_cap)
        quals = ctypes.create_string_buffer(seq_cap)
        hasq = ctypes.create_string_buffer(self.batch_reads)
        lens = np.zeros(self.batch_reads, np.int64)
        while True:
            n = _LIB.fastx_read_batch(
                self._h, self.batch_reads, self.batch_bases, names,
                names_cap, seqs, hasq, quals,
                lens.ctypes.data_as(ctypes.c_void_p))
            if n < 0:
                raise IOError("malformed FASTX stream")
            if n == 0:
                break
            total = int(lens[:n].sum())
            raw_names = names.raw.split(b"\n", n)[:n]
            seq_bytes = seqs.raw[:total]
            qual_bytes = quals.raw[:total]
            yield (raw_names, seq_bytes, qual_bytes,
                   lens[:n].copy(), np.frombuffer(hasq.raw[:n], np.uint8))

    def close(self):
        if self._h:
            _LIB.fastx_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def encode_batch(seq_bytes: bytes, lens: np.ndarray, pad_len: int):
    """Concatenated ASCII sequences -> (n, 2*pad_len) F+R code matrix."""
    n = len(lens)
    out = np.zeros((n, 2 * pad_len), np.uint8)
    _LIB.fastx_encode_batch(
        seq_bytes, lens.astype(np.int64).ctypes.data_as(ctypes.c_void_p),
        n, pad_len, out.ctypes.data_as(ctypes.c_void_p))
    return out


def lv_extd(ref: np.ndarray, ref_length: int, query: np.ndarray,
            query_length: int, lv_error: int) -> int:
    """Native Landau-Vishkin (csrc/goldhot.c); == gold lv_extd."""
    r = np.ascontiguousarray(ref[:ref_length], dtype=np.uint8)
    q = np.ascontiguousarray(query[:query_length], dtype=np.uint8)
    return _LIB.lv_extd(r.ctypes.data, ref_length, q.ctypes.data,
                        query_length, lv_error)


def get_ref_bases(ref_bin: np.ndarray, offset: int, length: int,
                  forward: bool) -> np.ndarray:
    """Native 2-bit reference unpack (csrc/goldhot.c); == gold get_ref."""
    out = np.empty(length, np.uint8)
    _LIB.get_ref_bases(ref_bin.ctypes.data, len(ref_bin) * 4, offset,
                       length, 1 if forward else 0, out.ctypes.data)
    return out


def mem_run(qbuf: np.ndarray, qi: int, t: np.ndarray, ti: int,
            forward: bool, maxlen: int) -> int:
    """Native exact-match run (csrc/goldhot.c); == gold _mem_q."""
    return _LIB.mem_run(qbuf.ctypes.data, len(qbuf), qi, t.ctypes.data,
                        len(t), ti, 1 if forward else 0, maxlen)


def sort_unique_u64(vals: np.ndarray):
    """Native radix np.unique(return_inverse) (csrc/buildhot.c).
    Returns (unique values, int64 inverse) or None on alloc failure."""
    n = len(vals)
    uniq = np.empty(n, np.uint64)
    inv = np.empty(n, np.int64)
    nu = _LIB.sort_unique_u64(vals.ctypes.data, n, uniq.ctypes.data,
                              inv.ctypes.data)
    if nu < 0:
        return None
    return uniq[:nu].copy(), inv


def build_exist_tables(text: np.ndarray, l_ek: int, hash_mask: int,
                       ek0: np.ndarray, ek1: np.ndarray) -> None:
    """Native existence-table build (csrc/goldhot.c); == the chunked
    numpy hashing in index/build.py."""
    _LIB.build_exist_tables(text.ctypes.data, len(text), l_ek, hash_mask,
                            ek0.ctypes.data, ek1.ctypes.data)


def unitig_walk(succ: np.ndarray, is_start: np.ndarray,
                is_end: np.ndarray, first_base: np.ndarray):
    """Native serial unitig walk (csrc/buildhot.c); == the index
    builder's pointer-doubling derivation of (uid, offset, prev_char).
    Returns (uid, off, prev_char, n_uni) or None (cycle -> fallback)."""
    n = len(succ)
    uid = np.empty(n, np.int64)
    off = np.empty(n, np.int64)
    pc = np.empty(n, np.uint8)
    n_uni = _LIB.unitig_walk(succ.ctypes.data, is_start.ctypes.data,
                             is_end.ctypes.data, first_base.ctypes.data,
                             n, uid.ctypes.data, off.ctypes.data,
                             pc.ctypes.data)
    if n_uni < 0:
        return None
    return uid, off, pc, int(n_uni)


def unitig_walk_stream(succ32, is_start, is_end, first_base, pos2k,
                       prevc_pos, uni_end_kmer, uni_len_out):
    """Position-ordered streaming walk (csrc/buildhot.c) for the
    external builder: sequential writes into the memmapped outputs,
    int32 successor table in RAM. Returns n_uni."""
    n = len(succ32)
    n_uni = _LIB.unitig_walk_stream(
        succ32.ctypes.data, is_start.ctypes.data, is_end.ctypes.data,
        first_base.ctypes.data, n, pos2k.ctypes.data,
        prevc_pos.ctypes.data, uni_end_kmer.ctypes.data,
        uni_len_out.ctypes.data)
    if n_uni < 0:
        raise RuntimeError("unitig walk found a start-less cycle")
    return int(n_uni)


def unitig_walk_into(succ, is_start, is_end, first_base, uid, off, pc):
    """unitig_walk writing into caller-provided (memmapped) outputs —
    the external builder's RAM-bounded variant. Arrays may be
    np.memmap; the walk touches each element once."""
    n = len(succ)
    n_uni = _LIB.unitig_walk(succ.ctypes.data, is_start.ctypes.data,
                             is_end.ctypes.data, first_base.ctypes.data,
                             n, uid.ctypes.data, off.ctypes.data,
                             pc.ctypes.data)
    if n_uni < 0:
        raise RuntimeError("unitig walk found a start-less cycle")
    return int(n_uni)


def resolve_tree_m2(arows: np.ndarray, m3_threshold: int,
                    max_dis_minus: int, max_waiting_len: int):
    """Native M2 chaining (csrc/goldhot.c); == gold resolve_tree for
    < m3_threshold anchors. arows: (n, 14) int64 anchor rows
    (classify_dir cols + direction). Returns (chain_rows (nc, 14),
    anc3 (m, 3)) views into per-thread scratch, or None (M3 / caps —
    caller falls back)."""
    chains = _scratch("rt_chains", (64, 14))
    anc3 = _scratch("rt_anc3", (64, 3))
    nc = _LIB.resolve_tree_m2(arows.ctypes.data, len(arows), m3_threshold,
                              max_dis_minus, max_waiting_len,
                              chains.ctypes.data, 64, anc3.ctypes.data, 64)
    if nc < 0:
        return None
    ncnt = int(chains[:nc, 10:12].sum(axis=0)[1]) if nc else 0
    return chains[:nc], anc3[:ncnt]


def rescore_finish(params: np.ndarray, chains: np.ndarray,
                   anc3: np.ndarray) -> int:
    """Native delete_small_score_rst + detect_primary
    (csrc/rescorehot.c); chains (nc, 14) rewritten in place. Returns the
    final chain count or -1 (caller falls back)."""
    return _LIB.rescore_finish(params.ctypes.data, chains.ctypes.data,
                               len(chains), anc3.ctypes.data)


import threading as _threading

_TLS = _threading.local()


def _scratch(name, shape, dtype=np.int64):
    """Per-thread scratch arrays: the C kernels release the GIL, so the
    host engine can run under a thread pool."""
    buf = getattr(_TLS, name, None)
    if buf is None:
        buf = np.empty(shape, dtype)
        setattr(_TLS, name, buf)
    return buf


def classify_dir(ctx: np.ndarray, buf: np.ndarray, base: int,
                 read_len: int, seeds: np.ndarray, mode: int):
    """Native fast/slow seeding ladder (csrc/goldhot.c classify_dir);
    == gold fast_classify (mode 0) / slow_classify (mode 1). Returns an
    (n, 13) int64 row view (11 map_seed cols + seed_id + useless) or
    None when the caller must fall back."""
    out = _scratch("cd_out", 13 * 8192)
    n = _LIB.classify_dir(ctx.ctypes.data, buf.ctypes.data, len(buf),
                          base, read_len, seeds.ctypes.data, len(seeds),
                          mode, out.ctypes.data, 8192)
    if n < 0:
        return None
    return out[: 13 * n].reshape(n, 13)





def map_seed(ctx: np.ndarray, buf: np.ndarray, base: int, read_len: int,
             sp: int, read_offset: int, match_len: int, sa_sp: int,
             sa_sp_l: int):
    """Native map_seed (csrc/goldhot.c); == gold map_seed. Returns
    (score, rows) where rows is an (n, 11) int64 view of anchor fields,
    or (0, None) when the row cap overflowed (caller falls back)."""
    out = _scratch("ms_out", 1 + 11 * 1100)
    score = _LIB.map_seed(ctx.ctypes.data, buf.ctypes.data, len(buf),
                          base, read_len, sp, read_offset, match_len,
                          sa_sp, sa_sp_l, out.ctypes.data, 1100)
    if score == -1:
        return 0, None
    n = int(out[0])
    return int(score), out[1 : 1 + 11 * n].reshape(n, 11)





def fm_mem_search(fm_ptrs, string, str_i, pre_v, max_rst, l_min_mth,
                  l_max_mth, l_pre_idx, spset_ptrs):
    """Native FM backward MEM search (csrc/goldhot.c); == gold
    bwt_mem_search. fm_ptrs / spset_ptrs are the pinned pointer tuples
    from FM.nat_ptrs / SpSet.nat_ptrs. Returns an (n, 4) int64 view of
    [match_len, sp, sa_sp(-1 = MAX_U64), sa_sp_l] rows."""
    out = _scratch("fm_out", (64, 4))
    n = _LIB.fm_mem_search(
        *fm_ptrs, string.ctypes.data, str_i, pre_v, max_rst, l_min_mth,
        l_max_mth, l_pre_idx, *spset_ptrs, out.ctypes.data, len(out))
    return out[:n]


def store_kmers_vals(bin_read: np.ndarray, n_kmers: int, l_ek: int,
                     single_base_max: int) -> np.ndarray:
    """Native rolling e-kmer values (csrc/goldhot.c); == gold
    store_kmers_mask."""
    out = np.zeros(max(n_kmers, 0), np.uint64)
    if n_kmers > 0:
        _LIB.store_kmers_vals(bin_read.ctypes.data, n_kmers, l_ek,
                              single_base_max, out.ctypes.data)
    return out





def lazy_islands(bin_read: np.ndarray, n_kmers: int, l_ek: int,
                 single_base_max: int, ek0: np.ndarray, ek1: np.ndarray,
                 hash_mask: int, step_ek: int, seed_range: int,
                 forward: bool):
    """Native stride-3 island walk with on-demand existence probes
    (csrc/goldhot.c); == gold exist_hits + search_islands + mark_top.
    Returns (seeds (n, 3) int32 copy, total_score)."""
    cap = max(64, n_kmers // 2 + 4)
    out = np.empty((cap, 3), np.int32)
    total = _scratch("lz_total", 1)
    n = _LIB.lazy_islands(bin_read.ctypes.data, n_kmers, l_ek,
                          single_base_max, ek0.ctypes.data,
                          ek1.ctypes.data, hash_mask, step_ek, seed_range,
                          1 if forward else 0, out.ctypes.data, cap,
                          total.ctypes.data)
    assert n >= 0, "lazy_islands cap"
    return out[:n], int(total[0])


def exist_hits(bin_read: np.ndarray, n_kmers: int, l_ek: int,
               single_base_max: int, ek0: np.ndarray, ek1: np.ndarray,
               hash_mask: int) -> np.ndarray:
    """Native e-kmer probe mask (csrc/goldhot.c); == gold
    store_kmers_mask + exist_mask."""
    out = np.zeros(n_kmers, np.uint8)
    if n_kmers > 0:
        _LIB.exist_hits(bin_read.ctypes.data, n_kmers, l_ek,
                        single_base_max, ek0.ctypes.data, ek1.ctypes.data,
                        hash_mask, out.ctypes.data)
    return out.view(bool)


def sdp_match(q_bg: int, q_ed: int, qbuf: np.ndarray, qbase: int,
              rkvals: np.ndarray, rkpos: np.ndarray,
              t_arr: np.ndarray, t0: int, t_len: int, t_st: int,
              forward: bool, over_search: int, k9: int, sms: list) -> None:
    """Native 9-mer match harvest (csrc/goldhot.c); == gold sdp_match.
    Appends [q, t, len, 0] rows to sms."""
    out = _scratch("sms_out", (4096, 4))
    n = _LIB.sdp_match(
        q_bg & 0xFFFFFFFF, q_ed & 0xFFFFFFFF, qbuf.ctypes.data, len(qbuf),
        qbase, rkvals.ctypes.data, rkpos.ctypes.data, len(rkvals),
        t_arr.ctypes.data, len(t_arr), t0, t_len, t_st & 0xFFFFFFFF,
        1 if forward else 0, over_search, k9, out.ctypes.data, len(out))
    if n < 0:
        _TLS.sms_out = np.empty((-n + 64, 4), np.int64)
        return sdp_match(q_bg, q_ed, qbuf, qbase, rkvals, rkpos, t_arr, t0,
                         t_len, t_st, forward, over_search, k9, sms)
    for k in range(n):
        sms.append([int(out[k, 0]), int(out[k, 1]), int(out[k, 2]), 0])


CHAIN_CAP = 64


def classify_batch(dp: np.ndarray, seqs: bytes, lens: np.ndarray,
                   effs: np.ndarray):
    """Native per-read classify driver over a batch (csrc/driver.c);
    == ClassifyEngine._classify_read_rows per read. Returns
    (meta (n,4) [status, n_chains, n_anchors, fast], chains
    (n, CHAIN_CAP, 14)) — both views into per-thread scratch; a read
    with meta[i,0] < 0 needs the python fallback path."""
    n = len(lens)
    meta = _scratch_n("cb_meta", n, 4)
    chains = _scratch_n("cb_chains", n, CHAIN_CAP * 14)
    rc = _LIB.classify_batch(dp.ctypes.data, seqs, lens.ctypes.data,
                             effs.ctypes.data, n, meta.ctypes.data,
                             chains.ctypes.data, CHAIN_CAP)
    if rc < 0:
        raise MemoryError("classify_batch scratch allocation failed")
    return (meta[:n].reshape(n, 4),
            chains[:n].reshape(n, CHAIN_CAP, 14))


def classify_batch_sam(dp: np.ndarray, seqs: bytes, lens: np.ndarray,
                       effs: np.ndarray, names: bytes,
                       name_offs: np.ndarray, quals: bytes | None,
                       ref_names: bytes, ref_offs: np.ndarray,
                       max_sec_n: int, output_seq: bool):
    """classify_batch with the SAM formatter fused in (csrc/driver.c);
    == classify_batch + io.sam.format_sam per read. Returns
    (meta (n,4), sam_text bytes, out_offs (n+1)) — a read with
    meta[i,0] < 0 has an empty text slice and needs the python path."""
    n = len(lens)
    meta = _scratch_n("cbs_meta", n, 4)
    offs = _scratch_n("cbs_offs", n + 1, 1).reshape(-1)
    cap = len(seqs) * (2 if output_seq else 0) + len(names) + 256 * n + 4096
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        w = _LIB.classify_batch_sam(
            dp.ctypes.data, seqs, lens.ctypes.data, effs.ctypes.data, n,
            names, name_offs.ctypes.data, quals, ref_names,
            ref_offs.ctypes.data, max_sec_n, 1 if output_seq else 0,
            meta.ctypes.data, buf, cap, offs.ctypes.data)
        if w == -(1 << 63):
            raise MemoryError("classify_batch_sam scratch allocation")
        if w >= 0:
            return meta[:n].reshape(n, 4), buf.raw[:w], offs[: n + 1]
        cap = -w + 4096
    raise RuntimeError("classify_batch_sam buffer sizing failed")


def _scratch_n(name, n, row_width, dtype=np.int64):
    """Per-thread scratch with a grow-to-fit leading dimension."""
    buf = getattr(_TLS, name, None)
    if buf is None or len(buf) < n:
        buf = np.empty((max(n, 64), row_width), dtype)
        setattr(_TLS, name, buf)
    return buf


def islands_batch(hits: np.ndarray, n_kmers: np.ndarray, dirs: np.ndarray,
                  step_ek: int, seed_range: int):
    """Segment + mark_top every strand's hit row in one native call.

    hits: (S, W) uint8 0/1 rows; n_kmers, dirs: (S,) int32.
    Returns (seeds (n,3) int32, offs (S,) int64, counts (S,) int64,
    totals (S,) int64). See csrc/islands.c.
    """
    assert available()
    S, W = hits.shape
    hits = np.ascontiguousarray(hits, dtype=np.uint8)
    n_kmers = np.ascontiguousarray(n_kmers, dtype=np.int32)
    dirs = np.ascontiguousarray(dirs, dtype=np.int32)
    cap = max(1024, int(n_kmers.clip(min=0).sum() // 3) + 64 * S)
    for _ in range(2):
        out = np.empty((cap, 3), np.int32)
        offs = np.empty((S,), np.int64)
        counts = np.empty((S,), np.int64)
        totals = np.empty((S,), np.int64)
        need = _LIB.islands_batch(
            hits.ctypes.data, hits.strides[0], n_kmers.ctypes.data,
            dirs.ctypes.data, S, step_ek, seed_range, out.ctypes.data,
            cap, offs.ctypes.data, counts.ctypes.data, totals.ctypes.data)
        if need <= cap:
            return out, offs, counts, totals
        cap = int(need) + 64
    raise RuntimeError("islands_batch buffer sizing failed")
