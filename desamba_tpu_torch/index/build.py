"""Index construction (replaces Jellyfish + `kmersort` + `deSAMBA index`).

Builds, from a reference FASTA, every structure the classifier needs — with
byte-level parity to the reference's 8-file index (verified by
tests/test_index_parity.py against an index built by the reference binary).

Key departure from the reference implementation (not from its *semantics*):
the reference synthesizes the BWT of the unitig text via an on-disk merge of
sorted 31-mers and "special" boundary k-mers, then recovers suffix positions
with a serial LF-walk over the whole BWT (src/idx.c:1163-1237). Since every
31-mer occurs exactly once in the unitig set, the row order and every row's
text position are directly constructible — so we build the full SA (row ->
text position) in vectorized numpy with no suffix sorting and no LF walks.
On TPU this makes seed location a pure gather (engine/device), and here it
makes index build fully array-parallel.

Reference algorithms mirrored:
  - maximal-ACGT-run k-mer extraction        (src/idx_sort.c, jellyfish)
  - dBG edge marking + head/tail collection  (src/idx.c:125-306)
  - setLabel start/end rules                 (src/idx.c:392-513)
  - unitig walk + prev-char stash            (src/idx.c:722-854)
  - per-reference unitig occurrence scan     (src/idx.c:554-706)
  - sp-kmer generation + stable sort + merge (src/idx.c:345-390,514-553,856-881)
  - hash_index build + compression           (src/idx.c:333-343,944-961)
  - existence filter                         (src/idx.c:964-1026)
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..constants import (
    B_KMER,
    CHAR_DOLLAR,
    CHAR_HASH,
    EKMER_PARAMS,
    L_PRE_IDX,
    MIN_UNI_L,
    SINGLE_BASE_MAX_RATIO,
)
from ..io import native
from ..io.fastx import read_fastx
from .kmers import (
    BIN_BIT,
    BIT,
    hash64_1,
    hash64_2,
    pack_2bit,
    rolling_kmers,
    valid_kmer_mask,
)

U64 = np.uint64


@dataclasses.dataclass
class IndexData:
    """All index arrays (host side). See store.py for (de)serialization."""

    # BWT rows (n_rows = n_uni + n_kmer + 30*n_uni)
    row_char: np.ndarray      # uint8, BWT char per row (0-3 ACGT, 4 '#', 5 '$')
    row_pos: np.ndarray       # int64, text position of each row's suffix
    rank: np.ndarray          # int64[6], first row per char class (src/bwt.c:133-137)
    hash13: np.ndarray        # uint32/64[2^26+1], 13-mer -> row interval start
    dollar_pos: int           # row of the '$' suffix

    # unitigs / text
    n_uni: int
    uni_len: np.ndarray       # uint32[n_uni+1], last entry sentinel length 0
    uni_ref_list: np.ndarray  # uint32[n_uni+1], CSR into ref_pos (reference quirks kept)
    uni_start: np.ndarray     # int64[n_uni+1], text start of each unitig (derived)
    text_len: int

    # reference occurrence fan-out
    rp_global_off: np.ndarray  # int64[n_occ]
    rp_ref_id: np.ndarray      # int32[n_occ]
    rp_dir: np.ndarray         # uint8[n_occ]

    # reference sequences
    ref_bin: np.ndarray       # uint8, 2-bit packed reference, 4bp/byte
    ref_name: list            # str per sequence
    ref_len: np.ndarray       # int64 per sequence
    ref_off: np.ndarray       # int64 per sequence (global offset)

    # existence filter
    ekmer0: np.ndarray        # uint8 bit table
    ekmer1: np.ndarray        # uint8 bit table
    e_kmer_size: int          # bytes per table
    len_e_kmer: int
    e_hash_mask: int
    single_base_max: int

    # occ: cumulative char counts per block for rank queries (derived)
    occ_prefix: np.ndarray | None = None  # int64[5, n_rows+1] lazily built

    def build_occ_prefix(self):
        if self.occ_prefix is None:
            n = len(self.row_char)
            occ = np.zeros((5, n + 1), dtype=np.int64)
            for c in range(5):
                np.cumsum(self.row_char == c, out=occ[c, 1:])
            self.occ_prefix = occ
        return self.occ_prefix


def _read_reference(fasta_path: str):
    names, lens, seq_codes = [], [], []
    for rec in read_fastx(fasta_path):
        names.append(rec.name)
        lens.append(len(rec.seq))
        seq_codes.append(np.frombuffer(rec.seq.encode(), dtype=np.uint8))
    return names, np.array(lens, dtype=np.int64), seq_codes


def _runs_of(valid: np.ndarray):
    """Maximal True runs as (start, end) pairs."""
    if len(valid) == 0:
        return np.empty((0, 2), dtype=np.int64)
    v = valid.astype(np.int8)
    d = np.diff(np.concatenate([[0], v, [0]]))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    return np.stack([starts, ends], axis=1)


def _popcount4(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint8)
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)


def _needs_external(fasta_path: str) -> bool:
    """The array-parallel build peaks at ~100 bytes per reference base
    plus a ~3 GB dense hash13 stage (round-2 memory-pass measurements in
    BASELINE.md). Inputs whose estimate exceeds available RAM route to
    the external-memory builder (build_ext.py: disk-bucketed k-mer sort
    + memmapped tables — the reference's own strategy,
    src/idx_sort.c:86-194)."""
    import os

    if os.environ.get("DESAMBA_FORCE_EXTERNAL_BUILD"):
        return True
    size = os.path.getsize(fasta_path)
    need = int(size * 120) + 3 * (1 << 30)
    try:
        with open("/proc/meminfo") as f:
            avail_kb = next(int(line.split()[1]) for line in f
                            if line.startswith("MemAvailable:"))
        avail = avail_kb * 1024
    except (OSError, StopIteration):
        return False
    return need > avail


def build_index(fasta_path: str, progress=lambda *_: None) -> IndexData:
    if _needs_external(fasta_path):
        from .build_ext import build_index_external

        progress("input exceeds the in-RAM budget; external-memory build")
        return build_index_external(fasta_path, progress=progress)
    names, lens, raw_codes = _read_reference(fasta_path)
    if not names:
        raise ValueError(f"{fasta_path}: no sequences")
    codes = [BIT[c] for c in raw_codes]  # 0-3 ACGT, 4 other

    # ---- reference packing + offsets (src/idx.c:577-603) -------------------
    ref_off = np.concatenate([[0], np.cumsum(lens)])[:-1]
    ref_bin = pack_2bit(np.concatenate([BIN_BIT[c] for c in raw_codes]))
    del raw_codes
    progress("ref packed")

    # ---- sorted unique 31-mers (jellyfish + kmersort equivalent) ------------
    all_vals = []
    for c in codes:
        runs = _runs_of(c < 4)
        for s, e in runs:
            if e - s < B_KMER:
                continue
            all_vals.append(rolling_kmers(c[s:e], B_KMER))  # L-30 kmers
    if not all_vals:
        raise ValueError("no k-mers in reference")
    run_sizes = np.array([len(v) for v in all_vals], dtype=np.int64)
    run_off = np.concatenate([[0], np.cumsum(run_sizes)])
    vals_cat = np.concatenate(all_vals)
    del all_vals  # the concatenated copy is the only one the passes need
    # return_inverse gives every occurrence's row in kmer_v for free — a
    # searchsorted join here costs ~1.4 us/lookup (latency-bound binary
    # search), 15+ s at RefSeq-viral scale. The native radix path is the
    # kmersort equivalent (~4x numpy's introsort at genome scale).
    res = native.sort_unique_u64(vals_cat) if native.available() else None
    if res is not None:
        kmer_v, pos_in_kv = res
    else:
        kmer_v, pos_in_kv = np.unique(vals_cat, return_inverse=True)
        pos_in_kv = pos_in_kv.astype(np.int64)
    n_kmer = len(kmer_v)
    progress(f"{n_kmer} unique 31-mers")

    # ---- dBG edges (src/idx.c:125-306) --------------------------------------
    # Adjacent in-run k-mer pairs ARE the edge set: pair (i, i+1) within a
    # run is an edge SRC->DST whose char is DST's last base (= SRC's next
    # base), and whose in-char at DST is SRC's first base. All neighbor
    # queries below use these observed pairs — no key reconstruction.
    adj = np.ones(len(vals_cat) - 1, dtype=bool) if len(vals_cat) > 1 else np.zeros(0, bool)
    if len(run_off) > 2:
        adj[run_off[1:-1] - 1] = False
    pair_src = pos_in_kv[:-1][adj]
    pair_dst = pos_in_kv[1:][adj]
    pair_in_char = ((vals_cat[:-1][adj] >> U64((B_KMER - 1) * 2)) & U64(3)).astype(np.uint8)
    pair_out_char = (vals_cat[1:][adj] & U64(3)).astype(np.uint8)
    in_edges = np.zeros(n_kmer, dtype=np.uint8)
    out_edges = np.zeros(n_kmer, dtype=np.uint8)
    # OR-accumulate per char class: within a class every update writes the
    # same bit, so duplicate indices in a buffered fancy |= are harmless.
    # (ufunc.at is ~100x slower; this is the build's hottest line at scale)
    for ch in range(4):
        in_edges[pair_dst[pair_in_char == ch]] |= np.uint8(1 << ch)
        out_edges[pair_src[pair_out_char == ch]] |= np.uint8(1 << ch)
    heads = pos_in_kv[run_off[:-1]]
    tails = pos_in_kv[run_off[1:] - 1]
    progress("dBG edges")

    # ---- setLabel (src/idx.c:392-513) ---------------------------------------
    in_cnt = _popcount4(in_edges)
    out_cnt = _popcount4(out_edges)
    is_start = np.zeros(n_kmer, dtype=bool)
    is_end = np.zeros(n_kmer, dtype=bool)
    is_start[in_cnt != 1] = True
    is_end[out_cnt != 1] = True
    is_start[heads] = True
    is_end[tails] = True
    # neighbors of multi/zero-edge nodes and of heads/tails get the
    # complementary flag (cutOffMulEdges + handleFrstLastKmer); every
    # (node, edge-char) neighbor is observed as at least one in-run pair,
    # so propagation over pairs covers exactly the edge set
    marked_start = is_start.copy()  # nodes whose in-neighbors must become ends
    marked_end = is_end.copy()      # nodes whose out-neighbors must become starts
    is_end[pair_src[marked_start[pair_dst]]] = True
    is_start[pair_dst[marked_end[pair_src]]] = True
    n_uni = int(is_end.sum())
    assert int(is_start.sum()) == n_uni, "start/end count mismatch"
    progress(f"{n_uni} unitigs")

    # ---- unitig walk via pointer doubling (src/idx.c:722-854) --------------
    # successor of each non-end kmer (single out-edge)
    out_char = np.full(n_kmer, 255, dtype=np.uint8)
    nz = out_cnt > 0
    # lowest set bit index (the walk picks the lowest, src/idx.c:745)
    ob = out_edges.astype(np.int16)
    low = np.where(ob & 1, 0, np.where(ob & 2, 1, np.where(ob & 4, 2, 3)))
    out_char[nz] = low[nz]
    # int32 walk arrays halve the doubling loop's footprint (indices and
    # distances are < n_rows; the guard upgrades past the int32 range)
    idt = np.int64 if n_kmer + 31 * n_uni >= (1 << 31) else np.int32
    succ = np.arange(n_kmer, dtype=idt)
    walkable = ~is_end
    # walkable nodes have exactly one out-edge; its destination appears as
    # an observed pair whose edge char equals out_char[src]
    sel = walkable[pair_src] & (pair_out_char == out_char[pair_src])
    succ[pair_src[sel]] = pair_dst[sel]
    del vals_cat, pos_in_kv, pair_src, pair_dst, pair_in_char, pair_out_char, adj
    start_locs = np.flatnonzero(is_start)
    first_base_k = ((kmer_v >> U64((B_KMER - 1) * 2)) & U64(3)).astype(
        np.uint8)
    kmer_uid = kmer_off = prev_char = None
    if native.available():
        # serial per-unitig walk in C: O(n) successor lookups instead of
        # the doubling loop's O(n log L) random gathers (~40x at 256 MB)
        walked = native.unitig_walk(succ.astype(np.int64),
                                    is_start.view(np.uint8),
                                    is_end.view(np.uint8), first_base_k)
        if walked is not None:
            kmer_uid, kmer_off, prev_char, n_uni_w = walked
            assert n_uni_w == n_uni
            prev_char[start_locs[0]] = CHAR_DOLLAR
    if kmer_uid is None:
        # predecessor links for offset/char computation: invert succ
        pred = np.full(n_kmer, -1, dtype=idt)
        src = np.flatnonzero(walkable).astype(idt)
        pred[succ[src]] = src
        pred[is_start] = -1  # starts have no predecessor within a unitig
        # distance to start + head id via pointer doubling on pred
        jmp = np.where(pred >= 0, pred, np.arange(n_kmer, dtype=idt)).astype(idt)
        dist = (pred >= 0).astype(idt)
        for _ in range(64):
            nj = jmp[jmp]
            if np.array_equal(nj, jmp):
                break
            dist = dist + dist[jmp]
            jmp = nj
        else:
            raise AssertionError("unitig walk did not converge (cycle without start?)")
        head_idx = jmp  # start kmer index of each kmer's unitig
        assert is_start[head_idx].all(), "dBG contains a start-less cycle"
        # unitig ids: rank of start kmer (ascending order = reference order)
        uid_of_start = np.full(n_kmer, -1, dtype=idt)
        uid_of_start[start_locs] = np.arange(n_uni, dtype=idt)
        kmer_uid = uid_of_start[head_idx]
        kmer_off = dist  # offset of kmer within its unitig (0 = start)
        prev_char = np.empty(n_kmer, dtype=np.uint8)
        has_pred = pred >= 0
        prev_char[has_pred] = (kmer_v[pred[has_pred]]
                               >> U64((B_KMER - 1) * 2)).astype(np.uint8) & 0x3
        prev_char[is_start] = CHAR_HASH
        prev_char[start_locs[0]] = CHAR_DOLLAR
        del succ, pred, jmp, head_idx, uid_of_start, has_pred
    # unitig lengths: 31 + offset of end kmer
    end_locs = np.flatnonzero(is_end)
    uni_len = np.zeros(n_uni + 1, dtype=np.uint32)
    uni_len[kmer_uid[end_locs]] = (B_KMER + kmer_off[end_locs]).astype(np.uint32)
    end_kmer_of_uid = np.zeros(n_uni, dtype=U64)
    end_kmer_of_uid[kmer_uid[end_locs]] = kmer_v[end_locs]
    start_kmer_of_uid = kmer_v[start_locs]
    del walkable, low, ob, out_char, in_edges, out_edges, in_cnt, out_cnt
    del marked_start, marked_end, is_start, is_end
    progress("unitig walk")

    # ---- text geometry ------------------------------------------------------
    uni_start = np.zeros(n_uni + 1, dtype=np.int64)
    np.cumsum(uni_len[:n_uni].astype(np.int64) + 1, out=uni_start[1:])
    text_len = int(uni_start[n_uni])  # includes separators
    n_rows = n_uni + n_kmer + 30 * n_uni
    assert text_len == n_rows, (text_len, n_rows)

    # ---- unitig occurrences in the reference (src/idx.c:554-706) -----------
    occ_ref, occ_uid, occ_off = [], [], []
    for ref_id, c in enumerate(codes):
        runs = _runs_of(c < 4)
        for s, e in runs:
            if e - s < B_KMER:
                continue
            seg_vals = rolling_kmers(c[s:e], B_KMER)
            p = 0  # offset into run
            n_in_run = len(seg_vals)
            while True:
                u = np.searchsorted(start_kmer_of_uid, seg_vals[p])
                assert u < n_uni and start_kmer_of_uid[u] == seg_vals[p], "not a start"
                L = int(uni_len[u])
                if L >= MIN_UNI_L:
                    occ_ref.append(ref_id)
                    occ_uid.append(u)
                    occ_off.append(s + p)
                p += L - B_KMER + 1
                if p + 1 > n_in_run:
                    assert p == n_in_run, "run not tiled by unitigs"
                    break
    occ_ref = np.array(occ_ref, dtype=np.int64)
    occ_uid = np.array(occ_uid, dtype=np.int64)
    occ_off = np.array(occ_off, dtype=np.int64)
    # stable sort by unitig id (src/idx.c:673-678)
    order = np.argsort(occ_uid, kind="stable")
    occ_ref, occ_uid, occ_off = occ_ref[order], occ_uid[order], occ_off[order]
    n_occ = len(occ_uid)
    # ref_list CSR with the reference's gap quirks (src/idx.c:682-701)
    uni_ref_list = np.zeros(n_uni + 2, dtype=np.uint32)
    old = -1
    for i in range(n_occ):
        u = int(occ_uid[i])
        if u != old:
            if uni_ref_list[u] == 0:
                uni_ref_list[u] = i
            uni_ref_list[u + 1] = i + 1
            old = u
        else:
            uni_ref_list[u + 1] += 1
    uni_ref_list[n_uni] = n_occ  # sentinel unitig (src/idx.c:703-707)
    uni_ref_list = uni_ref_list[: n_uni + 1]
    rp_global_off = ref_off[occ_ref] + occ_off
    rp_ref_id = occ_ref.astype(np.int32)
    rp_dir = np.ones(n_occ, dtype=np.uint8)  # FORWARD only (desc.h:6 disabled)
    progress(f"{n_occ} unitig occurrences")

    # ---- BWT rows -----------------------------------------------------------
    # Part A: n_uni separator rows, char = last base of each unitig
    # (src/idx.c:862-864), suffix position = separator position.
    rowA_char = (end_kmer_of_uid & U64(3)).astype(np.uint8)
    rowA_pos = uni_start[1 : n_uni + 1] - 1

    # Part B: merge of normal kmers and sp kmers (truncated end kmers).
    # sp kmer (u, sp_pos=k in 1..30): value = low k bases of end kmer,
    # char = base (k+1) from the end, suffix position = unitig end - k.
    k_arr = np.arange(30, 0, -1, dtype=np.uint64)  # generation order per unitig
    sp_uid = np.repeat(np.arange(n_uni, dtype=np.int64), 30)
    sp_k = np.tile(k_arr, n_uni)
    ek = np.repeat(end_kmer_of_uid, 30)
    sp_val = ek & ((U64(1) << (sp_k * U64(2))) - U64(1))
    sp_char = ((ek >> (sp_k * U64(2))) & U64(3)).astype(np.uint8)
    sp_aligned = sp_val << ((U64(B_KMER) - sp_k) * U64(2))
    sp_pos_text = uni_start[sp_uid] + uni_len[sp_uid].astype(np.int64) - sp_k.astype(np.int64)

    # normal kmer rows: aligned value = kmer itself; pos from walk
    nk_pos_text = uni_start[kmer_uid] + kmer_off

    # merge: sort by (aligned, is_normal, sp_pos asc, original sp order)
    # (spkmer_cmp_l src/idx.c:856-881 + findInsertPos merge src/idx.c:309-331).
    # One uint8 tie key encodes (is_normal, sp_pos): sp rows carry k in
    # 1..30, normal rows 255 — same order as the 3-key lexsort since k < 255
    # and normal kmers are unique (no normal-vs-normal ties).
    n_sp = len(sp_val)
    m_aligned = np.empty(n_sp + n_kmer, dtype=U64)
    m_aligned[:n_sp] = sp_aligned
    m_aligned[n_sp:] = kmer_v
    m_tie = np.empty(n_sp + n_kmer, dtype=np.uint8)
    m_tie[:n_sp] = sp_k.astype(np.uint8)
    m_tie[n_sp:] = 255
    del sp_val, sp_aligned, ek
    morder = np.lexsort((m_tie, m_aligned))
    row_char = np.empty(n_rows, dtype=np.uint8)
    row_char[:n_uni] = rowA_char
    np.take(np.concatenate([sp_char, prev_char]), morder,
            out=row_char[n_uni:])
    row_pos = np.empty(n_rows, dtype=np.int64)
    row_pos[:n_uni] = rowA_pos
    np.take(np.concatenate([sp_pos_text, nk_pos_text]), morder,
            out=row_pos[n_uni:])
    m_char = row_char[n_uni:]
    m_pos = row_pos[n_uni:]
    del sp_char, sp_pos_text, prev_char
    # row order sanity: positions form a permutation
    progress("BWT rows merged")

    # ---- hash13 (src/idx.c:333-343,944-961) --------------------------------
    # key per merged row: top 13 bases; sp rows with sp_pos < 13 have no key
    m_key = (m_aligned >> U64((B_KMER - L_PRE_IDX) * 2)).astype(
        np.uint32)[morder]
    m_haskey = (m_tie >= L_PRE_IDX)[morder]
    del m_aligned, m_tie, morder
    # 2^26-entry working arrays: int32 unless rows exceed the int32 range
    # (RefSeq-"all" scale); the dense allocations dominate small builds
    rdt = np.int64 if n_uni + len(m_key) + 1 >= (1 << 31) else np.int32
    rows_b = np.arange(n_uni, n_uni + len(m_key), dtype=rdt)
    keys = m_key[m_haskey].astype(np.int64)
    krows = rows_b[m_haskey]
    # first/last row per key (keys are non-decreasing over merged order)
    n_keys = 1 << (2 * L_PRE_IDX)
    first = np.full(n_keys, -1, dtype=rdt)
    last = np.full(n_keys, -1, dtype=rdt)
    uk, ui = np.unique(keys, return_index=True)
    first[uk] = krows[ui]
    # last occurrence of each key = element before the next key's first
    last_idx = np.concatenate([ui[1:], [len(keys)]]) - 1
    last[uk] = krows[last_idx] + 1
    # compression: missing keys forward-fill the previous key's end
    # (src/idx.c:944-961); initial fill value 0
    present = first >= 0
    ffill = np.where(present, last, 0)
    idx_src = np.where(present, np.arange(n_keys, dtype=rdt), rdt(-1))
    np.maximum.accumulate(idx_src, out=idx_src)
    prev_end = np.where(idx_src >= 0, ffill[np.maximum(idx_src, 0)], 0)
    # hash13[k]: start of k if present else end of previous present key;
    # the "previous" for position k excludes k itself when absent.
    prev_excl = np.concatenate([[0], prev_end[:-1]])
    hdt = np.uint64 if n_uni + len(m_key) + 1 >= (1 << 32) else np.uint32
    hash13 = np.empty(n_keys + 1, dtype=hdt)
    hash13[:n_keys] = np.where(present, first, prev_excl)
    hash13[n_keys] = prev_end[-1]
    del (m_key, m_haskey, keys, krows, rows_b, first, last, uk, ui,
         last_idx, present, ffill, idx_src, prev_end, prev_excl)
    progress("hash13")

    # ---- rank (src/bwt.c:133-137, load fixup src/bwt.c:81) -----------------
    counts = np.bincount(row_char, minlength=6).astype(np.int64)
    rank = np.zeros(6, dtype=np.int64)
    rank[0] = counts[4] + counts[5]
    rank[1] = rank[0] + counts[0]
    rank[2] = rank[1] + counts[1]
    rank[3] = rank[2] + counts[2]
    rank[4] = 0
    rank[5] = rank[0] - 1
    dollar_pos = n_uni - 1

    # ---- existence filter (src/idx.c:964-1026) ------------------------------
    e_kmer_size = None
    forced = os.environ.get("DESAMBA_FORCE_EKMER_SIZE")
    if forced:
        # test hook: force a table tier (e.g. 268435456 -> len_e_kmer 17)
        # so the 17-20-mer probe paths are exercisable on small genomes;
        # the reference binary derives its parameters from the exported
        # exki value (src/idx.c:966-982), so differential tests stay valid
        e_kmer_size = int(forced)
        mask_bits, len_e_kmer = EKMER_PARAMS[e_kmer_size]
    else:
        for size, (bits, le) in EKMER_PARAMS.items():
            if n_kmer < (1 << (bits + 1)) // 9:
                e_kmer_size, mask_bits, len_e_kmer = size, bits, le
                break
    if e_kmer_size is None:
        e_kmer_size, (mask_bits, len_e_kmer) = 1 << 34, EKMER_PARAMS[1 << 34]
    e_hash_mask = (1 << mask_bits) - 1
    single_base_max = int(SINGLE_BASE_MAX_RATIO * len_e_kmer)
    # unitig text chars: each kmer start contributes its first base; the end
    # kmer contributes the final 30 bases; separators stay 4
    text = np.full(text_len, 4, dtype=np.uint8)
    first_base = (kmer_v >> U64((B_KMER - 1) * 2)).astype(np.uint8)
    text[nk_pos_text] = first_base
    tail_pos = uni_start[:n_uni] + uni_len[:n_uni].astype(np.int64) - B_KMER
    for j in range(1, B_KMER):
        b = (end_kmer_of_uid >> U64((B_KMER - 1 - j) * 2)).astype(np.uint8) & 0x3
        text[tail_pos + j] = b
    ekmer0 = np.zeros(e_kmer_size, dtype=np.uint8)
    ekmer1 = np.zeros(e_kmer_size, dtype=np.uint8)
    if native.available():
        # one native pass sets both bit tables (~20x the chunked numpy)
        native.build_exist_tables(text, len_e_kmer, e_hash_mask, ekmer0,
                                  ekmer1)
    else:
        m = valid_kmer_mask(text < 4, len_e_kmer)
        text3 = np.minimum(text, 3)
        # chunked: the hash intermediates are ~33 bytes per position.
        # Bit-sets OR per bit lane with fancy |= (duplicates write the
        # same value; ufunc.at is ~100x slower)
        CH = 1 << 26
        for lo in range(0, len(m), CH):
            hi = min(len(m), lo + CH)
            ekv = rolling_kmers(text3[lo : hi + len_e_kmer - 1],
                                len_e_kmer)[m[lo:hi]]
            h1 = (hash64_1(ekv) & U64(e_hash_mask)).astype(np.int64)
            h2 = (hash64_2(ekv) & U64(e_hash_mask)).astype(np.int64)
            for b in range(8):
                ekmer0[(h1[(h1 & 7) == b]) >> 3] |= np.uint8(0x80 >> b)
                ekmer1[(h2[(h2 & 7) == b]) >> 3] |= np.uint8(0x80 >> b)
    progress("existence filter")

    return IndexData(
        row_char=row_char,
        row_pos=row_pos,
        rank=rank,
        hash13=hash13,
        dollar_pos=dollar_pos,
        n_uni=n_uni,
        uni_len=uni_len,
        uni_ref_list=uni_ref_list,
        uni_start=uni_start,
        text_len=text_len,
        rp_global_off=rp_global_off.astype(np.int64),
        rp_ref_id=rp_ref_id,
        rp_dir=rp_dir,
        ref_bin=ref_bin,
        ref_name=names,
        ref_len=lens,
        ref_off=ref_off,
        ekmer0=ekmer0,
        ekmer1=ekmer1,
        e_kmer_size=e_kmer_size,
        len_e_kmer=len_e_kmer,
        e_hash_mask=e_hash_mask,
        single_base_max=single_base_max,
    )
