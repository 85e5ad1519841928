"""External-memory index construction (the reference-scale path).

The in-RAM builder (build.py) peaks at ~100 bytes per reference base:
fine for viral-scale, unreachable for the reference's 35 GB-FASTA /
160 GB-RAM envelope (the reference's README.md:50, jellyfish sizing
build-index:76-81). This builder mirrors the reference's external
strategy (12-base disk-bucketed k-mer sort, src/idx_sort.c:86-194;
re-scan + binary-search edge marking, src/idx.c:250-306) with
numpy-on-memmap mechanics:

  pass A  stream the FASTA; per ACGT-run emit (kmer u64, edge u16)
          records into 256 disk buckets by the k-mer's top 4 bases.
          The edge word carries the occurrence's in/out edge chars and
          head/tail flags, so the dBG needs no second genome scan.
  pass B  per bucket: sort, unique, OR the edge words -> append to a
          memmapped global sorted k-mer table + info table.
  labels  setLabel start/end rules + neighbor propagation via
          np.searchsorted against the memmapped k-mer table (the
          reference does the same lookups with its 2^26 prefix jump
          table, src/idx.c:74-110).
  walk    successor table (memmap) via searchsorted; the serial unitig
          walk runs in native C directly over the memmaps.
  merge   sp-kmers (30 per unitig, RAM) merge-join against the already
          sorted k-mer memmap — no global sort of the row set at all.
  outputs row_char/row_pos/isa/... written chunk-wise into memmaps.

Peak RSS is bounded by the dense hash13 stage + the largest bucket +
whatever page cache the OS keeps for the memmaps (reclaimable under
pressure). Byte-parity with build.py is asserted by
tests/test_build_external.py.
"""
from __future__ import annotations

import os
import shutil
import tempfile

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
from .build import IndexData, _popcount4, _runs_of
from .kmers import BIN_BIT, BIT, hash64_1, hash64_2, pack_2bit, rolling_kmers

U64 = np.uint64
N_BUCKETS = 256          # top 4 bases
REC_DT = np.dtype([("k", "<u8"), ("e", "<u2")])
CHUNK = 1 << 24          # positions per streaming chunk


def _mm(workdir: str, name: str, dtype, shape):
    # numpy scalar shapes serialize as np.int64(...) in the .npy header,
    # which literal_eval rejects on re-open — coerce to python ints
    shape = tuple(int(s) for s in shape)
    return np.lib.format.open_memmap(
        os.path.join(workdir, name + ".npy"), mode="w+", dtype=dtype,
        shape=shape)


def _emit_run_records(c_run, writers, counts):
    """One ACGT run -> (kmer, edge) records appended to bucket files.

    edge u16: bits 0-3 in-edge char bit (0 = head), bits 4-7 out-edge
    char bit (0 = tail), bit 8 head, bit 9 tail."""
    n_k = len(c_run) - B_KMER + 1
    for lo in range(0, n_k, CHUNK):
        hi = min(n_k, lo + CHUNK)
        vals = rolling_kmers(c_run[lo : hi + B_KMER - 1], B_KMER)
        e = np.zeros(hi - lo, np.uint16)
        # in edge: predecessor's first base = base[p-1]
        if lo == 0:
            e[0] |= 1 << 8  # head
            if hi > 1:
                e[1:] |= (1 << c_run[lo : hi - 1]).astype(np.uint16)
        else:
            e |= (1 << c_run[lo - 1 : hi - 1]).astype(np.uint16)
        # out edge: successor's last base = base[p+31]
        if hi == n_k:
            e[-1] |= 1 << 9  # tail
            out = c_run[lo + B_KMER : hi + B_KMER - 1]
            e[: hi - lo - 1] |= (16 << out).astype(np.uint16)
        else:
            out = c_run[lo + B_KMER : hi + B_KMER]
            e |= (16 << out).astype(np.uint16)
        bucket = (vals >> U64(56)).astype(np.int32)
        order = np.argsort(bucket, kind="stable")
        vals, e, bucket = vals[order], e[order], bucket[order]
        bounds = np.searchsorted(bucket, np.arange(N_BUCKETS + 1))
        rec = np.empty(hi - lo, REC_DT)
        rec["k"] = vals
        rec["e"] = e
        for b in range(N_BUCKETS):
            s, t = bounds[b], bounds[b + 1]
            if t > s:
                writers[b].write(rec[s:t].tobytes())
                counts[b] += t - s


def build_index_external(fasta_path: str, workdir: str | None = None,
                         progress=lambda *_: None) -> IndexData:
    """Build the same IndexData as build.build_index with bounded RAM.

    Large intermediates live in `workdir` (a temp dir by default,
    removed on success); the returned IndexData's big arrays are
    memmaps into that directory's `keep/` subtree, which the caller
    owns (save_index streams them out)."""
    own = workdir is None
    if own:
        workdir = tempfile.mkdtemp(prefix="desamba_build_")
    keep = os.path.join(workdir, "keep")
    os.makedirs(keep, exist_ok=True)
    bdir = os.path.join(workdir, "buckets")
    os.makedirs(bdir, exist_ok=True)

    # ---- pass A: stream FASTA -> ref_bin + bucket records ------------------
    names, lens, seq_off = [], [], []
    writers = [open(os.path.join(bdir, f"{b:03d}.rec"), "wb", buffering=1 << 20)
               for b in range(N_BUCKETS)]
    counts = [0] * N_BUCKETS
    packed_parts = []
    codes_store = os.path.join(workdir, "codes.bin")
    cfh = open(codes_store, "wb", buffering=1 << 20)
    total = 0
    for rec in read_fastx(fasta_path):
        names.append(rec.name)
        raw = np.frombuffer(rec.seq.encode(), np.uint8)
        lens.append(len(raw))
        seq_off.append(total)
        total += len(raw)
        c = BIT[raw]
        cfh.write(c.tobytes())
        packed_parts.append(pack_2bit(BIN_BIT[raw]))
        for s, e in _runs_of(c < 4):
            if e - s >= B_KMER:
                _emit_run_records(c[s:e], writers, counts)
    cfh.close()
    for w in writers:
        w.close()
    if not names:
        raise ValueError(f"{fasta_path}: no sequences")
    lens = np.array(lens, np.int64)
    ref_off = np.array(seq_off, np.int64)
    ref_bin = np.concatenate(packed_parts)
    del packed_parts
    codes_mm = np.memmap(codes_store, np.uint8, "r")
    progress("pass A (stream + bucket)")

    # ---- pass B: per-bucket sort-unique-OR ---------------------------------
    n_total = sum(counts)
    kmer_v = _mm(keep, "kmer_v", np.uint64, (max(n_total, 1),))
    kinfo = _mm(workdir, "kinfo", np.uint16, (max(n_total, 1),))
    n_kmer = 0
    for b in range(N_BUCKETS):
        path = os.path.join(bdir, f"{b:03d}.rec")
        if counts[b] == 0:
            os.unlink(path)
            continue
        rec = np.fromfile(path, REC_DT)
        os.unlink(path)
        order = np.argsort(rec["k"], kind="stable")
        k = rec["k"][order]
        e = rec["e"][order]
        first = np.ones(len(k), bool)
        first[1:] = k[1:] != k[:-1]
        starts = np.flatnonzero(first)
        uk = k[starts]
        ue = np.bitwise_or.reduceat(e, starts)
        kmer_v[n_kmer : n_kmer + len(uk)] = uk
        kinfo[n_kmer : n_kmer + len(uk)] = ue
        n_kmer += len(uk)
    os.rmdir(bdir)
    if n_kmer == 0:
        raise ValueError("no k-mers in reference")
    # shrink the memmaps to the unique count
    kmer_v.flush()
    kinfo.flush()
    kmer_v = _shrink(keep, "kmer_v", np.uint64, n_kmer)
    kinfo = _shrink(workdir, "kinfo", np.uint16, n_kmer)
    progress(f"{n_kmer} unique 31-mers (external)")

    # ---- setLabel (src/idx.c:392-513) ---------------------------------------
    in_bits = (kinfo & 0xF).astype(np.uint8)
    out_bits = ((kinfo >> 4) & 0xF).astype(np.uint8)   # RAM: 2 B/kmer
    head = (kinfo & (1 << 8)) != 0
    tail = (kinfo & (1 << 9)) != 0
    del kinfo
    in_cnt = _popcount4(in_bits)
    out_cnt = _popcount4(out_bits)
    is_start = (in_cnt != 1) | head
    is_end = (out_cnt != 1) | tail
    del in_cnt, out_cnt, head, tail
    # neighbor propagation via memmap binary search: in-neighbors of a
    # marked-start kmer become ends; out-neighbors of a marked-end
    # kmer become starts (cutOffMulEdges + handleFrstLastKmer)
    mask = U64((1 << (2 * B_KMER)) - 1)
    marked_start = np.flatnonzero(is_start)
    marked_end = np.flatnonzero(is_end)
    for ch in range(4):
        src = marked_start[(in_bits[marked_start] >> ch) & 1 == 1]
        if len(src):
            nb = (U64(ch) << U64(2 * B_KMER - 2)) | (kmer_v[src] >> U64(2))
            pos = np.searchsorted(kmer_v, nb)
            is_end[pos] = True
        dst = marked_end[(out_bits[marked_end] >> ch) & 1 == 1]
        if len(dst):
            nb = ((kmer_v[dst] << U64(2)) | U64(ch)) & mask
            pos = np.searchsorted(kmer_v, nb)
            is_start[pos] = True
    n_uni = int(is_end.sum())
    assert int(is_start.sum()) == n_uni, "start/end count mismatch"
    progress(f"{n_uni} unitigs (external)")

    # ---- successor table (int32, RAM) + streaming walk ----------------------
    # A kmer-indexed walk writes ~17 bytes/kmer of RANDOMLY-ordered dirty
    # pages (the dBG successor permutation) — a writeback death spiral
    # under a memory cap. Instead the walk emits POSITION-ordered streams
    # (purely sequential memmap writes) and a later disk-bucketed pass
    # inverts position -> kmer order.
    z8 = np.zeros((), np.int8)
    low = np.where(out_bits & 1, z8,
                   np.where(out_bits & 2, z8 + 1,
                            np.where(out_bits & 4, z8 + 2, z8 + 3)))
    succ32 = np.empty(n_kmer, np.int32)            # 4 B/kmer, in RAM
    for lo in range(0, n_kmer, CHUNK):
        hi = min(n_kmer, lo + CHUNK)
        sl = slice(lo, hi)
        nxt = ((kmer_v[sl] << U64(2))
               | low[sl].astype(np.uint64)) & mask
        s = np.searchsorted(kmer_v, nxt).astype(np.int32)
        idxs = np.arange(lo, hi, dtype=np.int32)
        succ32[sl] = np.where(is_end[sl], idxs, s)
    del low
    first_base_k = np.empty(n_kmer, np.uint8)
    for lo in range(0, n_kmer, CHUNK):
        hi = min(n_kmer, lo + CHUNK)
        first_base_k[lo:hi] = (kmer_v[lo:hi]
                               >> U64((B_KMER - 1) * 2)).astype(np.uint8) & 3
    if not native.available():
        raise RuntimeError("external build requires the native runtime "
                           "(csrc) for the serial unitig walk")
    text_len = n_kmer + 31 * n_uni      # kmers + 30 tail bases + 1 sep each
    pos2k = _mm(workdir, "pos2k", np.int32, (text_len,))
    for lo in range(0, text_len, CHUNK):
        pos2k[lo : min(text_len, lo + CHUNK)] = -1
    prevc_pos = _mm(workdir, "prevc", np.uint8, (text_len,))
    uni_end_kmer = np.zeros(n_uni, np.int64)
    uni_len = np.zeros(n_uni + 1, np.uint32)
    n_uni_w = native.unitig_walk_stream(
        succ32, is_start.view(np.uint8), is_end.view(np.uint8),
        first_base_k, pos2k, prevc_pos, uni_end_kmer, uni_len)
    assert n_uni_w == n_uni
    prevc_pos[0] = CHAR_DOLLAR          # first unitig start stashes '$'
    del succ32, in_bits, out_bits
    end_kmer_of_uid = kmer_v[uni_end_kmer]
    start_kmer_of_uid = kmer_v[np.flatnonzero(is_start)]
    progress("unitig walk (external)")

    # ---- invert pos2k -> kmer_pos (kmer order), disk-bucketed ---------------
    uni_start = np.zeros(n_uni + 1, np.int64)
    np.cumsum(uni_len[:n_uni].astype(np.int64) + 1, out=uni_start[1:])
    assert int(uni_start[n_uni]) == text_len
    kmer_pos = _mm(workdir, "kmer_pos", np.int64, (n_kmer,))
    SH = max((n_kmer - 1).bit_length() - 8, 1)
    inv_dir = os.path.join(workdir, "inv")
    os.makedirs(inv_dir, exist_ok=True)
    INV_DT = np.dtype([("k", "<i4"), ("p", "<i8")])
    n_ib = ((n_kmer - 1) >> SH) + 1
    iw = [open(os.path.join(inv_dir, f"{b:03d}.rec"), "wb",
               buffering=1 << 20) for b in range(n_ib)]
    for lo in range(0, text_len, CHUNK):
        hi = min(text_len, lo + CHUNK)
        pk = pos2k[lo:hi]
        m = pk >= 0
        kid = pk[m]
        pp = np.arange(lo, hi, dtype=np.int64)[m]
        bucket = kid >> SH
        order = np.argsort(bucket, kind="stable")
        kid, pp, bucket = kid[order], pp[order], bucket[order]
        bounds = np.searchsorted(bucket, np.arange(n_ib + 1))
        rec = np.empty(len(kid), INV_DT)
        rec["k"] = kid
        rec["p"] = pp
        for b in range(n_ib):
            s, t = bounds[b], bounds[b + 1]
            if t > s:
                iw[b].write(rec[s:t].tobytes())
    for w in iw:
        w.close()
    for b in range(n_ib):
        path = os.path.join(inv_dir, f"{b:03d}.rec")
        rec = np.fromfile(path, INV_DT)
        os.unlink(path)
        base = b << SH
        width = min(n_kmer - base, 1 << SH)
        local = np.zeros(width, np.int64)
        local[rec["k"].astype(np.int64) - base] = rec["p"]
        kmer_pos[base : base + width] = local
    os.rmdir(inv_dir)
    progress("position inversion (external)")

    n_rows = n_uni + n_kmer + 30 * n_uni
    assert text_len == n_rows, (text_len, n_rows)

    # ---- unitig occurrences (src/idx.c:554-706) -----------------------------
    occ_ref, occ_uid, occ_off = [], [], []
    for ref_id in range(len(names)):
        c = codes_mm[ref_off[ref_id] : ref_off[ref_id] + lens[ref_id]]
        for s, e in _runs_of(c < 4):
            if e - s < B_KMER:
                continue
            seg = np.asarray(c[s:e])
            p = 0
            n_in_run = e - s - B_KMER + 1
            while True:
                val = U64(0)
                for j in range(B_KMER):
                    val = (val << U64(2)) | U64(int(seg[p + j]))
                u = int(np.searchsorted(start_kmer_of_uid, val))
                assert (u < n_uni and start_kmer_of_uid[u] == val), \
                    "not a start"
                L = int(uni_len[u])
                if L >= MIN_UNI_L:
                    occ_ref.append(ref_id)
                    occ_uid.append(u)
                    occ_off.append(s + p)
                p += L - B_KMER + 1
                if p + 1 > n_in_run:
                    assert p == n_in_run, "run not tiled by unitigs"
                    break
    occ_ref = np.array(occ_ref, np.int64)
    occ_uid = np.array(occ_uid, np.int64)
    occ_off = np.array(occ_off, np.int64)
    order = np.argsort(occ_uid, kind="stable")
    occ_ref, occ_uid, occ_off = occ_ref[order], occ_uid[order], occ_off[order]
    n_occ = len(occ_uid)
    uni_ref_list = np.zeros(n_uni + 2, np.uint32)
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
    uni_ref_list[n_uni] = n_occ
    uni_ref_list = uni_ref_list[: n_uni + 1]
    progress(f"{n_occ} unitig occurrences (external)")

    # ---- BWT rows: merge-join sp-kmers against the sorted k-mer memmap ------
    k_arr = np.arange(30, 0, -1, dtype=np.uint64)
    sp_uid = np.repeat(np.arange(n_uni, dtype=np.int64), 30)
    sp_k = np.tile(k_arr, n_uni)
    ek = np.repeat(end_kmer_of_uid, 30)
    sp_val = ek & ((U64(1) << (sp_k * U64(2))) - U64(1))
    sp_char = ((ek >> (sp_k * U64(2))) & U64(3)).astype(np.uint8)
    sp_aligned = sp_val << ((U64(B_KMER) - sp_k) * U64(2))
    sp_pos_text = (uni_start[sp_uid] + uni_len[sp_uid].astype(np.int64)
                   - sp_k.astype(np.int64))
    del sp_val, ek
    # stable sort of the sp set by (aligned, k); merged rank of each
    # element = its own rank + #elements of the other (sorted) set
    # before it. sp ties with normal kmers sort sp-first (tie key k<255).
    sp_order = np.lexsort((sp_k, sp_aligned))
    sp_aligned = sp_aligned[sp_order]
    sp_char = sp_char[sp_order]
    sp_pos_text = sp_pos_text[sp_order]
    sp_k_s = sp_k[sp_order]
    n_sp = len(sp_aligned)
    sp_before = np.searchsorted(kmer_v, sp_aligned, side="left")
    sp_rank = np.arange(n_sp, dtype=np.int64) + sp_before
    row_char = _mm(keep, "row_char", np.uint8, (n_rows,))
    row_pos = _mm(keep, "row_pos", np.int64, (n_rows,))
    rowA_char = (end_kmer_of_uid & U64(3)).astype(np.uint8)
    rowA_pos = uni_start[1 : n_uni + 1] - 1
    row_char[:n_uni] = rowA_char
    row_pos[:n_uni] = rowA_pos
    row_char[n_uni + sp_rank] = sp_char
    row_pos[n_uni + sp_rank] = sp_pos_text
    # normal kmers: rank = own index + #sp before them (per chunk — a
    # full nk_before array would cost 8 B/kmer)
    for lo in range(0, n_kmer, CHUNK):
        hi = min(n_kmer, lo + CHUNK)
        nb = np.searchsorted(sp_aligned, kmer_v[lo:hi], side="right")
        r = np.arange(lo, hi, dtype=np.int64) + nb + n_uni
        kp = kmer_pos[lo:hi]
        row_char[r] = prevc_pos[kp]
        row_pos[r] = kp
    progress("BWT rows merged (external)")

    # ---- hash13 --------------------------------------------------------------
    # key per merged row (top 13 bases); sp rows with k < 13 have none.
    n_keys = 1 << (2 * L_PRE_IDX)
    rdt = np.int64 if n_uni + n_sp + n_kmer + 1 >= (1 << 31) else np.int32
    first = np.full(n_keys, -1, dtype=rdt)
    last = np.full(n_keys, -1, dtype=rdt)

    def feed(keys, rows):
        # keys ascending within each call AND across calls per source;
        # combined via min/max so interleaved sp/normal order is safe
        uk, ui = np.unique(keys, return_index=True)
        last_idx = np.concatenate([ui[1:], [len(keys)]]) - 1
        lo_r = rows[ui].astype(rdt)
        hi_r = rows[last_idx].astype(rdt) + 1
        cur_f = first[uk]
        first[uk] = np.where(cur_f < 0, lo_r, np.minimum(cur_f, lo_r))
        last[uk] = np.maximum(last[uk], hi_r)

    sp_ok = sp_k_s >= L_PRE_IDX
    feed((sp_aligned[sp_ok] >> U64((B_KMER - L_PRE_IDX) * 2)).astype(
        np.uint32).astype(np.int64), n_uni + sp_rank[sp_ok])
    for lo in range(0, n_kmer, CHUNK):
        hi = min(n_kmer, lo + CHUNK)
        nb = np.searchsorted(sp_aligned, kmer_v[lo:hi], side="right")
        r = np.arange(lo, hi, dtype=np.int64) + nb + n_uni
        feed((kmer_v[lo:hi] >> U64((B_KMER - L_PRE_IDX) * 2)).astype(
            np.uint32).astype(np.int64), r)
    present = first >= 0
    ffill = np.where(present, last, 0)
    idx_src = np.where(present, np.arange(n_keys, dtype=rdt), rdt(-1))
    np.maximum.accumulate(idx_src, out=idx_src)
    prev_end = np.where(idx_src >= 0, ffill[np.maximum(idx_src, 0)], 0)
    prev_excl = np.concatenate([[0], prev_end[:-1]])
    hdt = np.uint64 if n_uni + n_sp + n_kmer + 1 >= (1 << 32) else np.uint32
    hash13 = np.empty(n_keys + 1, dtype=hdt)
    hash13[:n_keys] = np.where(present, first, prev_excl)
    hash13[n_keys] = prev_end[-1]
    del first, last, present, ffill, idx_src, prev_end, prev_excl
    progress("hash13 (external)")

    # ---- rank ----------------------------------------------------------------
    counts6 = np.zeros(6, np.int64)
    for lo in range(0, n_rows, CHUNK):
        hi = min(n_rows, lo + CHUNK)
        counts6 += np.bincount(row_char[lo:hi], minlength=6)
    rank = np.zeros(6, np.int64)
    rank[0] = counts6[4] + counts6[5]
    rank[1] = rank[0] + counts6[0]
    rank[2] = rank[1] + counts6[1]
    rank[3] = rank[2] + counts6[2]
    rank[4] = 0
    rank[5] = rank[0] - 1
    dollar_pos = n_uni - 1

    # ---- existence filter ----------------------------------------------------
    e_kmer_size = None
    forced = os.environ.get("DESAMBA_FORCE_EKMER_SIZE")
    if forced:
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
    text = _mm(workdir, "text", np.uint8, (text_len,))
    for lo in range(0, text_len, CHUNK):
        hi = min(text_len, lo + CHUNK)
        pk = pos2k[lo:hi]
        ch = np.full(hi - lo, 4, np.uint8)
        m = pk >= 0
        ch[m] = first_base_k[pk[m]]
        text[lo:hi] = ch
    tail_pos = uni_start[:n_uni] + uni_len[:n_uni].astype(np.int64) - B_KMER
    for j in range(1, B_KMER):
        b = (end_kmer_of_uid >> U64((B_KMER - 1 - j) * 2)).astype(
            np.uint8) & 0x3
        text[tail_pos + j] = b
    # the bit tables themselves reach 2 x 4-16 GB at reference scale —
    # memmap them so the kernel can write dirty pages back under memory
    # pressure instead of holding both resident
    ekmer0 = _mm(keep, "ekmer0", np.uint8, (e_kmer_size,))
    ekmer1 = _mm(keep, "ekmer1", np.uint8, (e_kmer_size,))
    native.build_exist_tables(np.asarray(text), len_e_kmer, e_hash_mask,
                              ekmer0, ekmer1)
    progress("existence filter (external)")

    rp_global_off = ref_off[occ_ref] + occ_off
    out = IndexData(
        row_char=row_char, row_pos=row_pos, rank=rank, hash13=hash13,
        dollar_pos=dollar_pos, n_uni=n_uni, uni_len=uni_len,
        uni_ref_list=uni_ref_list, uni_start=uni_start, text_len=text_len,
        rp_global_off=rp_global_off.astype(np.int64),
        rp_ref_id=occ_ref.astype(np.int32),
        rp_dir=np.ones(n_occ, np.uint8),
        ref_bin=ref_bin, ref_name=names, ref_len=lens, ref_off=ref_off,
        ekmer0=ekmer0, ekmer1=ekmer1, e_kmer_size=e_kmer_size,
        len_e_kmer=len_e_kmer, e_hash_mask=e_hash_mask,
        single_base_max=single_base_max,
    )
    out._workdir = workdir  # keep the memmap backing alive with the index
    return out


def _shrink(d, name, dtype, n):
    """Reopen a memmap truncated to n elements (header rewritten)."""
    path = os.path.join(d, name + ".npy")
    old = np.lib.format.open_memmap(path, mode="r")
    tmp = path + ".tmp"
    new = np.lib.format.open_memmap(tmp, mode="w+", dtype=dtype,
                                    shape=(int(n),))
    step = CHUNK
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        new[lo:hi] = old[lo:hi]
    new.flush()
    del old
    os.replace(tmp, path)
    return np.lib.format.open_memmap(path, mode="r+")
