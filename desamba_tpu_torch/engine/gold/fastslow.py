"""Fast / slow seeding loops (src/cly.c:1478-1611)."""
from __future__ import annotations

import numpy as np

from ...constants import (
    MEM_SEARCH_FAST,
    MEM_SEARCH_SLOW,
    MIN_MEM_LEN_FAST,
    MIN_MEM_LEN_SLOW,
    PRE_IDX_MASK,
)
from ...io import native
from .fm import FM, SpSet, bwt_mem_search
from .islands import SearchDir, store_kmers_mask
from .mapseed import Locator, map_seed



def _read_kmers(sd: SearchDir, idx, read_len: int):
    """The e-kmer values for this direction (store_kmers output)."""
    l_ek = idx.len_e_kmer
    n_kmers = read_len - l_ek + 1
    if native.available():
        return native.store_kmers_vals(sd.bin_read, n_kmers, l_ek,
                                       idx.single_base_max)
    return store_kmers_mask(sd.bin_read, n_kmers, l_ek, idx.single_base_max)


def _classify_dir_native(idx, fm, loc, q_mem, q_lv, sd, read_len,
                         anchors, mode) -> bool:
    """Run the whole island ladder natively; False -> python fallback."""
    from .mapseed import Anchor, _ms_ctx

    if len(sd.seeds) == 0:
        return True
    ctx = _ms_ctx(idx, fm, loc, q_mem, q_lv)
    seeds = np.ascontiguousarray(np.array(sd.seeds, np.int32))
    rows = native.classify_dir(ctx, sd.buf, sd.base, read_len, seeds, mode)
    if rows is None:
        return False
    for k in range(len(rows)):
        r = rows[k]
        anchors.append(Anchor(
            mtch_len=int(r[0]), score=int(r[1]), left_len=int(r[2]),
            left_ed=int(r[3]), rigt_len=int(r[4]), rigt_ed=int(r[5]),
            direction=sd.direction, global_offset=int(r[6]),
            ref_id=int(r[7]), ref_offset=int(r[8]),
            index_in_read=int(r[9]), chain_anchor_pre=None,
            seed_id=int(r[11]), chain_id=0,
            anchor_useless=bool(r[12]), duplicate=bool(r[10])))
    return True


def fast_classify(idx, fm: FM, loc: Locator, q_mem, q_lv, sd: SearchDir,
                  read_len: int, anchors: list, trace=None) -> int:
    if trace is None and native.available() and _classify_dir_native(
            idx, fm, loc, q_mem, q_lv, sd, read_len, anchors, 0):
        return 0
    l_ek = idx.len_e_kmer
    min_index = MIN_MEM_LEN_FAST - l_ek
    kmers = _read_kmers(sd, idx, read_len)
    sp_set = SpSet()
    super_repeat = [0, 0]
    si = -1
    while si + 1 < len(sd.seeds):
        si += 1
        seed = sd.seeds[si]
        if not seed[2]:
            continue
        sp_set.reset()
        a_b_idx = len(anchors)
        s_off, s_len = int(seed[0]), int(seed[1])  # np.int32 rows wrap
        j = s_len - 1
        skip_next = False
        while j >= min_index:
            kmer_index = s_off + j
            pre_v = int(kmers[kmer_index]) & PRE_IDX_MASK
            string_index = kmer_index + l_ek - 1
            m_r = []
            bwt_mem_search(fm, sd.bin_read, string_index, pre_v,
                           MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1, string_index,
                           sp_set, m_r)
            if trace is not None:
                trace.append(("MEM", sd.direction, si, j, kmer_index,
                              [(r.match_len, r.sp, r.sa_sp, r.sa_sp_l) for r in m_r]))
            if not m_r:
                j -= 2
                continue
            j -= 3
            max_score = 0
            for r in m_r:
                r.read_offset = string_index - r.match_len
                c_score = map_seed(idx, fm, loc, q_mem, q_lv, r, sd.buf,
                                   sd.base, read_len, si, sd.direction,
                                   anchors, super_repeat)
                max_score = max(c_score, max_score)
            if max_score > 35:
                j -= 7
            if max_score > 256:
                if max_score > 512:
                    skip_next = True
                break
        # mark useless anchors below this island's top score
        top_score = 35
        for a in anchors[a_b_idx:]:
            top_score = max(top_score, a.score)
        for a in anchors[a_b_idx:]:
            a.anchor_useless = a.score < top_score
        if skip_next:
            si += 1  # c_sv++ skips the next island (src/cly.c:1530-1531)
    return super_repeat[0]


def slow_classify(idx, fm: FM, loc: Locator, q_mem, q_lv, sd: SearchDir,
                  read_len: int, anchors: list) -> None:
    if native.available() and _classify_dir_native(
            idx, fm, loc, q_mem, q_lv, sd, read_len, anchors, 1):
        return
    l_ek = idx.len_e_kmer
    kmers = _read_kmers(sd, idx, read_len)
    sp_set = SpSet()
    super_repeat = [0, 0]
    for si, seed in enumerate(sd.seeds):
        if seed[1] < 3 and not sd.seeds[0][2]:
            # NOTE: reference checks sv_f->top (the FIRST seed's flag), a
            # likely bug kept for parity (src/cly.c:1564)
            continue
        min_match_len = min(MIN_MEM_LEN_SLOW - 1, l_ek + 1)
        sp_set.reset()
        mem_rst = []
        s_off = int(seed[0])
        j = int(seed[1]) - 1
        while j >= 1:
            k_idx = s_off + j
            pre_v = int(kmers[k_idx]) & PRE_IDX_MASK
            s_idx = k_idx + l_ek - 1
            n0 = len(mem_rst)
            bwt_mem_search(fm, sd.bin_read, s_idx, pre_v, MEM_SEARCH_SLOW,
                           min_match_len, s_idx, sp_set, mem_rst)
            for r in mem_rst[n0:]:
                r.read_offset = k_idx + l_ek - 1 - r.match_len
            j -= 2
        if not mem_rst:
            continue
        if len(mem_rst) > 1:
            mem_rst = _qsort_by_match_len(mem_rst)
        a_b_idx = len(anchors)
        for r in mem_rst[: min(len(mem_rst), MEM_SEARCH_SLOW)]:
            map_seed(idx, fm, loc, q_mem, q_lv, r, sd.buf, sd.base,
                     read_len, si, sd.direction, anchors, super_repeat)
        top_score = 35
        for a in anchors[a_b_idx:]:
            top_score = max(top_score, a.score)
        for a in anchors[a_b_idx:]:
            a.anchor_useless = a.score < top_score


def _qsort_by_match_len(mem_rst):
    """qsort with MEM_rst_cmp_by_match_len (descending match_len).

    glibc qsort tie order is emulated lazily: start with a stable sort;
    replaced by glibc introsort emulation if demo parity requires it.
    """
    return sorted(mem_rst, key=lambda r: -r.match_len)
