"""9-mer sparse-DP rescoring ("M2"), chain combining, filtering, primary.

Faithful ports of src/cly.c:1691-1710 (sc_hash_idx), 1763-1808
(combine_chain), 1810-1818 (MEM_search), 2173-2224 (build_hash_table_M2),
2335-2440 (sdp_match), 2444-2530 (sdp_middle_M2), 2532-2677 (sdp_right_M2),
2679-2819 (sdp_left_M2), 2821-2849 (get_score_M2), 2883-2993
(delete_small_score_rst), 2995-3058 (detect_primary).

C integer quirks preserved and documented inline:
  - sdp_right's search_q_st goes through MAX(int, uint32): for
    search_q_ed < 2000 the result is negative, reaches sdp_match as a huge
    uint32 q_bg, and kills every match -> right extension is a no-op (+1 on
    q_ed/t_ed via the len=-8 seed node) for reads shorter than ~2000 bp.
  - chain q_st may underflow uint32 (detect_primary resets > 4294960000).
  - sms node 0 of sdp_left never gets a len (uninitialized in C, unused).
"""
from __future__ import annotations

import numpy as np

from ...constants import (
    FILTER_MIN_SCORE_2G,
    FILTER_MIN_SCORE_SHORT_3G,
    MIN_SCORE_MEM,
    OVER_SEARCH_M2,
    PRIMARY,
    S_A_KMER_L,
    SECONDARY,
    SUPPLEMENTARY,
)
from ...index.kmers import rolling_kmers
from ...io import native
from .mapseed import get_ref

U32 = 0xFFFFFFFF
K9 = S_A_KMER_L


class ReadKmerIndex:
    """Per-direction read 9-mer -> ascending positions (build_hash_table_M2
    equivalent: hash-chain traversal order == ascending insertion order)."""

    def __init__(self, bin_read: np.ndarray):
        if len(bin_read) >= K9:
            vals = rolling_kmers(bin_read.astype(np.uint8), K9)
            order = np.argsort(vals, kind="stable")
            self.vals = vals[order]
            self.pos = order
        else:
            self.vals = np.empty(0, dtype=np.uint64)
            self.pos = np.empty(0, dtype=np.int64)

    def probe(self, v: int) -> np.ndarray:
        lo = np.searchsorted(self.vals, np.uint64(v), "left")
        hi = np.searchsorted(self.vals, np.uint64(v), "right")
        return self.pos[lo:hi]

    def probe_many(self, vs: np.ndarray):
        """Batched probe: (lo, hi) slice bounds into .pos per query."""
        lo = np.searchsorted(self.vals, vs, "left")
        hi = np.searchsorted(self.vals, vs, "right")
        return lo, hi


def _mem_q(qbuf: np.ndarray, qi: int, t: np.ndarray, ti: int, forward: bool,
           maxlen: int) -> int:
    """MEM_search (src/cly.c:1810-1818) for the sdp probes.

    Bytes past the buffer END mismatch (the C reads stale realloc tail
    there — unreplicable, and runs reaching it are vanishingly rare).
    Bytes BEFORE the buffer start compare as char 0: the C walks into
    the glibc chunk header whose top size bytes are 0x00 ('A'), which
    is what makes its head-over-read matches stable across runs.

    Long extensions take a vectorized first-mismatch scan; short ones
    (the 4-cap leftmost checks) stay scalar to skip array overhead."""
    if native.available():
        return native.mem_run(qbuf, qi, t, ti, forward, maxlen)
    lq, lt = len(qbuf), len(t)
    if forward:
        m = min(maxlen, lq - qi, lt - ti)
    else:
        m = min(maxlen, ti + 1)
    if m <= 0:
        return 0
    if m > 24:
        if forward:
            neq = np.flatnonzero(qbuf[qi : qi + m] != t[ti : ti + m])
        else:
            qidx = qi - np.arange(m)
            qv = np.where(qidx >= 0, qbuf[np.maximum(qidx, 0)], 0)
            neq = np.flatnonzero(qv != t[ti - m + 1 : ti + 1][::-1])
        return int(neq[0]) if len(neq) else m
    n = 0
    if forward:
        while n < m and qbuf[qi + n] == t[ti + n]:
            n += 1
    else:
        while n < m and (qbuf[qi - n] if qi - n >= 0 else 0) == t[ti - n]:
            n += 1
    return n


def sdp_match(q_bg: int, q_ed: int, qbuf: np.ndarray, qbase: int,
              rk: ReadKmerIndex, t_arr: np.ndarray, t0: int, t_len: int,
              sms: list, t_st: int, forward: bool):
    """src/cly.c:2335-2440. qbuf is the full F+R buffer, qbase the direction
    offset (C passes bin_read pointers into one allocation; backward
    over-reads cross into the other strand's bytes). t_arr is the loaded ref
    buffer; the match window starts at t0 (sdp_left passes ref+50 in C so
    backward extension reads the 50-base pad before the window)."""
    q_bg &= U32
    q_ed &= U32
    t_kmer_num = t_len - K9 + 1
    if t_kmer_num <= 4:
        return
    if native.available():
        native.sdp_match(q_bg, q_ed, qbuf, qbase, rk.vals, rk.pos, t_arr,
                         t0, t_len, t_st, forward, OVER_SEARCH_M2, K9, sms)
        return
    tv = rolling_kmers(np.asarray(t_arr[t0 : t0 + t_len], dtype=np.uint8), K9)
    probe_at = np.arange(4, t_kmer_num, 4)
    if forward:
        los, his = rk.probe_many(tv[probe_at])
        for j in np.flatnonzero(his > los):
            i = int(probe_at[j])
            for q_pos in rk.pos[los[j] : his[j]]:
                q_pos = int(q_pos)
                # filter 2 (src/cly.c:2251): the C compares q_bg (not
                # q_pos) to q_ed — candidates above q_ed are accepted;
                # the upper bound only gates the window as a whole
                if not (q_pos >= q_bg and q_bg <= q_ed):
                    continue
                back_len = _mem_q(qbuf, qbase + q_pos - 1, t_arr, t0 + i - 1,
                                  False, 4)
                if back_len < 4 or i == 4:
                    ms = q_ed - q_pos - 1
                    if ms < 0:
                        ms = U32
                    max_search = min(ms, t_len - i - 1) + OVER_SEARCH_M2
                    fwd_len = _mem_q(qbuf, qbase + q_pos + K9, t_arr,
                                     t0 + i + K9, True, max_search)
                    total = back_len + fwd_len + 1
                    if total >= 4:
                        sms.append([(q_pos - back_len) & U32,
                                    (i - back_len + t_st) & U32, total, 0])
    else:
        # i-th probe is at ref position t_len - 9 - i
        los, his = rk.probe_many(tv[t_kmer_num - 1 - probe_at])
        for j in np.flatnonzero(his > los):
            i = int(probe_at[j])
            tpos = t_kmer_num - 1 - i
            for q_pos in rk.pos[los[j] : his[j]]:
                q_pos = int(q_pos)
                # filter 2 (src/cly.c:2306): same q_bg/q_ed quirk as fwd
                if not (q_pos >= q_bg and q_bg <= q_ed):
                    continue
                fwd_len = _mem_q(qbuf, qbase + q_pos + K9, t_arr,
                                 t0 + tpos + K9, True, 4)
                if fwd_len < 4 or i == 4:
                    max_search = min(q_pos, tpos) + OVER_SEARCH_M2
                    back_len = _mem_q(qbuf, qbase + q_pos - 1, t_arr,
                                      t0 + tpos - 1, False, max_search)
                    total = back_len + fwd_len + 1
                    if total >= 4:
                        sms.append([(q_pos - back_len) & U32,
                                    (tpos - back_len + t_st) & U32, total, 0])


def _i32(x: int) -> int:
    """A C uint32 expression assigned to / compared as signed int.

    The reference's SDP node loops run entirely in uint32 (q_pos/t_pos
    wrap negative when matches over-read the buffer start, e.g. the
    node q = 2^32-2 a backward MEM emits at the read head); derived
    bounds like ``min_pre_q = q_pos + len + 2`` then wrap back to SMALL
    values, so predecessors still chain. Ints that never wrap are
    unchanged by this helper — it only matters on wrapped nodes."""
    x &= U32
    return x - (1 << 32) if x >= (1 << 31) else x


def sc_hash_idx(chains: list) -> dict:
    """Chain-endpoint diagonal hash (src/cly.c:1691-1710): key ->
    [(chain_index, s_or_e), ...] in insertion order."""
    h: dict = {}
    for ci, c in enumerate(chains):
        for i in (1, 0):  # 1: left/start, 0: right/end
            key = ((c.t_st - c.q_st) if i == 1 else (c.t_ed - c.q_ed)) & 0xFF
            h.setdefault(key, []).append((ci, i))
    return h


def combine_chain(chains: list, chain_id: int, sc_hash: dict, dis: int,
                  isleft: bool, c_q_pos: int):
    """src/cly.c:1763-1808. Returns absorbed chain or None."""
    c_h = chains[chain_id]
    for ci, s_or_e in sc_hash.get(dis & 0xFF, ()):
        c = chains[ci]
        # int casts of uint32 expressions (src/cly.c:1779-1780)
        dis_con = _i32((c.t_ed - c.q_ed) if isleft else (c.t_st - c.q_st))
        q_pos_con = _i32(c.q_st if not isleft else (c.q_ed - K9))
        if (dis == dis_con and c is not c_h and int(isleft) != s_or_e
                and abs(c_q_pos - q_pos_con) < 8 and c_h.ref_id == c.ref_id
                and c_h.direction == c.direction and c.sum_score != 0
                and ci > chain_id):
            c_h.sum_score += c.sum_score
            c_h.anchor_number += c.anchor_number
            c_h.indel += c.indel
            c_h.q_st = min(c_h.q_st, c.q_st)
            c_h.t_st = min(c_h.t_st, c.t_st)
            c_h.q_ed = max(c_h.q_ed, c.q_ed)
            c_h.t_ed = max(c_h.t_ed, c.t_ed)
            c.sum_score = 0
            c.t_st = c.t_ed = c.q_st = c.q_ed = 0
            return c
    return None


def sdp_middle(c_a, idx, sms: list, qbuf, qbase, rk: ReadKmerIndex) -> int:
    """src/cly.c:2444-2530."""
    score = 10000
    t_offset = int(idx.ref_off[c_a.ref_id])
    while c_a is not None:
        pre_a = c_a.chain_anchor_pre
        if pre_a is not None:
            pre_mch = pre_a.mtch_len
            pre_refoffset = pre_a.ref_offset - 3
            total_ref_len = c_a.ref_offset - (pre_refoffset + pre_mch) + 3
            sms.clear()
            sms.append([pre_a.index_in_read, pre_a.ref_offset,
                        pre_a.mtch_len - K9 + 1, score])
            if total_ref_len > 12:
                assert total_ref_len < 2000, "middle gap >= 2000"
                ref_offset = pre_refoffset + t_offset + pre_mch
                ref = get_ref(idx.ref_bin, ref_offset, total_ref_len, True)
                sdp_match(pre_a.index_in_read + pre_mch - 8,
                          c_a.index_in_read - 1, qbuf, qbase, rk, ref, 0,
                          total_ref_len, sms, pre_refoffset + pre_mch, True)
            sms.append([c_a.index_in_read, c_a.ref_offset,
                        c_a.mtch_len - K9 + 1, 0])
            # uint32 loop domain (src/cly.c:2488-2517): positions wrap,
            # derived bounds wrap back, comparisons are unsigned
            for si in range(1, len(sms)):
                c_spd = sms[si]
                max_score = c_spd[2]
                max_q = (c_spd[0] + 6) & U32
                max_t = (c_spd[1] + 6) & U32
                for pi in range(si - 1, -1, -1):
                    pre = sms[pi]
                    pre_q_ed = (pre[0] + pre[2] + K9 - 1) & U32
                    pre_t_ed = (pre[1] + pre[2] + K9 - 1) & U32
                    if pre_q_ed > max_q:
                        continue
                    if pre_t_ed > max_t:
                        continue
                    indel = _i32(pre[0] - pre[1] - (max_q - max_t))
                    if abs(indel) > 200:
                        continue
                    new_score = pre[3] + c_spd[2] - (abs(indel) >> 3)
                    if pre_q_ed > c_spd[0] or pre_t_ed > c_spd[1]:
                        new_score -= max(_i32(pre_q_ed - c_spd[0]),
                                         _i32(pre_t_ed - c_spd[1]))
                    if new_score > max_score:
                        max_score = new_score
                score = max(max_score, score)
                c_spd[3] = max_score
        else:
            score += c_a.mtch_len - K9 + 1
        c_a = pre_a
    return score - 10000


def sdp_right(idx, sms, qbuf, qbase, rk, chains, chain_id, l_read, sc_hash,
              score_ori):
    """src/cly.c:2532-2677."""
    score_ori += 10000
    total_max_score = score_ori
    max_sms_id = 0
    c_h = chains[chain_id]
    sms.clear()
    sms.append([c_h.q_ed, c_h.t_ed, 1 - K9, score_ori])
    current_sms = 1
    t_offset_global = int(idx.ref_off[c_h.ref_id])
    t_length = int(idx.ref_len[c_h.ref_id])
    c_t_offset = (c_h.t_ed - 3) & U32
    last_search = False
    while True:
        if len(sms) == current_sms:
            next_step = (t_length - c_t_offset) & ((1 << 64) - 1)
            if next_step < MIN_SCORE_MEM:
                break
            if l_read - c_h.q_ed < 600:
                if last_search:
                    break
                last_search = True
                max_search_ref = l_read - c_h.q_ed + 60
            else:
                max_search_ref = t_length - c_t_offset
            max_search_ref = min(600, max_search_ref)
            ref = get_ref(idx.ref_bin, c_t_offset + t_offset_global,
                          max_search_ref + OVER_SEARCH_M2, True)
            search_q_ed = min(int(sms[max_sms_id][0]) + 1000, l_read)
            # MAX(int, uint32) quirk: for search_q_ed < 2000 the int operand
            # compares as huge uint and wins -> negative q_bg -> no matches
            a = search_q_ed - 2000
            b = (c_h.q_st - 8) & U32
            search_q_st = a if (a & U32) > b else b
            sdp_match(search_q_st, search_q_ed, qbuf, qbase, rk, ref, 0,
                      max_search_ref, sms, c_t_offset, True)
            c_t_offset = (c_t_offset + max_search_ref - K9 - 3) & U32
            if len(sms) == current_sms:
                break
            if sms[current_sms][1] > (sms[max_sms_id][1] + 1000) & U32:
                break
        c_sms = sms[current_sms]
        current_sms += 1
        max_score = c_sms[2]
        # uint32 loop domain (src/cly.c:2607-2641) — see _i32
        max_pre_q = (c_sms[0] + 6) & U32
        max_pre_t = (c_sms[1] + 6) & U32
        for pi in range(current_sms - 2, -1, -1):
            pre = sms[pi]
            pre_q_ed = (pre[0] + pre[2] + K9 - 1) & U32
            pre_t_ed = (pre[1] + pre[2] + K9 - 1) & U32
            if pre_q_ed > max_pre_q:
                continue
            if pre_t_ed > max_pre_t:
                continue
            if (pre[1] + 600) & U32 < max_pre_t:
                break
            indel = _i32(pre[0] - pre[1] - (max_pre_q - max_pre_t))
            if abs(indel) > 200:
                continue
            new_score = pre[3] + c_sms[2] - (abs(indel) >> 3)
            if pre_q_ed > c_sms[0] or pre_t_ed > c_sms[1]:
                new_score -= max(_i32(pre_q_ed - c_sms[0]),
                                 _i32(pre_t_ed - c_sms[1]))
            if new_score > max_score:
                max_score = new_score
        c_sms[3] = max_score
        if c_sms[2] >= 8:
            combined = combine_chain(chains, chain_id, sc_hash,
                                     _i32(c_sms[1] - c_sms[0]), False,
                                     _i32(c_sms[0]))
            if combined is not None:
                total_max_score = (max(score_ori, max_score) - c_sms[2]
                                   + sdp_middle(combined.chain_anchor_cur, idx,
                                                sms, qbuf, qbase, rk))
                score_ori = total_max_score
                max_sms_id = 0
                sms.clear()
                sms.append([c_h.q_ed, c_h.t_ed, -K9, total_max_score])
                current_sms = 1
                c_t_offset = c_h.t_ed & U32
                continue
        if total_max_score < max_score:
            total_max_score = max_score
            max_sms_id = current_sms - 1
        if c_sms[1] > (sms[max_sms_id][1] + 1000) & U32:
            break
    c_h.q_ed = (sms[max_sms_id][0] + sms[max_sms_id][2] + K9) & U32
    c_h.t_ed = (sms[max_sms_id][1] + sms[max_sms_id][2] + K9) & U32
    return total_max_score - 10000


def sdp_left(idx, sms, qbuf, qbase, rk, chains, chain_id, l_read, sc_hash,
             score_ori):
    """src/cly.c:2679-2819."""
    score_ori += 10000
    total_max_score = score_ori
    max_sms_id = 0
    c_h = chains[chain_id]
    sms.clear()
    sms.append([c_h.q_st, c_h.t_st, 0, score_ori])  # len uninitialized in C
    current_sms = 1
    t_offset_global = int(idx.ref_off[c_h.ref_id])
    c_t_offset = (c_h.t_st + 3) & U32
    last_search = False
    while True:
        if len(sms) == current_sms:
            if c_t_offset < MIN_SCORE_MEM:
                break
            if c_h.q_st < 600:
                if last_search:
                    break
                last_search = True
                max_search_ref = c_h.q_st + 60
            else:
                max_search_ref = c_t_offset
            max_search_ref = min(600, max_search_ref)
            if t_offset_global == 0 and c_t_offset < OVER_SEARCH_M2 + max_search_ref:
                # reference's own "//bug" branch (src/cly.c:2724): window
                # loaded without the 50-pad, matching still offset by +50
                raw = get_ref(idx.ref_bin,
                              c_t_offset + t_offset_global - max_search_ref,
                              max_search_ref, True)
                ref = np.zeros(max_search_ref + OVER_SEARCH_M2, dtype=np.uint8)
                ref[: max_search_ref] = raw
            else:
                ref = get_ref(idx.ref_bin,
                              c_t_offset + t_offset_global - max_search_ref
                              - OVER_SEARCH_M2,
                              max_search_ref + OVER_SEARCH_M2, True)
            search_q_st = max(int(sms[max_sms_id][0]) - 1000, 0)
            search_q_ed = min(search_q_st + 2000, (c_h.q_st - 1) & U32)
            sdp_match(search_q_st, search_q_ed, qbuf, qbase, rk,
                      ref, OVER_SEARCH_M2, max_search_ref, sms,
                      (c_t_offset - max_search_ref) & U32, False)
            c_t_offset = (c_t_offset - max_search_ref + K9 + 3) & U32
            if len(sms) == current_sms:
                break
            if (sms[current_sms][1] + 1000) & U32 < sms[max_sms_id][1]:
                break
        c_sms = sms[current_sms]
        current_sms += 1
        max_score = c_sms[2]
        # uint32 loop domain (src/cly.c:2755-2784) — see _i32. A wrapped
        # node (q ~ 2^32-2) makes min_pre_q wrap back SMALL, so normal
        # predecessors still chain onto it.
        min_pre_q = (c_sms[0] + c_sms[2] - 6 + K9 - 1) & U32
        min_pre_t = (c_sms[1] + c_sms[2] - 6 + K9 - 1) & U32
        for pi in range(current_sms - 2, -1, -1):
            pre = sms[pi]
            if pre[0] < min_pre_q:
                continue
            if pre[1] < min_pre_t:
                continue
            if (min_pre_t + 600) & U32 < pre[1]:
                break
            indel = _i32(pre[0] - pre[1] - (min_pre_q - min_pre_t))
            if abs(indel) > 200:
                continue
            new_score = pre[3] + c_sms[2] - (abs(indel) >> 3)
            if (min_pre_q + 6) & U32 > pre[0] or (min_pre_t + 6) & U32 > pre[1]:
                new_score -= max(_i32(min_pre_q + 6 - pre[0]),
                                 _i32(min_pre_t + 6 - pre[1]))
            if new_score > max_score:
                max_score = new_score
        c_sms[3] = max_score
        if c_sms[2] >= 8:
            combined = combine_chain(chains, chain_id, sc_hash,
                                     _i32(c_sms[1] - c_sms[0]), True,
                                     _i32(c_sms[0] + c_sms[2]))
            if combined is not None:
                total_max_score = (max(score_ori, max_score) - c_sms[2]
                                   + sdp_middle(combined.chain_anchor_cur, idx,
                                                sms, qbuf, qbase, rk))
                score_ori = total_max_score
                max_sms_id = 0
                sms.clear()
                sms.append([c_h.q_st, c_h.t_st, 0, total_max_score])
                current_sms = 1
                c_t_offset = c_h.t_st & U32
                continue
        if total_max_score < max_score:
            total_max_score = max_score
            max_sms_id = current_sms - 1
        if (c_sms[1] + 1000) & U32 < sms[max_sms_id][1]:
            break
    c_h.q_st = sms[max_sms_id][0] & U32
    c_h.t_st = sms[max_sms_id][1] & U32
    return total_max_score - 10000


def get_score_m2(idx, chains, dirs, l_read, sc_hash, rk_cache):
    """src/cly.c:2821-2849."""
    sms: list = []
    for i, c in enumerate(chains):
        if c.sum_score == 0:
            continue
        sd = dirs[0] if dirs[0].direction == c.direction else dirs[1]
        if c.direction not in rk_cache:
            rk_cache[c.direction] = ReadKmerIndex(sd.bin_read)
        rk = rk_cache[c.direction]
        qbuf, qbase = sd.buf, sd.base
        score = sdp_middle(c.chain_anchor_cur, idx, sms, qbuf, qbase, rk)
        score = sdp_right(idx, sms, qbuf, qbase, rk, chains, i, l_read,
                          sc_hash, score)
        score = sdp_left(idx, sms, qbuf, qbase, rk, chains, i, l_read,
                         sc_hash, score)
        c.sum_score = score


def delete_small_score_rst(idx, chains, dirs, l_read, state, opts):
    """src/cly.c:2883-2993. `state` carries max_read_l batch history."""
    if not chains:
        return
    truncate_chains(chains)
    sc_hash = sc_hash_idx(chains)
    rk_cache: dict = {}
    get_score_m2(idx, chains, dirs, l_read, sc_hash, rk_cache)
    post_rescore_finish(chains, l_read, state, opts)


def post_finish_native(idx, chains, l_read, state, opts) -> bool:
    """post_rescore_finish + detect_primary via csrc/rescorehot.c
    mode 1 (the device engine's host finish: scores already computed on
    device). False -> caller runs the python path."""
    if not chains or not native.available():
        return False
    import numpy as np

    from ...constants import (FILTER_MIN_SCORE_2G,
                              FILTER_MIN_SCORE_SHORT_3G, FORWARD,
                              MIN_SCORE_MEM, OVER_SEARCH_M2)
    from .chain import Chain

    nc = len(chains)
    rows = np.zeros((nc, 14), np.int64)
    for i, c in enumerate(chains):
        rows[i] = (c.ref_id, c.sum_score, c.anchor_number, c.direction,
                   int(c.with_top_anchor), c.t_st, c.t_ed, c.q_st,
                   c.q_ed, c.indel, 0, 0, 0, 0)
    eff = max(state.max_read_l, l_read)
    anc3 = np.zeros((1, 3), np.int64)
    params = np.array([
        idx.ref_bin.ctypes.data, len(idx.ref_bin) * 4,
        idx.ref_off.ctypes.data, idx.ref_len.ctypes.data,
        0, 0, l_read, FORWARD, eff,
        opts.filter_min_score_lv3, opts.filter_min_length,
        opts.filter_min_score, K9, OVER_SEARCH_M2, MIN_SCORE_MEM,
        FILTER_MIN_SCORE_2G, FILTER_MIN_SCORE_SHORT_3G,
        1,  # mode: post_rescore_finish + detect_primary only
    ], np.int64)
    n = native.rescore_finish(params, rows, anc3)
    if n < 0:
        return False
    state.max_read_l = eff
    chains[:] = [Chain(
        ref_id=int(r[0]), q_t_dis=0, sum_score=int(r[1]),
        anchor_number=int(r[2]), direction=int(r[3]),
        with_top_anchor=bool(r[4]), primary=int(r[12]),
        pri_index=int(r[13]), t_st=int(r[5]), t_ed=int(r[6]),
        q_st=int(r[7]), q_ed=int(r[8]), indel=int(r[9]),
        chain_id=i, chain_anchor_cur=None)
        for i, r in enumerate(rows[:n])]
    return True


def truncate_chains(chains):
    """Pre-rescore truncation (src/cly.c:2891-2897)."""
    if len(chains) > 200:
        rst_num = 200
        while rst_num < len(chains) and chains[rst_num].sum_score > 50:
            rst_num += 1
        del chains[rst_num:]
    del chains[400:]


def post_rescore_finish(chains, l_read, state, opts):
    """Everything after get_score_m2 (src/cly.c:2912-2993): position sort,
    chain merge, adaptive filters, MEM-score sort, truncation. Shared by
    the gold and device engines (the device engine computes sum_score and
    bounds on device, then finishes here)."""
    # sort by position (stable 3-way cmp: ref asc, t_st asc, score desc)
    chains.sort(key=lambda c: (c.ref_id, c.t_st, -c.sum_score))
    n = len(chains)
    for ci in range(n - 1):
        c_c = chains[ci]
        if c_c.sum_score == 0:
            continue
        for ni in range(ci + 1, n):
            nxt = chains[ni]
            if c_c.ref_id == nxt.ref_id:
                if c_c.direction != nxt.direction:
                    continue
                if nxt.sum_score == 0:
                    continue
                # uint32 domain (src/cly.c:2931-2941): +5 and the
                # distances wrap when a left extension wrapped q_st/t_st
                if (nxt.t_st < (c_c.t_st + 5) & U32
                        and nxt.q_st < (c_c.q_st + 5) & U32
                        and nxt.sum_score < c_c.sum_score + 5):
                    nxt.sum_score = 0
                    nxt.q_ed = nxt.q_st
                    nxt.t_ed = nxt.t_st
                    continue
                dis_t = _i32(nxt.t_st - c_c.t_ed)
                dis_q = _i32(nxt.q_st - c_c.q_ed)
                if (-20 < dis_t < 1000 and -20 < dis_q < 1000
                        and abs(dis_t - dis_q) < 200):
                    c_c.t_ed = max(c_c.t_ed, nxt.t_ed)
                    c_c.q_ed = max(c_c.q_ed, nxt.q_ed)
                    c_c.sum_score += nxt.sum_score
                    nxt.sum_score = 0
                    nxt.q_ed = nxt.q_st
                    nxt.t_ed = nxt.t_st
            else:
                break
    state.max_read_l = max(state.max_read_l, l_read)

    # spans in uint32 (src/cly.c:2965-2986): a wrapped q_st makes
    # q_ed - q_st wrap back to the true span
    if state.max_read_l < 510:
        for c in chains:
            if c.sum_score + (((c.q_ed - c.q_st) & U32) >> 5) \
                    < FILTER_MIN_SCORE_2G:
                c.sum_score = 0
    elif l_read < 310:
        for c in chains:
            if c.sum_score + (((c.q_ed - c.q_st) & U32) >> 5) \
                    < FILTER_MIN_SCORE_SHORT_3G:
                c.sum_score = 0
    else:
        for c in chains:
            score = c.sum_score + (((c.q_ed - c.q_st) & U32) >> 5)
            if score < opts.filter_min_score_lv3 and (
                    ((c.q_ed - c.q_st) & U32) < opts.filter_min_length
                    or score < opts.filter_min_score):
                c.sum_score = 0

    # chain_cmp_by_MEM_score: desc by sum_score; glibc msort reverses tie
    # groups whose sum_score is odd (the %2 hack, src/cly.c:63)
    if len(chains) > 1:
        _sort_mem_score(chains)
    for ci, c in enumerate(chains):
        if c.sum_score == 0:
            del chains[ci:]
            break


def _sort_mem_score(chains):
    order = sorted(range(len(chains)), key=lambda i: -chains[i].sum_score)
    out = []
    i = 0
    while i < len(order):
        j = i
        s = chains[order[i]].sum_score
        while j < len(order) and chains[order[j]].sum_score == s:
            j += 1
        grp = order[i:j]
        if s % 2 == 1:
            grp = grp[::-1]
        out.extend(grp)
        i = j
    chains[:] = [chains[i] for i in out]


def detect_primary(chains, read_len):
    """src/cly.c:2995-3058."""
    if not chains:
        return
    primary_v = [0] * 800
    primary_v_idx = [0] * 800
    n_primary_v = 1
    chains[0].pri_index = 0
    chains[0].primary = PRIMARY
    for c in chains:
        if c.q_st > 4294960000:
            c.q_st = 0
    for hi in range(1, len(chains)):
        c_hit = chains[hi]
        overlap = False
        for i in range(n_primary_v):
            p = chains[primary_v[i]]
            if p.direction == c_hit.direction:
                pst, ped = p.q_st, p.q_ed
            else:
                pst, ped = read_len - p.q_ed, read_len - p.q_st
            overlap_st = max(c_hit.q_st, pst)
            overlap_ed = min(c_hit.q_ed, ped)
            if (overlap_st < overlap_ed
                    and ((overlap_ed - overlap_st) << 1) >= (c_hit.q_ed - c_hit.q_st)):
                overlap = True
            if overlap:
                c_hit.primary = SECONDARY
                primary_v_idx[i] += 1
                c_hit.pri_index = primary_v_idx[i]
                max_gap = max(p.sum_score >> 6, 5)
                if c_hit.sum_score + max_gap > p.sum_score:
                    c_hit.pri_index = 1
                if primary_v_idx[i] == 255:
                    primary_v_idx[i] = 254
                break
        if not overlap:
            c_hit.primary = SUPPLEMENTARY
            c_hit.pri_index = 0
            primary_v_idx[n_primary_v] = 0
            primary_v[n_primary_v] = hi
            n_primary_v += 1
            if n_primary_v > 750:  # slot 750 overwritten, never scanned
                n_primary_v = 750
