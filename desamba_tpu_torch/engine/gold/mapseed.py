"""Seed -> anchor mapping: locate, Landau-Vishkin extend, fan out.

Faithful ports of src/cly.c:435-466 (get_ref), 471-496 (get_uni),
510-609 (lv_extd), 629-694 (get_new_ed), 706-939 (map_seed).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...constants import (
    LV_ERROR,
    LV_L,
    MIN_S_1,
    MIN_S_2,
    MIN_UNI_L,
    SA_MASK,
)
from ...io import native
from .fm import FM, MAX_U64, MemRst

LV_BASE = LV_ERROR
SENT_REF = 254   # stands in for the '#' ref sentinel (src/cly.c:534)
SENT_QRY = 255   # stands in for the '$' query sentinel
GARBAGE = 200    # stands in for C reads outside the read buffer
U32M = 0xFFFFFFFF


def qslice(buf: np.ndarray, start: int, length: int, step: int) -> np.ndarray:
    """Read `length` bytes from the F+R read buffer starting at absolute
    index `start`, direction `step` (+1/-1). Out-of-buffer bytes (heap
    garbage in C) become GARBAGE, which never matches a base or sentinel."""
    if length <= 0:
        return np.empty(0, dtype=np.uint8)
    idx = start + step * np.arange(length)
    ok = (idx >= 0) & (idx < len(buf))
    out = np.full(length, GARBAGE, dtype=np.uint8)
    out[ok] = buf[idx[ok]]
    return out


@dataclass
class Anchor:
    __slots__ = (
        "mtch_len", "score", "left_len", "left_ed", "rigt_len", "rigt_ed",
        "direction", "global_offset", "ref_id", "ref_offset", "index_in_read",
        "chain_anchor_pre", "seed_id", "chain_id", "anchor_useless", "duplicate",
    )
    mtch_len: int
    score: int
    left_len: int
    left_ed: int
    rigt_len: int
    rigt_ed: int
    direction: int
    global_offset: int
    ref_id: int
    ref_offset: int
    index_in_read: int
    chain_anchor_pre: object
    seed_id: int
    chain_id: int
    anchor_useless: bool
    duplicate: bool


def get_ref(ref_bin: np.ndarray, offset: int, length: int, forward: bool) -> np.ndarray:
    """Read `length` 2-bit bases at global position `offset`; backward mode
    reads offset, offset-1, ... (src/cly.c:435-466). Out-of-range reads
    (which the C leaves to wild pointers) return 0s."""
    if offset < 0:
        offset = 0
    if length <= 0:
        return np.empty(0, dtype=np.uint8)
    if native.available():
        return native.get_ref_bases(ref_bin, offset, length, forward)
    if forward:
        idx = offset + np.arange(length)
    else:
        idx = offset - np.arange(length)
    idx = np.clip(idx, 0, len(ref_bin) * 4 - 1)
    byte = ref_bin[idx >> 2]
    shift = (6 - ((idx & 3) << 1)).astype(np.uint8)
    return (byte >> shift) & 0x3


class Locator:
    """get_uni equivalent: SA-sample -> (unitig, offset, global ref pos).

    Built on row_pos (full SA); sample semantics match the reference's
    sa_taxon: sample(row) = (unitig, offset) of text position row_pos-1,
    separators belonging to the preceding unitig (see index/build.py and
    src/idx.c:1163-1237).
    """

    def __init__(self, idx):
        self.idx = idx
        self.row_pos = idx.row_pos
        self.uni_start = idx.uni_start
        self.uni_len = idx.uni_len
        self.uni_ref_list = idx.uni_ref_list
        self.rp_global_off = idx.rp_global_off
        self.text_len = idx.text_len
        self.n_uni = idx.n_uni

    def sample(self, row: int):
        p1 = (int(self.row_pos[row]) - 1) % self.text_len
        u = int(np.searchsorted(self.uni_start[1 : self.n_uni + 1], p1, side="right"))
        return u, p1 - int(self.uni_start[u])

    def get_uni(self, bwt_pos: int, search_l: int):
        """Returns (uni_id, uni_offset, global_offset) (src/cly.c:471-496)."""
        u, off = self.sample(bwt_pos)
        uni_offset = off + search_l + 1
        if search_l > 0:
            while uni_offset >= int(self.uni_len[u]):
                uni_offset -= int(self.uni_len[u]) + 1
                u += 1
        elif uni_offset < 0:
            uni_offset &= 0xFFFFFFFF  # uint32 wrap, loop body unreachable in C
        g = int(self.rp_global_off[int(self.uni_ref_list[u])]) + uni_offset
        return u, uni_offset, g


def lv_extd(ref: np.ndarray, ref_length: int, query: np.ndarray,
            query_length: int) -> int:
    """Landau-Vishkin semi-global edit distance <= 4 (src/cly.c:510-609).

    Dispatches to the native port (csrc/goldhot.c) when built — the DP
    is the single hottest scalar loop of the host engine; the python
    body below stays as the differential oracle (test_kmers.py)."""
    if native.available():
        return native.lv_extd(ref, ref_length, query, query_length,
                              LV_ERROR)
    return _lv_extd_py(ref, ref_length, query, query_length)


def _lv_extd_py(ref: np.ndarray, ref_length: int, query: np.ndarray,
                query_length: int) -> int:
    if ref_length < query_length:
        ref, query = query, ref
        ref_length, query_length = query_length, ref_length
    # sentinel-terminated copies (C writes/restores in place); python
    # lists: the DP below is scalar-indexing bound and list indexing is
    # ~5x cheaper than numpy scalar access on <=13-char windows
    r = list(map(int, ref[:ref_length]))
    r.append(SENT_REF)
    q = list(map(int, query[:query_length]))
    q.append(SENT_QRY)

    size = 2 * (LV_BASE + 1) + 1
    mn = [0] * (size + 2)
    ed = [0] * (size + 2)
    OFF = LV_BASE + 1  # mn[j] in C == mn[OFF + j] here

    best_score = query_length
    for i in range(-LV_BASE - 1, LV_BASE + 2):
        mn[OFF + i] = -1
        ed[OFF + i] = i if i > 0 else -i

    for i in range(LV_ERROR + 1):
        prev_mn = -1
        cur_mn = i - 1
        next_mn = mn[OFF - i + 1]
        prev_ed = i + 1
        cur_ed = i
        next_ed = ed[OFF - i + 1]
        for j in range(-i, LV_ERROR + 1):
            if cur_mn + j < ref_length - 1:
                max_mn_ed = cur_mn + 1 - cur_ed
                mn[OFF + j] = cur_mn + 1
                ed[OFF + j] = cur_ed + 1
                if max_mn_ed < next_mn + 1 - next_ed:
                    mn[OFF + j] = next_mn + 1
                    ed[OFF + j] = next_ed + 1
                    max_mn_ed = next_mn - next_ed
                if max_mn_ed < prev_mn - prev_ed:
                    mn[OFF + j] = prev_mn + 1
                    ed[OFF + j] = prev_ed + 1
            else:
                max_mn_ed = cur_mn - cur_ed
                mn[OFF + j] = cur_mn
                ed[OFF + j] = cur_ed + 1
                if max_mn_ed < prev_mn - prev_ed:
                    mn[OFF + j] = prev_mn
                    ed[OFF + j] = prev_ed + 1
                    max_mn_ed = prev_mn - prev_ed
                if max_mn_ed < next_mn + 1 - next_ed:
                    mn[OFF + j] = next_mn + 1
                    ed[OFF + j] = next_ed + 1
            mn_j = min(mn[OFF + j], query_length)
            mn_j = min(mn_j, ref_length - j)
            # C indexes before the buffers when mn_j < 0 (stack garbage that
            # in practice never equals a real base or sentinel): negative
            # indices compare as mismatch / non-sentinel.
            while (mn_j >= 0 and mn_j + j >= 0 and mn_j < len(q)
                   and mn_j + j < len(r) and r[mn_j + j] == q[mn_j]):
                mn_j += 1
            mn[OFF + j] = mn_j
            if (0 <= mn_j < len(q) and q[mn_j] == SENT_QRY) or (
                    0 <= mn_j + j < len(r) and r[mn_j + j] == SENT_REF):
                best_score = min(ed[OFF + j] - 1, best_score)
                if j <= i + 1:
                    return best_score
            prev_mn, cur_mn, next_mn = cur_mn, next_mn, mn[OFF + j + 2]
            prev_ed, cur_ed, next_ed = cur_ed, next_ed, ed[OFF + j + 2]
    return best_score


def get_new_ed(q_off: int, t_off: int, l_read: int, buf: np.ndarray,
               base: int, ref_bin: np.ndarray, is_fwd: bool):
    """Re-extension against the true reference (src/cly.c:629-694).

    Returns (ed, len, l_mem_ext).
    """
    l_mem_ext = 0
    if is_fwd:
        if q_off < 0:
            q_off = 0
        max_len = q_off
        length = min(12, max_len)
        q = qslice(buf, base + q_off, length, -1)
    else:
        max_len = l_read - q_off
        length = min(12, max_len)
        q = qslice(buf, base + q_off, length, 1)
    t = get_ref(ref_bin, t_off, length, not is_fwd)
    if length > 0 and len(t) > 0 and t[0] == q[0]:
        while True:
            mtc = 0
            while mtc < length and t[mtc] == q[mtc]:
                mtc += 1
            if mtc <= 0:
                break
            l_mem_ext += mtc
            max_len -= mtc
            length = min(12, max_len)
            if is_fwd:
                q_off -= mtc
                t_off -= mtc
                q = qslice(buf, base + q_off, length, -1)
            else:
                t_off += mtc
                q = qslice(buf, base + q_off + l_mem_ext, length, 1)
            t = get_ref(ref_bin, t_off, length, not is_fwd)
            if length <= 0 or len(t) == 0:
                break
    e_d = lv_extd(t, length, q, length)
    return e_d, length, l_mem_ext


def _ms_ctx(idx, fm: FM, loc: Locator, q_mem, q_lv) -> np.ndarray:
    """Context block for the native map_seed (csrc/goldhot.c ms_load)."""
    key = (id(fm), id(q_mem))
    cached = getattr(loc, "_ms_ctx_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    from ...constants import (L_PRE_IDX, MEM_SEARCH_FAST, MEM_SEARCH_SLOW,
                              MIN_MEM_LEN_FAST, MIN_MEM_LEN_SLOW,
                              PRE_IDX_MASK)

    p = lambda a: a.ctypes.data
    ctx = np.array([
        p(fm.blocks), 0, 0,
        p(fm.rank), int(fm.dollar_pos), int(SA_MASK),
        p(idx.row_pos), p(idx.uni_start), p(idx.uni_len),
        p(idx.uni_ref_list), p(idx.rp_global_off), p(idx.rp_ref_id),
        p(idx.ref_off), int(idx.text_len), int(idx.n_uni),
        p(idx.ref_bin), len(idx.ref_bin) * 4,
        p(q_mem), p(q_lv), q_lv.shape[1],
        LV_L, MIN_S_1, MIN_S_2, MIN_UNI_L, LV_ERROR,
        p(fm.hash13), PRE_IDX_MASK, MEM_SEARCH_FAST, MIN_MEM_LEN_FAST,
        MEM_SEARCH_SLOW, MIN_MEM_LEN_SLOW, idx.len_e_kmer,
        idx.single_base_max, L_PRE_IDX,
    ], dtype=np.int64)
    loc._ms_ctx_cache = (key, ctx)
    return ctx


def map_seed(idx, fm: FM, loc: Locator, q_mem, q_lv, m_r: MemRst,
             buf: np.ndarray, base: int, read_len: int, seed_id: int,
             direction: int, anchors: list, strain_mode_counts: list) -> int:
    """src/cly.c:706-939. Appends Anchors; returns max anchor score.

    Dispatches to the native port (csrc/goldhot.c map_seed) when built;
    the python body below is the differential oracle
    (tests/test_native_goldhot.py)."""
    if native.available():
        ctx = _ms_ctx(idx, fm, loc, q_mem, q_lv)
        sa_sp = -1 if m_r.sa_sp == MAX_U64 else m_r.sa_sp
        score, rows = native.map_seed(
            ctx, buf, base, read_len, m_r.sp, m_r.read_offset,
            m_r.match_len, sa_sp, m_r.sa_sp_l)
        if rows is not None:
            for k in range(len(rows)):
                r = rows[k]
                anchors.append(Anchor(
                    mtch_len=int(r[0]), score=int(r[1]),
                    left_len=int(r[2]), left_ed=int(r[3]),
                    rigt_len=int(r[4]), rigt_ed=int(r[5]),
                    direction=direction, global_offset=int(r[6]),
                    ref_id=int(r[7]), ref_offset=int(r[8]),
                    index_in_read=int(r[9]), chain_anchor_pre=None,
                    seed_id=seed_id, chain_id=0, anchor_useless=False,
                    duplicate=bool(r[10])))
            return score
        # fall through to the python body on row-cap overflow
    return _map_seed_py(idx, fm, loc, q_mem, q_lv, m_r, buf, base,
                        read_len, seed_id, direction, anchors,
                        strain_mode_counts)


def _map_seed_py(idx, fm: FM, loc: Locator, q_mem, q_lv, m_r: MemRst,
                 buf: np.ndarray, base: int, read_len: int, seed_id: int,
                 direction: int, anchors: list, strain_mode_counts: list) -> int:
    """src/cly.c:706-939. Appends Anchors; returns max anchor score."""
    ref_bin = idx.ref_bin
    b_p = m_r.sp
    q_off = m_r.read_offset
    l_m = m_r.match_len
    uni = None          # unitig id or None
    u_off = 0
    t_off = 0
    l_pre = l_suf = d_pre = d_suf = 0
    s = 0
    max_s = 0

    while True:  # do { } while(0)
        # step 1: prefix. C sets l_pre = min(q_off+1, LV_L) but the walk
        # below can overshoot to s_l = 1 when l_pre == 0 (check runs after
        # the first step); the LV then reads q_pre[0] = buf[base + q_off],
        # which for q_off = -1 is the byte before this strand's pointer
        # (cross-strand read or heap garbage). Gather LV_L chars so qslice
        # models exactly that.
        l_pre = min(q_off + 1, LV_L)
        q_pre = qslice(buf, base + q_off, LV_L, -1)
        t_pre_chars = []
        s_l = 0
        if m_r.sa_sp != MAX_U64:
            uni, u_off, t_off = loc.get_uni(m_r.sa_sp, m_r.sa_sp_l)
        else:
            while True:
                if (b_p & SA_MASK) == 0:
                    break
                new_sp, c = fm.lf(b_p)
                if c == 4:
                    break
                t_pre_chars.append(c)
                s_l += 1
                b_p = new_sp
                if s_l >= l_pre:
                    break
            if (b_p & SA_MASK) == 0:
                uni, u_off, t_off = loc.get_uni(b_p, s_l)
            else:
                l_pre = s_l
        if uni is not None:
            if int(idx.uni_len[uni]) < MIN_UNI_L:
                break
            l_pre = min(l_pre, u_off)
            t_pre = get_ref(ref_bin, t_off - 1, l_pre, False)
        else:
            t_pre = np.array(t_pre_chars[:l_pre], dtype=np.uint8)
        d_pre = lv_extd(t_pre, l_pre, q_pre, l_pre)
        s = int(q_mem[l_m]) + int(q_lv[d_pre][l_pre])
        if s < MIN_S_1 and l_pre == LV_L and uni is None:
            s = 0
            break
        # step 2: suffix
        if uni is None:
            while b_p & SA_MASK:
                b_p, _c = fm.lf(b_p)
                s_l += 1
            uni, u_off, t_off = loc.get_uni(b_p, s_l)
            if int(idx.uni_len[uni]) < MIN_UNI_L:
                s = 0
                break
        q_off_r = q_off + l_m + 1
        # uint32 arithmetic: negative operands wrap huge (src/cly.c:798)
        l_max_suf = min((int(idx.uni_len[uni]) - u_off - l_m) & U32M,
                        (read_len - q_off_r) & U32M)
        if l_max_suf != 0:
            l_suf = min(l_max_suf, LV_L)
            q_suf_i = q_off_r
            t_suf = get_ref(ref_bin, t_off + l_m, l_suf, True)
            q_suf = qslice(buf, base + q_suf_i, l_suf, 1)
            if len(t_suf) and len(q_suf) and t_suf[0] == q_suf[0]:
                while True:
                    mtc = 0
                    while mtc < l_suf and mtc < len(q_suf) and t_suf[mtc] == q_suf[mtc]:
                        mtc += 1
                    if mtc <= 0:
                        break
                    l_m += mtc
                    s = int(q_mem[l_m]) + int(q_lv[d_pre][l_pre])
                    l_max_suf -= mtc
                    l_suf = min(l_max_suf, LV_L)
                    q_suf_i += mtc
                    t_suf = get_ref(ref_bin, t_off + l_m, l_suf, True)
                    q_suf = qslice(buf, base + q_suf_i, l_suf, 1)
                    if l_suf <= 0:
                        break
            d_suf = lv_extd(t_suf, l_suf, q_suf, l_suf)
            s += int(q_lv[d_suf][l_suf])
        else:
            l_suf = d_suf = 0
        if s <= MIN_S_2 and l_suf == LV_L:
            s = 0
            break
        break  # normal do-while(0) exit

    # part 2: fan out over reference occurrences
    if s > 0:
        rl_s = int(idx.uni_ref_list[uni])
        rl_e = int(idx.uni_ref_list[uni + 1])
        ref_search_l = l_pre < LV_L or d_pre == 0
        ref_search_r = l_suf < LV_L or d_suf == 0
        duplicate = False
        if rl_e - rl_s > 50:
            if rl_e - rl_s >= 1000:
                return 50
        base_am = (l_m, s, l_pre, d_pre, l_suf, d_suf)
        for ci in range(rl_s, rl_e):
            a_mtch, a_score, a_ll, a_le, a_rl, a_re = base_am
            g_off = int(idx.rp_global_off[ci])
            l_m_ext_l = 0
            if ref_search_l or ref_search_r:
                if ref_search_l:
                    ed_l, len_l, l_m_ext_l = get_new_ed(
                        q_off, g_off + u_off - 1, read_len, buf, base, ref_bin, True)
                    a_ll, a_le = len_l, ed_l
                a_mtch = l_m + l_m_ext_l
                if ref_search_r:
                    ed_r, len_r, l_m_ext_r = get_new_ed(
                        q_off + l_m + 1, g_off + u_off + l_m, read_len,
                        buf, base, ref_bin, False)
                    a_rl, a_re = len_r, ed_r
                    a_mtch += l_m_ext_r
                a_score = int(q_mem[a_mtch]) + int(q_lv[a_le][a_ll]) + int(q_lv[a_re][a_rl])
                if a_score < MIN_S_2:
                    continue
            max_s = max(max_s, a_score)
            ref_id = int(idx.rp_ref_id[ci])
            global_offset = g_off + u_off - l_m_ext_l
            anchors.append(Anchor(
                mtch_len=a_mtch, score=a_score, left_len=a_ll, left_ed=a_le,
                rigt_len=a_rl, rigt_ed=a_re, direction=direction,
                global_offset=global_offset, ref_id=ref_id,
                # uint32: extensions crossing the ref start wrap (the
                # reference stores Anchor.ref_offset as uint32)
                ref_offset=(global_offset - int(idx.ref_off[ref_id])) & U32M,
                index_in_read=q_off + 1 - l_m_ext_l, chain_anchor_pre=None,
                seed_id=seed_id, chain_id=0, anchor_useless=False,
                duplicate=duplicate,
            ))
    return max_s
