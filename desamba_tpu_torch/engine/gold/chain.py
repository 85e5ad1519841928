"""Anchor chaining (src/cly.c:66-349).

qsort emulation notes (glibc 2.36 msort, verified empirically on the build
host): 3-way comparators == Python stable sort; the 0/1 comparator
Anchor_cmp_by_chr_ID_and_pos (src/cly.c:226-235) still yields a stable
ascending sort; chain_cmp_by_MEM_score's `return sum_score%2` tie hack
(src/cly.c:63) reverses tie groups with odd sum_score and keeps even ones
stable.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...constants import (
    M3_ANCHOR_THRESHOLD,
    M3_MAX_RUN,
    MAX_ANCHOR_OVERLAP,
    MAX_DIS_MINUS,
    MAX_WAITING_LEN,
)

U32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    """C: uint32 expression assigned/compared as signed int (see
    gold/rescore._i32 — anchors can carry wrapped ref_offset when an
    extension crosses the reference start, e.g. 2^32-2)."""
    x &= U32
    return x - (1 << 32) if x >= (1 << 31) else x


@dataclass
class Chain:
    __slots__ = (
        "ref_id", "q_t_dis", "sum_score", "anchor_number", "direction",
        "with_top_anchor", "primary", "pri_index", "t_st", "t_ed", "q_st",
        "q_ed", "indel", "chain_id", "chain_anchor_cur",
    )
    ref_id: int
    q_t_dis: int
    sum_score: int
    anchor_number: int
    direction: int
    with_top_anchor: bool
    primary: int
    pri_index: int
    t_st: int
    t_ed: int
    q_st: int
    q_ed: int
    indel: int
    chain_id: int
    chain_anchor_cur: object


def _insert_meta(anchor, c: Chain, new_chain: bool, dis_minus: int):
    """src/cly.c:72-112."""
    ref_l = anchor.ref_offset
    ref_r = (ref_l + anchor.mtch_len) & U32
    read_l = anchor.index_in_read
    read_r = read_l + anchor.mtch_len
    if new_chain:
        anchor.chain_id = c.chain_id
        anchor.chain_anchor_pre = None
        c.ref_id = anchor.ref_id
        c.direction = anchor.direction
        c.q_t_dis = _i32(anchor.ref_offset - anchor.index_in_read)
        c.t_st, c.t_ed = ref_l, ref_r
        c.q_st, c.q_ed = read_l, read_r
        c.with_top_anchor = not anchor.anchor_useless
        c.anchor_number = 1
        c.sum_score = 1 if anchor.duplicate else anchor.score
        c.indel = 0
        c.chain_anchor_cur = anchor
    else:
        anchor.chain_id = c.chain_id
        c.with_top_anchor = c.with_top_anchor or (not anchor.anchor_useless)
        if c.q_ed >= read_r:
            return
        c.t_ed = max(ref_r, c.t_ed)
        c.q_ed = read_r
        anchor.chain_anchor_pre = c.chain_anchor_cur
        c.chain_anchor_cur = anchor
        c.q_t_dis = _i32(anchor.ref_offset - anchor.index_in_read)
        c.indel += dis_minus
        c.anchor_number += 1
        c.sum_score += 1 if anchor.duplicate else anchor.score


def _new_chain(chains: list) -> Chain:
    c = Chain(0, 0, 0, 0, 0, False, 0, 0, 0, 0, 0, 0, 0, len(chains), None)
    chains.append(c)
    return c


def chain_insert_m2(anchor, chains: list):
    """Linear scan insert (src/cly.c:201-224)."""
    dis = _i32(anchor.ref_offset - anchor.index_in_read)
    for c in chains:
        if c.direction == anchor.direction and c.ref_id == anchor.ref_id:
            dis_minus = abs(dis - c.q_t_dis)
            if dis_minus < MAX_DIS_MINUS and abs(c.t_ed - anchor.ref_offset) < MAX_WAITING_LEN:
                _insert_meta(anchor, c, False, dis_minus)
                return
    c = _new_chain(chains)
    _insert_meta(anchor, c, True, 0)


def chain_insert_m3(anchors: list, chains: list):
    """Sort + sparse DP per run (src/cly.c:238-323)."""
    anchors.sort(key=lambda a: (a.ref_id, a.direction, a.ref_offset))
    n = len(anchors)
    i = 0
    while i < n:
        ref_id, direction = anchors[i].ref_id, anchors[i].direction
        j = i + 1
        while (j < n and anchors[j].ref_id == ref_id
               and anchors[j].direction == direction
               and (anchors[j].ref_offset
                    - anchors[j - 1].ref_offset) & U32 < 2000):
            j += 1
        if j - i > M3_MAX_RUN:
            j = i + M3_MAX_RUN
        run = anchors[i:j]
        score_v = [0] * len(run)
        max_anchor_i, max_score = None, 0
        for ci, c_a in enumerate(run):
            c_a.chain_anchor_pre = None
            anchor_max = c_a.score
            # uint32 domain (src/cly.c:263-280) — see _i32
            max_t = (c_a.ref_offset + MAX_ANCHOR_OVERLAP) & U32
            max_q = c_a.index_in_read + MAX_ANCHOR_OVERLAP
            for pi in range(ci - 1, -1, -1):
                pre = run[pi]
                if pre.index_in_read + pre.mtch_len > max_q:
                    continue
                if (pre.ref_offset + pre.mtch_len) & U32 > max_t:
                    continue
                if pre.index_in_read + 1000 < max_q:
                    break
                if (pre.ref_offset + 1000) & U32 < max_t:
                    break
                indel = _i32(pre.index_in_read - pre.ref_offset
                             - (max_q - max_t))
                abs_indel = abs(indel)
                if abs_indel > 200:
                    continue
                new_score = (score_v[pi] + c_a.mtch_len - (abs_indel >> 4)
                             - (((max_q - pre.index_in_read) & U32) >> 8))
                if new_score > anchor_max:
                    anchor_max = new_score
                    c_a.chain_anchor_pre = pre
            score_v[ci] = anchor_max
            if max_score < anchor_max:
                max_score = anchor_max
                max_anchor_i = ci
        # backtrack (src/cly.c:294-319)
        max_anchor = run[max_anchor_i]
        sum_indel, anchor_number = 0, 1
        sum_score = 1 if max_anchor.duplicate else max_anchor.score
        with_top = not max_anchor.anchor_useless
        pre = max_anchor
        while pre.chain_anchor_pre is not None:
            pre_ = pre.chain_anchor_pre
            sum_indel += _i32((pre.index_in_read - pre_.index_in_read)
                              - (pre.ref_offset - pre_.ref_offset))
            with_top = with_top or (not pre.anchor_useless)
            sum_score += 1 if pre.duplicate else pre.score
            pre = pre_
            anchor_number += 1
        c = _new_chain(chains)
        c.ref_id = ref_id
        c.direction = direction
        c.q_t_dis = _i32(max_anchor.ref_offset - max_anchor.index_in_read)
        c.t_st = pre.ref_offset
        c.t_ed = (max_anchor.ref_offset + max_anchor.mtch_len) & U32
        c.q_st = pre.index_in_read
        c.q_ed = max_anchor.index_in_read + max_anchor.mtch_len
        c.with_top_anchor = with_top
        c.anchor_number = anchor_number
        c.sum_score = sum_score
        c.indel = sum_indel
        c.chain_anchor_cur = max_anchor
        i = j


def resolve_tree(anchors: list, chains: list):
    """src/cly.c:326-349. Mutates chains (cleared first)."""
    chains.clear()
    if len(anchors) < M3_ANCHOR_THRESHOLD:
        for a in anchors:
            chain_insert_m2(a, chains)
    else:
        chain_insert_m3(anchors, chains)
    if len(chains) > 1:
        chains.sort(key=lambda c: (
            0 if c.with_top_anchor else 1,
            -(_i32(c.sum_score + (((c.q_ed - c.q_st) & U32) << 1))
              - _i32((c.indel << 2) & U32)),
        ))
    rst_num = min(5, len(chains))
    while rst_num < len(chains) and chains[rst_num].with_top_anchor:
        rst_num += 1
    del chains[rst_num:]
