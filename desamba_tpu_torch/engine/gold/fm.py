"""FM-index backward MEM search on the row tables.

Faithful to src/cly.c:1281-1447 (SP_SET, bwt_single_search, bwt_MEM_search)
and src/bwt.c:43-65 (occ). The gold engine uses O(1) cumulative occ tables
instead of block+popcount — same values, different mechanics.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...constants import CHAR_DOLLAR, L_PRE_IDX, SA_MASK, SP_SET_CAP
from ...io import native

MAX_U64 = (1 << 64) - 1


class SpSet:
    """500-entry linear dedup set with wrap-reset (src/cly.c:1281-1298).

    Holds both the python list (oracle path) and the flat buffers the
    native fm_mem_search mutates in place — per engine run only one of
    the two representations is ever used."""

    __slots__ = ("items", "buf", "cnt", "nat_ptrs")

    def __init__(self):
        self.items = []
        self.buf = np.zeros(SP_SET_CAP + 1, np.uint64)
        self.cnt = np.zeros(1, np.int64)
        self.nat_ptrs = (self.buf.ctypes.data, self.cnt.ctypes.data)

    def reset(self):
        self.items.clear()
        self.cnt[0] = 0

    def contents(self) -> list:
        """Members regardless of which representation is live."""
        if self.items:
            return list(self.items)
        return [int(x) for x in self.buf[: int(self.cnt[0])]]

    def insert(self, node: int) -> bool:
        items = self.items
        if len(items) == SP_SET_CAP:
            items.clear()
        if node in items:
            return False
        items.append(node)
        return True


@dataclass
class MemRst:
    match_len: int
    sp: int
    sa_sp: int
    sa_sp_l: int
    read_offset: int = 0


def build_fm_blocks(row_char: np.ndarray) -> np.ndarray:
    """Blocked FM table for the native search (csrc/goldhot.c blk_occ):
    168-byte blocks of 256 rows = 5 x int64 cumulative counts at block
    start + 256 nibbles (low nibble first). ~0.66 B/row, so the whole
    table is cache-resident (the flat occ_prefix is 40 B/row)."""
    n = len(row_char)
    # one extra block so rank queries at r == n_rows (the hash13 end
    # sentinel) stay in range
    nb = n // 256 + 1
    rcp = np.full(nb * 256, 15, np.uint8)
    rcp[:n] = row_char
    blocks = np.zeros((nb, 168), np.uint8)
    counts = blocks[:, :40].view(np.int64).reshape(nb, 5)
    for c in range(5):
        pbc = (rcp == c).reshape(nb, 256).sum(axis=1)
        counts[:, c] = np.concatenate([[0], np.cumsum(pbc)[:-1]])
    nib = rcp[0::2] | (rcp[1::2] << 4)
    blocks[:, 40:] = nib.reshape(nb, 128)
    return blocks.reshape(-1)


class FM:
    """Rank/occ over the index's row arrays."""

    def __init__(self, idx):
        self.idx = idx
        self.row_char = idx.row_char
        self.rank = idx.rank
        self.hash13 = idx.hash13
        self.dollar_pos = idx.dollar_pos
        if native.available():
            self.blocks = build_fm_blocks(idx.row_char)
            self._occ_prefix = None
        else:
            self.blocks = None
            self._occ_prefix = idx.build_occ_prefix()
        # pinned table pointers for the native search (pointer property
        # lookups cost ~1 us each; the tables never move)
        self.nat_ptrs = (
            (self.blocks.ctypes.data, self.rank.ctypes.data,
             int(self.dollar_pos), int(SA_MASK), self.hash13.ctypes.data)
            if self.blocks is not None else None)

    @property
    def occ_prefix(self):
        """Flat cumulative occ for the python oracle path (lazy: the
        native path uses the blocked table instead)."""
        if self._occ_prefix is None:
            self._occ_prefix = self.idx.build_occ_prefix()
        return self._occ_prefix

    def lf(self, r: int):
        """One LF step reading the char at r: returns (new_row, char).

        Mirrors callers computing occ(bt, r, &c) + rank[c] (src/cly.c:749,
        787, 1366): occ returns DOLLOR_POS when the char is '$'
        (src/bwt.c:55), and callers still add rank[c].
        """
        c = int(self.row_char[r])
        if c == CHAR_DOLLAR:
            return self.dollar_pos + int(self.rank[CHAR_DOLLAR]), c
        return int(self.occ_prefix[c, r]) + int(self.rank[c]), c


def bwt_single_search(fm: FM, sp: int, string: np.ndarray, str_i: int,
                      max_match_len: int, sp_set: SpSet, rst: MemRst) -> None:
    """Single-row backward extension (src/cly.c:1344-1383).

    string/str_i: binary read and current position (descending).
    """
    sa_sp, sa_sp_l = MAX_U64, 0
    match_len = 0
    while True:
        if match_len >= max_match_len:
            break
        if (sp & SA_MASK) == 0:
            sa_sp, sa_sp_l = sp, 0
        else:
            sa_sp_l -= 1
        new_sp, c = fm.lf(sp)
        if str_i < 0 or c != string[str_i]:
            break
        match_len += 1
        str_i -= 1
        if not sp_set.insert(new_sp):
            rst.match_len = -1000
            return
        sp = new_sp
    rst.sp = sp
    rst.match_len = match_len
    rst.sa_sp = sa_sp
    rst.sa_sp_l = sa_sp_l


def bwt_mem_search(fm: FM, string: np.ndarray, str_i: int, pre_v: int,
                   max_rst: int, l_min_mth: int, l_max_mth: int,
                   sp_set: SpSet, out: list) -> int:
    """Backward MEM search from 13-mer jumpstart (src/cly.c:1388-1447).

    string: binary read; str_i: index of the last char of the probe e-kmer.
    Appends MemRst entries to out; returns count appended.
    """
    n0 = len(out)
    if native.available() and fm.nat_ptrs is not None:
        rows = native.fm_mem_search(
            fm.nat_ptrs, string, str_i, pre_v, max_rst, l_min_mth,
            l_max_mth, L_PRE_IDX, sp_set.nat_ptrs)
        for k in range(len(rows)):
            ml, sp_r, sa_sp, sa_sp_l = (int(rows[k, 0]), int(rows[k, 1]),
                                        int(rows[k, 2]), int(rows[k, 3]))
            out.append(MemRst(ml, sp_r,
                              MAX_U64 if sa_sp < 0 else sa_sp, sa_sp_l))
        return len(out) - n0
    sp = int(fm.hash13[pre_v])
    ep = int(fm.hash13[pre_v + 1])
    str_i -= L_PRE_IDX
    match_len = L_PRE_IDX
    while True:
        c = int(string[str_i]) if str_i >= 0 else None
        str_i -= 1
        if c is None:
            # C reads before the buffer; in practice l_max_mth stops first.
            # Mirror by treating as mismatch char.
            new_sp = new_ep = 0
        else:
            new_sp = int(fm.rank[c]) + int(fm.occ_prefix[c, sp])
            new_ep = int(fm.rank[c]) + int(fm.occ_prefix[c, ep])
        if match_len >= l_min_mth - 1:
            if new_sp + max_rst >= new_ep:
                break
            if match_len >= l_max_mth:
                return 0
        if new_sp + 1 >= new_ep:
            break
        match_len += 1
        sp, ep = new_sp, new_ep
    if new_sp >= new_ep:
        return 0
    if new_sp + 1 == new_ep:
        if not sp_set.insert(new_sp):
            return 0
        rst = MemRst(0, 0, MAX_U64, 0)
        bwt_single_search(fm, new_sp, string, str_i, max(0, l_max_mth - match_len),
                          sp_set, rst)
        rst.match_len += match_len + 1
        if rst.match_len >= l_min_mth:
            out.append(rst)
    else:
        for c_sp in range(new_sp, new_ep):
            if not sp_set.insert(c_sp):
                continue
            rst = MemRst(0, 0, MAX_U64, 0)
            bwt_single_search(fm, c_sp, string, str_i,
                              max(0, l_max_mth - match_len), sp_set, rst)
            rst.match_len += match_len + 1
            if rst.match_len >= l_min_mth:
                out.append(rst)
    return len(out) - n0
