"""Reader/writer for the reference's 8-file index format.

Used for differential testing: an index built by `build.py` is exported to
the reference layout and byte-compared against one produced by the reference
binary (format documented in SURVEY.md §2.4; writers at src/bwt.c:206-267 and
src/idx.c:1046-1101).
"""
from __future__ import annotations

import os

import numpy as np

from ..constants import B_KMER, L_PRE_IDX
from .build import IndexData

BP_PER_BLOCK = 256
BLOCK_BYTES = 40 + 128


def export_reference_format(idx: IndexData, out_dir: str, prefix: str = "deSAMBA") -> None:
    os.makedirs(out_dir, exist_ok=True)
    p = lambda ext: os.path.join(out_dir, prefix + ext)

    # ---- .bwt: [byteLen][blocks][rank*5][hash13] ----------------------------
    chars = idx.row_char
    n = len(chars)
    n_blocks = (n + BP_PER_BLOCK - 1) // BP_PER_BLOCK
    # checkpoint counts: cumulative char counts at block starts (A,C,G,T,#)
    occ5 = np.zeros((5, n_blocks), dtype=np.uint64)
    counts = np.zeros((5, n + 1), dtype=np.int64)
    for c in range(5):
        np.cumsum(chars == c, out=counts[c, 1:])
    for c in range(5):
        occ5[c] = counts[c, : n_blocks * BP_PER_BLOCK : BP_PER_BLOCK].astype(np.uint64)
    # 4-bit packed chars, pairs little-endian (low nibble = even index,
    # src/bwt.c:142-155); trailing odd char padded with 0xF
    padded = np.concatenate([chars, np.full((-n) % 2, 0xF, dtype=np.uint8)])
    packed = (padded[0::2] | (padded[1::2] << 4)).astype(np.uint8)
    pad_bytes = n_blocks * 128 - len(packed)
    packed = np.concatenate([packed, np.zeros(pad_bytes, dtype=np.uint8)])
    blocks = np.zeros(n_blocks * BLOCK_BYTES, dtype=np.uint8)
    bv = blocks.reshape(n_blocks, BLOCK_BYTES)
    bv[:, :40] = occ5.T.copy().view(np.uint8).reshape(n_blocks, 40)
    bv[:, 40:] = packed.reshape(n_blocks, 128)
    with open(p(".bwt"), "wb") as f:
        np.array([n_blocks * BLOCK_BYTES], dtype=np.uint64).tofile(f)
        blocks.tofile(f)
        idx.rank[:5].astype(np.uint64).tofile(f)
        idx.hash13.astype(np.uint64).tofile(f)

    # ---- .sa: every 8th row -> (unitig_ID, offset) of position-1 -----------
    sa_rows = np.arange(0, n, 8)
    pos1 = (idx.row_pos[sa_rows] - 1) % idx.text_len
    u = np.searchsorted(idx.uni_start[1 : idx.n_uni + 1], pos1, side="right")
    off = pos1 - idx.uni_start[u]
    sa = np.empty(len(sa_rows) * 2, dtype=np.uint32)
    sa[0::2] = u.astype(np.uint32)
    sa[1::2] = off.astype(np.uint32)
    with open(p(".sa"), "wb") as f:
        np.array([len(sa_rows)], dtype=np.uint64).tofile(f)
        sa.tofile(f)

    # ---- .acg: popcount tables (src/bwt.c:169-182) --------------------------
    with open(p(".acg"), "wb") as f:
        np.array([65536], dtype=np.uint64).tofile(f)
        acg_tables().tofile(f)

    # ---- .exk0/.exk1/.exki --------------------------------------------------
    idx.ekmer0.tofile(p(".exk0"))
    idx.ekmer1.tofile(p(".exk1"))
    np.array([idx.e_kmer_size], dtype=np.uint64).tofile(p(".exki"))

    # ---- .unv ---------------------------------------------------------------
    unv = np.empty((idx.n_uni + 1, 2), dtype=np.uint32)
    unv[:, 0] = idx.uni_ref_list
    unv[:, 1] = idx.uni_len
    with open(p(".unv"), "wb") as f:
        np.array([idx.n_uni + 1], dtype=np.uint64).tofile(f)
        unv.tofile(f)

    # ---- .ref_b -------------------------------------------------------------
    with open(p(".ref_b"), "wb") as f:
        np.array([len(idx.ref_bin)], dtype=np.uint64).tofile(f)
        idx.ref_bin.tofile(f)

    # ---- .ref_i: REF_INFO{char[128], u64 seq_l, u64 seq_offset} -------------
    n_ref = len(idx.ref_name)
    ri = np.zeros(n_ref, dtype=np.dtype([("name", "S128"), ("l", "<u8"), ("off", "<u8")]))
    for i, nm in enumerate(idx.ref_name):
        ri["name"][i] = nm.encode()
    ri["l"] = idx.ref_len
    ri["off"] = idx.ref_off
    with open(p(".ref_i"), "wb") as f:
        np.array([n_ref], dtype=np.uint64).tofile(f)
        ri.tofile(f)

    # ---- .ref_p: REF_POS{global_offset:40, ref_ID:23, direction:1} ----------
    rp = (
        idx.rp_global_off.astype(np.uint64)
        | (idx.rp_ref_id.astype(np.uint64) << np.uint64(40))
        | (idx.rp_dir.astype(np.uint64) << np.uint64(63))
    )
    with open(p(".ref_p"), "wb") as f:
        np.array([len(rp)], dtype=np.uint64).tofile(f)
        rp.tofile(f)


def acg_tables() -> np.ndarray:
    """The 5 x 64K nibble-equality popcount tables (src/bwt.c:169-182)."""
    i = np.arange(65536, dtype=np.uint64)
    out = np.zeros((5, 65536), dtype=np.uint8)
    for c in range(5):
        mask = np.uint64(c * 0x1111)
        x = i ^ mask
        cnt = np.zeros(65536, dtype=np.uint8)
        for nib in range(4):
            cnt += ((x >> np.uint64(4 * nib)) & np.uint64(0xF)) == 0
        out[c] = cnt
    return out


def load_reference_index(in_dir: str, prefix: str = "deSAMBA") -> IndexData:
    """Load a reference-format index into IndexData (row_pos reconstructed)."""
    p = lambda ext: os.path.join(in_dir, prefix + ext)
    with open(p(".bwt"), "rb") as f:
        byte_len = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        blocks = np.fromfile(f, dtype=np.uint8, count=byte_len).reshape(-1, BLOCK_BYTES)
        rank5 = np.fromfile(f, dtype=np.uint64, count=5)
        hash13 = np.fromfile(f, dtype=np.uint64, count=(1 << (2 * L_PRE_IDX)) + 1)
    packed = blocks[:, 40:].reshape(-1)
    chars_all = np.empty(len(packed) * 2, dtype=np.uint8)
    chars_all[0::2] = packed & 0xF
    chars_all[1::2] = packed >> 4
    n_rows = int(rank5[3])  # rank[3] = total rows before 'T' block + T count...
    # recover true length: rows = rank[0] + counts of ACGT; rank arrays do not
    # directly give it, so trim trailing 0xF padding instead
    valid = chars_all <= 5
    n_rows = int(np.max(np.flatnonzero(valid))) + 1 if valid.any() else 0
    row_char = chars_all[:n_rows]

    sa_raw = np.fromfile(p(".sa"), dtype=np.uint64)
    sa = sa_raw[1:].view(np.uint32).reshape(-1, 2)

    with open(p(".unv"), "rb") as f:
        n = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        unv = np.fromfile(f, dtype=np.uint32, count=2 * n).reshape(-1, 2)
    uni_ref_list, uni_len = unv[:, 0].copy(), unv[:, 1].copy()
    n_uni = n - 1
    uni_start = np.zeros(n_uni + 1, dtype=np.int64)
    np.cumsum(uni_len[:n_uni].astype(np.int64) + 1, out=uni_start[1:])
    text_len = int(uni_start[n_uni])

    # reconstruct row positions from SA samples + LF (only needed for tests /
    # gold engine on reference-built indexes): position of sampled rows is
    # (uni_start[u] + off + 1) % text_len
    row_pos = np.full(n_rows, -1, dtype=np.int64)
    rows = np.arange(0, n_rows, 8)
    u, off = sa[:, 0].astype(np.int64), sa[:, 1].astype(np.int64)
    row_pos[rows] = (uni_start[np.minimum(u, n_uni)] + off + 1) % text_len

    with open(p(".ref_b"), "rb") as f:
        nb = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        ref_bin = np.fromfile(f, dtype=np.uint8, count=nb)
    with open(p(".ref_i"), "rb") as f:
        nr = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        ri = np.fromfile(f, dtype=np.dtype([("name", "S128"), ("l", "<u8"), ("off", "<u8")]), count=nr)
    with open(p(".ref_p"), "rb") as f:
        np_ = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
        rp = np.fromfile(f, dtype=np.uint64, count=np_)
    e_kmer_size = int(np.fromfile(p(".exki"), dtype=np.uint64)[0])
    from ..constants import EKMER_PARAMS

    mask_bits, len_e_kmer = EKMER_PARAMS[e_kmer_size]
    rank = np.zeros(6, dtype=np.int64)
    rank[:5] = rank5.astype(np.int64)
    rank[5] = rank[0] - 1

    return IndexData(
        row_char=row_char,
        row_pos=row_pos,
        rank=rank,
        hash13=hash13,
        dollar_pos=n_uni - 1,
        n_uni=n_uni,
        uni_len=uni_len,
        uni_ref_list=uni_ref_list,
        uni_start=uni_start,
        text_len=text_len,
        rp_global_off=(rp & np.uint64((1 << 40) - 1)).astype(np.int64),
        rp_ref_id=((rp >> np.uint64(40)) & np.uint64((1 << 23) - 1)).astype(np.int32),
        rp_dir=(rp >> np.uint64(63)).astype(np.uint8),
        ref_bin=ref_bin,
        ref_name=[x.decode() for x in ri["name"]],
        ref_len=ri["l"].astype(np.int64),
        ref_off=ri["off"].astype(np.int64),
        ekmer0=np.fromfile(p(".exk0"), dtype=np.uint8),
        ekmer1=np.fromfile(p(".exk1"), dtype=np.uint8),
        e_kmer_size=e_kmer_size,
        len_e_kmer=len_e_kmer,
        e_hash_mask=(1 << mask_bits) - 1,
        single_base_max=int(0.8 * len_e_kmer),
    )
