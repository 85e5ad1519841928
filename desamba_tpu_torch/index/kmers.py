"""2-bit base encoding and vectorized k-mer extraction (numpy, host side).

Encodings mirror the reference tables: `Bit` (non-ACGT -> 4, src/idx.c:9-27),
`bin_Bit` (non-ACGT -> A, src/idx.c:29-47), `CLY_Bit` (non-ACGT -> C,
src/cly.c:17-35). A=0 C=1 G=2 T=3.
"""
from __future__ import annotations

import numpy as np

# non-ACGT -> 4 (invalid marker)
BIT = np.full(256, 4, dtype=np.uint8)
# non-ACGT -> 0 ('A'), used for packing the reference
BIN_BIT = np.zeros(256, dtype=np.uint8)
# non-ACGT -> 1 ('C'), used for binarizing reads
CLY_BIT = np.ones(256, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    for _o in (ord(_c), ord(_c.lower())):
        BIT[_o] = _i
        BIN_BIT[_o] = _i
        CLY_BIT[_o] = _i


def encode(seq: bytes | str, table: np.ndarray = BIT) -> np.ndarray:
    """Encode an ASCII sequence to 2-bit codes via the given table."""
    if isinstance(seq, str):
        seq = seq.encode()
    return table[np.frombuffer(seq, dtype=np.uint8)]


def rolling_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All length-k windows of `codes` as uint64 values (first base = MSBs).

    codes must already be valid 2-bit values (0..3). Returns array of
    len(codes)-k+1 values; empty if too short.
    """
    n = len(codes)
    if n < k:
        return np.empty(0, dtype=np.uint64)
    vals = np.zeros(n - k + 1, dtype=np.uint64)
    c = codes.astype(np.uint64)
    for j in range(k):
        vals |= c[j : n - k + 1 + j] << np.uint64(2 * (k - 1 - j))
    return vals


def valid_kmer_mask(valid: np.ndarray, k: int) -> np.ndarray:
    """Mask of windows (len n-k+1) where all k bases are valid (ACGT)."""
    n = len(valid)
    if n < k:
        return np.empty(0, dtype=bool)
    cs = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    return (cs[k:] - cs[:-k]) == k


def unique_kmers_of_fasta_codes(seq_codes: list[np.ndarray], k: int) -> np.ndarray:
    """Sorted unique forward-strand k-mers over maximal ACGT runs.

    Matches jellyfish count -m k (no -C) + deSAMBA kmersort output
    (reference build-index:88-106): k-mers containing non-ACGT are skipped,
    runs shorter than k produce nothing.
    """
    chunks = []
    for codes in seq_codes:
        m = valid_kmer_mask(codes < 4, k)
        if m.any():
            chunks.append(rolling_kmers(np.minimum(codes, 3), k)[m])
    if not chunks:
        return np.empty(0, dtype=np.uint64)
    return np.unique(np.concatenate(chunks))


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes 4 bases/byte, first base in the top 2 bits.

    Matches the reference's ref_bin layout (src/idx.c:595-603).
    """
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=codes.dtype)])
    q = codes.reshape(-1, 4).astype(np.uint8)
    return (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]


def unpack_2bit(packed: np.ndarray, start: int, length: int) -> np.ndarray:
    """Read `length` bases starting at global base offset `start` (forward)."""
    if length <= 0:
        return np.empty(0, dtype=np.uint8)
    idx = start + np.arange(length)
    byte = packed[idx >> 2]
    shift = (6 - ((idx & 3) << 1)).astype(np.uint8)
    return (byte >> shift) & 0x3


def hash64_1(key: np.ndarray) -> np.ndarray:
    """Thomas Wang 64-bit mix #1 (reference src/lib/utils.c:1067-1078)."""
    key = np.asarray(key, dtype=np.uint64)
    key = (~key) + (key << np.uint64(21))
    key = key ^ (key >> np.uint64(24))
    key = key + (key << np.uint64(3)) + (key << np.uint64(8))
    key = key ^ (key >> np.uint64(14))
    key = key + (key << np.uint64(2)) + (key << np.uint64(4))
    key = key ^ (key >> np.uint64(28))
    key = key + (key << np.uint64(31))
    return key


def hash64_2(key: np.ndarray) -> np.ndarray:
    """64-bit mix #2 (reference src/lib/utils.c:1081-1092)."""
    key = np.asarray(key, dtype=np.uint64)
    key = key + (~(key << np.uint64(32)))
    key = key ^ (key >> np.uint64(22))
    key = key + (~(key << np.uint64(13)))
    key = key ^ (key >> np.uint64(8))
    key = key + (key << np.uint64(3))
    key = key ^ (key >> np.uint64(15))
    key = key + (~(key << np.uint64(27)))
    key = key ^ (key >> np.uint64(31))
    return key
