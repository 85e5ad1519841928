"""Island detection: e-kmer rolling + 2-hash existence probe + top marking.

Faithful to src/cly.c:360-398 (store_kmers), 1071-1160 (search_exist_kmer_M2),
1162-1234 (get_seed_vector_M2), 1236-1268 (getIsland). The probe itself is
vectorized; the island expansion walk keeps the reference's exact stride /
reset behavior (including quirks like windows advancing one SEED_RANGE per
boundary crossing regardless of gap size).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...constants import FORWARD, REVERSE, SEED_RANGE, STEP_EK
from ...index.kmers import CLY_BIT, hash64_1, hash64_2
from ...io import native


@dataclass
class SearchDir:
    seeds: list          # list of [offset, length, top] (mutable)
    bin_read: np.ndarray  # uint8 codes for this direction (view into buf)
    kmer_hit: np.ndarray  # bool per kmer position: passes existence filter
    direction: int
    total_score: int
    buf: np.ndarray = None   # full F+R buffer (C: one allocation, src/cly.c:1241)
    base: int = 0            # this direction's offset into buf


def store_kmers_mask(bin_read: np.ndarray, n_kmers: int, l_ek: int,
                     single_base_max: int) -> np.ndarray:
    """Rolling e-kmers with low-complexity filter; 0 = filtered (src/cly.c:360)."""
    c = bin_read.astype(np.uint64)
    vals = np.zeros(n_kmers, dtype=np.uint64)
    for j in range(l_ek):
        vals |= c[j : n_kmers + j] << np.uint64(2 * (l_ek - 1 - j))
    # per-window base counts via cumsum
    bad = np.zeros(n_kmers, dtype=bool)
    for b in range(4):
        cs = np.concatenate([[0], np.cumsum(bin_read == b)])
        bad |= (cs[l_ek:n_kmers + l_ek] - cs[:n_kmers]) >= single_base_max
    vals[bad] = 0
    return vals


def exist_mask(kmers: np.ndarray, ek0: np.ndarray, ek1: np.ndarray,
               hash_mask: int) -> np.ndarray:
    """Vectorized 2-hash existence probe (src/cly.c:956-972); kmer 0 never hits."""
    h1 = (hash64_1(kmers) & np.uint64(hash_mask)).astype(np.int64)
    hit = (ek0[h1 >> 3] >> (7 - (h1 & 7)).astype(np.uint8)) & 1
    h2 = (hash64_2(kmers) & np.uint64(hash_mask)).astype(np.int64)
    hit2 = (ek1[h2 >> 3] >> (7 - (h2 & 7)).astype(np.uint8)) & 1
    return (hit & hit2 & (kmers != 0)).astype(bool)


def search_islands(hit: np.ndarray, direction: int) -> list:
    """Island expansion (src/cly.c:1071-1160). Returns [[offset, len], ...]."""
    n = len(hit)
    seeds = []
    if direction == FORWARD:
        i = STEP_EK - 1
        while i < n:
            if hit[i]:
                offset, length = i, 1
                for j in range(1, STEP_EK):
                    if hit[i - j]:
                        offset -= 1
                        length += 1
                    else:
                        break
                j = 1
                while i + j < n:
                    if hit[i + j]:
                        length += 1
                        if length > 60:
                            break
                    else:
                        break
                    j += 1
                seeds.append([offset, length, 0])
                i = offset + length
            i += STEP_EK
    else:
        i = n - STEP_EK
        while i >= 0:
            if hit[i]:
                offset, length = i, 1
                for j in range(1, STEP_EK):
                    if i + j < n and hit[i + j]:
                        offset += 1
                        length += 1
                    else:
                        break
                j = 1
                while j <= i:
                    if hit[i - j]:
                        length += 1
                        if length > 60:
                            break
                    else:
                        break
                    j += 1
                seeds.append([offset - length + 1, length, 0])
                i = offset - length
            i -= STEP_EK
    return seeds


def mark_top(seeds: list, n_kmers: int, direction: int) -> int:
    """Top-island-per-100bp-window marking; returns total_score
    (src/cly.c:1174-1226). Mutates seeds in place."""
    total_score = 0
    max_index, max_length, index_end = 0, 0, SEED_RANGE
    for m, s in enumerate(seeds):
        s[2] = 0
        key = s[0] if direction == FORWARD else n_kmers - s[0] - s[1]
        if key < index_end:
            if max_length < s[1]:
                max_length = s[1]
                max_index = m
            seeds[max_index][2] = 0
        else:
            seeds[max_index][2] = 1
            index_end += SEED_RANGE
            total_score += max_length
            max_index, max_length = m, s[1]
    if seeds:
        seeds[max_index][2] = 1
    total_score += max_length
    return total_score


def get_islands(read_seq: str, idx, *,
                _enc=lambda s: CLY_BIT[np.frombuffer(s.encode(), np.uint8)]):
    """Full getIsland (src/cly.c:1236-1268): both directions, best first.

    Returns (search_dirs[2], both_close) where search_dirs[0] has the higher
    total score.
    """
    l_ek = idx.len_e_kmer
    read_len = len(read_seq)
    n_kmers = read_len - l_ek + 1
    bin_f = _enc(read_seq)
    buf = np.concatenate([bin_f, (3 - bin_f)[::-1]])
    dirs = []
    for base, direction in ((0, FORWARD), (read_len, REVERSE)):
        bin_read = buf[base : base + read_len]
        if native.available():
            seeds, total = native.lazy_islands(
                bin_read, n_kmers, l_ek, idx.single_base_max, idx.ekmer0,
                idx.ekmer1, idx.e_hash_mask, STEP_EK, SEED_RANGE,
                direction == FORWARD)
            hit = None
        else:
            kmers = store_kmers_mask(bin_read, n_kmers, l_ek,
                                     idx.single_base_max)
            hit = exist_mask(kmers, idx.ekmer0, idx.ekmer1, idx.e_hash_mask)
            seeds = search_islands(hit, direction)
            total = mark_top(seeds, n_kmers, direction)
        dirs.append(SearchDir(seeds, bin_read, hit, direction, total, buf, base))
    if dirs[0].total_score < dirs[1].total_score:
        dirs = [dirs[1], dirs[0]]
    both = (dirs[0].total_score - dirs[1].total_score) <= (dirs[0].total_score >> 3)
    return dirs, both
