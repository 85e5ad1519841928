"""MAPQ score tables (reference src/cly_mt.c:413-437)."""
from __future__ import annotations

import math

import numpy as np

from ...constants import MAX_LV_R_LEN, MAX_LV_WRONG, P_E, Q_MEM_MAX


def _c_int(x: float) -> int:
    """C double->int conversion (truncation toward zero)."""
    return int(x)


def mapq_tables(l_ref: int):
    ref_size_penalty = -10 * math.log(l_ref) / math.log(10)
    match_score = -10 * math.log(0.25 / (1 - P_E)) / math.log(10)
    mismatch_penalty = -10 * math.log(0.75 / P_E) / math.log(10)
    q_mem = np.empty(Q_MEM_MAX, dtype=np.int64)
    for i in range(Q_MEM_MAX):
        q_mem[i] = _c_int(ref_size_penalty + i * match_score + 0.5)
    q_lv = np.empty((MAX_LV_WRONG, MAX_LV_R_LEN), dtype=np.int64)
    for j in range(MAX_LV_R_LEN):
        for i in range(MAX_LV_WRONG):
            v = _c_int((j - i) * match_score + i * mismatch_penalty + 0.5)
            if j < 5:
                v += 15
            q_lv[i, j] = max(v, -8)
    return q_mem, q_lv
