"""9-mer sparse-DP rescore: the shared record layout.

Counterpart of the parts of ``desamba_tpu/engine/device/rescore.py`` that
the port needs: ``RescoreIn``, the cap and field constants, and
``_pack2``. The JAX module's 961-line lockstep VM is not ported; its two
jobs (the rescore off the TPU and the M3 sub-batch at ``chain.M3_A2``
anchors) pass to the hand-written kernel (``rescore_pl.py``) and its
plain version (``rescore_ref.py``), both of which take the anchor width
at run time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...constants import S_A_KMER_L

from .textwalk import pack2

K9 = S_A_KMER_L

C_CAP = 8        # chains per read
A_CAP = 64       # anchors per read (main batch; the M3 sub-batch runs at
#                  chain.M3_A2 — the width is read from anchors.shape[1])
S_CAP = 128      # sms nodes per extension
W_CAP = 704      # window chars incl. 50-pad

# chain record fields
CF = ("ref_id", "direction", "sum_score", "anchor_number", "t_st", "t_ed",
      "q_st", "q_ed", "indel", "cur_anchor")
CF_N = len(CF)
(C_REF, C_DIR, C_SUM, C_ANUM, C_TST, C_TED, C_QST, C_QED, C_INDEL,
 C_CUR) = range(CF_N)

# anchor record fields: index_in_read, ref_offset, mtch_len, pre (-1 none)
AF_N = 4


class RescoreIn(NamedTuple):
    """Per-batch device inputs (B = reads)."""
    chains: torch.Tensor     # (B, C_CAP, CF_N) int32
    n_chains: torch.Tensor   # (B,) int32
    anchors: torch.Tensor    # (B, A2, AF_N) int32
    schash: torch.Tensor     # (B, 2*C_CAP, 3) int32 [key, ci, s_or_e]
    n_hash: torch.Tensor     # (B,) int32
    codes_fr: torch.Tensor   # (B, 2L) uint8
    buf_len: torch.Tensor    # (B,) int32
    read_len: torch.Tensor   # (B,) int32


def _pack2(ch):
    """(N, L) uint8 chars -> (N, ceil(L/16)) int32 u32 bit patterns, char j
    of a word at bits 2j..2j+1 (little-endian char order)."""
    return pack2(ch)
