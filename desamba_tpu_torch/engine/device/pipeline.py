"""13-mer prefix values and the seeding step.

Counterpart of ``desamba_tpu/engine/device/pipeline.py``: ``pre13_values``
(the classify path's) and ``seed_wave_step``, the per-batch seeding step
(existence probe + first-wave FM MEM search) that the JAX package's
single-step entry and ``parallel.mesh.sharded_seed_step`` build on. No
Pallas kernel was behind the seeding step; its plain torch version here
is its port.
"""
from __future__ import annotations

import torch

from ...constants import (L_PRE_IDX, MEM_SEARCH_FAST, MIN_MEM_LEN_FAST,
                          PRE_IDX_MASK, STEP_EK)

from . import fm as dev_fm
from .intops import I32, I64
from .islands import bloom_hit_kernel
from .textwalk import pack2


def pre13_values(codes, l_ek: int):
    """13-mer prefix value for the e-kmer ending at each position.

    codes: (B, L) uint8; returns (B, L - l_ek + 1) int32
    (kmer & PRE_IDX_MASK)."""
    B, L = codes.shape
    n_k = L - l_ek + 1
    c64 = codes.to(I64)
    pre = torch.zeros((B, n_k), dtype=I64, device=codes.device)
    for j in range(L_PRE_IDX):
        off = l_ek - L_PRE_IDX + j
        pre = pre | (c64[:, off : off + n_k] << (2 * (L_PRE_IDX - 1 - j)))
    return (pre & PRE_IDX_MASK).to(I32)


def index_args(dix):
    """The positional index arguments of ``seed_wave_step`` (the port's
    ``mem_probe`` takes the ``IndexRefs`` where the JAX one takes
    ``WalkRefs``: the same tables)."""
    return (dix.index_refs(), dix.fm_blocks, dix.rank, dix.hash13,
            dix.ekmer0, dix.ekmer1)


def seed_wave_step(ixr, fm_blocks, rank6, hash13, ek0, ek1, codes, lengths,
                   *, l_ek: int, single_base_max: int, mask_bits: int,
                   n_probes: int = 8):
    """(codes, lengths) -> (hit_count, mem_len, mem_valid).

    Probes the existence filter for every read position, picks the first
    ``n_probes`` hit positions (>= STEP_EK apart) and runs fast-mode FM
    MEM search on them."""
    hit = bloom_hit_kernel(codes, lengths, ek0, ek1, l_ek, single_base_max,
                           mask_bits)
    return mem_wave(ixr, fm_blocks, rank6, hash13, codes, hit, l_ek,
                    n_probes)


def mem_wave(ixr, fm_blocks, rank6, hash13, codes, hit, l_ek: int,
             n_probes: int):
    """``seed_wave_step`` from the existence hits ``hit`` (B, n_k) of
    ``codes`` on: the first ``n_probes`` hits, at least STEP_EK apart,
    MEM-probed one after another (the SP_SET carried between them)."""
    B, n_k = hit.shape
    dev = codes.device
    pos = torch.arange(n_k, dtype=I32, device=dev)[None, :]
    taken_after = torch.zeros((B,), dtype=I32, device=dev)
    p_idx, p_ok = [], []
    for _ in range(n_probes):
        cand = hit & (pos >= taken_after[:, None])
        # argmax over a boolean row: its first True, else 0
        i = cand.to(torch.uint8).argmax(dim=1).to(I32)
        ok = torch.gather(cand, 1, i[:, None].long())[:, 0]
        taken_after = torch.where(ok, i + STEP_EK, n_k)
        p_idx.append(i)
        p_ok.append(ok)
    pre = pre13_values(codes, l_ek)
    spset, spcount = dev_fm.spset_init(B, device=dev)
    codes_pk = pack2(codes)
    lens, valids = [], []
    for ki, ok in zip(p_idx, p_ok):
        out = dev_fm.mem_probe(
            ixr, fm_blocks, rank6, hash13, codes, codes_pk, ki + l_ek - 1,
            torch.gather(pre, 1, ki[:, None].long())[:, 0], ok, spset,
            spcount, MEM_SEARCH_FAST, MIN_MEM_LEN_FAST - 1)
        res_len, _sp, _sa, _ok, _sal, res_valid, spset, spcount = out
        lens.append(res_len)
        valids.append(res_valid)
    return (hit.sum(dim=1, dtype=I32), torch.stack(lens, 1),
            torch.stack(valids, 1))
