"""Compare-count lookup: the K3 kernel's wrapper and its plain version.

    out[b, p] = sum over r < repeats of #{k : t[b, k] < q[b, p] + r}

all in int32 (signed compare, wrapping adds), as the Pallas kernels of
``tools/gather_bench.py`` (``pallas_cc``) and ``tools/gather_bench2.py``
(``cc_pallas``) compute it on the TPU. Their CUDA counterpart is
``kernels/cmpcount.cu``: one block per table row, which stages the row in
shared memory, sorts it there only if it does not ascend, and runs one
binary search per threshold q + r. The table may be unsorted: the count
does not depend on order. ``lanes_per_block`` (1 for the first tool's
variant, 8 for the second's) names the TPU kernel's grid step, so that the
bench's two variants stay distinct; it does not set the launch geometry,
which is always one block per row. On the card a row may hold at most
``MAX_K`` entries (its padded copy fills 128 KB of shared memory).

``compare_count`` launches the kernel for CUDA tensors and runs
``compare_count_plain`` only for CPU tensors; there is no other path.
``torch.searchsorted`` over the sorted table, summed over r, computes the
same function; ``chip_smoke.py`` times it as a yardstick, and the port
never calls it.
"""
from __future__ import annotations

import torch

I32 = torch.int32
MAX_K = 32767   # entries of a row on the card (CMPCOUNT_MAX_N - 1 in the .cu)


def _check(q, t, repeats, lanes_per_block):
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"compare_count: q (B, P) and t (B, K) must share B, "
                         f"got {tuple(q.shape)} and {tuple(t.shape)}")
    if q.dtype != I32 or t.dtype != I32:
        raise ValueError("compare_count: q and t must be int32")
    if q.device != t.device:
        raise ValueError("compare_count: q and t must be on one device")
    if repeats < 0 or lanes_per_block < 1:
        raise ValueError("compare_count: repeats >= 0 and lanes_per_block "
                         ">= 1")


def compare_count_plain(q, t, repeats: int):
    """The plain version: one (B, P, K) comparison per repeat."""
    _check(q, t, repeats, 1)
    acc = torch.zeros(q.shape, dtype=I32, device=q.device)
    for r in range(repeats):
        acc += (t[:, None, :] < (q + r)[:, :, None]).sum(dim=2, dtype=I32)
    return acc


def compare_count(q, t, repeats: int, lanes_per_block: int = 1):
    """(B, P) int32 counts. CUDA tensors launch ``kernels/cmpcount.cu`` on
    torch's current stream, one block per row whatever ``lanes_per_block``
    says (or raise); CPU tensors take the plain version."""
    _check(q, t, repeats, lanes_per_block)
    if q.device.type == "cpu":
        return compare_count_plain(q, t, repeats)
    if q.device.type != "cuda":
        raise ValueError(f"compare_count: unsupported device {q.device}")
    from ..kernels.build import cmpcount_lib

    q, t = q.contiguous(), t.contiguous()
    (B, P), K = q.shape, t.shape[1]
    if K > MAX_K:
        raise ValueError(f"compare_count: a row of {K} entries does not fit "
                         f"the kernel's shared memory (at most {MAX_K})")
    out = torch.empty((B, P), dtype=I32, device=q.device)
    rc = cmpcount_lib().cmpcount_launch(
        q.data_ptr(), t.data_ptr(), out.data_ptr(), B, P, K, repeats,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cmpcount kernel launch failed: CUDA error {rc}")
    compare_count.launches += 1
    return out


compare_count.launches = 0
