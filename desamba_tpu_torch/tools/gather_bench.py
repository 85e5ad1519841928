"""Gather-cost bench: what one per-lane lookup costs on the card.

    python -m desamba_tpu_torch.tools.gather_bench [B] [which] [--device cuda]

Counterpart of both ``tools/gather_bench.py`` and ``tools/gather_bench2.py``.
A read's 9-mer table is B lanes of K rows, probed by P queries per lane;
each variant repeats its lookup R times with the query advanced by one, as
the TPU tools' loops do, and prints one line: milliseconds per call and ns
per element (elements = looked-up entries times R). ``which`` selects one
variant group (default all):

  gather   ``table[b, q % K]`` per query (torch indexing)
  mxu      one-hot (B, P, K) bf16 product with the table (``torch.matmul``)
  cmp      compare-count, the plain PyTorch version
  pallas   compare-count, the ``cmpcount`` kernel on the sorted table (K3a,
           ``pallas_cc``): each block finds its row ascending and only
           searches it
  rows     row gathers ``table[q % M]`` of N rows, widths 1-256 int8 and
           128 int32 (``gather_bench2.py``)
  blocked  compare-count, the ``cmpcount`` kernel on an unsorted table (K3b,
           ``cc_pallas``, whose TPU grid step held 8 lanes): each block
           sorts its row in shared memory, then searches it

It runs on the card (``--device cuda``, the default) and times each call by
CUDA events; ``--device cpu`` runs the same code with the kernels' plain
versions and host-clock times, for tests. The TPU tools perturbed their
inputs between timed calls to defeat a relay's memoization; nothing here
memoizes, so the inputs stay fixed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .cmpcount import compare_count, compare_count_plain

B_TOOLS = 512   # lanes, the TPU tools' default
K = 1152      # per-lane table rows (a read's 9-mer table)
P = 176       # queries per lane (probes per window)
R = 16        # repeats of each lookup
N_ROWS = 16384  # rows per row gather
LANES_BLOCKED = 8
GROUPS = ("gather", "mxu", "cmp", "pallas", "rows", "blocked")


def make_inputs(B: int, device, seed: int = 0, k: int = K, p: int = P):
    """The bench's tables and queries, made with numpy from ``seed``: a
    (B, k) table, its row-sorted copy, (B, p) indices below k and (B, p)
    values below 2^18, and a second unsorted (B, k) table with its own
    (B, p) values for the blocked variant."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.int32)).to(device)

    table = t(rng.integers(0, 1 << 18, (B, k)))
    return dict(table=table, tsort=torch.sort(table, dim=1).values,
                qidx=t(rng.integers(0, k, (B, p))),
                qval=t(rng.integers(0, 1 << 18, (B, p))),
                table_b=t(rng.integers(0, 1 << 18, (B, k))),
                qval_b=t(rng.integers(0, 1 << 18, (B, p))))


def time_ms(fn, device, reps: int = 3) -> float:
    """Mean milliseconds of fn() after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def gather(qidx, table, repeats=R):
    acc = torch.zeros(qidx.shape, dtype=torch.int32, device=qidx.device)
    q = qidx
    for _ in range(repeats):
        acc += torch.gather(table, 1, (q % table.shape[1]).long())
        q = q + 1
    return acc


def onehot_mxu(qidx, table, repeats=R):
    """One-hot (B, P, K) bf16 times the (B, K) table. The TPU tool asked
    for a float32 result; torch's bf16 product rounds its result to bf16,
    so the sum is kept in float32 outside it."""
    k = table.shape[1]
    ks = torch.arange(k, dtype=torch.int32, device=qidx.device)
    tb = table.to(torch.bfloat16)[:, :, None]
    acc = torch.zeros(qidx.shape, dtype=torch.float32, device=qidx.device)
    q = qidx
    for _ in range(repeats):
        oh = (q[:, :, None] % k == ks).to(torch.bfloat16)
        acc += torch.matmul(oh, tb)[:, :, 0].float()
        q = q + 1
    return acc


def row_gather(idx, table, repeats=R):
    acc = torch.zeros(idx.shape, dtype=torch.int32, device=idx.device)
    q = idx
    for _ in range(repeats):
        acc += table[(q % table.shape[0]).long()].to(torch.int32).sum(
            dim=1, dtype=torch.int32)
        q = q + 1
    return acc


def _line(name, ms, elems, rows=None):
    per = f"{ms * 1e6 / (elems * R):9.4f} ns/elem"
    if rows is not None:
        per = f"{ms * 1e6 / (rows * R):9.3f} ns/row  " + per
    print(f"{name:40s} {ms:10.4f} ms  {per}  ({elems * R / 1e6:.1f} M elems)",
          flush=True)


def main(argv=None, reps: int = 3):
    """Run the selected variants, each timed over ``reps`` calls after one
    warm-up; returns {variant: record}, each with ``ms``, ``ns_per_elem``
    and ``elems`` and, for the two kernel variants, ``out`` (the kernel's
    result), ``inputs`` (q, t) and ``launches``."""
    ap = argparse.ArgumentParser(prog="gather_bench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=B_TOOLS, help="lanes")
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all",) + GROUPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("gather_bench: no CUDA device is available")
    B = args.B
    groups = GROUPS if args.which == "all" else (args.which,)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"B={B} K={K} P={P} R={R} device={name}", flush=True)
    x = make_inputs(B, dev)
    out = {}

    def run(key, label, fn, elems, rows=None):
        ms = time_ms(fn, dev, reps)
        _line(label, ms, elems, rows)
        out[key] = dict(ms=ms, ns_per_elem=ms * 1e6 / (elems * R),
                        elems=elems)

    def kernel(key, label, q, t, lanes):
        if dev.type == "cpu":
            label += " (its plain version on the cpu)"
        n0 = compare_count.launches
        res = compare_count(q, t, R, lanes)
        run(key, label, lambda: compare_count(q, t, R, lanes), B * P * K)
        out[key].update(out=res, inputs=(q, t), lanes_per_block=lanes,
                        launches=compare_count.launches - n0)

    if "gather" in groups:
        run("gather", "gather table[b, q % K]",
            lambda: gather(x["qidx"], x["table"]), B * P)
    if "mxu" in groups:
        run("mxu", "one-hot bf16 matmul",
            lambda: onehot_mxu(x["qidx"], x["table"]), B * P * K)
    if "cmp" in groups:
        run("cmp", "compare-count, plain PyTorch",
            lambda: compare_count_plain(x["qval"], x["tsort"], R), B * P * K)
    if "pallas" in groups:
        kernel("pallas", "compare-count kernel, sorted table",
               x["qval"], x["tsort"], 1)
    if "rows" in groups:
        rng = np.random.default_rng(1)
        for width, dt in [(w, torch.int8) for w in (1, 8, 32, 128, 256)] + [
                (128, torch.int32)]:
            m = (1 << 22) // width
            table = torch.from_numpy(rng.integers(0, 100, (m, width)).astype(
                np.int8 if dt == torch.int8 else np.int32)).to(dev)
            idx = torch.from_numpy(rng.integers(0, m, N_ROWS).astype(
                np.int32)).to(dev)
            tname = str(dt).replace("torch.", "")
            run(f"rows_w{width}_{tname}", f"row gather w={width} {tname}",
                lambda: row_gather(idx, table), N_ROWS * width, rows=N_ROWS)
    if "blocked" in groups:
        kernel("blocked", "compare-count kernel, unsorted table",
               x["qval_b"], x["table_b"], LANES_BLOCKED)
    return out


if __name__ == "__main__":
    main()
