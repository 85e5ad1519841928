#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (desamba_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--mbases 32] [--reads 4096] \
        [--depths 1,2,3]

Run from the root of a checkout, on a machine with an NVIDIA card, nvcc
and a C compiler. Phases:

1. card and build: print the card's name and power limit, build every
   CUDA kernel from the sources in the checkout, one nvcc each, all
   started together;
2. data: from --seed, a reference collection of viral-genome-sized
   sequences in families of 3-8 strains (1-5 % substitutions and indels
   apart), its index (built on the host, not timed), and long reads with
   ~10 % ONT-like errors, 80 % from the collection and 20 % absent from it;
3. end to end: DeviceClassifier(device="cuda").classify_reads over every
   read (pipelined: two batches of 2,048 at the full size, device phases
   on worker threads, finishes in input order), its SAM byte-equal to the
   gold oracle's (ClassifyEngine) on the same reads, with the slow ladders
   and the M3 path both taken; the kernels' launch counts are zeroed just
   before and read just after this run, and so are the eager ladders' and
   chaining functions' counts of runs: the run fails if the rescore kernel
   (K1), either ladder kernel (B2, B3) or either chaining kernel (B4a,
   B4b) was not launched, or if an eager ladder or chaining function ran
   on the card; the pipeline depth, prep workers and ``os.cpu_count()``,
   each batch's prep, device phase and finish (start and end from the
   call's start) and the island prep's encode, bloom probe and
   segmentation seconds are printed; the calls that phases 5-5d replay are the
   first batch's (told apart by a thread-local set around each device
   phase);
3b. the CLI: phase 3's reads as a FASTQ and its index saved, then
   ``desamba_tpu_torch.cli`` ``classify --engine device`` (``classify_file``;
   counts zeroed just before and read just after, as in phase 3), its SAM
   byte-equal to phase 3's, and ``classify --engine gold -t n`` (n =
   min(8, os.cpu_count())), its SAM byte-equal to
   ``classify_records_formatted`` at one thread; both walls printed;
3c. with --depths, ``classify_reads`` over the same reads once at each
   ``DESAMBA_PIPE_DEPTH`` of the list, in its order, with a new classifier
   each time: the wall and stage times of each, its SAM byte-equal to
   phase 3's;
3d. the mesh, the bootstrap and the entry, on phase 3's first batch
   (2,048 reads) with fresh classifiers: a DeviceClassifier, then a
   MeshClassifier on a (2, 2) mesh of ``cuda:0`` repeated (and on a
   (2, 1) mesh of two cards where there are two), each SAM byte-equal to
   phase 3's first 2,048 records, the kernels' counts zeroed just before
   and read just after: each sharded stage's kernel (B2, B3, M2, the main
   batch's K1) launched once a dp row for each call of the stage, M3 and
   the M3 sub-batch's K1 once a call, B3 and M3 wherever the single
   classifier launched them, no eager ladder or chaining function; the
   walls and the reads to gold by cause printed beside the single
   classifier's; then ``distributed.initialize`` on a free localhost port
   at world size 1 over NCCL, the multi-process worker's ``all_reduce`` of
   the read count and its ordered gather of the SAM bytes, exact, and
   ``destroy_process_group``; then ``entry()``'s step on the first batch
   three times, timed by CUDA events, its tensors bit-equal to those of
   phase 3's first device phase;
4. long reads: a new DeviceClassifier over one batch of 64 reads, the
   first 62 of phase 3's and two of at least 250 kb (a chimera of whole
   references end to end, and a span of one reference inside random
   sequence), so that K1's 9-mer tables are too wide for the least fence
   stride; its SAM byte-equal to gold's, K1 launched in that run (counts
   zeroed just before, read just after; the ladder and chaining kernels
   too, and no eager ladder or chaining function) and, as in phase 5,
   bit-equal to
   its plain version on every row of each of its batches, with the table
   width, the fence stride, the shared memory a block and the rows of long
   reads with chains printed;
5. K1: the rescore kernel's wrapper on the inputs the main path gave it
   (the first main batch and the first M3 sub-batch), bit-equal
   (tolerance 0) to its plain version on every row (chains and the three
   flag columns), both timed; per width, the rows with chains, the steps
   in all and in the longest walk, the shared memory a block and
   ``ptxas``'s registers, stack and spills;
5b. B2, the fast ladder: the kernel's wrapper on the fast-ladder calls of
   phase 3's first batch (one a group of island lengths) and on the run's
   first re-dispatch at the full SP_SET tier (``iv_cap=None``) where there
   was one, and on the first batch's last call again at ``iv_cap=1``
   (hot-tier overflows), each bit-equal (tolerance 0: packed anchors, info
   rows, pack overflow) to the eager ``fast_ladder`` on the card, its
   longest lane's trips equal to the eager loop's trip count; per call the
   lanes and NB, the kernel's ms by CUDA events twice (the launch alone, on
   arguments and outputs made once, and through the wrapper: launch and
   pack), the plain version's ms and trips, the lanes' mean trips, their
   largest and mean anchor count (a_cnt), the shared memory a block and
   the bound; the record sums the first batch's calls (``ms`` the launches
   alone, ``wrapper_ms`` the wrapper's);
5c. B3, the slow ladder: the same on phase 3's first batch's slow-ladder
   calls (both directions, each a group of island lengths), the run's
   first slow re-dispatch at the full SP_SET tier where there was one, and
   the first batch's last slow call again at ``iv_cap=1``, each bit-equal
   to the eager ``slow_ladder`` on the card (packed anchors, info rows with
   the MEM overflow in column 2, pack overflow), with the same numbers a
   call and ``ptxas``'s line for the kernel;
5d. B4, the chaining: the M2 kernel (B4a, ``chain_kernel`` of
   ``kernels/chain.cu``) on phase 3's first three M2 calls (the first
   batch's fast, slow0 and slow1 chain stages) and the M3 kernel (B4b,
   ``m3_kernel``) on every M3 call of phase 3, each bit-equal (tolerance 0:
   chains, n_out, pre, ovf) to the eager ``chain_kernel``/``m3_kernel`` on
   the card, through the wrapper and through the library entry alone; per
   call B and A2, the kernel's ms three ways (the launch alone on arguments
   and outputs made once, in a replayed CUDA graph and by CUDA events, and
   the wrapper by events), the plain version's ms, the bound
   (``chain_bytes``) and ``ptxas``'s line; per M3 call also the launch
   alone at both block shapes (8 and 4 warps a block, the wrapper's
   first), the shared memory a block and the batch's valid nodes, longest
   run, widest DP window and most runs in a read (``m3_shape``); each
   record sums its calls (``ms`` the launches alone in a graph,
   ``events_ms`` by events, ``wrapper_ms`` the wrapper's);
6. gather bench: the entry point ``desamba_tpu_torch.tools.gather_bench``
   at the TPU tools' full shapes (B 512, K 1,152, P 176, R 16), which
   launches the compare-count kernel (K3) on a sorted table (the 1-lane
   variant) and on an unsorted one (the 8-lane variant); its counts are
   zeroed just before and read just after; each result bit-equal to the
   plain version and to ``torch.searchsorted`` over the sorted table, and
   so is each variant on a seeded edge-case batch (the wrap of q + r, the
   int32 extremes, duplicates; an unsorted table through the 1-lane variant
   and a sorted one through the 8-lane variant, so that the kernel's sort
   and no-sort paths both run for both); kernel and searchsorted timed in a
   replayed CUDA graph and by events around eager calls, the plain version
   by events; ``ptxas``'s line for the kernel;
7. primitive benches: the entry point ``desamba_tpu_torch.tools.micro`` at
   the TPU tools' full shapes and trip counts, which launches each of the 17
   kernels of its 16 sites (K4, K6, K5: gathers, dynamic-offset row loads,
   asynchronous copies and a scalar loop over the whole card, a block, a
   launch); each output bit-equal to its plain version and, where there is
   one, to the one index or elementwise PyTorch call with a sum that
   computes the same function; ``ptxas``'s line and the SASS trip loops
   (``cuobjdump -sass``) of K6.2's, K6.3's and K5.c's kernels, which must
   hold a shared-memory load (K6.2, K6.3) or a multiply-add (K5.c) and
   neither a barrier nor a device load; and K6.2's and K6.3's rates of
   shared-memory loads against the card's 33.45 TB/s (a time under that
   floor fails the run: it would mean gathers were folded away);
8. tile helpers: every body of the harness of ``kernels/plops.cu`` (K2) on
   seeded (R, 128) tiles with the edge cases of the CPU test, bit-equal to
   the plain versions;
9. capability probes: the entry point ``desamba_tpu_torch.tools.caps``
   (K7), every probe OK against its numpy expression (it raises otherwise)
   and bit-equal to its plain version; ``ptxas``'s line and the SASS load
   and store counts of K7.3's ``p_s2``.

A line then lists every kernel slower than its library call in a graph
(printed only: a slow kernel is a finding, not a failure).

Phases 7-9 zero their wrappers' launch counts just before the entry point
runs and read them just after, as phase 6 does. Their kernels, and K3 with
its searchsorted, are timed in a replayed CUDA graph (``micro.graph_ms``;
phase 7 reports the bench's own times): most are shorter than the tens of
microseconds a Python wrapper takes to submit a launch, so events around
eager launches would time the host. Every library call is timed both
ways: in a replayed CUDA graph (the record's ``library_ms``, like its
kernel) and by events around eager calls (``library_eager_ms``, as a
caller runs it; a call that cannot be captured has only this time, and the
run says so). Plain versions are timed by events around eager calls.

Each kernel's bound is the larger of the bytes its function must move
(what this run's data needs of each input, read once; each output written
once) over the card's memory rate and the least operations that function
needs on these inputs over the card's int32 rate (the constants below);
``rescore_bytes``, ``ladder_bytes``, ``chain_bytes``, ``cmpcount_ops`` and
``micro.sites`` say what is counted. A kernel or
library call faster than its bound fails the run, since the bound would
not be one. Any mismatch or exception exits non-zero. The line before the
last is the kernels' JSON record; the last line is the device record.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
# H100 SXM data sheet: 3.35 TB/s of HBM. int32: 64 lanes per SM (Hopper
# white paper) x 132 SMs x 1.98 GHz boost clock, the lanes x clock that
# give the data sheet's 67 TFLOP/s of float32 from 128 lanes x 2 (FMA).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
# shared memory: one 128-byte warp load a clock on each of the 132 SMs
SMEM_BYTES_S = 132 * 128 * 1.98e9


def log(*a):
    print(*a, flush=True)


# ---- phase 2: synthetic data ------------------------------------------------

def _mutate(rng, seq, sub, ins, dele):
    """seq with independent per-base substitutions, 1-base insertions
    and deletions at the given rates."""
    out = seq.copy()
    ps = rng.random(len(out)) < sub
    out[ps] = (out[ps] + rng.integers(1, 4, int(ps.sum()))) % 4
    keep = rng.random(len(out)) >= dele
    at = np.flatnonzero(rng.random(len(out)) < ins)
    out = np.insert(out, at, rng.integers(0, 4, len(at)).astype(np.uint8))
    keep = np.insert(keep, at, True)
    return out[keep]


def make_collection(rng, mbases):
    """[(name, codes)] totalling ~mbases Mbase: families of 3-8 strains of a
    5-60 kb (log-uniform) ancestor, each strain 1-5 % diverged."""
    refs, total, fam = [], 0, 0
    while total < mbases * 1e6:
        L = int(np.exp(rng.uniform(np.log(5000), np.log(60000))))
        anc = rng.integers(0, 4, L).astype(np.uint8)
        for s in range(int(rng.integers(3, 9))):
            d = rng.uniform(0.01, 0.05)
            seq = _mutate(rng, anc, 0.8 * d, 0.1 * d, 0.1 * d)
            refs.append((f"tid|{100000 + len(refs)}|ref|F{fam}_S{s}", seq))
            total += len(seq)
        fam += 1
    return refs


def make_reads(rng, refs, n):
    """n reads, 500-10,000 bp log-uniform, ~10 % errors (4 % substitutions,
    3 % insertions, 3 % deletions); 80 % sampled from refs (either strand,
    chosen by length), 20 % random sequence absent from them."""
    lens = np.array([len(s) for _, s in refs], np.float64)
    pick = lens / lens.sum()
    reads = []
    for i in range(n):
        ln = int(np.exp(rng.uniform(np.log(500), np.log(10000))))
        if rng.random() < 0.8:
            _, src = refs[int(rng.choice(len(refs), p=pick))]
            ln = min(ln, len(src))
            st = int(rng.integers(0, len(src) - ln + 1))
            frag = src[st : st + ln]
            if rng.random() < 0.5:
                frag = (3 - frag)[::-1]
        else:
            frag = rng.integers(0, 4, ln).astype(np.uint8)
        frag = _mutate(rng, frag, 0.04, 0.03, 0.03)
        reads.append((f"read{i}", ACGT[frag].tobytes().decode()))
    return reads


LONG_READ = 250_000   # bases: an ultra-long ONT read


def make_long_reads(rng, refs):
    """Two reads of at least LONG_READ bases with make_reads' errors: a
    chimera of whole references end to end (each drawn by length, either
    strand), and a 2-5 kb span of one reference inside random sequence
    absent from the collection (a provirus in its host's DNA)."""
    lens = np.array([len(s) for _, s in refs], np.float64)
    parts, total = [], 0
    while total < LONG_READ:
        _, src = refs[int(rng.choice(len(refs), p=lens / lens.sum()))]
        parts.append(src if rng.random() < 0.5 else (3 - src)[::-1])
        total += len(src)
    _, src = refs[int(rng.integers(len(refs)))]
    ln = min(int(rng.integers(2000, 5001)), len(src))
    st = int(rng.integers(0, len(src) - ln + 1))
    host = rng.integers(0, 4, LONG_READ).astype(np.uint8)
    out = []
    for name, seq in (("long_chimera", np.concatenate(parts)),
                      ("long_provirus", np.concatenate(
                          [host[: LONG_READ // 2], src[st : st + ln],
                           host[LONG_READ // 2 :]]))):
        seq = _mutate(rng, seq, 0.04, 0.03, 0.03)
        out.append((name, ACGT[seq].tobytes().decode()))
    return out


def write_fasta(path, refs):
    with open(path, "w") as f:
        for name, seq in refs:
            f.write(f">{name}\n{ACGT[seq].tobytes().decode()}\n")


# ---- helpers ----------------------------------------------------------------

def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def ptxas_lines(out, kernel, targs=""):
    """What ``nvcc -Xptxas -v`` said of one kernel (``targs``: a template
    instance's mangled arguments, as ``ILi8E``): its stack, spills,
    registers and shared memory, one string."""
    lines, mine = [], False
    name = f"_Z{len(kernel)}{kernel}{targs}"  # mangled, not a suffix's
    for ln in out.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            mine = name in ln
        if mine and ("stack" in ln or "registers" in ln):
            lines.append(ln.split(":", 1)[-1].strip() if "ptxas" in ln
                         else ln.strip())
    return " | ".join(lines) or "not reported"


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches (after one
    warm-up), by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def library_ms(fn, device):
    """(ms in a replayed CUDA graph, ms by events around eager calls) of a
    library call: as many calls as fit about 20 ms (1 to 50) in the graph,
    as ``micro.main`` times its kernels. The graph time is None where the
    call cannot be captured."""
    import torch
    from desamba_tpu_torch.tools import micro

    eager = cuda_ms(fn, 3)
    try:
        return micro.graph_ms(fn, device, max(1, min(50, int(20 / eager)))), \
            eager
    except RuntimeError as e:
        torch.cuda.synchronize()
        log(f"library call not captured in a CUDA graph: {e}")
        return None, eager


def sass(so, kernel):
    """One kernel's instructions in ``cuobjdump -sass`` of library ``so``:
    [(address, opcode without modifiers, the instruction)]."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], check=True,
                         capture_output=True, text=True).stdout
    name = f"_Z{len(kernel)}{kernel}"
    text = next((f for f in out.split("Function : ")[1:]
                 if f.startswith(name)), None)
    if text is None:
        raise RuntimeError(f"cuobjdump: no function {kernel} in {so}")
    ins = []
    for ln in text.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
        if m:
            words = m.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            ins.append((int(m.group(1), 16), op.split(".")[0], m.group(2)))
    return ins


def sass_loops(so, kernel):
    """The loops of one kernel in ``cuobjdump -sass`` of library ``so``:
    for each backward branch, the opcodes (without modifiers) from its
    target to it, innermost (shortest) first."""
    ins = sass(so, kernel)
    loops = []
    for addr, op, txt in ins:
        target = re.search(r"0x([0-9a-f]+)\s*$", txt)
        if op == "BRA" and target and int(target.group(1), 16) <= addr:
            lo = int(target.group(1), 16)
            loops.append([o for a, o, _ in ins if lo <= a <= addr])
    return sorted(loops, key=len)


def bound(nbytes, ops):
    """(least milliseconds for the work, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_S, ops / INT32_OPS_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


class Touched:
    """A reference-word array that records the [start, stop) word spans
    the plain rescore reads from it (its only access is a window slice)."""

    def __init__(self, words):
        self.words, self.spans = words, []

    def __len__(self):
        return len(self.words)

    def __getitem__(self, s):
        self.spans.append((s.start, s.stop))
        return self.words[s]


def span_words(spans):
    """Words in the union of [start, stop) spans."""
    n, end = 0, -1
    for a, b in sorted(spans):
        if b > end:
            n += b - max(a, end)
            end = b
    return n


def rescore_bytes(host, rows, spans):
    """Bytes K1's function must move on a prepared batch (numpy arrays):
    each row's scal record and its output record (chains and flags); for
    each row with chains, its chain records with their reference offset
    and length, its combine-hash entries, the anchors its chains' walks
    reach, the packed read in both directions and the valid part of its
    two value-sorted 9-mer tables (values and positions); and, once for
    the batch, the reference words in the union of the windows read
    (``spans``). Padding and unread reference are not counted."""
    from desamba_tpu_torch.engine.device.rescore import (C_CAP, C_CUR,
                                                         C_SUM, CF_N, K9)

    scal, chains, anchors = host["scal"], host["chains"], host["anchors"]
    A2 = anchors.shape[1]
    n = len(scal) * (16 + 4 * (C_CAP * CF_N + 3)) + 4 * span_words(spans)
    for b in rows:
        nc, nh, rl = (int(x) for x in scal[b, :3])
        seen = set()
        for c in chains[b, :nc]:
            a = int(c[C_CUR]) if c[C_SUM] != 0 else -1
            while 0 <= a < A2 and a not in seen:
                seen.add(a)
                a = int(anchors[b, a, 3])
        n += (nc * (4 * CF_N + 8) + 12 * nh + 16 * len(seen)
              + 4 * -(-2 * rl // 16) + 16 * max(rl - K9 + 1, 0))
    return n


def ladder_bytes(lane_args, trips, info, l_ek, a_cap, pack_cap):
    """Bytes B2's function must move on one call (numpy inputs, ``trips``
    the kernel's trips a lane): the lane arguments; for the lanes that
    probe, the read codes under their seed spans (the e-kmers of each
    island, a byte a char, the union over the lanes of a read) and a 13-mer
    value a trip (per read, the most trips of one of its lanes: a lane's
    probes are at distinct positions); the packed anchor rows written (13
    int32 each, at most pack_cap) and the info rows. Index words are not
    counted, so it is a lower bound."""
    on = (lane_args[7] != 0) & (trips > 0)
    spans = collections.defaultdict(list)
    most = collections.Counter()
    for r, b, so, sl, n in zip(*(lane_args[k, on] for k in (0, 1, 5, 6)),
                               trips[on]):
        spans[int(r)].append((int(b + so), int(b + so + sl + l_ek - 1)))
        most[int(r)] = max(most[int(r)], int(n))
    chars = sum(span_words(v) for v in spans.values())
    rows = min(int(np.minimum(info[:, 1], a_cap).sum()), pack_cap)
    return (lane_args.size * 4 + chars + 4 * sum(most.values()) + 52 * rows
            + info.size * 4)


def chain_bytes(n_anc, A2, m3):
    """(bytes, operations) B4's function needs on one call (numpy
    ``n_anc``): each read's anchor count and its valid anchor rows (7
    int32 each), read once; its outputs written once (16 chain records of
    13 int32, n_out, A2 pre words, the overflow byte). Operations: a test
    per valid anchor and, for M3, the ceil(log2 n!) comparisons of a
    comparison sort of a read's n valid anchors; a lower bound."""
    n = np.minimum(n_anc, A2).clip(0)
    nbytes = (len(n_anc) * (4 + 16 * 13 * 4 + 4 + 4 * A2 + 1)
              + 28 * int(n.sum()))
    ops = int(n.sum())
    if m3:
        ops += sum(math.ceil(math.lgamma(k + 1) / math.log(2)) for k in n)
    return nbytes, ops


def m3_shape(anc, n_anc):
    """What the M3 kernel's latency follows on one call (anc (B, A2, 7),
    n_anc (B,) int32 tensors): the valid nodes in all, the longest run in
    valid nodes, the widest DP window (the slots a valid node scans: those
    of its run above its nearest break) and the most runs with a valid node
    in one read. The sort, runs and breaks are the eager ``m3_kernel``'s,
    recomputed from the anchors alone (no scores), 64 reads at a time."""
    import torch

    i64, m32 = torch.int64, 0xFFFFFFFF
    B, A2, _ = anc.shape
    dev = anc.device

    def wrap(x):                        # int64 -> the int32 it wraps to
        return ((x + (1 << 31)) & m32) - (1 << 31)

    slot = torch.arange(A2, device=dev)
    nodes = longest = widest = most = 0
    for b0 in range(0, B, 64):
        a = anc[b0:b0 + 64].to(i64)
        valid = slot[None] < n_anc[b0:b0 + 64, None].to(i64)
        key = torch.where(valid, wrap(a[..., 4] * 2 + a[..., 5]), 1 << 30)
        order = torch.argsort(a[..., 1] & m32, dim=1, stable=True)
        order = order.gather(1, torch.argsort(key.gather(1, order), dim=1,
                                              stable=True))
        s = a.gather(1, order[..., None].expand(-1, -1, a.shape[2]))
        sv = valid.gather(1, order)
        iir, roff, mlen, ref, dirc = (s[..., k] for k in (0, 1, 2, 4, 5))
        same = ((ref[:, 1:] == ref[:, :-1]) & (dirc[:, 1:] == dirc[:, :-1])
                & (((roff[:, 1:] - roff[:, :-1]) & m32) < 2000) & sv[:, 1:])
        new = torch.cat([torch.ones_like(same[:, :1]), ~same], dim=1)
        run_id = torch.cumsum(new.to(i64), dim=1) - 1
        start = torch.cummax(torch.where(new, slot, 0), dim=1).values
        run_nodes = torch.zeros_like(run_id).scatter_add_(1, run_id,
                                                          sv.to(i64))
        # brk[c, j]: slot j, before node c in c's run, breaks c's window
        mq = ((iir + 3) & m32)[:, :, None]
        mt = ((roff + 3) & m32)[:, :, None]
        pass_ov = (((iir + mlen) & m32)[:, None] <= mq) & \
            (((roff + mlen) & m32)[:, None] <= mt)
        brk = pass_ov & ((((iir + 1000) & m32)[:, None] < mq)
                         | (((roff + 1000) & m32)[:, None] < mt))
        prior = (slot[None, :] < slot[:, None])[None] & \
            (run_id[:, None, :] == run_id[:, :, None])
        brk_slot = torch.where(brk & prior, slot, -1).amax(dim=2)
        window = slot - torch.maximum(start, brk_slot + 1)
        nodes += int(sv.sum())
        longest = max(longest, int(run_nodes.max()))
        widest = max(widest, int(torch.where(sv, window, 0).max()))
        most = max(most, int((run_nodes > 0).sum(dim=1).max()))
    return nodes, longest, widest, most


def cmpcount_ops(B, P, K, t_sorted):
    """The least comparisons K3's function needs on these shapes: on a
    sorted table, one binary search per query (ceil(log2(K + 1)) steps;
    the counts at q + 1 .. q + R - 1 follow from the few entries in
    [q, q + R), which are left out); on an unsorted one, per lane the fewer
    of one comparison per entry per query and a comparison sort
    (ceil(log2 K!)) followed by those searches."""
    search = math.ceil(math.log2(K + 1))
    if t_sorted:
        return B * P * search
    sort = math.ceil(math.lgamma(K + 1) / math.log(2))
    return B * min(P * K, sort + P * search)


def searchsorted_count(q, t, repeats, t_sorted):
    """The compare-count by one torch.searchsorted over the row-sorted table
    (the library yardstick; the port never calls it)."""
    import torch

    ts = t if t_sorted else torch.sort(t, dim=1).values
    B, P = q.shape
    v = (q[:, :, None] + torch.arange(repeats, dtype=q.dtype,
                                      device=q.device)).reshape(B, P * repeats)
    return torch.searchsorted(ts, v).view(B, P, repeats).sum(
        dim=2, dtype=torch.int32)


I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def cmpcount_edge_batch(seed, device):
    """Seeded edge cases for K3: 64 rows of K 1,000 (not a power of two)
    with long runs of duplicates and both int32 extremes, in an unsorted
    and a row-sorted copy; 300 queries a row (more than a block's threads)
    among them INT32_MIN, INT32_MAX and INT32_MAX - R + 2 and up, where
    q + r wraps; R 5 (not a multiple of the kernel's four searches in
    flight)."""
    import torch

    rng = np.random.default_rng([seed, 3])
    B, K, P, R = 64, 1000, 300, 5
    t = rng.integers(I32_MIN, I32_MAX, (B, K), dtype=np.int64)
    dup = rng.random((B, K)) < 0.5
    t[dup] = rng.choice([I32_MIN, -1, 0, 0, 7, I32_MAX], int(dup.sum()))
    t[:, :2] = [I32_MAX, I32_MIN]                 # every row unsorted
    q = rng.integers(I32_MIN, I32_MAX, (B, P), dtype=np.int64)
    q[:, :4] = [I32_MIN, -1, 7, I32_MAX]
    q[:, 4 : 4 + R] = I32_MAX - R + 2 + np.arange(R)
    tt = torch.from_numpy(t.astype(np.int32)).to(device)
    return dict(q=torch.from_numpy(q.astype(np.int32)).to(device),
                t_unsorted=tt, t_sorted=torch.sort(tt, dim=1).values, R=R)


class Rec:
    __slots__ = ("name", "seq", "qual")

    def __init__(self, name, seq):
        self.name, self.seq, self.qual = name, seq, None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbases", type=float, default=32.0,
                    help="reference collection size, Mbase")
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--depths", default="",
                    help="comma-separated DESAMBA_PIPE_DEPTH values to time "
                         "classify_reads at, in this order, after phase 3")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from desamba_tpu_torch import cli
    from desamba_tpu_torch.engine.device import chain as dc
    from desamba_tpu_torch.engine.device import ladder, plops
    from desamba_tpu_torch.engine.device import rescore_pl as trp
    from desamba_tpu_torch.engine.device.classifier import (A_CAP, M_CAP,
                                                            DeviceClassifier)
    from desamba_tpu_torch.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu_torch.entry import entry
    from desamba_tpu_torch.index.build import build_index
    from desamba_tpu_torch.index.store import save_index
    from desamba_tpu_torch.io import native
    from desamba_tpu_torch.io.sam import format_result
    from desamba_tpu_torch.kernels import build
    from desamba_tpu_torch.parallel import (MeshClassifier, distributed,
                                            make_mesh)
    from desamba_tpu_torch.tools import caps, micro
    from desamba_tpu_torch.tools import multihost_worker as mhw
    from desamba_tpu_torch.tools import gather_bench as gb
    from desamba_tpu_torch.tools.cmpcount import (compare_count,
                                                  compare_count_plain)

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    built = build.build_all()
    for src, out in built.items():
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"built {src}: " + " | ".join(regs[-2:]))
    log(f"kernel build {time.perf_counter() - t0:.1f} s")
    k1_ptxas = ptxas_lines(built["rescore.cu"], "rescore_kernel")
    log(f"ptxas rescore_kernel: {k1_ptxas}")
    b2_ptxas = ptxas_lines(built["ladder.cu"], "fast_ladder_kernel")
    log(f"ptxas fast_ladder_kernel: {b2_ptxas}")
    b3_ptxas = ptxas_lines(built["ladder.cu"], "slow_ladder_kernel")
    log(f"ptxas slow_ladder_kernel: {b3_ptxas}")
    # B4's block shapes, the wrapper's first: M2 one (a warp a read), M3 8
    # or 4 warps a block (by the batch: m3_warps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def b4_blocks(name, B):
        if name == "chain":
            return (None,)
        w = dc.m3_warps(B, sms)
        return w, 12 - w

    b4_ptxas = {
        "chain_kernel": ptxas_lines(built["chain.cu"], "chain_kernel"),
        "m3_kernel": " || ".join(
            f"{w} warps a block: "
            + ptxas_lines(built["chain.cu"], "m3_kernel", f"ILi{w}E")
            for w in (8, 4))}
    for k, v in b4_ptxas.items():
        log(f"ptxas {k}: {v}")

    # ---- 2. data ------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    refs = make_collection(rng, args.mbases)
    reads = [Rec(n, s) for n, s in make_reads(rng, refs, args.reads)]
    long_batch = reads[:62] + [Rec(n, s) for n, s in make_long_reads(
        np.random.default_rng([args.seed, 1]), refs)]
    n_bases = sum(len(s) for _, s in refs)
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "collection.fa")
        write_fasta(fa, refs)
        del refs
        idx = build_index(fa)
    log(f"data: {len(idx.ref_off)} "
        f"references, {n_bases} bases, {idx.n_uni} unitigs; "
        f"{len(reads)} reads, {sum(len(r.seq) for r in reads)} bases; "
        f"built in {time.perf_counter() - t0:.1f} s (host, not timed)")

    # ---- 3. end to end ----------------------------------------------------
    opts = Options()
    kernels = {"rescore": trp.rescore_cuda, "cmpcount": compare_count,
               "fast_ladder": ladder.fast_ladder_cuda,
               "slow_ladder": ladder.slow_ladder_cuda,
               "chain": dc.chain_kernel_cuda, "m3_chain": dc.m3_kernel_cuda}
    eager = {"fast_ladder": ladder.fast_ladder,
             "slow_ladder": ladder.slow_ladder,
             "chain": dc.chain_kernel, "m3_chain": dc.m3_kernel}
    failures = []

    def zero_counts():
        for k in kernels.values():
            k.launches = 0
        for f in eager.values():
            f.runs = 0
        torch.cuda.synchronize()

    def check_counts(what):
        """The path kernels' launches and the eager functions' runs since
        ``zero_counts``: a path kernel not launched, or an eager function
        run on the card, fails the run."""
        launches = {n: k.launches for n, k in kernels.items()}
        eager_runs = {n: f.runs for n, f in eager.items()}
        for name in ("rescore", "fast_ladder", "slow_ladder", "chain",
                     "m3_chain"):
            if launches[name] <= 0:
                failures.append(f"kernel {name} was not launched by the "
                                f"{what} run")
        for name, n in eager_runs.items():
            if n:
                failures.append(f"the eager {name} ran {n} times on the "
                                f"card in the {what} run")
        log(f"{what} launches: " + json.dumps(launches)
            + "; eager runs " + json.dumps(eager_runs))
        return launches

    def classify(batch, what):
        """A new DeviceClassifier over ``batch`` through ``classify_reads``
        (pipelined from two batches on), the kernels' counts (and the eager
        ladders' and chaining functions' runs) zeroed just before and read
        just after, its SAM held against gold's, each batch's prep, device
        phase and finish logged (start and end, from the call's start).
        Returns (classifier, its SAM, the first batch's first rescore input
        per anchor width (a later batch's where the first had none),
        launches, [(kind, iv_cap, arguments)] of the first batch's ladder
        calls and, of each kind, the run's first at the full SP_SET tier,
        and the chaining calls' (anc, n_anc): the first batch's first three
        M2 calls and every M3 call). Batches run on worker threads, so a
        call is told to its batch by a thread-local set around each device
        phase."""
        clf = DeviceClassifier(idx, opts, "cuda")
        bs = clf.batch_size
        first_of = {id(batch[i]): i // bs for i in range(0, len(batch), bs)}
        tl = threading.local()
        spans = collections.defaultdict(dict)
        t_call = [0.0]

        def span(b, stage, t0):
            spans[b][stage] = (t0 - t_call[0], time.perf_counter() - t_call[0])

        captured_all, ladder_calls, step_tensors = {}, [], {}
        chain_calls = {"chain": [], "m3_chain": []}
        orig, orig_ladder = clf._k_rescore, clf._k_ladder
        orig_step = clf._device_step
        orig_prep, orig_phase = clf._prep_batch, clf._device_phase
        # the island prep's three steps, seconds summed over threads
        steps, steps_lock = collections.Counter(), threading.Lock()
        orig_steps = {"encode": native.encode_batch,
                      "bloom probe": clf._k_bloom,
                      "segmentation": native.islands_batch}

        def timed(name):
            def run(*a):
                t0 = time.perf_counter()
                out = orig_steps[name](*a)
                with steps_lock:
                    steps[name] += time.perf_counter() - t0
                return out
            return run
        orig_chain = {"chain": dc.run_chain_kernel,
                      "m3_chain": dc.run_m3_kernel}

        def first_batch():
            return getattr(tl, "batch", None) == 0

        def capture_chain(name):
            def run(anc, n_anc):
                if name == "m3_chain" or (first_batch()
                                          and len(chain_calls[name]) < 3):
                    chain_calls[name].append((anc, n_anc))
                return orig_chain[name](anc, n_anc)
            return run

        def capture(inp):
            captured_all.setdefault((tl.batch, int(inp.anchors.shape[1])),
                                    inp)
            return orig(inp)

        def capture_ladder(kind, *a, iv_cap=ladder.IV_HOT):
            if (iv_cap == ladder.IV_HOT and first_batch()) or (
                    iv_cap is None and not any(
                        k == kind and c is None for k, c, _ in ladder_calls)):
                ladder_calls.append((kind, iv_cap, a))
            return orig_ladder(kind, *a, iv_cap=iv_cap)

        def capture_step(recs, prep=None):
            step = orig_step(recs, prep)
            if first_batch():
                step_tensors.update(step.tensors)
            return step

        def prep(recs):
            t0 = time.perf_counter()
            out = orig_prep(recs)
            span(first_of[id(recs[0])], "prep", t0)
            return out

        def phase(recs, prep=None):
            b = first_of[id(recs[0])]
            t0 = time.perf_counter()
            tl.batch = b
            try:
                fin = orig_phase(recs, prep)
            finally:
                tl.batch = None
            span(b, "device", t0)

            def finish():
                t1 = time.perf_counter()
                out = fin()
                span(b, "finish", t1)
                return out
            return finish

        clf._k_rescore, clf._k_ladder = capture, capture_ladder
        clf._prep_batch, clf._device_phase = prep, phase
        clf._device_step = capture_step
        native.encode_batch = timed("encode")
        clf._k_bloom = timed("bloom probe")
        native.islands_batch = timed("segmentation")
        dc.run_chain_kernel = capture_chain("chain")
        dc.run_m3_kernel = capture_chain("m3_chain")
        log(f"{what}: batches of {bs}, DESAMBA_PIPE_DEPTH "
            f"{os.environ.get('DESAMBA_PIPE_DEPTH', '3 (default)')}, "
            f"DESAMBA_PREP_WORKERS "
            f"{os.environ.get('DESAMBA_PREP_WORKERS', '2 (default)')}, "
            f"os.cpu_count() {os.cpu_count()}")
        zero_counts()
        t0 = t_call[0] = time.perf_counter()
        res = list(clf.classify_reads(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_counts(what)
        clf._k_rescore, clf._k_ladder = orig, orig_ladder
        clf._prep_batch, clf._device_phase = orig_prep, orig_phase
        clf._device_step = orig_step
        native.encode_batch = orig_steps["encode"]
        clf._k_bloom = orig_steps["bloom probe"]
        native.islands_batch = orig_steps["segmentation"]
        dc.run_chain_kernel = orig_chain["chain"]
        dc.run_m3_kernel = orig_chain["m3_chain"]
        captured = {}
        for (_, width), inp in sorted(captured_all.items(),
                                      key=lambda kv: kv[0]):
            captured.setdefault(width, inp)
        del captured_all
        parts = [format_result(r, idx.ref_name, opts) for r in res]
        got = "".join(parts)
        log(f"{what}: {len(batch)} reads in {wall:.3f} s = "
            f"{len(batch) / wall:.1f} reads/s on {kind}")
        for b in sorted(spans):
            log(f"{what} batch {b + 1}: " + ", ".join(
                f"{stage} {a:.3f}-{e:.3f} s" for stage, (a, e)
                in sorted(spans[b].items(), key=lambda kv: kv[1])))
        log("stage wall s (summed over threads): " + json.dumps(
            {k: round(v, 3) for k, v in clf.stage_s.items()}))
        log("island prep steps s (summed over threads): " + json.dumps(
            {k: round(v, 3) for k, v in steps.items()}))
        log("fallback: " + json.dumps(clf.fallback_stats()))
        gold = ClassifyEngine(idx, opts)
        t0 = time.perf_counter()
        exp = "".join(format_result(gold.classify_read(r.name, r.seq, r.qual),
                                    idx.ref_name, opts) for r in batch)
        log(f"gold oracle: {time.perf_counter() - t0:.3f} s on the host")
        if got != exp:
            g, e = got.splitlines(), exp.splitlines()
            diff = [(a, b) for a, b in zip(g, e) if a != b][:5]
            failures.append(f"{what}: SAM differs from gold ({len(g)} vs "
                            f"{len(e)} lines): {diff}")
        else:
            log(f"{what}: SAM byte-equal to gold: {len(got.splitlines())} "
                f"lines")
        return dict(clf=clf, sam=got, parts=parts, captured=captured,
                    launches=launches, ladder_calls=ladder_calls,
                    chain_calls=chain_calls, step_tensors=step_tensors)

    run3 = classify(reads, "end to end")
    dev, sam3, captured, launches = (run3["clf"], run3["sam"],
                                     run3["captured"], run3["launches"])
    ladder_calls, chain_calls = run3["ladder_calls"], run3["chain_calls"]
    fb = dev.fallback_stats()
    if fb["slow_path_reads"] <= 0 or fb["m3_path_reads"] <= 0:
        failures.append("the slow path or the M3 path was not taken")

    # ---- 3b. the CLI on the card --------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        save_index(idx, os.path.join(tmp, "idx"))
        fq = os.path.join(tmp, "reads.fq")
        with open(fq, "w") as f:
            for r in reads:
                f.write(f"@{r.name}\n{r.seq}\n+\n{'I' * len(r.seq)}\n")
        threads = min(8, os.cpu_count())
        walls = {}
        for engine, extra in (("device", []), ("gold", ["-t", str(threads)])):
            out = os.path.join(tmp, f"{engine}.sam")
            if engine == "device":
                zero_counts()
            t0 = time.perf_counter()
            cli.main(["classify", os.path.join(tmp, "idx"), fq, "-o", out,
                      "--engine", engine] + extra)
            walls[engine] = time.perf_counter() - t0
            if engine == "device":
                check_counts("CLI --engine device")
            with open(out) as f:
                walls[engine, "sam"] = f.read()
    gold1 = ClassifyEngine(idx, opts)
    t0 = time.perf_counter()
    gold_t1 = "".join(gold1.classify_records_formatted(reads, threads=1))
    walls["gold1"] = time.perf_counter() - t0
    del gold1
    log(f"CLI on {card}: classify --engine device {walls['device']:.3f} s "
        f"(classify_file), --engine gold -t {threads} {walls['gold']:.3f} s; "
        f"classify_records_formatted at one thread {walls['gold1']:.3f} s; "
        f"{len(reads)} reads, os.cpu_count() {os.cpu_count()}")
    if walls["device", "sam"] != sam3:
        failures.append("CLI --engine device: SAM differs from phase 3's")
    if walls["gold", "sam"] != gold_t1:
        failures.append(f"CLI --engine gold -t {threads}: SAM differs from "
                        f"classify_records_formatted at one thread")
    else:
        log(f"CLI: device SAM byte-equal to phase 3's, gold -t {threads} SAM "
            f"byte-equal to one thread's: {len(gold_t1.splitlines())} lines")
    del walls, gold_t1

    # ---- 3c. pipeline depths (--depths) -------------------------------------
    depth_walls = collections.defaultdict(list)
    for d in [x for x in args.depths.split(",") if x]:
        os.environ["DESAMBA_PIPE_DEPTH"] = d
        clf = DeviceClassifier(idx, opts, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = "".join(format_result(r, idx.ref_name, opts)
                      for r in clf.classify_reads(reads))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        depth_walls[d].append(wall)
        log(f"depth {d}: {wall:.3f} s end to end; stage wall s (summed over "
            f"threads): " + json.dumps(
                {k: round(v, 3) for k, v in clf.stage_s.items()}))
        if got != sam3:
            failures.append(f"depth {d}: SAM differs from phase 3's")
        del clf
    os.environ.pop("DESAMBA_PIPE_DEPTH", None)
    if depth_walls:
        log(f"pipeline depths on {card}: " + "; ".join(
            f"depth {d}: " + ", ".join(f"{w:.3f}" for w in ws) + " s"
            for d, ws in sorted(depth_walls.items())))

    # ---- 3d. the mesh, the distributed bootstrap and the entry -------------
    bs = dev.batch_size
    first_reads = reads[:bs]
    sam_first = "".join(run3["parts"][:bs])

    def mesh_run(clf, what):
        """``clf`` over phase 3's first batch with a fresh state, the
        kernels' counts zeroed just before and read just after; returns
        (wall s, launches, calls of each sharded stage, SAM equal)."""
        calls = collections.Counter()

        def counted(name):
            fn = getattr(clf, name)

            def run(*a, **kw):
                if name != "_k_ladder":
                    calls[name] += 1
                else:
                    calls[f"_k_ladder {a[0]}"] += 1
                return fn(*a, **kw)
            return run

        for name in ("_k_ladder", "_k_chain", "_k_chain_m3", "_k_rescore",
                     "_k_rescore_m3"):
            setattr(clf, name, counted(name))
        zero_counts()
        t0 = time.perf_counter()
        got = "".join(format_result(r, idx.ref_name, opts)
                      for r in clf.classify_reads(first_reads))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: k.launches for n, k in kernels.items()}
        runs = {n: f.runs for n, f in eager.items()}
        log(f"{what}: {len(first_reads)} reads in {wall:.3f} s; launches "
            f"{json.dumps(counts)}; stage calls {json.dumps(calls)}; eager "
            f"runs {json.dumps(runs)}; fallback by cause "
            f"{json.dumps(clf.fallback_stats()['by_cause'])}")
        for name, n in runs.items():
            if n:
                failures.append(f"{what}: the eager {name} ran {n} times")
        if got != sam_first:
            failures.append(f"{what}: SAM differs from phase 3's first "
                            f"{len(first_reads)} records")
        return wall, counts, calls, got == sam_first

    single_wall, single_counts, _, _ = mesh_run(
        DeviceClassifier(idx, opts, "cuda"), "single device, batch 1")

    def check_mesh(mesh, what):
        n_dp = mesh.shape["dp"]
        clf = MeshClassifier(idx, opts, mesh=mesh)
        wall, counts, calls, same = mesh_run(clf, what)
        # each sharded stage launches its kernel once a dp row; the M3
        # sub-batch runs on one device
        want = {"fast_ladder": n_dp * calls["_k_ladder fast"],
                "slow_ladder": n_dp * calls["_k_ladder slow"],
                "chain": n_dp * calls["_k_chain"],
                "rescore": n_dp * calls["_k_rescore"]
                + calls["_k_rescore_m3"],
                "m3_chain": calls["_k_chain_m3"]}
        for name, n in want.items():
            if counts[name] != n:
                failures.append(f"{what}: {name} launched {counts[name]} "
                                f"times, not {n}")
        for name in ("fast_ladder", "rescore", "chain"):
            if counts[name] < n_dp:
                failures.append(f"{what}: {name} launched {counts[name]} "
                                f"times")
        for name in ("slow_ladder", "m3_chain"):
            if single_counts[name] > 0 and counts[name] <= 0:
                failures.append(f"{what}: {name} was not launched, where "
                                f"one device launched it")
        log(f"{what}: mesh {wall:.3f} s against one device's "
            f"{single_wall:.3f} s on {card}; SAM "
            + ("byte-equal to phase 3's" if same else "DIFFERS"))
        return counts

    check_mesh(make_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4),
               "mesh (2, 2) of cuda:0")
    if torch.cuda.device_count() >= 2:
        check_mesh(make_mesh(2, 1), "mesh (2, 1) of cuda:0, cuda:1")
    else:
        log("one card: only the mesh of one repeated device ran (no mesh "
            "over two distinct cards)")

    # the distributed bootstrap: NCCL at world size 1, the worker's count
    # and its ordered gather
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    if not distributed.initialize(f"localhost:{port}", 1, 0, backend="nccl"):
        failures.append("distributed.initialize did not start a group")
    try:
        cdev = mhw.comm_device("nccl")
        total = mhw.all_reduce_count(len(reads), cdev)
        blob = sam_first.encode()
        blobs = mhw.ordered_gather(blob, cdev)
        log(f"distributed: NCCL world size "
            f"{torch.distributed.get_world_size()}, all_reduce of the read "
            f"count {total}, ordered gather of {len(blob)} SAM bytes "
            f"{'equal' if blobs == [blob] else 'DIFFERS'}")
        if total != len(reads) or blobs != [blob]:
            failures.append("distributed: the count or the gather differs")
    finally:
        torch.distributed.destroy_process_group()

    # the single-step entry on phase 3's first batch
    step, step_args = entry(classifier=dev, recs=first_reads)
    step_ms, step_out = [], None
    for _ in range(3):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        step_out = step(*step_args)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    exp_t = run3["step_tensors"]
    same = (sorted(step_out) == sorted(exp_t) and all(
        step_out[k].dtype == t.dtype and torch.equal(step_out[k], t)
        for k, t in exp_t.items()))
    log(f"entry step on batch 1 ({len(first_reads)} reads): "
        + ", ".join(f"{m:.3f}" for m in step_ms) + " ms by CUDA events; "
        f"tensors {sorted(exp_t)} "
        + ("bit-equal to phase 3's _device_phase" if same else "DIFFER"))
    if not same:
        failures.append("entry: the step's tensors differ from phase 3's "
                        "batch 1")
    del step_out, step, step_args

    def check_k1(what, clf, captured):
        """K1 on each captured batch of ``clf``'s run against its plain
        version (every row), timed, with its bound; one record a width."""
        dix, recs = clf.dix, []
        for width, inp in sorted(captured.items()):
            prep = trp.prepare(inp, clf.ref_words, dix.ref_off,
                               dix.ref_len_arr, dix.n_bases)
            rows = np.flatnonzero(inp.n_chains.cpu().numpy() > 0)
            ch_k, fl_k = trp.rescore_cuda(prep)
            torch.cuda.synchronize()
            host = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                    for k, v in prep.items()}
            touched = Touched(host["ref_words"])
            t0 = time.perf_counter()
            ch_p, fl_p = trp.rescore_plain(dict(host, ref_words=touched), rows)
            plain_ms = (time.perf_counter() - t0) * 1e3
            ms = cuda_ms(lambda: trp.rescore_cuda(prep), 5)
            # operations: one per step of the walk and the DP (flags column 2),
            # a lower bound
            step_col = fl_k[:, 2].to(torch.int64)
            steps, max_steps = int(step_col.sum()), int(step_col.max())
            nbytes = rescore_bytes(host, rows, touched.spans)
            bnd = bound(nbytes, steps)
            # every row: those with chains, and the rows without, which the
            # kernel copies through with zero flags
            ck = ch_k.cpu().numpy().astype(np.int64)
            fk = fl_k.cpu().numpy().astype(np.int64)
            cp = ch_p.numpy().astype(np.int64)
            fp = fl_p.numpy().astype(np.int64)
            err = int(max(np.abs(ck - cp).max(initial=0),
                          np.abs(fk - fp).max(initial=0)))
            n_fb = int(fk[:, 0].sum())
            K = prep["rk_vals"].shape[2]
            smem, stride = trp.smem_bytes(width, K), trp.fence_stride(width, K)
            long_rows = rows[host["scal"][rows, 2] >= LONG_READ]
            log(f"{what}: rescore width {width}: batch of "
                f"{prep['scal'].shape[0]} rows, {len(rows)} with chains "
                f"({len(long_rows)} of them reads of {LONG_READ} bases or "
                f"more): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.1f} ms on those rows, bound {bnd[0]:.6f} ms "
                f"({bnd[1]}; {nbytes} bytes, {span_words(touched.spans)} "
                f"reference words); steps {steps} in all, {max_steps} in the "
                f"longest walk; table width K {K}, fence stride {stride}, "
                f"shared memory {smem} bytes a block; ptxas "
                f"{k1_ptxas}; max_abs_err {err} over all "
                f"rows, {n_fb} rows fell back")
            if len(rows) == 0:
                failures.append(f"{what}: no rescore rows checked at width "
                                f"{width}")
            if err != 0:
                failures.append(f"{what}: rescore kernel differs from its "
                                f"plain version at width {width}: "
                                f"max_abs_err {err}")
            if ms < bnd[0]:
                failures.append(f"{what}: rescore at width {width} beat its "
                                f"bound: {ms} < {bnd[0]} ms")
            recs.append(dict(width=width, ms=ms, plain_ms=plain_ms,
                             err=err, bound=bnd, K=K, stride=stride))
        return recs

    # ---- 4. long reads ------------------------------------------------------
    long_run = classify(long_batch, "long reads")
    long_clf, long_captured = long_run["clf"], long_run["captured"]
    del long_run
    long_recs = check_k1("long reads", long_clf, long_captured)
    if not long_recs or min(r["K"] for r in long_recs) < LONG_READ:
        failures.append("long reads: no rescore batch at a long read's width")
    if any(r["stride"] <= trp.FENCE for r in long_recs):
        failures.append("long reads: a batch kept the least fence stride")
    del long_clf, long_captured

    # ---- 5. K1 on the main path's batches -----------------------------------
    recs = check_k1("main path", dev, captured)
    if 512 not in captured:
        failures.append("no M3 rescore sub-batch ran")
    main = next((r for r in recs if r["width"] == 64), None)
    records = []
    if main is None:
        failures.append("no main-batch rescore ran")
    else:
        records.append({
            "name": "rescore", "route": "cuda",
            "source": "desamba_tpu_torch/kernels/rescore.cu",
            "replaces": "desamba_tpu/engine/device/rescore_pl.py:1101",
            "launches": launches["rescore"],
            "max_abs_err": max(r["err"] for r in recs + long_recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound"][0], "bound_by": main["bound"][1],
            "library_ms": None, "library_eager_ms": None})

    # ---- 5b, 5c. B2 and B3: the ladders on the main path's calls -----------
    def check_ladder(which, tag, a, iv_cap):
        """The ``which`` ladder's kernel and its eager version on one captured
        call's arguments at ``iv_cap``: compared (tolerance 0), timed,
        bounded."""
        codes_fr, buf_len, pre13, lane_args, NB = a
        dix = dev.dix
        args = (dev.ixr, dix.fm_blocks, dix.rank, dix.hash13, codes_fr,
                buf_len, pre13, dix.q_mem, dix.q_lv, lane_args)
        kw = dict(l_ek=idx.len_e_kmer, a_cap=A_CAP, pack_cap=2 * NB,
                  iv_cap=iv_cap)
        if which == "slow":
            kw["m_cap"] = M_CAP
        kernel = kernels[f"{which}_ladder"]
        plain = eager[f"{which}_ladder"]
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        trips = kernel.trips.cpu().numpy()
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        exp = plain(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        wrap_ms = cuda_ms(lambda: kernel(*args, **kw), 5)
        # the launch alone, on arguments and outputs made once (the wrapper
        # also packs the read codes, zeroes the anchor rows and packs them)
        largs, held = ladder.ladder_launch_args(
            *args, **{k: v for k, v in kw.items() if k != "pack_cap"})
        entry = getattr(ladder_lib, f"ladder_{which}_launch")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = entry(ctypes.addressof(largs), args[9].device.index, stream)
            if rc:
                raise RuntimeError(f"ladder_{which}_launch: CUDA error {rc}")

        ms = cuda_ms(launch, 5)
        torch.cuda.synchronize()
        del held
        err = max(int((got[0].long() - exp[0].long()).abs().max()),
                  int((got[1].long() - exp[1].long()).abs().max()),
                  int(got[2] != exp[2]))
        info = exp[1].cpu().numpy()
        nbytes = ladder_bytes(lane_args.cpu().numpy(), trips, info,
                              idx.len_e_kmer, A_CAP, 2 * NB)
        bnd = bound(nbytes, 0)
        lanes = int((lane_args[7] != 0).sum())
        a_cnt = info[:lanes, 1]
        extra = (f", {int(info[:, 2].sum())} lanes with more than {M_CAP} "
                 f"MEMs" if which == "slow" else "")
        smem = ladder_lib.ladder_smem_bytes(
            ladder.IV_CAP if iv_cap is None else iv_cap)
        log(f"{which} ladder {tag} (iv_cap {iv_cap}): {lanes} lanes, NB {NB}: "
            f"kernel {ms:.4f} ms (the launch alone), {wrap_ms:.4f} ms "
            f"(launch and pack), by events; plain "
            f"{plain_ms:.1f} ms over {plain.trips} trips; lanes' "
            f"trips: longest {int(trips.max())}, mean over the lanes "
            f"{trips[:lanes].mean():.3f}; lanes' a_cnt: largest "
            f"{int(a_cnt.max(initial=0))}, mean {a_cnt.mean():.3f}; "
            f"shared memory {smem} bytes a block; bound {bnd[0]:.6f} ms "
            f"({bnd[1]}; {nbytes} bytes, index words not counted); "
            f"{int(info[:, 1].sum())} anchors, {int(info[:, 3].sum())} lanes "
            f"with an SP_SET overflow{extra}; max_abs_err {err}")
        if err != 0:
            failures.append(f"{which} ladder {tag} (iv_cap {iv_cap}): kernel "
                            f"differs from the eager version: max_abs_err "
                            f"{err}")
        if int(trips.max()) != plain.trips:
            failures.append(f"{which} ladder {tag}: longest lane "
                            f"{trips.max()} trips, eager loop {plain.trips}")
        if min(ms, wrap_ms) < bnd[0]:
            failures.append(f"{which} ladder {tag} beat its bound: "
                            f"{min(ms, wrap_ms)} < {bnd[0]} ms")
        return dict(ms=ms, wrap_ms=wrap_ms, plain_ms=plain_ms, err=err,
                    nbytes=nbytes, ovf=int(info[:, 3].sum()))

    ladder_lib = build.ladder_lib()

    for which, name, line, ptxas in (
            ("fast", "fast_ladder", 98, b2_ptxas),
            ("slow", "slow_ladder", 211, b3_ptxas)):
        batch1 = [a for k, c, a in ladder_calls
                  if k == which and c is not None]
        if not batch1:
            failures.append(f"no {which}-ladder call was captured")
            continue
        checked = [check_ladder(which, f"batch 1 call {i + 1}", a,
                                ladder.IV_HOT) for i, a in enumerate(batch1)]
        full = [a for k, c, a in ladder_calls if k == which and c is None]
        if full:
            check_ladder(which, "first full-tier re-dispatch", full[0], None)
        else:
            log(f"{which} ladder: no full-tier re-dispatch in the main run")
        forced = check_ladder(which, f"batch 1 call {len(batch1)}",
                              batch1[-1], 1)
        if forced["ovf"] <= 0:
            failures.append(f"{which} ladder at iv_cap=1 never overflowed")
        nbytes = sum(r["nbytes"] for r in checked)
        bms, by = bound(nbytes, 0)
        log(f"{which} ladder, batch 1 ({len(checked)} calls): kernel "
            f"{sum(r['ms'] for r in checked):.4f} ms (the launches alone), "
            f"{sum(r['wrap_ms'] for r in checked):.4f} ms (launch and pack), "
            f"plain "
            f"{sum(r['plain_ms'] for r in checked):.1f} ms, bound "
            f"{bms:.6f} ms ({by}; {nbytes} bytes); ptxas {ptxas}")
        records.append({
            "name": name, "route": "cuda",
            "source": "desamba_tpu_torch/kernels/ladder.cu",
            "replaces": f"desamba_tpu/engine/device/ladder.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in checked + [forced]),
            "ms": sum(r["ms"] for r in checked),
            "wrapper_ms": sum(r["wrap_ms"] for r in checked),
            "plain_ms": sum(r["plain_ms"] for r in checked),
            "bound_ms": bms, "bound_by": by,
            "library_ms": None, "library_eager_ms": None})
    del ladder_calls

    # ---- 5d. B4: the chaining kernels on the main path's calls -------------
    chain_lib = build.chain_lib()
    dev0 = torch.device("cuda")

    def chain_launch(name, anc, n_anc, outs, block):
        """The library entry alone on (anc, n_anc) into ``outs`` (M3 at
        ``block`` warps a block): made once, no checks, not counted as a
        launch."""
        B, A2 = anc.shape[:2]
        entry, extra = chain_lib.chain_m2_launch, ()
        if name == "m3_chain":
            entry = chain_lib.chain_m3_launch
            extra = (dc.m3_smem_bytes(A2), block)
        ptrs = [t.data_ptr() for t in (anc, n_anc, *outs)]

        def launch():
            rc = entry(*ptrs, B, A2, *extra, anc.device.index,
                       torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name} launch: CUDA error {rc}")
        return launch

    def max_err(got, exp):
        return max(int((g.long() - e.long()).abs().max())
                   for g, e in zip(got, exp))

    for name, kname, line in (("chain", "chain_kernel", 56),
                              ("m3_chain", "m3_kernel", 247)):
        kernel, plain = kernels[name], eager[name]
        checked = []
        for i, (anc, n_anc) in enumerate(chain_calls[name]):
            got = kernel(anc, n_anc)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
            e0.record()
            exp = plain(anc, n_anc)
            e1.record()
            torch.cuda.synchronize()
            plain_ms = e0.elapsed_time(e1)
            wrap_ms = cuda_ms(lambda: kernel(anc, n_anc), 20)
            err = max_err(got, exp)
            # the launch alone, by events and in a replayed CUDA graph, at
            # each block shape; outputs made once and checked too
            alone = []
            for w in b4_blocks(name, anc.shape[0]):
                outs = [torch.empty_like(t) for t in got]
                launch = chain_launch(name, anc, n_anc, outs, w)
                ev_ms = cuda_ms(launch, 20)
                g_ms = micro.graph_ms(launch, dev0, 20)
                torch.cuda.synchronize()
                err = max(err, max_err(outs, exp))
                alone.append((w, g_ms, ev_ms))
            _, ms, ev_ms = alone[0]
            n_h = n_anc.cpu().numpy()
            nbytes, ops = chain_bytes(n_h, anc.shape[1], name == "m3_chain")
            bnd = bound(nbytes, ops)
            B, A2 = anc.shape[:2]
            extra = ""
            if name == "m3_chain":
                extra = ("; " + "; ".join(
                    f"{w} warps a block: {g:.5f} ms in a graph, {e:.5f} ms "
                    f"by events" for w, g, e in alone)
                    + f"; shared memory {dc.m3_smem_bytes(A2)} bytes a "
                    f"block; valid nodes, longest run, widest window, most "
                    f"runs a read: "
                    + ", ".join(str(x) for x in m3_shape(anc, n_anc)))
            log(f"{name} call {i + 1}: B {B}, A2 {A2}, "
                f"{int((n_h > 0).sum())} reads with anchors, "
                f"{int(np.minimum(n_h, A2).clip(0).sum())} anchors: kernel "
                f"{ms:.5f} ms (the launch alone, in a graph), {ev_ms:.5f} ms "
                f"(the launch alone, by events), {wrap_ms:.5f} ms (the "
                f"wrapper, by events), plain {plain_ms:.1f} ms; bound "
                f"{bnd[0]:.6f} ms ({bnd[1]}; {nbytes} bytes, {ops} "
                f"operations){extra}; {int(exp[3].sum())} reads overflowed; "
                f"ptxas {b4_ptxas[kname]}; max_abs_err {err}")
            if err != 0:
                failures.append(f"{name} call {i + 1}: kernel differs from "
                                f"the eager version: max_abs_err {err}")
            fastest = min([wrap_ms] + [t for _, g, e in alone for t in (g, e)])
            if fastest < bnd[0]:
                failures.append(f"{name} call {i + 1} beat its bound: "
                                f"{fastest} < {bnd[0]} ms")
            checked.append(dict(ms=ms, ev_ms=ev_ms, wrap_ms=wrap_ms,
                                plain_ms=plain_ms, err=err, nbytes=nbytes,
                                ops=ops))
        if not checked:
            failures.append(f"no {name} call was captured")
            continue
        bms, by = bound(sum(r["nbytes"] for r in checked),
                        sum(r["ops"] for r in checked))
        log(f"{name}, {len(checked)} calls: kernel "
            f"{sum(r['ms'] for r in checked):.5f} ms (the launches alone, in "
            f"a graph), {sum(r['ev_ms'] for r in checked):.5f} ms (by "
            f"events), {sum(r['wrap_ms'] for r in checked):.5f} ms (the "
            f"wrapper), plain {sum(r['plain_ms'] for r in checked):.1f} ms, "
            f"bound {bms:.6f} ms ({by})")
        records.append({
            "name": name, "route": "cuda",
            "source": "desamba_tpu_torch/kernels/chain.cu",
            "replaces": f"desamba_tpu/engine/device/chain.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in checked),
            "ms": sum(r["ms"] for r in checked),
            "events_ms": sum(r["ev_ms"] for r in checked),
            "wrapper_ms": sum(r["wrap_ms"] for r in checked),
            "plain_ms": sum(r["plain_ms"] for r in checked),
            "bound_ms": bms, "bound_by": by,
            "library_ms": None, "library_eager_ms": None})
    del chain_calls

    # ---- 6. gather bench: the compare-count kernel (K3) ---------------------
    k3_ptxas = ptxas_lines(built["cmpcount.cu"], "cmpcount_kernel")
    log(f"ptxas cmpcount_kernel: {k3_ptxas}")
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    bench = gb.main([str(gb.B_TOOLS), "all"])
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    log("gather bench launches: " + json.dumps(launches))
    variants = (("pallas", "cmpcount", "tools/gather_bench.py:112", True),
                ("blocked", "cmpcount_8lane", "tools/gather_bench2.py:87",
                 False))
    if sum(bench[v]["launches"] for v, *_ in variants) != launches["cmpcount"]:
        failures.append("cmpcount launches do not add up over its variants")
    edge = cmpcount_edge_batch(args.seed, dev0)
    for v, name, replaces, t_sorted in variants:
        r = bench[v]
        q, t = r["inputs"]
        lanes = r["lanes_per_block"]
        plain = compare_count_plain(q, t, gb.R)
        lib = searchsorted_count(q, t, gb.R, t_sorted)
        err = int(max((r["out"] - plain).abs().max(),
                      (r["out"] - lib).abs().max()))
        # the edge batch through the same variant, its table in the other
        # order: the sort path and the no-sort path run for both variants
        eq, er = edge["q"], edge["R"]
        et = edge["t_unsorted" if t_sorted else "t_sorted"]
        got = compare_count(eq, et, er, lanes)
        edge_err = int(max(
            (got - compare_count_plain(eq, et, er)).abs().max(),
            (got - searchsorted_count(eq, et, er, not t_sorted)).abs().max()))
        ms = micro.graph_ms(lambda: compare_count(q, t, gb.R, lanes), dev0, 50)
        lib_ms = micro.graph_ms(
            lambda: searchsorted_count(q, t, gb.R, t_sorted), dev0, 50)
        eager_ms = cuda_ms(lambda: compare_count(q, t, gb.R, lanes), 20)
        eager_lib_ms = cuda_ms(
            lambda: searchsorted_count(q, t, gb.R, t_sorted), 20)
        plain_ms = cuda_ms(lambda: compare_count_plain(q, t, gb.R), 3)
        (B, P), K = q.shape, t.shape[1]
        bms, by = bound(tensor_bytes(q, t, r["out"]),
                        cmpcount_ops(B, P, K, t_sorted))
        log(f"{name}: B={B} K={K} P={P} R={gb.R} "
            f"({'sorted' if t_sorted else 'unsorted'} table): kernel "
            f"{ms:.5f} ms in a CUDA graph, {eager_ms:.5f} ms by events "
            f"around eager calls; searchsorted {lib_ms:.5f} ms in a graph, "
            f"{eager_lib_ms:.5f} ms eager; plain {plain_ms:.4f} ms; bound "
            f"{bms:.6f} ms ({by}); ptxas {k3_ptxas}; max_abs_err {err} on "
            f"the bench's inputs, {edge_err} on the edge batch "
            f"({tuple(eq.shape)} queries, K {et.shape[1]}, R {er}, "
            f"{'unsorted' if t_sorted else 'sorted'} table)")
        if r["launches"] <= 0:
            failures.append(f"{name} was not launched by the gather bench")
        if (B, K, P) != (gb.B_TOOLS, gb.K, gb.P):
            failures.append(f"{name} ran at {(B, K, P)}, not the tools' shape")
        if err != 0 or edge_err != 0:
            failures.append(f"{name} differs from its plain version or "
                            f"searchsorted: max_abs_err {err} on the bench's "
                            f"inputs, {edge_err} on the edge batch")
        if min(ms, lib_ms, eager_ms, eager_lib_ms) < bms:
            failures.append(f"{name}: kernel {ms} / {eager_ms} ms or "
                            f"searchsorted {lib_ms} / {eager_lib_ms} ms beat "
                            f"the bound {bms} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": "desamba_tpu_torch/kernels/cmpcount.cu",
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": max(err, edge_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_eager_ms": eager_lib_ms})

    # ---- 7. primitive benches (K4, K6, K5) ----------------------------------
    def max_err(a, b):
        if a.shape != b.shape:
            return 1 << 62
        return int((a.long() - b.long()).abs().max())

    def small_record(name, source, replaces, launched, err, ms, plain_ms,
                     lib, nbytes, ops):
        """One kernel's record; ``lib`` is its library call's (graph ms,
        eager ms), or None where there is none."""
        bms, by = bound(nbytes, ops)
        lib_ms, lib_eager = lib or (None, None)
        lib_txt = ("none" if lib is None else
                   f"{'not captured' if lib_ms is None else f'{lib_ms:.5f}'}"
                   f" ms in a graph, {lib_eager:.5f} ms eager")
        log(f"{name}: kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib_txt}, bound {bms:.6f} ms ({by}; {nbytes} bytes, {ops} "
            f"operations), {launched} launches, max_abs_err {err}")
        if launched <= 0:
            failures.append(f"{name} was not launched through its entry point")
        if err != 0:
            failures.append(f"{name} differs from its plain version or its "
                            f"library call: max_abs_err {err}")
        if ms < bms or (lib is not None and min(
                t for t in lib if t is not None) < bms):
            failures.append(f"{name}: kernel {ms} ms or library {lib} ms "
                            f"beat the bound {bms} ms")
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "library_eager_ms": lib_eager})

    for f in micro.WRAPPERS:
        f.launches = 0
    torch.cuda.synchronize()
    mres = micro.main(["all", "--seed", str(args.seed)])
    torch.cuda.synchronize()
    log("primitive bench launches: " + json.dumps(
        {f.__name__: f.launches for f in micro.WRAPPERS}))
    if sum(r["launches"] for r in mres.values()) != sum(
            f.launches for f in micro.WRAPPERS):
        failures.append("micro launches do not add up over its sites")
    if len(mres) != 17:
        failures.append(f"micro ran {len(mres)} kernels, not 17")
    for key, r in mres.items():
        err = max_err(r["out"], r["plain"]())
        lib = None
        if r["library"] is not None:
            err = max(err, max_err(r["out"], r["library"]()))
            lib = library_ms(r["library"], dev0)
        if key == "K6.0":
            log(f"K6.0 launch floor: {r['graph_ms'] * 1e3:.3f} us per launch "
                f"in a CUDA graph, {r['eager_ms'] * 1e3:.3f} us by events "
                f"over back-to-back eager launches, "
                f"{r['host_sync_ms'] * 1e3:.3f} us of host time per "
                f"launch-and-synchronize")
        small_record(r["name"], "desamba_tpu_torch/kernels/micro.cu",
                     r["replaces"], r["launches"], err,
                     r["ms"], cuda_ms(r["plain"], 2), lib, r["nbytes"](),
                     r["ops"]())
    # K6.2 and K6.3 against the card's shared-memory rate: each of their
    # trips loads every output's word from shared memory once, so a time
    # under that floor means gathers were folded away
    for key in ("K6.2", "K6.3"):
        k = mres[key]
        smem_bytes = 4 * k["units"]
        floor_ms = smem_bytes / SMEM_BYTES_S * 1e3
        log(f"{key}: {smem_bytes} bytes of shared-memory loads in "
            f"{k['ms']:.5f} ms = {smem_bytes / k['ms'] / 1e9:.3f} TB/s, "
            f"{100 * floor_ms / k['ms']:.1f} % of "
            f"{SMEM_BYTES_S / 1e12:.2f} TB/s (floor {floor_ms:.5f} ms)")
        if k["ms"] < floor_ms:
            failures.append(f"{key} ran in {k['ms']} ms, under the "
                            f"{floor_ms} ms its shared-memory loads need: "
                            f"gathers were folded")
    # K6.3 with one trip a column: the same grid's staging, launch and
    # zeroed output without the trips
    x3 = micro.make_inputs(dev0, args.seed)
    one_ms = micro.graph_ms(
        lambda: micro.colgather(x3["tab"], x3["idxr"], 1, False), dev0, 50)
    log(f"K6.3 with one trip: {one_ms:.5f} ms (staging the columns, the "
        f"launch and the zeroed output)")
    del x3
    micro_so = build._lib_path("micro.cu")
    for kernel, want in (("lgather_kernel", "LDS"), ("rgather_kernel", "LDS"),
                         ("oneprog_kernel", "IMAD")):
        log(f"ptxas {kernel}: {ptxas_lines(built['micro.cu'], kernel)}")
        # the trip loops: those that hold the trip's work (a shared-memory
        # load, a multiply-add) and neither a barrier nor a device load
        loops = [lp for lp in sass_loops(micro_so, kernel)
                 if want in lp and not {"BAR", "LDG"} & set(lp)]
        if not loops:
            failures.append(f"{kernel}: no {want} in a loop of its SASS")
            continue
        mix = collections.Counter(loops[-1])
        log(f"SASS {kernel}: trip loops of "
            + ", ".join(f"{len(lp)} instructions ({lp.count(want)} {want})"
                        for lp in loops)
            + "; the longest: "
            + ", ".join(f"{n} {op}" for op, n in mix.most_common()))
    del mres
    torch.cuda.empty_cache()

    # ---- 8. tile helpers (K2) -----------------------------------------------
    for f in plops.HARNESS.values():
        f.launches = 0
    cases = plops.run_harness(dev0, args.seed)
    torch.cuda.synchronize()
    by_body = {k: f.launches for k, f in plops.HARNESS.items()}
    log(f"tile helpers: {len(cases)} cases, launches " + json.dumps(by_body))
    if min(by_body.values()) <= 0:
        failures.append("a tile-helper body was not launched: "
                        + json.dumps(by_body))
    err, first = 0, {}
    for c in cases:
        e = max_err(c["out"].cpu(), c["plain_out"])
        if e:
            log(f"tile helper {c['body']} ({c['case']}): max_abs_err {e}")
        err = max(err, e)
        first.setdefault(c["body"], c)
    # one launch of each of the ten bodies, on its first case
    ms = plain_ms = 0.0
    nbytes = ops = 0
    for name, c in first.items():
        ms += micro.graph_ms(
            lambda: plops.HARNESS[name](*c["inputs"], **c["kw"]), dev0, 50)
        plain_ms += cuda_ms(
            lambda: plops.PLAIN[name](*c["inputs"], **c["kw"]), 3)
        nbytes += tensor_bytes(*c["inputs"], c["out"])
        ops += c["out"].numel()
    small_record("plops", "desamba_tpu_torch/kernels/plops.cu",
                 "tests/test_plops.py:16", sum(by_body.values()), err, ms,
                 plain_ms, None, nbytes, ops)

    # ---- 9. capability probes (K7) ------------------------------------------
    for f in caps.WRAPPERS:
        f.launches = 0
    cres = caps.main(["--seed", str(args.seed)])
    torch.cuda.synchronize()
    by_site = {f.__name__: f.launches for f in caps.WRAPPERS}
    log("capability probe launches: " + json.dumps(by_site))
    if by_site != {"call_probe": 13, "smem_sum": 1, "scalar_block": 1}:
        failures.append("a capability probe was not launched once through "
                        "the entry point: " + json.dumps(by_site))
    for name, wrapper, site, library in (
            ("caps_call", caps.call_probe, "tools/pallas_caps.py:36", None),
            ("caps_scalar_out", caps.smem_sum, "tools/pallas_caps.py:153",
             lambda t: t.sum(dtype=torch.int32).reshape(1)),
            ("caps_scalar_in", caps.scalar_block, "tools/pallas_caps.py:225",
             lambda t, s: t + s)):
        probes = [r for r in cres.values() if r["site"] == site]
        err, ms, plain_ms, nbytes, ops = 0, 0.0, 0.0, 0, 0
        lib = None
        for r in probes:
            x = r["inputs"]
            err = max(err, max_err(r["out"], r["plain"](*x)))
            ms += micro.graph_ms(lambda: r["fn"](*x), dev0, 50)
            plain_ms += cuda_ms(lambda: r["plain"](*x), 3)
            nbytes += tensor_bytes(*x, r["out"])
            ops += r["out"].numel()
            if library is not None:
                err = max(err, max_err(r["out"], library(*x)))
                lib = library_ms(lambda: library(*x), dev0)
        if len(probes) != (13 if wrapper is caps.call_probe else 1):
            failures.append(f"{name}: {len(probes)} probes ran")
        small_record(name, "desamba_tpu_torch/kernels/caps.cu", site,
                     by_site[wrapper.__name__], err, ms, plain_ms, lib,
                     nbytes, ops)
    # p_s2 (K7.3): its loads must not wait for its stores
    caps_so = build._lib_path("caps.cu")
    mix = collections.Counter(op for _, op, _ in sass(caps_so, "p_s2")
                              if op != "NOP")
    log(f"ptxas p_s2: {ptxas_lines(built['caps.cu'], 'p_s2')}; SASS: "
        f"{mix['LDG']} LDG, {mix['STG']} STG, {sum(mix.values())} "
        f"instructions besides padding")

    slower = [f"{r['name']} ({r['ms']:.5f} ms against {r['library_ms']:.5f})"
              for r in records
              if r["library_ms"] is not None and r["ms"] > r["library_ms"]]
    log("kernels slower than their library call in a graph: "
        + (", ".join(slower) or "none"))
    if len(records) != 28:
        failures.append(f"{len(records)} kernel records, not 28")
    log(json.dumps({"kernels": records}))
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
