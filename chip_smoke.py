#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (desamba_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--mbases 32] [--reads 4096]

Run from the root of a checkout, on a machine with an NVIDIA card, nvcc
and a C compiler. Phases:

1. card and build: print the card's name and power limit, build every
   CUDA kernel of the classify pass from the sources in the checkout;
2. data: from --seed, a reference collection of viral-genome-sized
   sequences in families of 3-8 strains (1-5 % substitutions and indels
   apart), its index (built on the host, not timed), and long reads with
   ~10 % ONT-like errors, 80 % from the collection and 20 % absent from it;
3. end to end: DeviceClassifier(device="cuda") over every read, its SAM
   byte-equal to the gold oracle's (ClassifyEngine) on the same reads,
   with the slow ladders and the M3 path both taken; the kernels' launch
   counts are zeroed just before and read just after this run;
4. kernels: each kernel's wrapper on the inputs the main path gave it,
   bit-equal (tolerance 0) to its plain version on the same rows, and
   both timed.

Any mismatch or exception exits non-zero. The line before the last is the
kernels' JSON record; the last line is the device record.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
# rescore_pl.prepare fields with one row per read
PER_READ = ("scal", "chains", "anchors", "schash", "codes_pk", "rk_vals",
            "rk_pos")
CHECK_ROWS = 64    # main-batch rows with chains held against the plain version


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
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.index.build import build_index
    from desamba_tpu.io.sam import format_result
    from desamba_tpu_torch.engine.device import rescore_pl as trp
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier
    from desamba_tpu_torch.kernels import build

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    for src, out in build.build_all().items():
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"built {src}: " + " | ".join(regs[-2:]))
    log(f"kernel build {time.perf_counter() - t0:.1f} s")

    # ---- 2. data ------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    refs = make_collection(rng, args.mbases)
    reads = [Rec(n, s) for n, s in make_reads(rng, refs, args.reads)]
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
    dev = DeviceClassifier(idx, opts, "cuda")
    captured = {}
    orig = dev._k_rescore

    def capture(inp):
        captured.setdefault(int(inp.anchors.shape[1]), inp)
        return orig(inp)

    dev._k_rescore = capture
    kernels = {"rescore": trp.rescore_cuda}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = list(dev.classify_reads(reads))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    dev._k_rescore = orig
    got = "".join(format_result(r, idx.ref_name, opts) for r in res)
    fb = dev.fallback_stats()
    log(f"end to end: {len(reads)} reads in {wall:.3f} s = "
        f"{len(reads) / wall:.1f} reads/s on {kind}")
    log("stage wall s: " + json.dumps(
        {k: round(v, 3) for k, v in dev.stage_s.items()}))
    log("fallback: " + json.dumps(fb))

    gold = ClassifyEngine(idx, opts)
    t0 = time.perf_counter()
    exp = "".join(format_result(gold.classify_read(r.name, r.seq, r.qual),
                                idx.ref_name, opts) for r in reads)
    log(f"gold oracle: {time.perf_counter() - t0:.3f} s on the host")
    failures = []
    if got != exp:
        g, e = got.splitlines(), exp.splitlines()
        diff = [(a, b) for a, b in zip(g, e) if a != b][:5]
        failures.append(f"SAM differs from gold ({len(g)} vs {len(e)} "
                        f"lines): {diff}")
    else:
        log(f"SAM byte-equal to gold: {len(got.splitlines())} lines")
    if fb["slow_path_reads"] <= 0 or fb["m3_path_reads"] <= 0:
        failures.append("the slow path or the M3 path was not taken")
    for n, c in launches.items():
        if c <= 0:
            failures.append(f"kernel {n} was not launched by the main path")

    # ---- 4. kernels against their plain versions ------------------------------
    dix = dev.dix
    recs = []
    for width, inp in sorted(captured.items()):
        prep = trp.prepare(inp, dev.ref_words, dix.ref_off, dix.ref_len_arr,
                           dix.n_bases)
        live = np.flatnonzero(inp.n_chains.cpu().numpy() > 0)
        rows = live if width != 64 else live[:CHECK_ROWS]
        ch_k, fl_k = trp.rescore_cuda(prep)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ch_p, fl_p = trp.rescore_plain(prep, rows)
        plain_ms = (time.perf_counter() - t0) * 1e3
        sel = torch.as_tensor(rows, device=prep["scal"].device)
        sub = {k: (v[sel].contiguous() if k in PER_READ else v)
               for k, v in prep.items()}
        ms = cuda_ms(lambda: trp.rescore_cuda(sub), 5)
        full_ms = cuda_ms(lambda: trp.rescore_cuda(prep), 5)
        ck = ch_k.cpu().numpy()[rows].astype(np.int64)
        fk = fl_k.cpu().numpy()[rows].astype(np.int64)
        cp = ch_p.numpy()[rows].astype(np.int64)
        fp = fl_p.numpy()[rows].astype(np.int64)
        err = int(max(np.abs(ck - cp).max(initial=0),
                      np.abs(fk - fp).max(initial=0)))
        n_fb = int(fk[:, 0].sum())
        log(f"rescore width {width}: {len(rows)} rows, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, full batch of "
            f"{prep['scal'].shape[0]} rows {full_ms:.3f} ms, "
            f"max_abs_err {err}, {n_fb} rows fell back")
        if len(rows) == 0 or (width == 64 and len(rows) < min(
                CHECK_ROWS, len(live))):
            failures.append(f"too few rescore rows checked at width {width}")
        if err != 0:
            failures.append(f"rescore kernel differs from its plain version "
                            f"at width {width}: max_abs_err {err}")
        recs.append(dict(width=width, rows=len(rows), ms=ms,
                         plain_ms=plain_ms, err=err))
    if 512 not in captured:
        failures.append("no M3 rescore sub-batch ran")
    main = next((r for r in recs if r["width"] == 64), None)
    if main is None:
        failures.append("no main-batch rescore ran")
    else:
        log(json.dumps({"kernels": [{
            "name": "rescore", "route": "cuda",
            "source": "desamba_tpu_torch/kernels/rescore.cu",
            "replaces": "desamba_tpu/engine/device/rescore_pl.py:1101",
            "launches": launches["rescore"],
            "max_abs_err": max(r["err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "check": "ok" if not failures else "failed"}]}))
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
