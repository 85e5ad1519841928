"""The port's single-step and multi-device entry points.

Counterpart of the root ``__graft_entry__.py``:

``entry(device="cuda")``
    -> ``(step, args)``: ``step(*args)`` runs one batch's device work as
    ``DeviceClassifier._device_phase`` runs it up to the host finish (the
    island prep with its existence probe, the fast and slow ladders, M2
    and M3 chaining, the rescore prep and the rescore of the main batch
    and of the M3 sub-batch) and returns its tensors, on the device: the
    rescore's outputs (``DeviceBatch.tensors``). By default it builds a
    small synthetic index and batch from a seed; given a classifier and
    records, it runs on those. It is built from ``_device_step``, the
    first half of ``_device_phase``, not from the JAX ``entry()``, which
    calls ``fast_ladder`` with arguments it no longer takes.
``dryrun_multichip(n_devices, device="cuda")``
    -> holds ``MeshClassifier`` on an ``n_devices`` mesh (dp x idx, idx 2
    where ``n_devices`` is even) against ``DeviceClassifier`` on a
    synthetic corpus, SAM byte for byte, and prints what ran. A device
    repeats where the card count is below ``n_devices``; ``device="cpu"``
    repeats the CPU.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def synthetic_corpus(seed: int = 11, n_reads: int = 12, length: int = 300):
    """A small index and batch from ``seed``: two 12-kb references that
    share a 200-bp core every 2 kb, with ``NNN`` every 700 bp (so that the
    graph has unitigs and repeats), and ``n_reads`` reads of ``length``
    bases cut from them at 10 % substitutions (every third reverse
    complemented), then a read below the minimum length and two random
    reads absent from the index (the slow ladders). Returns (index,
    records)."""
    from .index.build import build_index
    from .io.fastx import Record

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    core = "".join(rng.choice(bases, size=12000))
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "synthetic.fa")
        with open(fa, "w") as f:
            for i, tid in enumerate((11, 22)):
                seq = list("".join(rng.choice(bases, size=12000)))
                for at in range(1500, 11000, 2000):
                    seq[at:at] = list(core[at:at + 200])
                for at in range(900, 11500, 700):
                    seq[at:at + 3] = list("NNN")
                s = "".join(seq)
                f.write(f">tid|{tid}|ref|SYNTH_{i} synthetic\n")
                for j in range(0, len(s), 80):
                    f.write(s[j:j + 80] + "\n")
        idx = build_index(fa)
    from .engine.gold.mapseed import get_ref

    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    comp = np.array([3, 2, 1, 0])
    recs = []
    for k in range(n_reads):
        st = int(rng.integers(0, total - length))
        seq = get_ref(idx.ref_bin, st, length, True).copy()
        pos = rng.integers(0, length, size=length // 10)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
        if k % 3 == 1:
            seq = comp[seq[::-1]]
        recs.append(Record(f"q{k}", "", "".join("ACGT"[c] for c in seq)))
    recs.append(Record("q_short", "", recs[0].seq[:30]))
    for k in range(2):
        recs.append(Record(f"q_absent{k}", "",
                           "".join(rng.choice(bases, size=length))))
    return idx, recs


def entry(device="cuda", classifier=None, recs=None):
    """``(step, args)``: ``step(*args)`` runs one batch's device work and
    returns its tensors (the module docstring). Without ``classifier`` it
    builds a ``DeviceClassifier`` on ``device`` over
    ``synthetic_corpus()``; ``recs`` defaults to that corpus's reads."""
    from .engine.device.classifier import DeviceClassifier
    from .engine.gold.classify import Options

    if classifier is None:
        idx, corpus = synthetic_corpus()
        classifier = DeviceClassifier(idx, Options(), device)
        recs = corpus if recs is None else recs
    if recs is None:
        raise ValueError("entry: pass the records to run with a classifier")

    def step(batch):
        return classifier._device_step(batch).tensors

    return step, (list(recs),)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """MeshClassifier on an ``n_devices`` mesh against DeviceClassifier on
    ``synthetic_corpus()``; raises where their SAMs differ. Returns (and
    prints) the mesh shape and the reads by path."""
    from .engine.device.classifier import DeviceClassifier
    from .engine.gold.classify import Options
    from .io.sam import format_result
    from .parallel.classifier import MeshClassifier
    from .parallel.mesh import make_mesh

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device is "
                               "available")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", k % count) for k in range(n_devices)]
    else:
        devices = [device] * n_devices
    if n_devices % 2 == 0 and n_devices > 1:
        n_dp, n_idx = n_devices // 2, 2
    else:
        n_dp, n_idx = n_devices, 1
    idx, recs = synthetic_corpus()
    single = DeviceClassifier(idx, Options(), devices[0])
    exp = [format_result(r, idx.ref_name, single.opts)
           for r in single.classify_reads(recs)]
    eng = MeshClassifier(idx, Options(),
                         mesh=make_mesh(n_dp, n_idx, devices=devices))
    got_res = list(eng.classify_reads(recs))
    got = [format_result(r, idx.ref_name, eng.opts) for r in got_res]
    if got != exp:
        bad = [r.name for r, a, b in zip(recs, got, exp) if a != b]
        raise RuntimeError(f"dryrun_multichip: mesh classify differs from "
                           f"the single device on {bad}")
    fb = eng.fallback_stats()
    out = dict(n_dp=n_dp, n_idx=n_idx, reads=len(recs),
               distinct_devices=len(set(devices)),
               classified=sum(1 for r in got_res if r.chains),
               slow_path=fb["slow_path_reads"],
               fallback=fb["fallback_reads"])
    print(f"dryrun_multichip ok: mesh dp={n_dp} idx={n_idx} over "
          f"{out['distinct_devices']} distinct {device.type} device(s), "
          f"full pipeline (probe, ladders, chaining, rescore) byte-equal "
          f"to one device on {len(recs)} reads (classified "
          f"{out['classified']}, slow path {out['slow_path']}, fallback "
          f"{out['fallback']})")
    return out
