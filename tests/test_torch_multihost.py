"""The port's multi-process classify: two localhost processes
(``torch.distributed`` over gloo), each a (2, 1) mesh of the CPU, run
``desamba_tpu_torch/tools/multihost_worker.py`` and gather the SAM in
order; it is byte-equal to one process's ``DeviceClassifier`` on the whole
stream and to the JAX package's serial gold ``classify_read``.

The stream sets the trap that the JAX worker's seeding falls into: slice
0 ends with a random (chainless) 600-bp read after reads that all stay
below 510 bp, and slice 1 opens with short reads (60-500 bp, 2-15 %
errors) whose filter depends on whether the stream state has reached 510.
One process's state stays below 510 there; the longest read before slice
1 is 600 bp."""
import os
import random
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_torch_cli import Rec, short_read_stream, write_fastq  # noqa: E402
from test_torch_stages import port_index  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N_OPEN = 30        # short reads that open slice 1


def _free_port():
    """A free localhost port below the kernel's ephemeral range, found by
    binding it. A port of that range, released for the worker to bind, can
    be handed in between to any outgoing connection on the host (the gloo
    pairs and the coordinator clients of another multi-process test running
    beside this one); a port below it is handed only to an explicit bind."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError):
        low = 32768
    rng = random.Random(os.getpid() * 1000003 + time.monotonic_ns())
    for _ in range(100):
        port = rng.randrange(max(1024, low - 8192), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free localhost port below the ephemeral range")


def _in_use(out):
    out = out.lower()
    return "eaddrinuse" in out or "address already in use" in out


def _run_workers(argv, tmp_path, timeout=300, attempts=3):
    """The two worker processes (``argv(k, port)``) on a free port, waited
    for together; where one fails to bind the port (another process bound
    it first), both stop and start again on another port. Returns (return
    codes, outputs) of the last attempt."""
    for attempt in range(attempts):
        port = _free_port()
        logs = [tmp_path / f"worker{k}.{attempt}.log" for k in range(2)]
        procs = []
        for k in range(2):
            with open(logs[k], "w") as f:
                procs.append(subprocess.Popen(
                    argv(k, port), cwd=REPO, env=dict(os.environ), stdout=f,
                    stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) and _in_use(log.read_text())
                        for p, log in zip(procs, logs)):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = [log.read_text() for log in logs]
        codes = [p.returncode for p in procs]
        if codes == [0, 0] or not any(map(_in_use, outs)):
            break
    return codes, outs


def _corpus48(idx):
    """The 48 reads of tests/test_multihost.py (150-900 bp from the
    reference at 1/12 substitutions, every third reverse complemented,
    every seventh cut to 40 bp)."""
    from desamba_tpu.engine.gold.mapseed import get_ref

    rng = np.random.default_rng(17)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    recs = []
    for k in range(48):
        ln = int(rng.integers(150, 900))
        st = int(rng.integers(0, total - ln))
        seq = get_ref(idx.ref_bin, st, ln, True).copy()
        pos = rng.integers(0, ln, size=ln // 12)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
        s = "".join("ACGT"[c] for c in seq)
        if k % 3 == 1:
            s = "".join("ACGT"[comp[c]] for c in seq[::-1])
        if k % 7 == 0:
            s = s[:40]
        recs.append(Rec(f"r{k}", s))
    return recs


def trap_stream(idx):
    """(stream, slice length): slice 0 is the 48 reads' shorter ones
    (under 510 bp), filler short reads and the random 600-bp read last;
    slice 1 is N_OPEN short reads, then the 48 reads' longer ones."""
    c48 = _corpus48(idx)
    short = short_read_stream(idx, 200)
    long0, short = short[0], short[1:]
    low = [r for r in c48 if len(r.seq) < 510]
    high = [r for r in c48 if len(r.seq) >= 510]
    slice1 = short[:N_OPEN] + high
    fill = len(slice1) - len(low) - 1
    slice0 = low + short[N_OPEN:N_OPEN + fill] + [long0]
    return slice0 + slice1, len(slice1)


def _by_read(sam):
    """{read name: its SAM lines}, in stream order."""
    out = {}
    for line in sam.splitlines():
        out.setdefault(line.split("\t", 1)[0], []).append(line)
    return out


def _sam(eng, results, idx):
    from desamba_tpu_torch.io.sam import format_result

    return "".join(format_result(r, idx.ref_name, eng.opts)
                   for r in results)


def test_two_process_classify_equals_one_process(small_my_index, tmp_path):
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.index.store import save_index
    from desamba_tpu.io.sam import format_result
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier

    idx = small_my_index
    recs, per = trap_stream(idx)
    assert len(recs) == 2 * per and recs[per - 1].name == "long0"
    fq = tmp_path / "reads.fq"
    write_fastq(fq, recs)
    idx_dir = tmp_path / "idx"
    save_index(idx, str(idx_dir))

    # one process, the whole stream; the trap holds: below 510 at the
    # slice boundary, while the longest read before slice 1 passes it
    one = DeviceClassifier(port_index(idx), None, "cpu")
    first = _sam(one, one.classify_reads(recs[:per]), idx)
    assert one.state.max_read_l < 510 <= max(len(r.seq) for r in recs[:per])
    exp = first + _sam(one, one.classify_reads(recs[per:]), idx)
    gold = ClassifyEngine(idx, Options())
    assert exp == "".join(
        format_result(gold.classify_read(r.name, r.seq, r.qual),
                      idx.ref_name, gold.opts) for r in recs)

    out = tmp_path / "mh.sam"
    codes, outs = _run_workers(
        lambda k, port: [
            sys.executable, "-m", "desamba_tpu_torch.tools.multihost_worker",
            "--coordinator", f"localhost:{port}", "--num-processes", "2",
            "--process-id", str(k), "--index", str(idx_dir),
            "--reads", str(fq), "--out", str(out), "--device", "cpu",
            "--local-devices", "2", "--n-idx", "1"], tmp_path)
    for k, (c, o) in enumerate(zip(codes, outs)):
        assert c == 0, f"process {k} failed:\n{o[-4000:]}"
    got = _by_read(out.read_text())
    want = _by_read(exp)
    differ = [n for n in want if got.get(n) != want[n]]
    assert (list(got), differ) == (list(want), []), \
        f"{len(differ)} of {len(want)} reads' records differ: {differ}"
    # slice 1 was re-run from the serial state (its guess, 600, is on the
    # other side of 510)
    assert "re-run from the serial state: [(1, " in outs[1], outs[1]
