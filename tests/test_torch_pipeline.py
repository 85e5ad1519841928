"""The port's pipelined DeviceClassifier (device="cpu") against its serial
schedule and the JAX DeviceClassifier, byte for byte (tolerance 0; the
pipeline is integer): ``classify_reads`` at ``DESAMBA_PIPE_DEPTH`` 1 and 3
and ``classify_file``, at ``batch_size=3`` over four batches, the first of
which opens with a chainless 600-bp read followed by short reads, one of
them handed to gold; ``fallback_stats()`` equal to the serial run's; every
finish on the caller's thread in input order; no batch's prep outliving its
finish; no thread left after an early close or a parse error."""
import gc
import threading
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from test_torch_cli import Rec, short_read_stream, write_fastq  # noqa: E402
from test_torch_stages import port_index  # noqa: E402

BATCH = 3
# from short_read_stream(idx, 300, 5): r59 goes to gold; r6 .. r107 are
# reads whose SAM depends on the stream state (max_read_l below or at 510)
PICK = ("long0", "r59", "r6", "r10", "r22", None, "r67", "r86", "r90",
        "r92", "r102", "r107")


def _stream(idx):
    """Twelve reads, four batches of three: the chainless 600-bp read, a
    gold read and state-dependent short reads, with a 700-bp read with
    chains (which raises the state past 510) in the second batch."""
    from desamba_tpu.engine.gold.mapseed import get_ref

    by_name = {r.name: r for r in short_read_stream(idx)}
    rng = np.random.default_rng(17)
    seq = get_ref(idx.ref_bin, int(idx.ref_off[1]) + 5000, 700, True).copy()
    pos = rng.integers(0, 700, size=21)
    seq[pos] = (seq[pos] + 1) % 4
    long1 = Rec("long1", "".join("ACGT"[c] for c in seq))
    return [by_name[n] if n else long1 for n in PICK]


def _sam(eng, results, idx):
    from desamba_tpu_torch.io.sam import format_result

    return "".join(format_result(r, idx.ref_name, eng.opts)
                   for r in results)


def _port(idx):
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier

    return DeviceClassifier(port_index(idx), None, "cpu", batch_size=BATCH)


@pytest.fixture(scope="module")
def case(small_my_index):
    """The stream, its serial-schedule SAM and fallback stats (batches one
    after another on this thread), and the JAX DeviceClassifier's SAM."""
    from desamba_tpu.engine.device.classifier import DeviceClassifier as J
    from desamba_tpu.io.sam import format_result as jfmt

    idx = small_my_index
    recs = _stream(idx)
    eng = _port(idx)
    serial = _sam(eng, [r for i in range(0, len(recs), BATCH)
                        for r in eng._classify_batch(recs[i : i + BATCH])],
                  idx)
    j = J(idx, None, batch_size=BATCH)
    jax_sam = "".join(jfmt(r, idx.ref_name, j.opts)
                      for r in j.classify_reads(recs))
    return dict(idx=idx, recs=recs, serial=serial, stats=eng.fallback_stats(),
                jax=jax_sam)


def test_stream_holds_the_edge(case):
    """The first read is chainless, a read goes to gold, the 700-bp read
    has chains, and some short read's SAM differs at another state."""
    from desamba_tpu_torch.engine.gold.classify import ClassifyEngine
    from desamba_tpu_torch.io.sam import format_result

    idx, recs = case["idx"], case["recs"]
    lines = case["serial"].splitlines()
    assert lines[0].split("\t")[:3] == ["long0", "4", "*"]
    assert any(ln.startswith("long1\t0\t") or ln.startswith("long1\t16\t")
               for ln in lines)
    assert case["stats"]["fallback_reads"] >= 1
    assert case["stats"]["total_reads"] == len(recs) == 4 * BATCH
    g = ClassifyEngine(port_index(idx))

    def at(r, state):
        g.state.max_read_l = state
        return format_result(g.classify_read(r.name, r.seq), idx.ref_name,
                             g.opts)

    assert any(at(r, 0) != at(r, 700) for r in recs[2:] if len(r.seq) < 510)
    assert case["serial"] == case["jax"]


@pytest.mark.parametrize("depth", ["1", "3"])
def test_pipelined_classify_reads_equals_serial_and_jax(case, depth,
                                                        monkeypatch):
    monkeypatch.setenv("DESAMBA_PIPE_DEPTH", depth)
    eng = _port(case["idx"])
    finishes = []
    orig = eng._device_phase

    def spy(recs_b, prep=None):
        fin = orig(recs_b, prep)

        def finish():
            finishes.append((case["recs"].index(recs_b[0]) // BATCH,
                             threading.current_thread()))
            return fin()
        return finish

    eng._device_phase = spy
    sam = _sam(eng, eng.classify_reads(case["recs"]), case["idx"])
    assert sam == case["serial"] == case["jax"]
    assert eng.fallback_stats() == case["stats"]
    assert finishes == [(k, threading.main_thread()) for k in range(4)]
    assert eng.stage_s["finish"] > 0 and eng.stage_s["islands"] > 0


def test_classify_file_equals_serial_and_jax(case, tmp_path):
    fq = tmp_path / "reads.fq"
    write_fastq(fq, case["recs"])
    eng = _port(case["idx"])
    sam = _sam(eng, eng.classify_file(str(fq)), case["idx"])
    assert sam == case["serial"] == case["jax"]
    assert eng.fallback_stats() == case["stats"]


def test_no_batch_prep_outlives_its_finish(case, monkeypatch):
    """When batch k's first result reaches the caller, no prep of a batch
    before k is still referenced (the JAX classifier keeps them all)."""
    monkeypatch.setenv("DESAMBA_PIPE_DEPTH", "1")
    eng = _port(case["idx"])
    recs = case["recs"]
    refs = {}
    orig = eng._prep_batch

    class Todo(list):
        pass

    def spy(recs_b):
        todo, islands = orig(recs_b)
        todo = Todo(todo)
        refs[recs.index(recs_b[0]) // BATCH] = weakref.ref(todo)
        return todo, islands

    eng._prep_batch = spy
    for i, _ in enumerate(eng.classify_reads(recs)):
        if i % BATCH == 0:
            gc.collect()
            alive = [k for k in range(i // BATCH) if refs[k]() is not None]
            assert alive == [], (i, alive)
    assert sorted(refs) == [0, 1, 2, 3]


def _our_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("desamba-")]


def test_early_close_leaves_no_thread(case, tmp_path, monkeypatch):
    monkeypatch.setenv("DESAMBA_PIPE_DEPTH", "1")
    monkeypatch.setenv("DESAMBA_PREP_WORKERS", "1")
    eng = _port(case["idx"])
    gen = eng.classify_reads(case["recs"])
    next(gen)
    assert _our_threads()
    gen.close()
    assert _our_threads() == []

    fq = tmp_path / "reads.fq"
    write_fastq(fq, case["recs"])
    gen = eng.classify_file(str(fq))
    next(gen)
    gen.close()
    assert _our_threads() == []


def test_classify_file_raises_a_parse_error(case, tmp_path):
    fq = tmp_path / "bad.fq"
    write_fastq(fq, case["recs"][:2])
    with open(fq, "a") as f:
        f.write("not a record\n")
    with pytest.raises(OSError, match="malformed"):
        list(_port(case["idx"]).classify_file(str(fq)))
    assert _our_threads() == []
