"""The port's DeviceClassifier (device="cpu") end to end: its SAM is
byte-equal to the JAX DeviceClassifier's and to the gold oracle's, on noisy
small-genome reads (with reads absent from the index, so the slow ladders
run) and on the repeat corpus (so the M3 path runs), and it hands to gold,
before the rescore, exactly the reads the JAX classifier hands to gold."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_repeat_paths import (  # noqa: E402,F401
    repeat_genome,
    repeat_my_index,
    repeat_reads,
)
from test_torch_ladder import _noisy_recs  # noqa: E402
from test_torch_stages import port_index  # noqa: E402


def _run(pkg, idx, recs, **kw):
    """(SAM text, names handed to gold before the rescore, classifier) of
    the DeviceClassifier of ``pkg`` (``desamba_tpu`` or
    ``desamba_tpu_torch``), with that package's Options and SAM formatter;
    the port gets the index through ``index_from_arrays``.

    The pre-rescore gold set is read from the ``fallback`` array that the
    device phase's finish closure holds, in both packages."""
    import importlib

    cls = importlib.import_module(
        f"{pkg}.engine.device.classifier").DeviceClassifier
    Options = importlib.import_module(f"{pkg}.engine.gold.classify").Options
    format_result = importlib.import_module(f"{pkg}.io.sam").format_result
    if pkg == "desamba_tpu_torch":
        idx = port_index(idx)
    eng = cls(idx, Options(), **kw)
    pre = []
    orig = eng._device_phase

    def spy(recs_b, prep=None):
        fin = orig(recs_b, prep)
        names = fin.__code__.co_freevars
        if "fallback" in names:
            cell = dict(zip(names, fin.__closure__))
            todo = cell["todo"].cell_contents
            fallback = cell["fallback"].cell_contents
            pre.extend(recs_b[todo[k]].name
                       for k in np.flatnonzero(fallback[: len(todo)]))
        return fin

    eng._device_phase = spy
    sam = "".join(format_result(r, idx.ref_name, eng.opts)
                  for r in eng.classify_reads(recs))
    return sam, pre, eng


def _gold_sam(idx, recs):
    from desamba_tpu.engine.gold.classify import ClassifyEngine, Options
    from desamba_tpu.io.sam import format_result

    g = ClassifyEngine(idx, Options())
    return "".join(format_result(g.classify_read(r.name, r.seq, r.qual),
                                 idx.ref_name, g.opts) for r in recs)


@pytest.fixture(scope="module", params=["small_noisy", "repeat_corpus"])
def corpus(request, small_my_index, repeat_my_index, repeat_reads):
    from desamba_tpu.io.fastx import read_fastx

    if request.param == "small_noisy":
        idx, recs = small_my_index, _noisy_recs(small_my_index, 24, 41)
    else:
        idx = repeat_my_index
        recs = list(read_fastx(str(repeat_reads[0])))
    jax_sam, jax_pre, _ = _run("desamba_tpu", idx, recs)
    sam, pre, eng = _run("desamba_tpu_torch", idx, recs, device="cpu")
    return dict(name=request.param, idx=idx, recs=recs, jax_sam=jax_sam,
                jax_pre=jax_pre, sam=sam, pre=pre, eng=eng,
                gold_sam=_gold_sam(idx, recs))


def test_sam_equals_jax_and_gold(corpus):
    assert corpus["sam"] == corpus["jax_sam"]
    assert corpus["sam"] == corpus["gold_sam"]
    fb = corpus["eng"].fallback_stats()
    assert fb["total_reads"] == len(corpus["recs"])
    if corpus["name"] == "small_noisy":
        assert fb["slow_path_reads"] > 0, fb
    else:
        assert fb["m3_path_reads"] > 0, fb


def test_pre_rescore_gold_set_equals_jax(corpus):
    assert corpus["pre"] == corpus["jax_pre"]
    eng = corpus["eng"]
    fb = eng.fallback_stats()
    by_cause = fb["by_cause"]
    pre_causes = sum(by_cause[c] for c in ("ladder_pack", "anchors",
                                           "chain_slot", "m3"))
    assert pre_causes == len(corpus["pre"])
    assert sum(by_cause.values()) == fb["fallback_reads"]


def test_cli_classify_on_cpu(small_my_index, tmp_path):
    """``python -m desamba_tpu_torch.cli classify`` writes the gold SAM."""
    from desamba_tpu.index.store import save_index
    from desamba_tpu_torch.cli import main

    recs = _noisy_recs(small_my_index, 6, 43)
    save_index(small_my_index, str(tmp_path / "idx"))
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@{r.name}\n{r.seq}\n+\n{'I' * len(r.seq)}\n"
                          for r in recs))
    out = tmp_path / "out.sam"
    main(["classify", str(tmp_path / "idx"), str(fq), "-o", str(out),
          "--device", "cpu"])
    assert out.read_text() == _gold_sam(small_my_index, recs)


def test_cli_engine_auto_runs_gold(small_my_index, tmp_path, monkeypatch):
    """``--engine auto`` resolves to the gold oracle, as the reference's
    does while gold leads: the gold SAM, and no DeviceClassifier built."""
    from desamba_tpu.index.store import save_index
    from desamba_tpu_torch.cli import main
    from desamba_tpu_torch.engine.device import classifier

    def refuse(*a, **kw):
        raise AssertionError("--engine auto built a DeviceClassifier")

    monkeypatch.setattr(classifier, "DeviceClassifier", refuse)
    recs = _noisy_recs(small_my_index, 3, 47)
    save_index(small_my_index, str(tmp_path / "idx"))
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@{r.name}\n{r.seq}\n+\n{'I' * len(r.seq)}\n"
                          for r in recs))
    out = tmp_path / "out.sam"
    main(["classify", str(tmp_path / "idx"), str(fq), "-o", str(out),
          "--engine", "auto"])
    assert out.read_text() == _gold_sam(small_my_index, recs)


def test_cuda_device_raises_without_a_card(small_my_index):
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceClassifier(small_my_index, None, "cuda")
