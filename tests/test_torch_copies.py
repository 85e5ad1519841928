"""The port's own copies of the JAX package's host code are faithful, with
tolerance 0 (the pipeline is integer throughout): ``build_index`` (in RAM
and through the external-memory builder) gives the same index field by
field, the gold ``ClassifyEngine`` writes the same SAM, the constants are
equal name for name, the copies of ``analysis/`` and ``index/compat.py``
are the originals' sources and export and load the reference's index
format alike, and the port's native library builds without a race when
several processes build it at once."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from test_repeat_paths import (  # noqa: F401
    repeat_genome,
    repeat_my_index,
    repeat_reads,
)
from test_torch_ladder import _noisy_recs
from test_torch_stages import port_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_index(exp, got):
    assert type(got).__module__ == "desamba_tpu_torch.index.build"
    # occ_prefix is built lazily, and the shared index of a test run has it
    # once any earlier test of this process has asked for it
    if exp.occ_prefix is not None:
        got.build_occ_prefix()
    for f in dataclasses.fields(exp):
        e, g = getattr(exp, f.name), getattr(got, f.name)
        if isinstance(e, np.ndarray):
            assert isinstance(g, np.ndarray), f.name
            assert e.dtype == g.dtype and e.shape == g.shape, f.name
            assert np.array_equal(e, g), f.name
        else:
            assert e == g, f.name


@pytest.mark.parametrize("how", ["in_ram", "external"])
def test_build_index_equals_jax(small_genome, small_my_index, how,
                                monkeypatch):
    from desamba_tpu.index.build import build_index as jax_build
    from desamba_tpu_torch.index.build import build_index

    if how == "external":
        monkeypatch.setenv("DESAMBA_FORCE_EXTERNAL_BUILD", "1")
        exp = jax_build(str(small_genome))
    else:
        exp = small_my_index
    _assert_same_index(exp, build_index(str(small_genome)))


def test_index_from_arrays_rejects_unknown_fields(small_my_index):
    from desamba_tpu_torch.index.store import index_from_arrays

    fields = {f.name: getattr(small_my_index, f.name)
              for f in dataclasses.fields(small_my_index)}
    _assert_same_index(small_my_index, index_from_arrays(fields))
    with pytest.raises(ValueError, match="unknown"):
        index_from_arrays({**fields, "bogus": 1})
    with pytest.raises(ValueError, match="missing"):
        index_from_arrays({k: v for k, v in fields.items() if k != "rank"})


@pytest.mark.parametrize("corpus", ["small_noisy", "repeat_corpus"])
def test_gold_sam_equals_jax(corpus, small_my_index, repeat_my_index,
                             repeat_reads):
    from desamba_tpu.engine.gold.classify import ClassifyEngine as JEng
    from desamba_tpu.io.fastx import read_fastx
    from desamba_tpu.io.sam import format_result as jfmt
    from desamba_tpu_torch.engine.gold.classify import ClassifyEngine
    from desamba_tpu_torch.io.sam import format_result

    if corpus == "small_noisy":
        idx, recs = small_my_index, _noisy_recs(small_my_index, 24, 41)
    else:
        idx, recs = repeat_my_index, list(read_fastx(str(repeat_reads[0])))
    j = JEng(idx)
    exp = "".join(jfmt(j.classify_read(r.name, r.seq, r.qual), idx.ref_name,
                       j.opts) for r in recs)
    g = ClassifyEngine(port_index(idx))
    got = "".join(format_result(g.classify_read(r.name, r.seq, r.qual),
                                idx.ref_name, g.opts) for r in recs)
    assert got == exp
    assert exp.count("\n") >= len(recs)


def test_constants_equal_jax():
    import desamba_tpu.constants as jc
    import desamba_tpu_torch.constants as tc

    def public(m):
        return {n for n in dir(m) if not n.startswith("_")}

    assert public(tc) == public(jc)
    for n in public(jc):
        assert getattr(tc, n) == getattr(jc, n), n


def test_native_builds_race_free(tmp_path):
    """Four processes build the port's native library into one fresh
    directory at once; all four load it, and no temporary file is left."""
    from desamba_tpu_torch.io import native

    code = ("import sys\n"
            "from desamba_tpu_torch.io import native\n"
            "lib = native._load(native.build(sys.argv[1]))\n"
            "print(lib.lv_extd is not None)\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "True"
    assert [str(f) for f in tmp_path.iterdir()] == [
        native.lib_path(str(tmp_path))]


VERBATIM = ["analysis/__init__.py", "analysis/taxonomy.py",
            "analysis/evaluate.py", "index/compat.py"]


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy_equals_its_original(path):
    """These copies import only relative to their package, so they are the
    original files byte for byte."""
    with open(os.path.join(REPO, "desamba_tpu", path), "rb") as f:
        exp = f.read()
    with open(os.path.join(REPO, "desamba_tpu_torch", path), "rb") as f:
        assert f.read() == exp


def test_compat_export_and_load_equal_jax(small_my_index, tmp_path):
    """The reference's index format of one index, written by each
    package, file for file; each package's loader reads it back with the
    same outcome."""
    from desamba_tpu.index.compat import export_reference_format as jexp
    from desamba_tpu.index.compat import load_reference_index as jload
    from desamba_tpu_torch.index.compat import (export_reference_format,
                                                load_reference_index)

    jexp(small_my_index, str(tmp_path / "jax"))
    export_reference_format(port_index(small_my_index),
                            str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert "deSAMBA.bwt" in names
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
    def outcome(load, d):
        # the reader's result, or what it raised (the JAX reader rejects
        # this index's export: it trims the rows at the last valid code)
        try:
            idx = load(str(d))
        except Exception as e:
            return type(e).__name__, str(e)
        return [(f.name, getattr(idx, f.name).tolist()
                 if isinstance(getattr(idx, f.name), np.ndarray)
                 else getattr(idx, f.name))
                for f in dataclasses.fields(idx)]

    assert outcome(load_reference_index, tmp_path / "port") == \
        outcome(jload, tmp_path / "jax")
