"""The rescore kernel's plain version (rescore_ref) == the JAX Pallas kernel
(rescore_pl, interpret mode) on RescoreIn batches captured by spying on
``DeviceClassifier._k_rescore``, the way tests/test_rescore_pl.py captures
them (here the port's classifier on the CPU, which builds the batches
exactly as the JAX classifier does).

Chains, fallback flags, reason bits and step counts must be equal on every
row with n_chains > 0: mid-reference reads and reads in the last packed
reference row (main batch, 64 anchors), and the M3 sub-batch of the repeat
corpus (chain.M3_A2 = 512 anchors)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_repeat_paths import (  # noqa: E402,F401
    repeat_genome,
    repeat_my_index,
    repeat_reads,
)
from test_rescore_pl import _Rec, _reads_from  # noqa: E402
from test_torch_stages import T, assert_same  # noqa: E402


def _capture(idx, recs):
    """Every RescoreIn (as numpy) the port's classifier hands its rescore:
    the main batch and the M3 sub-batch."""
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier

    eng = DeviceClassifier(idx, Options(), "cpu")
    got = []
    orig = eng._k_rescore

    def spy(inp):
        got.append([f.numpy() for f in inp])
        return orig(inp)

    eng._k_rescore = spy
    list(eng.classify_reads(recs))
    return got


def _mid_reads(idx):
    """The reads of test_rescore_pl_matches_vm (same seed, same spans)."""
    rng = np.random.default_rng(11)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    spans = [(int(rng.integers(0, total - ln)), ln)
             for ln in rng.integers(250, 900, size=10)]
    return [_Rec(i, r) for i, r in enumerate(_reads_from(idx, spans, rng))]


def _tail_reads(idx):
    """Reads inside and across the last 2048-char packed reference row
    (the reads of test_rescore_pl_tail_of_reference)."""
    rng = np.random.default_rng(12)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    spans = []
    for ln in (300, 400, 500, 600):
        spans.append((total - ln - 5, ln))
        spans.append((total - 2048 - ln // 2, ln))
    return [_Rec(i, r)
            for i, r in enumerate(_reads_from(idx, spans, rng, err=0.05))]


@pytest.fixture(scope="module")
def batches(small_my_index, repeat_my_index, repeat_reads):
    """{case: (index, first RescoreIn)}: the main batch of the
    mid-reference reads and of the tail reads, and the M3 sub-batch of the
    repeat corpus."""
    from desamba_tpu.io.fastx import read_fastx

    out = {}
    for name, recs in (("mid_reference", _mid_reads(small_my_index)),
                       ("tail_of_reference", _tail_reads(small_my_index))):
        out[name] = (small_my_index, _capture(small_my_index, recs)[0])
    got = _capture(repeat_my_index, list(read_fastx(str(repeat_reads[0]))))
    wide = [g for g in got if g[2].shape[1] == 512]
    assert wide, "the repeat corpus never reached the M3 sub-batch"
    out["m3_width_512"] = (repeat_my_index, wide[0])
    return out


@pytest.mark.parametrize("case", ["mid_reference", "tail_of_reference",
                                  "m3_width_512"])
def test_rescore_ref_matches_pallas(batches, case):
    import desamba_tpu.engine.device.rescore as dr
    import desamba_tpu.engine.device.rescore_pl as drp
    from desamba_tpu.engine.device.arrays import DeviceIndex as JDix
    from desamba_tpu_torch.engine.device import rescore as tr
    from desamba_tpu_torch.engine.device import rescore_pl as trp
    from desamba_tpu_torch.engine.device.arrays import DeviceIndex

    idx, inp = batches[case]
    rows = np.flatnonzero(inp[1] > 0)
    assert len(rows) >= (1 if case == "m3_width_512" else 4), case
    sub = [f[rows] for f in inp]
    jd = JDix.build(idx)
    exp = drp.rescore_pl(dr.RescoreIn(*[jnp.asarray(f) for f in sub]),
                         jd.ref_pk, jd.ref_off, jd.ref_len_arr,
                         n_bases=jd.n_bases, interpret=True)
    tix = DeviceIndex.build(idx, "cpu")
    got = trp.rescore(tr.RescoreIn(*[T(f) for f in sub]),
                      trp.ref_words(tix.ref_pk), tix.ref_off,
                      tix.ref_len_arr, tix.n_bases)
    for what, e, g in zip(("chains", "fallback", "reason", "steps"), exp,
                          got):
        assert_same(e, g, f"{case} {what}")
    assert (~np.asarray(exp[1])).sum() >= 1, "every row fell back"
    if case == "m3_width_512":
        assert sub[2].shape[1] == 512


def test_sorted_9mer_tables_match_jax(batches):
    """The kernel's value-sorted per-direction 9-mer tables (stable sort,
    ties by ascending position) equal the JAX prep's."""
    from desamba_tpu.engine.device.rescore_pl import _build_sorted_rk as jb
    from desamba_tpu_torch.engine.device.rescore_pl import _build_sorted_rk

    _idx, inp = batches["mid_reference"]
    codes_fr, read_len = inp[5], inp[7]
    ev, ep, _coarse = jb(jnp.asarray(codes_fr), jnp.asarray(read_len))
    gv, gp = _build_sorted_rk(T(codes_fr), T(read_len))
    assert_same(ev, gv, "sorted 9-mer values")
    assert_same(ep, gp, "sorted 9-mer positions")
    assert gv.dtype == gp.dtype == torch.int32
