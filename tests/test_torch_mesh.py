"""The port's MeshClassifier on meshes of the CPU (device="cpu" repeated,
which runs every split and merge): its SAM is byte-equal to the port's
and the JAX package's DeviceClassifier on the 48-read noisy corpus of
tests/test_mesh_classifier.py at (4, 2), (2, 1) and (1, 4) (the JAX
DeviceClassifier's SAM is taken as the JAX MeshClassifier's at (4, 2),
which tests/test_mesh_classifier.py holds equal to it on this corpus, so
that its programs compile once); at (4, 2) its
fallback counts are the JAX MeshClassifier's (on the conftest's 8 virtual
CPU devices); a lane set that overflows one shard's ladder pack, but not
the single device's, is flagged where the JAX MeshClassifier flags it;
the existence-table shards concatenate back to the tables and share their
storage; and the layouts the port does not take raise."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_mesh_classifier import noisy_reads  # noqa: E402,F401
from test_torch_stages import port_index  # noqa: E402

SHAPES = [(4, 2), (2, 1), (1, 4)]


def _sam(pkg, eng, idx, recs):
    import importlib

    fmt = importlib.import_module(f"{pkg}.io.sam").format_result
    return "".join(fmt(r, idx.ref_name, eng.opts)
                   for r in eng.classify_reads(recs))


def _port_mesh(idx, shape):
    from desamba_tpu_torch.parallel import MeshClassifier, make_mesh

    return MeshClassifier(port_index(idx), None,
                          mesh=make_mesh(*shape, devices=["cpu"] * 8))


@pytest.fixture(scope="module")
def ref(small_my_index, noisy_reads):  # noqa: F811
    """The corpus, the port's DeviceClassifier's SAM and stats, and the
    JAX MeshClassifier at (4, 2) after its run, with its SAM."""
    from desamba_tpu.engine.gold.classify import Options
    from desamba_tpu.io.fastx import Record
    from desamba_tpu.parallel.classifier import MeshClassifier as JM
    from desamba_tpu.parallel.mesh import make_mesh as jmake_mesh
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    idx = small_my_index
    recs = [Record(n, "", s) for n, s in noisy_reads]
    port = DeviceClassifier(port_index(idx), None, "cpu")
    jmesh = JM(idx, Options(), mesh=jmake_mesh(4, 2))
    return dict(idx=idx, recs=recs,
                port=_sam("desamba_tpu_torch", port, idx, recs),
                jax=_sam("desamba_tpu", jmesh, idx, recs), jmesh=jmesh,
                port_stats=port.fallback_stats())


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
def test_mesh_sam_equals_device_classifiers(ref, shape):
    eng = _port_mesh(ref["idx"], shape)
    sam = _sam("desamba_tpu_torch", eng, ref["idx"], ref["recs"])
    assert sam == ref["port"] == ref["jax"]
    assert eng.fallback_stats()["total_reads"] == len(ref["recs"])


def test_mesh_fallback_stats_equal_jax_mesh(ref):
    eng = _port_mesh(ref["idx"], (4, 2))
    _sam("desamba_tpu_torch", eng, ref["idx"], ref["recs"])
    stats = eng.fallback_stats()
    jstats = ref["jmesh"].fallback_stats()
    assert {k: stats[k] for k in jstats} == jstats
    assert stats["by_cause"] == ref["port_stats"]["by_cause"]


def test_shard_pack_overflow_flagged_as_in_jax(ref):
    """Sixty copies of the corpus's richest fast lane fill one shard: 180
    anchors against a shard's pack of 2 * 256 / 4 = 128 rows at (4, 2),
    within the single device's 512. The lanes past the shard's pack are
    flagged (the ``ladder_pack`` cause) with the JAX MeshClassifier's
    offsets and flags; the single device flags none."""
    from desamba_tpu.engine.device.classifier import LaneSet as JLaneSet
    from desamba_tpu_torch.engine.device.classifier import (
        CAUSES, DeviceClassifier, LaneSet)

    idx = ref["idx"]
    port = DeviceClassifier(port_index(idx), None, "cpu")
    calls = []
    orig = port._run_ladder

    def spy(kind, ls, *a):
        out = orig(kind, ls, *a)
        if kind == "fast" and out is not None and not calls:
            calls.append((ls, a, out))
        return out

    port._run_ladder = spy
    list(port.classify_reads(ref["recs"]))
    ls0, (codes, blen, pre13), out0 = calls[0]
    k = int(np.argmax(out0[2]))
    assert out0[2][k] == 3
    pick = np.full(60, k)
    cols = [getattr(ls0, f)[pick] for f in
            ("ridx", "base", "rl", "dir", "sid", "soff", "slen")]
    single = port._run_ladder("fast", LaneSet(*cols), codes, blen, pre13)
    mesh = _port_mesh(idx, (4, 2))
    got = mesh._run_ladder("fast", LaneSet(*cols), codes, blen, pre13)
    jm = ref["jmesh"]
    exp = jm._run_ladder("fast", JLaneSet(*cols), jax.numpy.asarray(
        codes.numpy()), jax.numpy.asarray(blen.numpy()),
        jax.numpy.asarray(pre13.numpy()))
    assert not single[4].any()
    assert got[4].sum() == 60 - 128 // 3 == exp[4].sum()
    for g, e in zip(got[1:], exp[1:]):
        assert np.array_equal(g, np.asarray(e))
    assert np.array_equal(got[0].numpy(), np.asarray(exp[0]))
    # the device phase flags such a lane's read with cause 1
    fallback = np.zeros(8, bool)
    cause = np.zeros(8, np.int8)
    mesh._flag(fallback, cause, LaneSet(*cols).ridx[got[4]], 1)
    assert CAUSES[cause[cols[0][0]] - 1] == "ladder_pack"


def test_bloom_shards_concatenate_and_share_storage(ref):
    from desamba_tpu_torch.engine.device.arrays import DeviceIndex
    from desamba_tpu_torch.engine.device.islands import bloom_hit_kernel
    from desamba_tpu_torch.parallel.mesh import (bloom_rows, make_mesh,
                                                 shard_index)

    idx = port_index(ref["idx"])
    dix = DeviceIndex.build(idx, "cpu")
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    placed = shard_index(mesh, dix)
    for name in ("ekmer0", "ekmer1"):
        tab = getattr(dix, name)
        for d in range(2):
            assert torch.equal(torch.cat(placed[name][d]), tab)
            for i, shard in enumerate(placed[name][d]):
                assert shard.data_ptr() == tab.data_ptr() + i * shard.numel()
    for t in placed["tables"]:      # every dp row's replica, no copy
        assert t.fm_blocks.data_ptr() == dix.fm_blocks.data_ptr()
        assert t.hash13.data_ptr() == dix.hash13.data_ptr()
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 4, (8, 300)).astype(np.uint8))
    lens = torch.tensor([300, 250, 40, 300, 299, 31, 300, 120],
                        dtype=torch.int32)
    exp = bloom_hit_kernel(codes, lens, dix.ekmer0, dix.ekmer1,
                           idx.len_e_kmer, idx.single_base_max, dix.mask_bits)
    got = torch.cat([bloom_rows(mesh, placed, d, codes[4 * d:4 * d + 4],
                                lens[4 * d:4 * d + 4], idx.len_e_kmer,
                                idx.single_base_max, dix.mask_bits)
                     for d in range(2)])
    assert torch.equal(got, exp)


def test_layouts_not_taken_raise(small_my_index):
    from desamba_tpu_torch.engine.device.arrays import DeviceIndex
    from desamba_tpu_torch.parallel import MeshClassifier, make_mesh
    from desamba_tpu_torch.parallel.mesh import shard_index

    idx = port_index(small_my_index)
    with pytest.raises(ValueError, match="power of two"):
        MeshClassifier(idx, None, mesh=make_mesh(3, 1, devices=["cpu"] * 3))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
        MeshClassifier(idx, None, mesh=make_mesh(2, 1, devices=["cpu"] * 2),
                       shard_full=True)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="equal ranges"):
        shard_index(make_mesh(1, 3, devices=["cpu"] * 3),
                    DeviceIndex.build(idx, "cpu"))
