"""The port's seeding step against the JAX package's, bit for bit: the
single-device ``pipeline.seed_wave_step`` on the inputs of
tests/test_parallel.py (8 reads of 512 bp at 1/10 substitutions, 4
probes), and ``mesh.sharded_seed_step`` at (2, 2) on a mesh of the CPU
against the single-device step."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_stages import port_index  # noqa: E402


@pytest.fixture(scope="module")
def inputs(small_my_index):
    from desamba_tpu.engine.gold.mapseed import get_ref

    idx = small_my_index
    rng = np.random.default_rng(13)
    B, L = 8, 512
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    codes = np.zeros((B, L), np.uint8)
    for i in range(B):
        st = int(rng.integers(0, total - L))
        seq = get_ref(idx.ref_bin, st, L, True).copy()
        pos = rng.integers(0, L, size=L // 10)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=len(pos))) % 4
        codes[i] = seq
    lens = np.full((B,), L, np.int32)
    lens[5] = 300           # a shorter read: its padding is never probed
    return idx, codes, lens


@pytest.fixture(scope="module")
def single(inputs):
    from desamba_tpu_torch.engine.device.arrays import DeviceIndex
    from desamba_tpu_torch.engine.device.pipeline import (index_args,
                                                          seed_wave_step)

    idx, codes, lens = inputs
    dix = DeviceIndex.build(port_index(idx), "cpu")
    out = seed_wave_step(*index_args(dix), torch.from_numpy(codes),
                         torch.from_numpy(lens), l_ek=idx.len_e_kmer,
                         single_base_max=idx.single_base_max,
                         mask_bits=dix.mask_bits, n_probes=4)
    return dix, out


def test_seed_wave_step_equals_jax(inputs, single):
    from desamba_tpu.engine.device.arrays import DeviceIndex
    from desamba_tpu.engine.device.pipeline import index_args, seed_wave_step

    idx, codes, lens = inputs
    jd = DeviceIndex.build(idx)
    exp = seed_wave_step(*index_args(jd), jnp.asarray(codes),
                         jnp.asarray(lens), l_ek=idx.len_e_kmer,
                         single_base_max=idx.single_base_max,
                         mask_bits=jd.mask_bits, n_probes=4)
    _, got = single
    assert int(got[0].sum()) > 0 and int(got[1].max()) > 0
    for e, g in zip(exp, got):
        e = np.asarray(e)
        assert e.shape == tuple(g.shape)
        assert np.array_equal(e.astype(np.int64), g.numpy().astype(np.int64))


def test_sharded_seed_step_equals_single_device(inputs, single):
    from desamba_tpu_torch.parallel import (make_mesh, shard_index,
                                            sharded_seed_step)

    idx, codes, lens = inputs
    dix, exp = single
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    step = sharded_seed_step(mesh, shard_index(mesh, dix), idx.len_e_kmer,
                             idx.single_base_max, dix.mask_bits, n_probes=4)
    got = step(torch.from_numpy(codes), torch.from_numpy(lens))
    for e, g in zip(exp, got):
        assert e.dtype == g.dtype and torch.equal(e, g)
