"""The compare-count lookup (K3): the port's ``compare_count`` (on the CPU,
so its plain version) == the two Pallas kernels of ``tools/gather_bench.py``
and ``tools/gather_bench2.py`` run in interpret mode, == the searchsorted
identity, bit for bit (tolerance 0: the function is integer throughout).

The tools run their benchmarks when imported, so the two Pallas bodies are
restated here verbatim, at small shapes (B=16, K=64, P=24, R=4, 8 lanes per
grid step)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

B, K, P, R, BB = 16, 64, 24, 4, 8


def pallas_cc_k3a(qval, tsort):
    """gather_bench.py:98-118 (``pallas_cc``): one program, whole arrays."""
    def cc_kernel(q_ref, t_ref, o_ref):
        t = t_ref[:]

        def body(i, acc_q):
            acc, q = acc_q
            cnt = jnp.sum((t[:, None, :] < q[:, :, None]), axis=2,
                          dtype=jnp.int32)
            return acc + cnt, q + 1
        acc, _ = jax.lax.fori_loop(
            0, R, body, (jnp.zeros((B, P), jnp.int32), q_ref[:]))
        o_ref[:] = acc

    return pl.pallas_call(
        cc_kernel,
        out_shape=jax.ShapeDtypeStruct((B, P), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(qval, tsort)


def pallas_cc_k3b(qval, table):
    """gather_bench2.py:72-97 (``cc_pallas``): a grid of B/8 steps."""
    def cc_kernel(q_ref, t_ref, o_ref):
        t = t_ref[:]                          # (BB, K)

        def body(i, acc_q):
            acc, q = acc_q
            cnt = jnp.sum((t[:, None, :] < q[:, :, None]), axis=2,
                          dtype=jnp.int32)
            return acc + cnt, q + 1
        acc, _ = jax.lax.fori_loop(
            0, R, body, (jnp.zeros((BB, P), jnp.int32), q_ref[:]))
        o_ref[:] = acc

    return pl.pallas_call(
        cc_kernel,
        grid=(B // BB,),
        out_shape=jax.ShapeDtypeStruct((B, P), jnp.int32),
        in_specs=[pl.BlockSpec((BB, P), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((BB, K), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((BB, P), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(qval, table)


@pytest.fixture(scope="module")
def inputs():
    """The bench's own inputs at the small shapes, plus edge queries: below
    every table value, above every one, equal to one (the compare is
    strict), and negative (the compare is signed)."""
    from desamba_tpu_torch.tools.gather_bench import make_inputs

    x = {k: v.numpy() for k, v in make_inputs(B, "cpu", seed=3, k=K,
                                               p=P).items()}
    for q, t in (("qval", "tsort"), ("qval_b", "table_b")):
        x[q][0, :4] = [-(1 << 31) + 2, -5, 1 << 20, x[t][0, 7]]
    return x


def _searchsorted(q, t):
    ts = torch.sort(torch.from_numpy(t), dim=1).values
    qt = torch.from_numpy(q)
    return sum(torch.searchsorted(ts, qt + r) for r in range(R)).to(
        torch.int32).numpy()


@pytest.mark.parametrize("variant", ["k3a_sorted_one_program",
                                     "k3b_unsorted_8_lane_grid"])
def test_compare_count_matches_pallas(inputs, variant):
    from desamba_tpu_torch.tools.cmpcount import compare_count

    if variant.startswith("k3a"):
        q, t, lanes, ref = inputs["qval"], inputs["tsort"], 1, pallas_cc_k3a
    else:
        q, t, lanes, ref = inputs["qval_b"], inputs["table_b"], BB, \
            pallas_cc_k3b
    exp = np.asarray(ref(jnp.asarray(q), jnp.asarray(t)))
    got = compare_count(torch.from_numpy(q), torch.from_numpy(t), R, lanes)
    assert got.dtype == torch.int32 and got.shape == (B, P)
    assert np.array_equal(got.numpy(), exp)
    assert np.array_equal(exp, _searchsorted(q, t))
    assert exp[0, 0] == 0 and exp[0, 2] == K * R    # below all, above all
    assert len(np.unique(exp)) > B                  # not a constant answer


def test_compare_count_plain_is_the_cpu_path():
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing; an unsupported device or a bad shape raises."""
    from desamba_tpu_torch.tools.cmpcount import (compare_count,
                                                  compare_count_plain)

    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-9, 9, (3, 5)).astype(np.int32))
    t = torch.from_numpy(rng.integers(-9, 9, (3, 7)).astype(np.int32))
    n0 = compare_count.launches
    assert torch.equal(compare_count(q, t, 3, 8), compare_count_plain(q, t, 3))
    assert compare_count.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        compare_count(q.to("meta"), t.to("meta"), 3)
    with pytest.raises(ValueError, match="share B"):
        compare_count(q, t[:2], 3)
    with pytest.raises(ValueError, match="int32"):
        compare_count(q.long(), t, 3)


def test_gather_bench_entry_point_on_cpu(capsys):
    """``main([..., "--device", "cpu"])`` runs every variant at a small B
    and prints one line per variant; its kernel variants return the plain
    version's counts on the bench's inputs."""
    from desamba_tpu_torch.tools import gather_bench as gb
    from desamba_tpu_torch.tools.cmpcount import compare_count_plain

    res = gb.main(["4", "all", "--device", "cpu"], reps=1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("B=4 K=1152 P=176 R=16 device=cpu")
    assert len(lines) == 1 + 5 + 6 and all(" ms " in ln for ln in lines[1:])
    assert set(res) >= {"gather", "mxu", "cmp", "pallas", "blocked",
                        "rows_w128_int32"}
    for key, lanes in (("pallas", 1), ("blocked", gb.LANES_BLOCKED)):
        r = res[key]
        q, t = r["inputs"]
        assert r["lanes_per_block"] == lanes and r["launches"] == 0
        assert torch.equal(r["out"], compare_count_plain(q, t, gb.R))
        assert r["ms"] > 0 and r["ns_per_elem"] > 0
    x = gb.make_inputs(4, "cpu")
    assert torch.equal(res["pallas"]["inputs"][1], x["tsort"])
    assert torch.equal(gb.gather(x["qidx"], x["table"], 1),
                       torch.gather(x["table"], 1, x["qidx"].long()))


def test_gather_bench_needs_a_card_for_cuda():
    from desamba_tpu_torch.tools import gather_bench as gb

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gb.main(["4", "pallas"])
