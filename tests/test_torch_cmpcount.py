"""The compare-count lookup (K3): the port's ``compare_count`` (on the CPU,
so its plain version) == the two Pallas kernels of ``tools/gather_bench.py``
and ``tools/gather_bench2.py`` run in interpret mode, == the searchsorted
identity, bit for bit (tolerance 0: the function is integer throughout).

The tools run their benchmarks when imported, so the two Pallas bodies are
restated here verbatim, at small shapes (B=16, K=64, P=24, R=4, 8 lanes per
grid step).

The CUDA kernel's own source, ``kernels/cmpcount.cu``, runs here too: compiled
with g++ over ``tests/cuda_host/block_emu.h`` (a block's threads as
coroutines, taken in one order or the other between barriers), it must equal
the plain version on every edge case below, bit for bit."""
import ctypes
import os
import shutil
import subprocess

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


# ---- the CUDA kernel's own source, run on the CPU ----------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


@pytest.fixture(scope="module")
def cmpcount_emu(tmp_path_factory):
    """kernels/cmpcount.cu compiled as host C++ over
    tests/cuda_host/block_emu.h, loaded with ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernel with")
    so = str(tmp_path_factory.mktemp("cmpcount_emu") / "cmpcount_emu.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", host,
                    "-I", KERNELS, os.path.join(host, "cmpcount_emu.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.cmpcount_emulate.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    lib.cmpcount_emulate.restype = ctypes.c_int
    lib.cmpcount_emu_error.restype = ctypes.c_char_p
    return lib


def _emulate(lib, q, t, repeats, threads, reverse):
    """The kernel's grid on the CPU, one block per row of t: (B, P) int32."""
    q = np.ascontiguousarray(q, dtype=np.int32)
    t = np.ascontiguousarray(t, dtype=np.int32)
    (B, P), K = q.shape, t.shape[1]
    out = np.full((B, P), -7, np.int32)            # every word is written
    rc = lib.cmpcount_emulate(q.ctypes.data, t.ctypes.data, out.ctypes.data,
                              B, P, K, repeats, threads, int(reverse))
    assert rc == 0, lib.cmpcount_emu_error().decode()
    return out


def _case(name, threads):
    """(q, t, repeats, threads) for one edge case, from a seed."""
    from desamba_tpu_torch.tools import gather_bench as gb

    rng = np.random.default_rng(11)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    if name.startswith("bench"):
        x = {k: v.numpy() for k, v in gb.make_inputs(3, "cpu").items()}
        q, t = ((x["qval"], x["tsort"]) if name == "bench_sorted_table"
                else (x["qval_b"], x["table_b"]))
        return q, t, gb.R, threads
    R, B, P, K = 5, 3, 40, 100
    q = ints(-300, 300, (B, P))
    if name in ("sorted_row", "unsorted_row"):
        t = ints(-300, 300, (B, K))
    elif name.startswith("extremes"):
        # few distinct values: long runs of duplicates, both int32 extremes
        t = rng.choice(np.array([I32_MIN, I32_MIN + 1, -3, 0, 0, 7, 7, 7,
                                 I32_MAX - 1, I32_MAX], np.int32), (B, K))
        q[:, :6] = [I32_MIN, I32_MIN + 1, -3, 7, I32_MAX - 1, I32_MAX]
    elif name == "wrapping_queries":
        # q + r passes INT32_MAX and wraps to near INT32_MIN
        t = ints(I32_MIN, I32_MAX, (B, K))
        t[:, :4] = [I32_MIN, I32_MIN + 2, I32_MAX - 1, I32_MAX]
        q[:, :R] = I32_MAX - R + 2 + np.arange(R, dtype=np.int32)
    elif name == "k_not_a_power_of_two":
        K = 37
        t = ints(-300, 300, (B, K))
    elif name == "k_a_power_of_two":
        K = 64
        t = ints(-300, 300, (B, K))
    elif name == "k_is_1":
        K, R = 1, 3
        t = ints(-5, 5, (B, K))
        q = ints(-8, 8, (B, P))
    elif name == "k_is_0":
        K = 0
        t = np.zeros((B, 0), np.int32)
    elif name == "p_not_a_multiple_of_the_block":
        P = 2 * threads + 7
        q = ints(-300, 300, (B, P))
        t = ints(-300, 300, (B, K))
    elif name in ("r_is_0", "r_is_1"):
        t = ints(-300, 300, (B, K))
        R = int(name[-1])
    elif name == "largest_row":
        from desamba_tpu_torch.tools.cmpcount import MAX_K

        B, K, R = 1, MAX_K, 3
        t = ints(-1000, 1000, (B, K))
        q = ints(-1000, 1000, (B, P))
    else:
        raise KeyError(name)
    if name in ("sorted_row", "extremes_sorted"):
        t = np.sort(t, axis=1)
    return q, t, R, threads


EMU_CASES = {
    # case: the block size it runs at (the launcher's for the bench's rows)
    "bench_sorted_table": None, "bench_unsorted_table": None,
    "sorted_row": 32, "unsorted_row": 64, "extremes_sorted": 32,
    "extremes_unsorted": 32, "wrapping_queries": 32,
    "k_not_a_power_of_two": 32, "k_a_power_of_two": 32, "k_is_1": 32,
    "k_is_0": 32, "p_not_a_multiple_of_the_block": 32, "r_is_0": 32, "r_is_1": 32,
    "largest_row": 64,
}


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["threads_up", "threads_down"])
@pytest.mark.parametrize("case", list(EMU_CASES))
def test_block_kernel_source_matches_plain(cmpcount_emu, case, reverse):
    """kernels/cmpcount.cu itself (a block per row: stage, sort only a row
    that does not ascend, search), run on the CPU with each block's threads
    taken in one order and then the other between barriers, equals the
    plain version bit for bit. A missing barrier shows in one of the two
    orders."""
    from desamba_tpu_torch.tools.cmpcount import compare_count_plain

    threads = EMU_CASES[case] or cmpcount_emu.cmpcount_emu_threads()
    q, t, R, threads = _case(case, threads)
    exp = compare_count_plain(torch.from_numpy(q), torch.from_numpy(t),
                              R).numpy()
    got = _emulate(cmpcount_emu, q, t, R, threads, reverse)
    assert np.array_equal(got, exp), (
        f"{case}: {int((got != exp).sum())} of {exp.size} counts differ")
    if case in ("sorted_row", "extremes_sorted", "bench_sorted_table"):
        assert (np.diff(t.astype(np.int64), axis=1) >= 0).all()
    elif t.shape[1] > 1:
        assert (np.diff(t.astype(np.int64), axis=1) < 0).any(axis=1).all()
    if case == "wrapping_queries":                 # the wrap did happen
        assert exp[:, 1].max() < exp[:, 0].min()
    if t.shape[1] and R:
        assert len(np.unique(exp)) > 1             # not a constant answer


def test_max_k_is_the_kernels_limit(cmpcount_emu):
    """The wrapper's MAX_K is the kernel's: the row fills CMPCOUNT_MAX_N
    words with its pad, and one entry more is refused."""
    from desamba_tpu_torch.tools.cmpcount import MAX_K

    q = np.zeros((1, 1), np.int32)
    t = np.zeros((1, MAX_K + 1), np.int32)
    out = np.zeros((1, 1), np.int32)
    assert cmpcount_emu.cmpcount_emulate(
        q.ctypes.data, t.ctypes.data, out.ctypes.data, 1, 1, MAX_K + 1, 1, 32,
        0) == 1
    assert b"out of range" in cmpcount_emu.cmpcount_emu_error()
