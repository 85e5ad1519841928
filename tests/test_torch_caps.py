"""The capability probes (K7): each probe of the port's ``tools/caps.py`` (on
the CPU, so its plain version) == the Pallas kernel body of
``tools/pallas_caps.py`` it replaces, run in interpret mode on the same
seeded inputs, == the numpy expression the port's entry point holds the
card's kernels against, bit for bit (tolerance 0: everything is integer).

The tool runs its probes when imported, so its twelve ``call`` bodies and
its two other call sites are restated here verbatim, with the lines they
restate."""
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

from desamba_tpu_torch.tools import caps  # noqa: E402

V, S = pltpu.VMEM, pltpu.SMEM
OUT = jax.ShapeDtypeStruct((8, 128), jnp.int32)


def call(k, out_shape, *specs):                          # :34-40
    def f(*args):
        return pl.pallas_call(
            k, out_shape=out_shape,
            in_specs=[pl.BlockSpec(memory_space=s) for s in specs],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True)(*args)
    return jax.jit(f)


def k_sub(t, i, o):                                      # :50-51
    o[:] = jnp.take_along_axis(t[:], i[:], axis=0)


def k_lane(t, i, o):                                     # :73-74
    o[:] = jnp.take_along_axis(t[:], i[:], axis=1)


def k_roll(t, s, o):                                     # :87-88
    o[:] = pltpu.roll(t[:], s[0], 1)


def k_roll0(t, s, o):                                    # :97-98
    o[:] = pltpu.roll(t[:], s[0], 0)


def k_lds(t, s, o):                                      # :111-112
    o[:] = t[:, pl.ds(s[0], 128)]


def k_2d(t, s, o):                                       # :121-122
    o[:] = jax.lax.dynamic_slice(t[:], (s[0], s[1]), (8, 128))


def k_u32(t, o):                                         # :137-141
    v = t[:]
    v = v ^ (v >> jnp.uint32(7))
    v = v * jnp.uint32(0x9E3779B1)
    o[:] = (v >> jnp.uint32(16)).astype(jnp.int32)


def k_smem_out(t, o):                                    # :148-149
    o[0] = jnp.sum(t[:])


def f_smem(t):                                           # :152-156
    return pl.pallas_call(
        k_smem_out, out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=V)],
        out_specs=pl.BlockSpec(memory_space=S), interpret=True)(t)


def k_while(t, o):                                       # :163-172
    def cond(c):
        return c[0] < 8

    def body(c):
        i, acc = c
        return i + 1, acc + jnp.sum(t[pl.ds(i, 1), :])

    _, acc = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.int32(0)))
    o[:] = jnp.full((8, 128), acc, jnp.int32)


def k_u8(t, o):                                          # :183-184
    o[:] = t[:].astype(jnp.int32)[:8] + 1


def k_argmax(t, o):                                      # :191-194
    m = jnp.max(t[:], axis=1, keepdims=True)
    am = jnp.argmax(t[:], axis=1).astype(jnp.int32)[:, None]
    o[:] = jnp.broadcast_to(m + am, (8, 128))


def k_dynw(t, s, o):                                     # :201-203
    o[:] = jnp.zeros((8, 128), jnp.int32)
    o[pl.ds(s[0], 1), :] = t[pl.ds(0, 1), :]


def k_cumsum(t, o):                                      # :212-213
    o[:] = jnp.cumsum(t[:], axis=1)


def k_s2(t, s, o):                                       # :220-221
    o[:] = t[:] + s[0, 0]


def f_s2(t, s):                                          # :224-229
    return pl.pallas_call(
        k_s2, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=V),
                  pl.BlockSpec((1, 1), memory_space=S)],
        out_specs=pl.BlockSpec(memory_space=V), interpret=True)(t, s)


# the port's probe name -> the TPU tool's function over the same inputs
PALLAS = {
    "take_along_axis axis=0 (8,128) from (8,128)": call(k_sub, OUT, V, V),
    "take_along_axis axis=0 (8,128) from (32,128)": call(k_sub, OUT, V, V),
    "take_along_axis axis=1 (8,128) from (8,128)": call(k_lane, OUT, V, V),
    "roll dynamic shift axis=1": call(k_roll, OUT, V, S),
    "roll dynamic shift axis=0": call(k_roll0, OUT, V, S),
    "lane-dim dynamic slice (8, 512)[:, o:o+128]": call(k_lds, OUT, V, S),
    "dynamic_slice both dims (64,512)->(8,128)": call(k_2d, OUT, V, S),
    "uint32 mul/xor/shift": call(k_u32, OUT, V),
    "1-element output (the tile's sum)": jax.jit(f_smem),
    "while_loop scalar state + row reads": call(k_while, OUT, V),
    "uint8 load + cast": call(k_u8, OUT, V),
    "max/argmax along lanes": call(k_argmax, OUT, V),
    "dynamic row write o[i] = v": call(k_dynw, OUT, V, S),
    "cumsum along lanes": call(k_cumsum, OUT, V),
    "(1,1) scalar operand": jax.jit(f_s2),
}
NAMES = [p[2][0] for p in caps.probes()]


I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _inputs(variant):
    """The tool's own inputs (seed 0), or a second draw with other
    scalars, ties for the argmax and words that make the sums wrap
    ("edges"); "bounds" and "bounds2" add, on further draws, gather
    indices outside their tables (negative ones that count from the end,
    and ones that stay outside), slice starts and a row that are negative
    or past the end (clamped), roll shifts that are negative or far past
    the width, and ties inside one warp and at the last lane."""
    if variant == "tool":
        return caps.make_inputs(0)
    seed = {"edges": 11, "bounds": 12, "bounds2": 13}[variant]
    x = caps.make_inputs(seed)
    x["tab8"] = (x["tab8"].astype(np.int64) * 40_000_000 - (1 << 31)).astype(
        np.int32)
    x["tab8"][2, 5] = x["tab8"][2, 90] = I32_MAX      # a tie: first wins
    x["tab8"][3, :] = -7                              # all equal
    x.update(sh=np.array([127], np.int32), off=np.array([384], np.int32),
             off2=np.array([56, 0], np.int32), row=np.array([7], np.int32),
             s2=np.array([[I32_MIN]], np.int32))
    if variant == "edges":
        return x
    x["tab8"][4, 40] = x["tab8"][4, 41] = I32_MAX     # a tie in one warp
    x["tab8"][5, :] = I32_MIN
    x["tab8"][5, 127] = I32_MIN + 1                   # the last lane alone
    x["idx8"][0, :6] = [8, -1, -8, -9, I32_MIN, I32_MAX]
    x["idx32"][1, :5] = [32, -1, -32, -33, 40]
    x["idxl"][2, :6] = [128, -1, -128, -129, I32_MIN, I32_MAX]
    if variant == "bounds":
        x.update(sh=np.array([-131], np.int32), off=np.array([-5], np.int32),
                 off2=np.array([-3, -5], np.int32),
                 row=np.array([-1], np.int32))
    else:
        x.update(sh=np.array([I32_MAX], np.int32),
                 off=np.array([1000], np.int32),
                 off2=np.array([I32_MIN, I32_MAX], np.int32),
                 row=np.array([9], np.int32))
    return x


VARIANTS = ["tool", "edges", "bounds", "bounds2"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_probe_matches_its_pallas_body(name, variant):
    assert sorted(NAMES) == sorted(PALLAS)
    x = _inputs(variant)
    site, fn, (_, kernel, args, plain, expect) = next(
        p for p in caps.probes() if p[2][0] == name)
    arrays = [x[a] for a in args]
    n0 = [f.launches for f in caps.WRAPPERS]
    got = fn(*(torch.from_numpy(a) for a in arrays))
    assert [f.launches for f in caps.WRAPPERS] == n0      # the CPU path
    assert got.dtype == torch.int32
    j_in = [jnp.asarray(a.view(np.uint32) if kernel == "u32" else a)
            for a in arrays]
    exp = np.asarray(PALLAS[name](*j_in))
    assert got.shape == exp.shape and np.array_equal(got.numpy(), exp)
    assert np.array_equal(expect(*arrays), exp)
    assert site.startswith("tools/pallas_caps.py:")


@pytest.mark.parametrize("s", [(1 << 31) - 1, -(1 << 31)],
                         ids=["int32_max", "int32_min"])
def test_scalar_block_wraps_at_the_int32_extremes(s):
    """K7.3 (``scalar_block``, the tile plus a (1, 1) scalar) == the
    JAX ``f_s2`` in interpret mode at either int32 extreme of the scalar,
    on the edge tile with both extremes, -1 and 0 in it: the sum wraps
    (some exact sums leave int32) and both agree bit for bit."""
    tile = _inputs("edges")["tab8"].copy()
    tile[0, :4] = [(1 << 31) - 1, -(1 << 31), -1, 0]
    scalar = np.array([[s]], np.int32)
    got = caps.scalar_block(torch.from_numpy(tile), torch.from_numpy(scalar))
    exp = np.asarray(PALLAS["(1,1) scalar operand"](jnp.asarray(tile),
                                                    jnp.asarray(scalar)))
    exact = tile.astype(np.int64) + s
    assert ((exact > (1 << 31) - 1) | (exact < -(1 << 31))).any()
    assert np.array_equal(got.numpy(), exp)
    assert np.array_equal(exp, exact.astype(np.int32))


def test_entry_point_on_the_cpu_prints_ok_per_probe(capsys):
    res = caps.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{n}: OK" for n in NAMES] and len(lines) == 15
    assert list(res) == NAMES
    sites = [r["site"] for r in res.values()]
    assert sites.count("tools/pallas_caps.py:36") == 13
    assert sites.count("tools/pallas_caps.py:153") == 1
    assert sites.count("tools/pallas_caps.py:225") == 1
    for r in res.values():
        assert torch.equal(r["out"], r["plain"](*r["inputs"]))


def test_entry_point_raises_on_the_first_wrong_probe(monkeypatch, capsys):
    """Unlike the TPU tool, which prints FAIL and goes on."""
    wrong = list(caps.CALL_PROBES)
    name, kernel, args, plain, expect = wrong[3]
    wrong[3] = (name, kernel, args, lambda t, s: plain(t, s) + 1, expect)
    monkeypatch.setattr(caps, "CALL_PROBES", tuple(wrong))
    with pytest.raises(RuntimeError, match="roll dynamic shift axis=1: WRONG"):
        caps.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [
        f"{n}: OK" for n in NAMES[:3]]


def test_wrappers_check_their_inputs_and_device():
    t = torch.zeros(8, 128, dtype=torch.int32)
    s = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        caps.smem_sum(t.to("meta"))
    with pytest.raises(ValueError, match="inputs must be"):
        caps.smem_sum(t.long())
    with pytest.raises(ValueError, match="inputs must be"):
        caps.scalar_block(t, s)                   # the scalar is (1, 1)
    with pytest.raises(ValueError, match="expected 2 inputs"):
        caps.call_probe("roll dynamic shift axis=0", t)
    with pytest.raises(ValueError, match="no probe named"):
        caps.call_probe("nothing", t)
    # a start past the end is clamped, as the JAX body's slice is
    big = torch.arange(8 * 512, dtype=torch.int32).view(8, 512)
    assert torch.equal(caps.call_probe(
        "lane-dim dynamic slice (8, 512)[:, o:o+128]", big, s + 385),
        big[:, 384:])


def test_cuda_path_builds_the_kernel_or_raises(monkeypatch):
    """With no nvcc, a launch fails in the build: nothing falls back to the
    plain version."""
    import shutil

    from desamba_tpu_torch.kernels import build

    if shutil.which("nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.caps_lib()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.plops_lib()


def test_entry_point_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        caps.main([])


# ---- the CUDA source of the probes, run on the CPU ----------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")


@pytest.fixture(scope="module")
def caps_emu(tmp_path_factory):
    """kernels/caps.cu's probes compiled as host C++ over
    tests/cuda_host/block_emu.h, loaded with ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernels with")
    so = str(tmp_path_factory.mktemp("caps_emu") / "caps_emu.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", host,
                    "-I", KERNELS, os.path.join(host, "caps_emu.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.caps_emu.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2
    lib.caps_emu.restype = lib.caps_emu_count.restype = ctypes.c_int
    lib.caps_emu_error.restype = ctypes.c_char_p
    return lib


def _aligned(a):
    """A copy of ``a`` at a 16-byte aligned address, as the card's
    allocations are (the wide probes load 16-byte words)."""
    buf = np.empty(a.nbytes + 16, np.uint8)
    off = -buf.ctypes.data % 16
    out = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", NAMES)
def test_probe_kernel_source_matches_plain(caps_emu, name, variant):
    """kernels/caps.cu itself, on the CPU: each probe's kernel, run as its
    one block with the launcher's block size and arguments, the block's
    threads in one order and then the other between barriers and warp
    collectives, equals the probe's plain version and the Pallas body in
    interpret mode bit for bit, out-of-range indices, clamped starts,
    far roll shifts and argmax ties included."""
    x = _inputs(variant)
    _, _, (_, kernel, args, plain, _) = next(
        p for p in caps.probes() if p[2][0] == name)
    arrays = [_aligned(x[a]) for a in args]
    a = arrays[0]
    b = arrays[1] if len(arrays) > 1 else a
    exp = plain(*(torch.from_numpy(t) for t in arrays)).numpy()
    j_in = [jnp.asarray(t.view(np.uint32) if kernel == "u32" else t)
            for t in arrays]
    assert np.array_equal(np.asarray(PALLAS[name](*j_in)), exp)
    assert caps_emu.caps_emu_count() == len(caps.KERNELS)
    for reverse in (0, 1):
        out = _aligned(np.full(exp.shape, 0x5A5A5A5A, np.int32))
        rc = caps_emu.caps_emu(caps.KERNELS.index(kernel), a.ctypes.data,
                               b.ctypes.data, out.ctypes.data, a.shape[0],
                               reverse)
        assert rc == 0, caps_emu.caps_emu_error().decode()
        assert np.array_equal(out, exp), (
            f"threads {'down' if reverse else 'up'}: "
            f"{int((out != exp).sum())} of {exp.size} words differ")


def test_probe_launcher_refuses_what_its_kernels_cannot_take(caps_emu):
    """The launcher's checks (caps_args_ok), through the emulator's entry:
    a probe number outside the table, a negative row count, and a tile of
    a 16-byte probe (p_u32, p_u8, p_s2) at an address that is not 16-byte
    aligned; the other probes take any address."""
    t = _aligned(np.zeros(8 * 128 + 4, np.int32))
    o = _aligned(np.zeros(8 * 128, np.int32))
    ptr, skew, out = t.ctypes.data, t.ctypes.data + 4, o.ctypes.data
    for probe, a, n in ((-1, ptr, 8), (len(caps.KERNELS), ptr, 8),
                        (0, ptr, -1),
                        *((caps.KERNELS.index(k), skew, 8) for k in caps.WIDE)):
        assert caps_emu.caps_emu(probe, a, a, out, n, 0) == 1
        assert caps_emu.caps_emu_error() == b"argument out of range"
    assert caps_emu.caps_emu(caps.KERNELS.index("roll0"), skew, skew, out, 8,
                             0) == 0
