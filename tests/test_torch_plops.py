"""The tile helpers (K2): the port's ``engine/device/plops.py`` (on the CPU,
so its plain versions) == the TPU helper library
``desamba_tpu/engine/device/plops.py`` run inside Pallas kernels in interpret
mode, bit for bit (tolerance 0: everything is integer).

The seven kernel bodies of ``tests/test_plops.py`` are restated here (with
the lines they restate), the lanes, offsets and values they fix turned into
parameters so that the edges are reached: lanes 0 and 127, offsets 0 and
127, INT32_MIN and -1 among the unsigned values, R = 1, extractions and
gather indices out of range. Three more bodies cover the helpers that file
never calls directly."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from desamba_tpu.engine.device import plops as jpo  # noqa: E402
from desamba_tpu_torch.engine.device import plops as tpo  # noqa: E402

I32_MIN = -(1 << 31)
EDGE = np.array([0, -1, I32_MIN, I32_MIN + 1, (1 << 31) - 1, 5, -100],
                np.int32)


def run1(kernel, out_shape, *args):
    """tests/test_plops.py:15-18."""
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(*out_shape),
        interpret=True)(*(jnp.asarray(a) for a in args)))


def tile(seed, lo, hi, rows):
    return np.random.default_rng(seed).integers(
        lo, hi, (rows, 128)).astype(np.int64).astype(np.int32)


def unsigned_pair(rows):
    a = tile(10 + rows, I32_MIN, 1 << 31, rows)
    b = tile(20 + rows, I32_MIN, 1 << 31, rows)
    a[0, :7], b[0, :7] = EDGE, EDGE[::-1]
    a[0, 20:27], b[0, 20:27] = EDGE, EDGE          # equal operands
    return a, b


def port(fn, *arrays, **kw):
    n0 = fn.launches
    out = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    assert out.dtype == torch.int32 and fn.launches == n0
    return out.numpy()


@pytest.mark.parametrize("rows,lane_b,lane_e,row_rc,lane_rc,lane_s1,lane_s2", [
    (4, 37, 5, 2, 9, 3, 7),          # the TPU test's own
    (4, 0, 127, 3, 0, 127, 0),
    (8, 127, 0, 0, 127, 0, 127),
    (8, 5, 128, 8, 3, 200, 64),      # extractions and a set-lane out of range
])
def test_bcast_extract_setlane(rows, lane_b, lane_e, row_rc, lane_rc, lane_s1,
                               lane_s2):
    v = tile(0, -100, 100, rows)

    def k(v_ref, o_ref):                      # tests/test_plops.py:25-35
        x = v_ref[:]
        b = jpo.bcast_lane(x, lane_b)
        s = jpo.extract(x, lane_e)
        s2 = jpo.extract_rc(x, row_rc, lane_rc)
        y = jpo.set_lane(x, lane_s1, jnp.int32(555))
        o_ref[:] = b + 0 * y
        o_ref[0, 0] = s
        o_ref[0, 1] = s2
        o_ref[1, :] = y[1]
        o_ref[3, :] = jpo.set_lane(x, lane_s2, jnp.int32(-9))[3]

    exp = run1(k, ((rows, 128), jnp.int32), v)
    got = port(tpo.body_bcast_extract_setlane, v, lane_b=lane_b,
               lane_e=lane_e, row_rc=row_rc, lane_rc=lane_rc,
               lane_s1=lane_s1, new1=555, lane_s2=lane_s2, new2=-9)
    assert np.array_equal(got, exp)
    assert got[2, 50] == v[2, lane_b]
    assert got[0, 0] == (v[0, lane_e] if lane_e < 128 else I32_MIN)
    assert got[0, 1] == (v[row_rc, lane_rc] if row_rc < rows else I32_MIN)


@pytest.mark.parametrize("rows", [1, 4, 16])
def test_unsigned_helpers(rows):
    a, b = unsigned_pair(rows)

    def k(a_ref, b_ref, o_ref):               # tests/test_plops.py:48-50
        o_ref[:] = jpo.ult(a_ref[:], b_ref[:]).astype(jnp.int32)
        o_ref[0, 10] = jpo.umax_reduce(a_ref[:])

    exp = run1(k, ((rows, 128), jnp.int32), a, b)
    got = port(tpo.body_unsigned, a, b)
    assert np.array_equal(got, exp)
    assert got[0, 1] == 0 and got[0, 0] == 1    # 0xFFFFFFFF < x never; 0 < x
    assert np.uint32(got[0, 10]) == a.view(np.uint32).max() == 0xFFFFFFFF


@pytest.mark.parametrize("rows_out", [1, 2])
@pytest.mark.parametrize("off", [0, 37, 127])
def test_roll_flat(off, rows_out):
    v = tile(1, 0, 1000, 2)

    def k(v_ref, o_ref):                      # tests/test_plops.py:62-63
        o_ref[:] = jpo.roll_flat(v_ref[:], off, rows_out=rows_out)

    exp = run1(k, ((rows_out, 128), jnp.int32), v)
    got = port(tpo.body_roll_flat, v, off=off, rows_out=rows_out)
    assert np.array_equal(got, exp)
    assert (got[0] == np.roll(v.reshape(-1), -off)[:128]).all()


@pytest.mark.parametrize("rows", [1, 4])
def test_gather_rows_table(rows):
    tab = tile(2, 0, 1 << 20, 16)
    idx = tile(3, 0, 16 * 128, rows)
    idx[0, :4] = [0, 16 * 128 - 1, 16 * 128, -1]    # the last two: outside

    def k(t_ref, i_ref, o_ref):               # tests/test_plops.py:75-77
        o_ref[:] = jpo.gather_rows_table(
            lambda r: t_ref[r : r + 1, :], 16, i_ref[:])

    exp = run1(k, ((rows, 128), jnp.int32), tab, idx)
    got = port(tpo.body_gather_rows_table, tab, idx)
    assert np.array_equal(got, exp)
    assert got[0, 1] == tab[15, 127] and got[0, 2] == 0 and got[0, 3] == 0
    assert (got[0, 4:] == tab.reshape(-1)[idx[0, 4:]]).all()


@pytest.mark.parametrize("wrapping", [False, True])
@pytest.mark.parametrize("rows", [1, 4, 16])
def test_prefix_sum_colmajor(rows, wrapping):
    v = unsigned_pair(rows)[0] if wrapping else tile(3, 0, 5, rows)

    def k(v_ref, o_ref):                      # tests/test_plops.py:87-88
        o_ref[:] = jpo.prefix_sum_colmajor(v_ref[:])

    exp = run1(k, ((rows, 128), jnp.int32), v)
    got = port(tpo.body_prefix_sum_colmajor, v)
    assert np.array_equal(got, exp)
    flat = np.cumsum(v.T.reshape(-1).astype(np.int64)).astype(np.int32)
    assert np.array_equal(got, flat.reshape(128, rows).T)


@pytest.mark.parametrize("rows", [1, 4, 16])
def test_reverse_colmajor(rows):
    v = tile(4, 0, 100, rows)

    def k(v_ref, o_ref):                      # tests/test_plops.py:100-101
        o_ref[:] = jpo.reverse_colmajor(v_ref[:])

    exp = run1(k, ((rows, 128), jnp.int32), v)
    got = port(tpo.body_reverse_colmajor, v)
    assert np.array_equal(got, exp)
    assert np.array_equal(got, v.T.reshape(-1)[::-1].reshape(128, rows).T)


@pytest.mark.parametrize("rows", [1, 4])
def test_popc32(rows):
    v = unsigned_pair(rows)[0]

    def k(v_ref, o_ref):                      # tests/test_plops.py:112-113
        o_ref[:] = jpo.popc32(v_ref[:])

    exp = run1(k, ((rows, 128), jnp.int32), v.view(np.uint32))
    got = port(tpo.body_popc32, v)
    assert np.array_equal(got, exp)
    assert got[0, 1] == 32 and got[0, 2] == 1 and got[0, 0] == 0


@pytest.mark.parametrize("name", ["umin", "ule", "reverse_lanes"])
@pytest.mark.parametrize("rows", [1, 4])
def test_helpers_the_tpu_test_never_calls(name, rows):
    a, b = unsigned_pair(rows)

    def k(a_ref, b_ref, o_ref):
        x, y = a_ref[:], b_ref[:]
        o_ref[:] = {"umin": lambda: jpo.umin(x, y),
                    "ule": lambda: jpo.ule(x, y).astype(jnp.int32),
                    "reverse_lanes": lambda: jpo.reverse_lanes(x) + 0 * y}[
                        name]()

    exp = run1(k, ((rows, 128), jnp.int32), a, b)
    args = (a,) if name == "reverse_lanes" else (a, b)
    got = port(tpo.HARNESS[name], *args)
    assert np.array_equal(got, exp)
    if name == "ule":
        assert got[0, 20:27].all()             # equal operands


HELPERS = {     # helper -> arguments after the tile(s); jnp outside a kernel
    "bcast_lane": (1, (37,)), "extract": (1, (127,)),
    "extract_rc": (1, (3, 0)), "set_lane": (1, (5, 77)),
    "umax_reduce": (1, ()), "umin": (2, ()), "ult": (2, ()), "ule": (2, ()),
    "reverse_lanes": (1, ()), "reverse_colmajor": (1, ()), "popc32": (1, ()),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_plain_helper_matches_the_jax_helper(name):
    """Each plain helper against the TPU library's function of the same
    name on the same tile (the helpers that need ``pltpu.roll`` run inside
    the kernels above)."""
    n, extra = HELPERS[name]
    tiles = unsigned_pair(4)[:n]
    j_in = [jnp.asarray(t.view(np.uint32) if name == "popc32" else t)
            for t in tiles]
    exp = np.asarray(getattr(jpo, name)(*j_in, *extra))
    got = getattr(tpo, name)(*(torch.from_numpy(t) for t in tiles),
                             *extra).numpy()
    assert got.shape == exp.shape and np.array_equal(got, exp)


def test_iotas_shuffle_and_table_gather():
    shape = (4, 128)
    assert np.array_equal(tpo.lane_iota(shape).numpy(),
                          np.asarray(jpo.lane_iota(shape)))
    assert np.array_equal(tpo.sub_iota(shape).numpy(),
                          np.asarray(jpo.sub_iota(shape)))
    v, idx = tile(5, -9, 9, 1), tile(6, 0, 128, 4)
    assert np.array_equal(
        tpo.shuffle_lanes(torch.from_numpy(v), torch.from_numpy(idx)).numpy(),
        np.asarray(jpo.shuffle_lanes(jnp.asarray(v), jnp.asarray(idx))))


def test_harness_cases_cover_every_body_and_launch_nothing_on_the_cpu():
    n0 = {k: f.launches for k, f in tpo.HARNESS.items()}
    cases = tpo.run_harness("cpu", seed=1)
    assert {c["body"] for c in cases} == set(tpo.BODIES) and len(cases) >= 40
    assert all(torch.equal(c["out"], c["plain_out"]) for c in cases)
    assert all(c["out"].dtype == torch.int32 for c in cases)
    assert {k: f.launches for k, f in tpo.HARNESS.items()} == n0


def test_bodies_check_their_tiles_and_device():
    """A wrong shape, type or row count raises; so does a device that is
    neither the CPU nor a card (a CUDA tensor launches the kernel or
    raises, and never takes the plain version)."""
    v = torch.zeros(4, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tpo.body_popc32(v.to("meta"))
    with pytest.raises(ValueError, match=r"\(R, 128\) int32"):
        tpo.body_popc32(v.long())
    with pytest.raises(ValueError, match=r"\(R, 128\) int32"):
        tpo.body_reverse_colmajor(v[:, :64])
    with pytest.raises(ValueError, match="1 <= R"):
        tpo.body_prefix_sum_colmajor(torch.zeros(65, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="R >= 4"):
        tpo.body_bcast_extract_setlane(v[:2])
    with pytest.raises(ValueError, match="lane_b"):
        tpo.body_bcast_extract_setlane(v, lane_b=128)
    with pytest.raises(ValueError, match="expected 2 rows"):
        tpo.body_roll_flat(v)
    with pytest.raises(ValueError, match="off"):
        tpo.body_roll_flat(v[:2], off=128)
    with pytest.raises(ValueError, match="one shape"):
        tpo.body_umin(v, v[:2])


def test_cuda_path_builds_the_kernel_or_raises(monkeypatch):
    """With the device check forced to "cuda" on a machine without nvcc a
    body raises from the build: nothing falls back to the plain version."""
    import shutil

    if shutil.which("nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(tpo, "_check", lambda *a, **k: True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tpo.body_popc32(torch.zeros(1, 128, dtype=torch.int32))
