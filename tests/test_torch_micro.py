"""The primitive benches (K4, K6, K5): each function of the port's
``tools/micro.py`` (on the CPU, so its plain version) == the Pallas kernel
it replaces, run in interpret mode on the same seeded inputs, bit for bit
(tolerance 0: everything is int32 and wraps).

``tools/pallas_micro.py``, ``pallas_micro3.py`` and ``pallas_micro2.py`` run
their benchmarks when imported, so their kernel bodies are restated here
verbatim (each with the file and lines it restates), with the tools' table
widths and small trip counts and grids (the constants just below). The two
copy loops (``make_async_copy`` under ``run_scoped``) run in interpret mode
too, and are also held against a numpy restatement of the loop. Inputs are
the port's ``make_inputs`` from a seed, so the tables the tools left at zero
carry values, the start scalar is not 0 and can be negative, and the
elementwise input has negative words (which pins the shift by 32 and more).

The five kernels of ``kernels/micro.cu`` that compile as host C++ (K6.2's
``lgather_kernel``, K6.3's ``rgather_kernel``, K5.c's ``oneprog_kernel``,
K4.2's ``egather_kernel`` and K4.1's ``rowgather_kernel``) also run here
from their own source, through
``tests/cuda_host/micro_emu.cpp`` over ``block_emu.h`` (a block's threads as
coroutines, in both orders between barriers and warp sums), against the
plain versions; and the splits of their work (trips over blocks, lanes and
threads, affine maps composed in trip order) are restated in numpy.
"""
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

from desamba_tpu_torch.tools import micro  # noqa: E402

KR, RW = 4096, 128
GN, REPK = 16, 20
EK, EB, EN = 4096, 8, 512
LOOPN, GS, HBROWS, DMAN, DR = 40, 4, 1 << 15, 24, 8
N3, GK, GR, RGN, RGR, GS3, DMAN3 = 64, 32, 70, 16, 33, 4, 24
LOOPN2, ONEP, VB, VPASS = 256, 64, 4, 40
SIZES = dict(GN=GN, LOOPN=LOOPN, GS=GS, DMAN=DMAN, N3=N3, GR=GR, RGN=RGN,
             RGR=RGR, GS3=GS3, DMAN3=DMAN3, LOOPN2=LOOPN2, ONEP=ONEP, VB=VB,
             VPASS=VPASS)
V, S = pltpu.VMEM, pltpu.SMEM


def call(kernel, out_shape, specs, *args, **kw):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=s) for s in specs],
        out_specs=pl.BlockSpec(memory_space=V), interpret=True, **kw)(
            *(jnp.asarray(a) for a in args)))


# ---- tools/pallas_micro.py ---------------------------------------------------

def rowgather_kernel(tab_ref, idx_ref, o_ref):          # :57-63
    tab = tab_ref[:]
    acc = jnp.zeros((GN, RW), jnp.int32)
    for r in range(REPK):
        ii = (idx_ref[:] + r) & (KR - 1)
        acc = acc + jnp.take(tab, ii[:, 0], axis=0)
    o_ref[:] = acc


def egather_kernel(tab_ref, idx_ref, o_ref):            # :93-99
    tab = tab_ref[:]
    acc = jnp.zeros((EB, EN), jnp.int32)
    for r in range(REPK):
        ii = (idx_ref[:] + r) & (EK - 1)
        acc = acc + jnp.take_along_axis(tab, ii, axis=1)
    o_ref[:] = acc


def dynslice_kernel(tab_ref, start_ref, o_ref):         # :127-132
    def body(i, acc):
        off = (start_ref[0] + i * 7) & (KR - 9)
        return acc + tab_ref[pl.ds(off, 8), :]
    o_ref[:] = jax.lax.fori_loop(0, LOOPN, body,
                                 jnp.zeros((8, RW), jnp.int32))


def grid_kernel(x_ref, o_ref):                          # :158-159
    o_ref[:] = x_ref[:] + pl.program_id(0)


def gridstep(x, gs):                                    # :163-172
    return np.asarray(pl.pallas_call(
        grid_kernel,
        out_shape=jax.ShapeDtypeStruct((gs * 8, 128), jnp.int32),
        grid=(gs,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0), memory_space=V)],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0), memory_space=V),
        interpret=True)(jnp.asarray(x)))


def dma_kernel(hbm_ref, start_ref, o_ref):              # :189-201
    def body(scratch, sem):
        def step(i, acc):
            off = ((start_ref[0] + i * 37) * DR) & (HBROWS - DR - 1)
            cp = pltpu.make_async_copy(hbm_ref.at[pl.ds(off, DR), :],
                                       scratch, sem)
            cp.start()
            cp.wait()
            return acc + scratch[:]
        o_ref[:] = jax.lax.fori_loop(0, DMAN, step,
                                     jnp.zeros((DR, RW), jnp.int32))
    pl.run_scoped(body, pltpu.VMEM((DR, RW), jnp.int32),
                  pltpu.SemaphoreType.DMA(()))


# ---- tools/pallas_micro3.py --------------------------------------------------

def empty_kernel(x_ref, o_ref):                         # :52-53
    o_ref[:] = x_ref[:] + 1


def mk(sl):                                             # :81-88
    def k(tab_ref, s_ref, o_ref):
        def body(i, acc):
            off = (s_ref[0] + i * 7) & (KR - 9)
            return acc + tab_ref[pl.ds(off, sl), :].astype(jnp.int32)[0:1, :]
        o_ref[:] = jax.lax.fori_loop(
            0, N3, body, jnp.zeros((1, RW), jnp.int32))
    return k


def lgather_kernel(tab_ref, idx_ref, o_ref):            # :108-113
    tab = tab_ref[:]          # (GK, 128)

    def body(i, acc):
        ii = (idx_ref[:] + i) % GK   # (8, 128)
        return acc + jnp.take_along_axis(tab, ii, axis=0)
    o_ref[:] = jax.lax.fori_loop(0, GR, body, jnp.zeros((8, RW), jnp.int32))


def rgather_kernel(tab_ref, idx_ref, o_ref):            # :141-147
    tab = tab_ref[:]

    def body(i, acc):
        ii = (idx_ref[:] + i) & (KR - 1)   # (RGN, 128)
        return acc + jnp.take_along_axis(tab, ii, axis=0)
    o_ref[:] = jax.lax.fori_loop(0, RGR, body,
                                 jnp.zeros((RGN, RW), jnp.int32))


def dma3_kernel(hbm_ref, s_ref, o_ref):                 # :200-212
    def body(scratch, sem):
        def step(i, acc):
            off = ((s_ref[0] + i * 37) * DR) & (HBROWS - DR - 1)
            cp = pltpu.make_async_copy(hbm_ref.at[pl.ds(off, DR), :],
                                       scratch, sem)
            cp.start()
            cp.wait()
            return acc + scratch[0:1, :]
        o_ref[:] = jax.lax.fori_loop(0, DMAN3, step,
                                     jnp.zeros((1, RW), jnp.int32))
    pl.run_scoped(body, pltpu.VMEM((DR, RW), jnp.int32),
                  pltpu.SemaphoreType.DMA(()))


# ---- tools/pallas_micro2.py --------------------------------------------------

def scalar_kernel(s_ref, o_ref):                        # :49-53
    def body(i, acc):
        return acc + ((s_ref[0] + i * 7) & 1023)
    tot = jax.lax.fori_loop(0, LOOPN2, body, jnp.int32(0))
    o_ref[:] = jnp.full((8, 128), tot, jnp.int32)


def dynal_kernel(tab_ref, s_ref, o_ref):                # :71-76
    def body(i, acc):
        off = ((s_ref[0] + i) * 8) & (KR - 9)
        return acc + tab_ref[pl.ds(off, 8), :]
    o_ref[:] = jax.lax.fori_loop(0, LOOPN2 // 4, body,
                                 jnp.zeros((8, RW), jnp.int32))


def dynrow_kernel(tab_ref, s_ref, o_ref):               # :97-102
    def body(i, acc):
        off = (s_ref[0] + i * 7) & (KR - 2)
        return acc + tab_ref[pl.ds(off, 1), :]
    o_ref[:] = jax.lax.fori_loop(0, LOOPN2 // 4, body,
                                 jnp.zeros((1, RW), jnp.int32))


def onep_kernel(x_ref, o_ref):                          # :121-125
    def body(i, acc):
        return acc * 3 + i
    o_ref[:] = x_ref[:] + jax.lax.fori_loop(
        0, ONEP, body, jnp.zeros((8, 128), jnp.int32))


def vec_kernel(x_ref, o_ref):                           # :147-152
    acc = jnp.zeros((8, 128), jnp.int32)
    v = x_ref[:]
    for r in range(VPASS):
        acc = acc + jnp.sum((v ^ (v >> (r + 1))).reshape(VB, 8, 128), axis=0)
    o_ref[:] = acc


# ---- the comparison ------------------------------------------------------------

def _inputs(start):
    x = {k: v.numpy().copy() for k, v in micro.make_inputs(
        "cpu", seed=7, sizes=SIZES).items()}
    x["start"][:] = start
    x["xv"][::3] *= -1                      # negative words for the shifts
    x["xv"][0, :4] = [-(1 << 31), -1, (1 << 31) - 1, 0]
    # sums that wrap: 40 values near 2^27 pass 2^31
    x["tab"][:, :8] <<= 7
    return x


def _pallas(key, x):
    s = x["start"]
    return {
        "K4.1": lambda: call(rowgather_kernel, (GN, RW), (V, V), x["tab"],
                             x["idxc"]),
        "K4.2": lambda: call(egather_kernel, (EB, EN), (V, V), x["tab2"],
                             x["idx2"]),
        "K4.3": lambda: call(dynslice_kernel, (8, RW), (V, S), x["tab"], s),
        "K4.4": lambda: gridstep(x["xgrid"][:8 * GS], GS),
        "K4.5": lambda: call(dma_kernel, (DR, RW), (pl.ANY, S), x["hbm"], s),
        "K6.0": lambda: call(empty_kernel, (8, 128), (V,), x["x8"]),
        "K6.1a": lambda: call(mk(8), (1, RW), (V, S), x["tab"], s),
        "K6.1b": lambda: call(mk(1), (1, RW), (V, S), x["tab"], s),
        "K6.2": lambda: call(lgather_kernel, (8, RW), (V, V), x["tabg"],
                             x["idxg"]),
        "K6.3": lambda: call(rgather_kernel, (RGN, RW), (V, V), x["tab"],
                             x["idxr"]),
        "K6.4": lambda: gridstep(x["xgrid"][:8 * GS3], GS3),
        "K6.5": lambda: call(dma3_kernel, (1, RW), (pl.ANY, S), x["hbm"], s),
        "K5.a": lambda: call(scalar_kernel, (8, RW), (S,), s),
        "K5.b": lambda: call(dynal_kernel, (8, RW), (V, S), x["tab"], s),
        "K5.b2": lambda: call(dynrow_kernel, (1, RW), (V, S), x["tab"], s),
        "K5.c": lambda: call(onep_kernel, (8, RW), (V,), x["x8"]),
        "K5.d": lambda: call(vec_kernel, (8, RW), (V,), x["xv"]),
    }[key]()


KEYS = ["K4.1", "K4.2", "K4.3", "K4.4", "K4.5", "K6.0", "K6.1a", "K6.1b",
        "K6.2", "K6.3", "K6.4", "K6.5", "K5.a", "K5.b", "K5.b2", "K5.c",
        "K5.d"]


@pytest.fixture(scope="module", params=[5, -123457],
                ids=["start_5", "start_negative"])
def world(request):
    x = _inputs(request.param)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    return x, {s["key"]: s for s in micro.sites(tx, SIZES)}


@pytest.mark.parametrize("key", KEYS)
def test_site_matches_its_pallas_kernel(world, key):
    x, sites = world
    site = sites[key]
    n0 = sum(f.launches for f in micro.WRAPPERS)
    got = site["fn"]()
    assert got.dtype == torch.int32
    assert sum(f.launches for f in micro.WRAPPERS) == n0    # the CPU path
    exp = _pallas(key, x)
    assert got.shape == exp.shape and np.array_equal(got.numpy(), exp)
    assert torch.equal(site["plain"](), got)
    if site["library"] is not None:
        assert torch.equal(site["library"](), got)
    assert len(np.unique(exp)) > 1 or key in ("K5.a",)   # not a constant
    assert site["ops"]() > 0 and site["nbytes"]() > 4 * got.numel()
    if key == "K4.4":           # the same call on successive slices
        grid = torch.from_numpy(x["xgrid"])
        assert len(site["cold"]) == GS3 // GS == 1
        assert torch.equal(site["cold"][0](), micro.gridstep(grid[:8 * GS]))


def test_copy_loops_match_a_numpy_restatement(world):
    """K4.5 and K6.5 once more, against the loop written out in numpy: the
    8-row slice at ((s + 37 i) * 8) & (HBROWS - DR - 1), summed (all rows,
    or row 0), wrapping."""
    x, sites = world
    s, hbm = int(x["start"][0]), x["hbm"].astype(np.int64)
    for key, n, rows in (("K4.5", DMAN, 8), ("K6.5", DMAN3, 1)):
        acc = np.zeros((rows, RW), np.int64)
        for i in range(n):
            off = ((s + i * 37) * DR) & (HBROWS - DR - 1)
            assert off & 0x7FF7 == off and off + DR <= HBROWS
            acc += hbm[off:off + rows]
        assert np.array_equal(sites[key]["fn"]().numpy(),
                              acc.astype(np.int32))


def test_the_odd_masks_wraps_and_shift_counts_are_pinned(world):
    x, sites = world
    s = int(x["start"][0])
    # the masks are not powers of two minus one: bit 3 (KR - 9) or bit 0
    # (KR - 2) is cleared, which keeps the slice inside the table
    offs = micro.slice_offsets(torch.from_numpy(x["start"]),
                               torch.arange(LOOPN), 7, 1, KR - 9)
    assert KR - 9 == 0xFF7 and int((offs & 8).max()) == 0
    assert int(offs.max()) + 8 <= KR and len(set(offs.tolist())) > 8
    assert [int(v) for v in offs[:3]] == [(s + 7 * i) & 0xFF7
                                          for i in range(3)]
    # a sum that wraps int32: the exact sum of K4.3's first column differs
    # from the int32 result, and equals it mod 2^32
    tab = x["tab"].astype(np.int64)
    exact = sum(tab[int(o):int(o) + 8, 0] for o in offs)
    got = sites["K4.3"]["fn"]().numpy()[:, 0].astype(np.int64)
    assert (np.abs(exact) >= 1 << 31).any()
    assert np.array_equal(got % (1 << 32), exact % (1 << 32))
    # acc * 3 + i overflows within 21 trips
    acc = 0
    for i in range(ONEP):
        acc = acc * 3 + i
    assert acc >= 1 << 32
    assert np.array_equal(sites["K5.c"]["fn"]().numpy().astype(np.int64)
                          % (1 << 32),
                          (x["x8"].astype(np.int64) + acc % (1 << 32))
                          % (1 << 32))
    # an arithmetic shift by 32 or more fills with the sign: -1 for the
    # negative words, so their late passes add v ^ -1, not v
    v = torch.from_numpy(x["xv"])
    assert VPASS > 32 and bool((v < 0).any())
    late = micro.vecwork(v, VPASS) - micro.vecwork(v, 31)
    exp = sum((v ^ (v >> 31)).view(-1, 8, RW).sum(0, dtype=torch.int64)
              for _ in range(VPASS - 31))
    assert torch.equal(late, micro.i32(exp))


def test_entry_point_on_the_cpu(capsys):
    res = micro.main(["all", "--device", "cpu", "--seed", "7"], reps=1,
                     sizes=SIZES)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("primitive benches, device=cpu")
    assert list(res) == KEYS and len(lines) == 1 + len(KEYS)
    loops = {"K4.3", "K6.1a", "K6.1b", "K5.b", "K5.b2"}
    for key, ln in zip(KEYS, lines[1:]):
        # the dynamic-slice trips run in parallel: a rate, not a trip's time
        assert " ms " in ln and ((" G trips/s" in ln and " GB/s" in ln)
                                 if key in loops else " ns/" in ln), ln
    assert "host launch+sync" in lines[6] and res["K6.0"]["host_sync_ms"] > 0
    assert res["K6.0"]["graph_ms"] > 0 and res["K6.0"]["eager_ms"] > 0
    for key, r in res.items():
        assert r["launches"] == 0 and r["ms"] > 0 and r["ns_per_unit"] > 0
        assert torch.equal(r["out"], r["plain"]())
    assert {r["replaces"].split(":")[0] for r in res.values()} == {
        "tools/pallas_micro.py", "tools/pallas_micro3.py",
        "tools/pallas_micro2.py"}
    one = micro.main(["micro2", "--device", "cpu"], reps=1, sizes=SIZES)
    assert list(one) == ["K5.a", "K5.b", "K5.b2", "K5.c", "K5.d"]
    capsys.readouterr()


def _kernel_trips(first, last, warps, rows_out):
    """The trips the warps of one dynslice block visit, restating the loops
    of kernels/micro.cu dynslice_kernel: warp w starts at first + w and
    takes every warps-th trip, U = 8 / rows_out at a time, then one at a
    time below last."""
    U = 8 // rows_out
    seen = []
    for w in range(warps):
        i = first + w
        while i + (U - 1) * warps < last:
            seen += [i + u * warps for u in range(U)]
            i += U * warps
        while i < last:
            seen.append(i)
            i += warps
    return seen


@pytest.mark.parametrize("n, max_blocks, start", [
    (1, 528, 5),               # one trip: one block
    (40, 528, 3),              # fewer trips than blocks
    (1000, 7, 11),             # the chunk does not divide n: a short last block
    (4099, 128, -123457),      # a negative start
])
def test_dynslice_split_sums_to_the_whole_loop(world, n, max_blocks, start):
    """The wrapper's split of the trips over the kernel's grid
    (``grid_split`` at DS_MIN_CHUNK): every trip in exactly one block and,
    inside it, in exactly one warp's loop; and the per-block partial sums
    (the plain version over each block's trips, from its own start) add up
    to the whole loop's, which is what the blocks' atomicAdds into the
    zeroed output compute."""
    warps = _micro_define("DS_WARPS")
    x, _ = world
    tab = torch.from_numpy(x["tab"])
    s = torch.tensor([start], dtype=torch.int32)
    blocks, chunk = micro.grid_split(n, max_blocks, micro.DS_MIN_CHUNK)
    assert 1 <= blocks <= max_blocks and chunk >= micro.DS_MIN_CHUNK
    assert (blocks - 1) * chunk < n <= blocks * chunk
    for mul, scale, mask, rows_out in ((7, 1, KR - 9, 8), (7, 1, KR - 9, 1),
                                       (1, 8, KR - 9, 8), (7, 1, KR - 2, 1)):
        trips = []
        total = torch.zeros(rows_out, RW, dtype=torch.int64)
        for b in range(blocks):
            first, last = b * chunk, min(n, (b + 1) * chunk)
            trips += _kernel_trips(first, last, warps, rows_out)
            s_b = torch.tensor([start + first * mul], dtype=torch.int64)
            total += micro.dynslice_plain(tab, micro.i32(s_b), last - first,
                                          mul, scale, mask, rows_out)
        assert sorted(trips) == list(range(n))
        whole = micro.dynslice_plain(tab, s, n, mul, scale, mask, rows_out)
        assert torch.equal(micro.i32(total), whole)
    assert micro.grid_split(0, max_blocks,
                            micro.DS_MIN_CHUNK) == (0, 0)


def _micro_define(name):
    """An integer #define of kernels/micro.cu."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(micro.__file__), "..", "kernels",
                            "micro.cu")).read()
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def _check_split(n, max_blocks, min_chunk):
    """``grid_split``'s (blocks, chunk) and each block's [first, last)."""
    blocks, chunk = micro.grid_split(n, max_blocks, min_chunk)
    if n == 0:
        assert (blocks, chunk) == (0, 0)
        return []
    assert 1 <= blocks <= max_blocks and chunk >= min_chunk
    assert (blocks - 1) * chunk < n <= blocks * chunk
    return [(b * chunk, min(n, (b + 1) * chunk)) for b in range(blocks)]


@pytest.mark.parametrize("n, max_blocks", [
    (0, 1056),                 # no trips: no block, no launch
    (1, 1056),                 # one trip
    (2047, 1056),              # fewer trips than one block's least share
    (100_001, 7),              # odd n, the chunk does not divide it
    (1 << 21, 1056),           # the tool's trip count on 132 SMs x 8
])
def test_scalarloop_split_sums_to_the_whole_loop(world, n, max_blocks):
    """scalarloop's grid (``grid_split`` at SL_MIN_CHUNK): every trip in
    exactly one block and, inside it, in exactly one thread's loop (thread
    t takes every SL_THREADS-th trip from the range's start + t, restating
    kernels/micro.cu scalarloop_kernel); and the block sums (the plain
    version over each block's trips, from its own start) add up to the
    whole loop's, which is what the blocks' atomicAdds into the zeroed word
    compute."""
    x, _ = world
    threads = _micro_define("SL_THREADS")
    spans = _check_split(n, max_blocks, micro.SL_MIN_CHUNK)
    s = int(x["start"][0])
    seen = np.zeros(n, np.int64)
    total = 0
    for first, last in spans:
        for t in range(threads):
            seen[first + t:last:threads] += 1
        s_b = torch.tensor([s + 7 * first], dtype=torch.int64)
        total += int(micro.scalarloop_plain(micro.i32(s_b),
                                            last - first)[0, 0])
    assert (seen == 1).all()
    whole = micro.scalarloop_plain(torch.tensor([s], dtype=torch.int32), n)
    assert torch.equal(micro.i32(torch.tensor(total)).expand(8, RW), whole)


def _ring_trips(cnt, stages):
    """The trips one dmaloop block sums, in order, restating the ring of
    kernels/micro.cu dmaloop_kernel: stages - 1 copies started ahead, one
    commit group a trip (empty past the block's range); before trip k is
    summed, __pipeline_wait_prior(stages - 2) has let all but the last
    stages - 2 groups land, and the barrier after it frees the slot that
    the next copy overwrites. Checks that trip k has landed when it is
    summed, and that no copy lands in a slot whose trip is still unread."""
    groups, slot, summed = [], {}, []

    def fetch(k):
        if k < cnt:
            prev = slot.get(k % stages)
            assert prev is None or prev in summed, (k, prev)
            slot[k % stages] = k
        groups.append(k)

    for k in range(stages - 1):
        fetch(k)
    for k in range(cnt):
        landed = groups[: len(groups) - (stages - 2)]
        assert k in landed, (k, cnt, stages)
        fetch(k + stages - 1)
        assert slot[k % stages] == k
        summed.append(k)
    return summed


@pytest.mark.parametrize("n, max_blocks", [
    (0, 1056),                 # no copies: no block, no launch
    (1, 1056),                 # one copy, fewer than the ring holds
    (5, 1056),                 # fewer copies than one block's least share
    (1001, 9),                 # odd n, a short last block
    (1024, 1056),              # K4.5's copies
    (1 << 15, 1056),           # K6.5's copies on 132 SMs x 8
])
def test_dmaloop_split_sums_to_the_whole_loop(world, n, max_blocks):
    """dmaloop's grid (``grid_split`` at DMA_MIN_CHUNK) and each block's
    ring of DMA_STAGES slots: every copy in exactly one block, summed there
    once, after it landed and before its slot is reused; and the block sums
    (the plain version over each block's copies, from its own start) add up
    to the whole loop's for both summed heights, as the blocks' atomicAdds
    into the zeroed output do."""
    x, _ = world
    stages = _micro_define("DMA_STAGES")
    assert stages >= 2
    hbm = torch.from_numpy(x["hbm"])
    mask = HBROWS - 9
    s = int(x["start"][0])
    spans = _check_split(n, max_blocks, micro.DMA_MIN_CHUNK)
    seen = np.zeros(n, np.int64)
    for first, last in spans:
        seen[[first + k for k in _ring_trips(last - first, stages)]] += 1
    assert (seen == 1).all()
    for rows_out in (8, 1):
        total = torch.zeros(rows_out, RW, dtype=torch.int64)
        for first, last in spans:
            s_b = torch.tensor([s + 37 * first], dtype=torch.int64)
            total += micro.dynslice_plain(hbm, micro.i32(s_b), last - first,
                                          37, 8, mask, rows_out)
        whole = micro.dynslice_plain(hbm, torch.tensor([s], dtype=torch.int32),
                                     n, 37, 8, mask, rows_out)
        assert torch.equal(micro.i32(total), whole)


def test_scalarloop_library_is_the_plain_version_in_one_chunk(world):
    """K5.a's library call is its plain version as one elementwise
    expression over every trip index with a sum; on the CPU it equals the
    plain version, in any number of chunks."""
    x, sites = world
    site = sites["K5.a"]
    assert site["library"] is not None
    assert torch.equal(site["library"](), site["plain"]())
    s = torch.from_numpy(x["start"])
    for n in (0, 1, 1023, 4099):
        one = micro.scalarloop_plain(s, n, chunk_elems=max(1, n))
        assert torch.equal(one, micro.scalarloop_plain(s, n, chunk_elems=97))


def test_vecwork_counts_three_operations_an_element_pass(world):
    """K5.d's bound counts the shift, the xor and the add of every element
    and pass, as the TPU tool does (tools/pallas_micro2.py:166)."""
    x, sites = world
    site = sites["K5.d"]
    assert site["units"] == x["xv"].size * VPASS
    assert site["ops"]() == 3 * x["xv"].size * VPASS


def test_full_sizes_are_the_tools_own():
    z = micro.FULL
    assert (z["KR"], z["GN"], z["REPK"], z["EB"], z["EK"], z["EN"]) == (
        4096, 256, 20, 8, 4096, 512)
    assert (z["LOOPN"], z["GS"], z["HBROWS"], z["DMAN"]) == (
        4096, 2048, 1 << 15, 1024)
    assert (z["N3"], z["GK"], z["GR"], z["RGN"], z["RGR"], z["GS3"],
            z["DMAN3"]) == (1 << 23, 32, 1 << 21, 256, 1 << 13, 1 << 15,
                            1 << 15)
    assert (z["LOOPN2"], z["ONEP"], z["VB"], z["VPASS"]) == (
        1 << 21, 1 << 19, 512, 256)


def test_wrappers_check_their_tensors_and_device():
    """A wrong type, shape, mask or device raises; a device that is neither
    the CPU nor a card is refused (a CUDA tensor launches the kernel or
    raises, and never takes the plain version)."""
    tab = torch.zeros(16, RW, dtype=torch.int32)
    s = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        micro.gridstep(tab.to("meta"))
    with pytest.raises(ValueError, match="int32"):
        micro.vecwork(tab.long(), 3)
    with pytest.raises(ValueError, match="expected shape"):
        micro.rowgather(tab[:, :64], tab, 2)
    with pytest.raises(ValueError, match="power of two"):
        micro.colgather(tab[:12], tab, 2, False)
    with pytest.raises(ValueError, match="multiple of 8"):
        micro.gridstep(tab[:12])
    with pytest.raises(ValueError, match="leave the table"):
        micro.dynslice(tab, s, 4, 7, 1, 15, 8, 8)
    with pytest.raises(ValueError, match=r"\(8, 8\)"):
        micro.dynslice(tab, s, 4, 7, 1, 7, 4, 4)
    with pytest.raises(ValueError, match="fit 48 KB"):
        micro.colgather(torch.zeros(128, RW, dtype=torch.int32), tab, 2, True)
    with pytest.raises(ValueError, match="one device"):
        micro.egather(tab, tab.to("meta"), 2)


def test_cuda_path_builds_the_kernel_or_raises(monkeypatch):
    """With the device check forced to "cuda" on a machine without nvcc the
    wrapper raises from the build: nothing falls back to the plain
    version."""
    import shutil

    if shutil.which("nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(micro, "_check", lambda *a: True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        micro.gridstep(torch.zeros(8, RW, dtype=torch.int32))


def test_entry_point_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        micro.main(["micro2"])


# ---- the CUDA source of K6.2 and K5.c, run on the CPU ------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
M32 = (1 << 32) - 1
# trip counts: none, one, around the table's 32 rows, and a prime (no chunk
# of more than one trip divides it)
EMU_N = [0, 1, 31, 32, 33, 3001]


@pytest.fixture(scope="module")
def micro_emu(tmp_path_factory):
    """lgather_kernel, rgather_kernel, oneprog_kernel, egather_kernel and
    rowgather_kernel of kernels/micro.cu compiled as host C++ over
    tests/cuda_host/block_emu.h, loaded with ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernels with")
    so = str(tmp_path_factory.mktemp("micro_emu") / "micro_emu.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", host,
                    "-I", KERNELS, os.path.join(host, "micro_emu.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.micro_emu_lgather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.micro_emu_rgather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.micro_emu_rgather_fits.argtypes = [ctypes.c_int]
    lib.micro_emu_oneprog.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    lib.micro_emu_egather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.micro_emu_egather.restype = ctypes.c_int
    lib.micro_emu_rowgather.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 6)
    lib.micro_emu_rowgather.restype = ctypes.c_int
    lib.micro_emu_rowgather_warps.restype = ctypes.c_int
    lib.micro_emu_lgather.restype = lib.micro_emu_oneprog.restype = ctypes.c_int
    lib.micro_emu_rgather.restype = ctypes.c_int
    lib.micro_emu_rgather_fits.restype = ctypes.c_int
    lib.micro_emu_error.restype = ctypes.c_char_p
    return lib


def _lgather_inputs(seed=13):
    """K6.2's shapes from a seed: a (32, 128) table over the whole int32
    range (so that sums wrap) and (8, 128) start rows, with negative ones,
    both int32 extremes and a row of starts below -32."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(I32_MIN, I32_MAX, (GK, RW), dtype=np.int64)
    idx = rng.integers(0, GK, (8, RW), dtype=np.int64)
    idx[0, :5] = [-1, -33, I32_MIN, I32_MAX, I32_MAX - 3]
    idx[1] = rng.integers(-(1 << 20), -32, RW)
    return tab.astype(np.int32), idx.astype(np.int32)


def _emu_lgather(lib, tab, idx, n, max_blocks, min_chunk, threads, reverse):
    """The kernel's grid as the wrapper splits it (``grid_split``) at
    ``max_blocks`` and ``min_chunk``, on the CPU: (out, blocks)."""
    blocks, chunk = micro.grid_split(n, max_blocks, min_chunk)
    out = np.zeros(idx.shape, np.int32)            # the wrapper zeroes it
    if blocks:
        rc = lib.micro_emu_lgather(tab.ctypes.data, idx.ctypes.data,
                                   out.ctypes.data, idx.shape[0],
                                   tab.shape[0], n, blocks, chunk, threads,
                                   int(reverse))
        assert rc == 0, lib.micro_emu_error().decode()
    return out, blocks


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["threads_up", "threads_down"])
@pytest.mark.parametrize("n", EMU_N)
def test_lgather_kernel_source_matches_plain(micro_emu, n, reverse):
    """kernels/micro.cu lgather_kernel (K6.2) itself, on the CPU: several
    blocks of its trips at the launcher's block size and at a block that
    does not divide the 1,024 outputs, each block's threads in one order
    and then the other, summed into a zeroed output, equal the plain
    version bit for bit, negative and extreme start rows included."""
    tab, idx = _lgather_inputs()
    exp = micro.colgather_plain(torch.from_numpy(tab), torch.from_numpy(idx),
                                n).numpy()
    for max_blocks, min_chunk, threads in (
            (5, 1, _micro_define("LG_THREADS")),   # the launcher's block
            (3, 4, 96),
            (264, micro.LG_MIN_CHUNK, 128)):          # the wrapper's split
        got, blocks = _emu_lgather(micro_emu, tab, idx, n, max_blocks,
                                   min_chunk, threads, reverse)
        assert np.array_equal(got, exp), (
            f"n {n}, {blocks} blocks of {threads} threads: "
            f"{int((got != exp).sum())} of {exp.size} sums differ")
        if max_blocks == 5 and n >= 5:
            assert blocks == 5
    if n:
        assert len(np.unique(exp)) > 1
    if n >= GK:     # the sums wrap int32
        exact = sum(tab.astype(np.int64)[(idx.astype(np.int64) + i) % GK,
                                         np.arange(RW)] for i in range(GK))
        assert (np.abs(exact) >= 1 << 31).any()


def _rgather_inputs(rows, seed=19):
    """K6.3's shapes cut to three index rows, from a seed: a (rows, 128)
    table over the whole int32 range (so that sums wrap) and (3, 128) start
    rows inside the table, with negative ones and both int32 extremes in
    row 0."""
    rng = np.random.default_rng([seed, rows])
    tab = rng.integers(I32_MIN, I32_MAX, (rows, RW), dtype=np.int64)
    idx = rng.integers(0, rows, (3, RW), dtype=np.int64)
    idx[0, :6] = [-1, -rows - 3, I32_MIN, I32_MAX, I32_MAX - 3, I32_MIN + 5]
    return tab.astype(np.int32), idx.astype(np.int32)


def _emu_rgather(lib, tab, idx, n, max_blocks, min_chunk, threads, reverse):
    """The kernel's grid as the wrapper splits it on the CPU, the trips of
    each of the 128 columns split by ``grid_split`` at ``max_blocks`` (the
    card's SMs) // 128: (out, blocks)."""
    splits, chunk = micro.grid_split(n, max(1, max_blocks // RW), min_chunk)
    out = np.zeros(idx.shape, np.int32)            # the wrapper zeroes it
    if splits:
        rc = lib.micro_emu_rgather(tab.ctypes.data, idx.ctypes.data,
                                   out.ctypes.data, idx.shape[0],
                                   tab.shape[0], n, splits, chunk, threads,
                                   int(reverse))
        assert rc == 0, lib.micro_emu_error().decode()
    return out, splits * RW


RG_ROWS = [64, 4096]


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["threads_up", "threads_down"])
@pytest.mark.parametrize("wraps", ["1", "31", "33", "rows-1", "rows+5",
                                   "2rows+3"])
@pytest.mark.parametrize("rows", RG_ROWS)
def test_rgather_kernel_source_matches_plain(micro_emu, rows, wraps,
                                             reverse):
    """kernels/micro.cu rgather_kernel (K6.3) itself, on the CPU: the
    wrapper's grid on the card's 132 SMs (one trip range a column) and
    several trip ranges a column (down to ranges of 7 trips,
    so that a lane takes no trip or ends inside its unrolled group), at the
    launcher's block size and at one, two and three warps (fewer warps
    than the outputs of a column, so a warp takes several), each block's
    threads in one order and then the other, summed into a zeroed output,
    equal the plain version bit for bit, negative and extreme start rows
    included. No n is a whole number of wraps of the column."""
    n = {"1": 1, "31": 31, "33": 33, "rows-1": rows - 1,
         "rows+5": rows + 5, "2rows+3": 2 * rows + 3}[wraps]
    tab, idx = _rgather_inputs(rows)
    exp = micro.colgather_plain(torch.from_numpy(tab), torch.from_numpy(idx),
                                n).numpy()
    for max_blocks, min_chunk, threads in (
            (132, micro.RG_MIN_CHUNK, 64),            # the wrapper's split
            (132, micro.RG_MIN_CHUNK, _micro_define("RG_THREADS")),
            (640, 7, 96), (1000, 16, 32), (600, 40, 64)):
        got, blocks = _emu_rgather(micro_emu, tab, idx, n, max_blocks,
                                   min_chunk, threads, reverse)
        assert np.array_equal(got, exp), (
            f"n {n}, {blocks} blocks of {threads} threads: "
            f"{int((got != exp).sum())} of {exp.size} sums differ")
    assert n % rows and len(np.unique(exp)) > 1
    if n >= rows:     # the sums wrap int32: a whole wrap is a column's sum
        assert (np.abs(tab.astype(np.int64).sum(0)) >= 1 << 31).any()


@pytest.mark.parametrize("n, max_blocks, rows", [
    (0, 132, 4096),             # no trips: no block, no launch
    (1, 132, 4096),             # one trip, one lane
    (255, 132, 4096),           # fewer trips than a block's least share
    (8192, 132, 4096),          # the tool's size: one range a column
    (8192, 264, 4096),          # a card of 264 SMs: two ranges
    (3001, 640, 64),            # a prime: a short last range
])
def test_rgather_split_sums_to_the_whole_loop(n, max_blocks, rows):
    """rgather's grid (``grid_split`` at RG_MIN_CHUNK for each of the 128
    columns, one block a SM): every (output, trip) pair in exactly one block and one lane's
    loads (lane k takes the range's trips k, k + 32, ...: RG_UNROLL at a
    time from one start row below ``rows``, each inside the column's RG_PAD
    staged rows past its end, then the rest), and every output of a column
    in exactly one warp of a block (warp w takes outputs w, w + warps,
    ...), restating kernels/micro.cu rgather_kernel; and the block partial
    sums (the plain version over each range's trips, its start rows moved
    on by the range's first trip) add up to the whole loop's, which is what
    the blocks' atomicAdds into the zeroed output compute."""
    unroll = _micro_define("RG_UNROLL")
    assert micro.RG_PAD == 32 * unroll == _micro_define("RG_PAD")
    spans = _check_split(n, max(1, max_blocks // RW), micro.RG_MIN_CHUNK)
    assert len(spans) * RW <= max(max_blocks, RW)
    tab, idx = (torch.from_numpy(a) for a in _rgather_inputs(rows))
    seen = np.zeros(n, np.int64)
    for first, last in spans:
        cnt = last - first
        for lane in range(32):
            steps = -(-(cnt - lane) // 32) if cnt > lane else 0
            k = 0
            for _ in range(steps // unroll):
                # a group's loads: rows p + 32 u, p < rows, u < RG_UNROLL
                assert (rows - 1) + 32 * (unroll - 1) < rows + micro.RG_PAD
                seen[first + lane + 32 * k:
                     first + lane + 32 * (k + unroll):32] += 1
                k += unroll
            seen[first + lane + 32 * k:
                 first + lane + 32 * (k + steps % unroll):32] += 1
    assert (seen == 1).all()
    warps = _micro_define("RG_THREADS") // 32
    owners = sorted(o for w in range(warps)
                    for o in range(w, idx.shape[0], warps))
    assert owners == list(range(idx.shape[0]))
    total = torch.zeros(idx.shape, dtype=torch.int64)
    for first, last in spans:
        total += micro.colgather_plain(tab, micro.i32(idx.long() + first),
                                       last - first)
    assert torch.equal(micro.i32(total), micro.colgather_plain(tab, idx, n))


def test_rgather_refuses_a_column_it_cannot_stage(micro_emu):
    """The wrapper and the emulated launcher take the same tables: a
    column of up to 32,768 rows (and its RG_PAD rows again) fits a block's
    227 KB of shared memory, one of 65,536 rows does not, and both refuse
    it, the wrapper on the CPU too."""
    assert micro.RG_MAX_SMEM == _micro_define("RG_MAX_SMEM")
    for k in range(18):
        rows = 1 << k
        fits = micro.rgather_smem(rows) <= micro.RG_MAX_SMEM
        assert micro_emu.micro_emu_rgather_fits(rows) == fits
        assert fits == (rows <= 1 << 15)
    big = torch.zeros(1 << 16, RW, dtype=torch.int32)
    idx = torch.zeros(2, RW, dtype=torch.int32)
    with pytest.raises(ValueError, match="cannot be staged"):
        micro.colgather(big, idx, 3, False)
    tab, idx_np = _rgather_inputs(64)
    out = np.zeros(idx_np.shape, np.int32)
    for rows, n, splits, chunk, threads in (
            (1 << 16, 3, 1, 3, 64),       # one column does not fit
            (48, 3, 1, 3, 64),            # rows not a power of two
            (64, 3, 2, 3, 64),            # an empty last range
            (64, 9, 1, 8, 64),            # a trip left over
            (64, 3, 1, 3, 48),            # a short warp
            (64, 3, 1, 3, 2048)):         # over the launcher's block
        assert micro_emu.micro_emu_rgather(
            tab.ctypes.data, idx_np.ctypes.data, out.ctypes.data, 3, rows, n,
            splits, chunk, threads, 0) == 1
        assert b"out of range" in micro_emu.micro_emu_error()
    assert not out.any()


def _emu_oneprog(lib, x, n, max_blocks, min_chunk, threads, reverse):
    """The kernel's grid as the wrapper splits it, on the CPU: (out,
    blocks); x itself for no trips, where the wrapper launches nothing."""
    blocks, chunk = micro.grid_split(n, max_blocks, min_chunk)
    if not blocks:
        return x.copy(), 0
    scratch = np.zeros(1 + 2 * blocks, np.uint32)  # the wrapper zeroes it
    out = np.full((8, RW), -7, np.int32)           # every word is written
    rc = lib.micro_emu_oneprog(x.ctypes.data, scratch.ctypes.data,
                               out.ctypes.data, n, blocks, chunk, threads,
                               int(reverse))
    assert rc == 0, lib.micro_emu_error().decode()
    assert scratch[0] == blocks                    # every block counted
    return out, blocks


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("n", EMU_N + [1 << 14])
def test_oneprog_kernel_source_matches_plain(micro_emu, n, reverse):
    """kernels/micro.cu oneprog_kernel (K5.c) itself, on the CPU: one block
    and several (so that the last block composes the others' maps), at the
    launcher's 256 threads, at 32, 7 (not a power of two: the tree's last
    span is short) and 4 (fewer threads than blocks), blocks and threads
    run first to last and then last to first (so the last block to finish
    is another one), equals the plain version bit for bit."""
    rng = np.random.default_rng(17)
    x = rng.integers(I32_MIN, I32_MAX, (8, RW), dtype=np.int64).astype(
        np.int32)
    exp = micro.oneprog_plain(torch.from_numpy(x), n).numpy()
    full = _micro_define("OP_THREADS")
    for max_blocks, min_chunk, threads in (
            (1056, micro.OP_MIN_CHUNK, full),    # the wrapper's split
            (5, 1, full), (3, 2, 32), (7, 1, 7),
            (13, 1, 4)):     # more blocks than threads: the last block's
                             # threads each compose a run of block maps
        got, blocks = _emu_oneprog(micro_emu, x, n, max_blocks, min_chunk,
                                   threads, reverse)
        assert np.array_equal(got, exp), (n, blocks, threads)
        if max_blocks < 10 and n >= 2 * max_blocks:
            assert blocks == max_blocks


def test_emulated_launches_refuse_what_the_launchers_refuse(micro_emu):
    tab, idx = _lgather_inputs()
    out = np.zeros(idx.shape, np.int32)
    for rows, n, blocks, chunk in ((24, 8, 1, 8),     # rows not a power of 2
                                   (GK, 8, 2, 8),     # an empty last block
                                   (GK, 9, 1, 8)):    # a trip left over
        assert micro_emu.micro_emu_lgather(
            tab.ctypes.data, idx.ctypes.data, out.ctypes.data, 8, rows, n,
            blocks, chunk, 32, 0) == 1
        assert b"out of range" in micro_emu.micro_emu_error()
    x = np.zeros((8, RW), np.int32)
    scratch = np.zeros(3, np.uint32)
    for n, blocks, chunk, threads in ((4, 1, 4, 512),  # over the launcher's
                                      (0, 1, 4, 32),   # no trips
                                      (9, 1, 8, 32)):  # a trip left over
        assert micro_emu.micro_emu_oneprog(
            x.ctypes.data, scratch.ctypes.data, x.ctypes.data, n, blocks,
            chunk, threads, 0) == 1
        assert b"out of range" in micro_emu.micro_emu_error()


@pytest.mark.parametrize("n, max_blocks", [
    (0, 264),                  # no trips: no block, no launch
    (1, 264),                  # one trip
    (63, 264),                 # fewer trips than one block's least share
    (3001, 5),                 # a prime: a short last block
    (1 << 16, 264),            # 132 SMs x 2 blocks of 1,024 threads
])
def test_lgather_split_sums_to_the_whole_loop(n, max_blocks):
    """lgather's grid (``grid_split`` at LG_MIN_CHUNK): every trip in
    exactly one block, and inside a block every output in exactly one
    thread (thread t takes outputs t, t + LG_THREADS, ... over all of the
    block's trips, restating kernels/micro.cu lgather_kernel); and the
    block partial sums (the plain version over each block's trips, its
    start rows moved on by the range's first trip) add up to the whole
    loop's, which is what the blocks' atomicAdds into the zeroed output
    compute."""
    threads = _micro_define("LG_THREADS")
    tab, idx = (torch.from_numpy(a) for a in _lgather_inputs())
    spans = _check_split(n, max_blocks, micro.LG_MIN_CHUNK)
    seen = np.zeros(n, np.int64)
    total = torch.zeros(idx.shape, dtype=torch.int64)
    for first, last in spans:
        seen[first:last] += 1
        total += micro.colgather_plain(tab, micro.i32(idx.long() + first),
                                       last - first)
    assert (seen == 1).all()
    owners = sorted(o for t in range(threads)
                    for o in range(t, idx.numel(), threads))
    assert owners == list(range(idx.numel()))
    assert torch.equal(micro.i32(total), micro.colgather_plain(tab, idx, n))


def _affine_maps(span, threads):
    """Each thread's (A, B) of kernels/micro.cu oneprog_kernel for one
    block's trips [first, last): thread t folds its span [first + t c,
    first + min(cnt, (t + 1) c)), c = ceil(cnt / threads), one trip at a
    time, vectorised over the threads. Returns (A, B, the spans)."""
    first, last = span
    cnt = last - first
    c = -(-cnt // threads)
    t = np.arange(threads, dtype=np.uint64)
    lo = first + np.minimum(cnt, t * c)
    hi = first + np.minimum(cnt, t * c + c)
    a = np.ones(threads, np.uint64)
    b = np.zeros(threads, np.uint64)
    for j in range(c):
        i = lo + np.uint64(j)
        live = i < hi
        a = np.where(live, (a * np.uint64(3)) & np.uint64(M32), a)
        b = np.where(live, (b * np.uint64(3) + i) & np.uint64(M32), b)
    return list(a.astype(object)), list(b.astype(object)), list(zip(lo, hi))


def _compose(maps):
    """The maps applied one after another, as one (A, B)."""
    a, b = 1, 0
    for a2, b2 in maps:
        a, b = (a2 * a) & M32, (a2 * b + b2) & M32
    return a, b


def _tree(pa, pb):
    """kernels/micro.cu compose_maps: the threads' maps as its tree."""
    pa, pb, s = list(pa), list(pb), 1
    while s < len(pa):
        for t in range(0, len(pa) - s, 2 * s):
            pb[t] = (pa[t + s] * pb[t] + pb[t + s]) & M32
            pa[t] = (pa[t + s] * pa[t]) & M32
        s *= 2
    return pa[0], pb[0]


@pytest.mark.parametrize("n, max_blocks, threads, block_order_shows", [
    (0, 1056, 256, False),     # no trips: no block, no launch
    (1, 1056, 256, False),     # one trip, one thread's map
    (3001, 1056, 256, True),   # a prime, two blocks (the second short)
    (3001, 5, 7, True),        # a block size that is not a power of two
    (1 << 19, 1056, 256, False),      # the tool's size, as the wrapper
                                      # splits it: see below
    ((1 << 19) + 1001, 1056, 256, True),   # 257 blocks, the last short
])
def test_oneprog_maps_composed_in_order_equal_the_chain(n, max_blocks,
                                                        threads,
                                                        block_order_shows):
    """oneprog's split (``grid_split`` at OP_MIN_CHUNK, then each block's
    trips over its threads): every trip in exactly one block and one
    thread's span; the maps composed in trip order, one after another and
    as the kernel's trees (each block's threads, then the blocks), give the
    serial chain's acc_n; and in reverse order (the threads' maps, and the
    blocks') another number, so the check sees the order. One exception:
    at the tool's own size every block holds 2,048 trips, so every block's
    A is 3^2048 = 1 (mod 2^13) and the blocks' maps give the same sum mod
    2^32 in either order. A kernel whose last block composed the blocks
    out of order would pass on the card at full size; the odd sizes here
    and the emulated kernel's cases are what hold that order."""
    spans = _check_split(n, max_blocks, micro.OP_MIN_CHUNK)
    seen = np.zeros(n, np.int64)
    maps, blocks = [], []
    for span in spans:
        a, b, th = _affine_maps(span, threads)
        for lo, hi in th:
            seen[int(lo):int(hi)] += 1
        maps += zip(a, b)
        blocks.append(_tree(a, b))
    assert (seen == 1).all()
    acc = 0
    for i in range(n):
        acc = (acc * 3 + i) & M32
    assert _compose(maps)[1] == acc
    assert _compose(blocks)[1] == acc
    if blocks:
        assert _tree(*zip(*blocks))[1] == acc
    assert (_compose(reversed(maps))[1] != acc) == (n > 1)
    assert (_compose(reversed(blocks))[1] != acc) == block_order_shows
    assert int(micro.oneprog_plain(torch.zeros(8, RW, dtype=torch.int32),
                                   n)[0, 0]) & M32 == acc


# (eb, ek, en, reps, how the indices are drawn): the tool's shape, a narrow
# table, no rep and one, every window wrapping past the row's end, a row of
# outputs that no block size divides, and a row narrower than one 16-byte
# copy
EG_CASES = {
    "tool": (EB, EK, EN, REPK, "any"),
    "ek128": (EB, 128, EN, REPK, "any"),
    "reps0": (EB, EK, EN, 0, "any"),
    "reps1": (EB, EK, EN, 1, "any"),
    "wrap": (EB, 128, 40, 37, "last"),
    "ragged": (3, 256, 37, 45, "any"),
    "ek2": (3, 2, 5, 7, "any"),
}


def _aligned(a):
    """A copy of ``a`` at a 16-byte aligned address, as the card's
    allocations are."""
    buf = np.empty(a.nbytes + 16, np.uint8)
    off = -buf.ctypes.data % 16
    out = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


@pytest.mark.parametrize("case", list(EG_CASES))
def test_egather_kernel_source_matches_plain(micro_emu, case):
    """kernels/micro.cu egather_kernel (K4.2) itself, on the CPU: its grid
    of (rows, output blocks) at the launcher's block size and at one and
    three warps a block, the row staged by 16-byte copies (where the row is
    whole 16-byte words, as the launcher chooses) and by 4-byte ones, the
    blocks and each block's threads in one order and then the other (shared
    memory filled with 0xA5 before each block), equals ``egather_plain`` bit
    for bit on a table over the whole int32 range (the sums wrap), with
    negative and extreme indices; in "wrap" every index is ek - 1, so each
    window runs past the row's end."""
    eb, ek, en, reps, draw = EG_CASES[case]
    rng = np.random.default_rng([23, eb, ek, en, reps])
    tab = rng.integers(I32_MIN, I32_MAX, (eb, ek), dtype=np.int64)
    if draw == "last":
        idx = np.full((eb, en), ek - 1, np.int64)
    else:
        idx = rng.integers(0, ek, (eb, en), dtype=np.int64)
        idx[0, :4] = [-1, I32_MIN, I32_MAX, -ek - 3]
    tab, idx = _aligned(tab.astype(np.int32)), idx.astype(np.int32)
    exp = micro.egather_plain(torch.from_numpy(tab), torch.from_numpy(idx),
                              reps).numpy()
    for wide in ((1, 0) if ek % 4 == 0 else (0,)):
        for threads in (_micro_define("EG_THREADS"), 32, 96):
            for reverse in (0, 1):
                out = np.full((eb, en), 0x5A5A5A5A, np.int32)
                rc = micro_emu.micro_emu_egather(
                    tab.ctypes.data, idx.ctypes.data, out.ctypes.data, eb,
                    ek, en, reps, wide, threads, reverse)
                assert rc == 0, micro_emu.micro_emu_error().decode()
                assert np.array_equal(out, exp), (
                    f"wide {wide}, {threads} threads a block, reverse "
                    f"{reverse}: {int((out != exp).sum())} of {exp.size} "
                    f"sums differ")
    if reps:
        assert len(np.unique(exp)) > 1
    if reps > 1:
        exact = sum(tab.astype(np.int64)[
            np.arange(eb)[:, None], (idx.astype(np.int64) + r) % ek]
            for r in range(reps))
        assert (np.abs(exact) >= 1 << 31).any()     # the sums wrap int32


def test_egather_launcher_refusals(micro_emu):
    """What micro_egather refuses (egather_args_ok, which the emulator's
    entry shares): no rows or no outputs, an ek that is not a power of two
    or whose row passes 48 KB of shared memory, negative reps and more
    output blocks than a grid's second dimension holds; an 8,192-word row,
    the widest it stages, is taken."""
    tab = _aligned(np.arange(2 * 16384, dtype=np.int32).reshape(2, 16384))
    idx = np.zeros((2, 4), np.int32)
    out = np.zeros((2, 4), np.int32)
    ptrs = (tab.ctypes.data, idx.ctypes.data, out.ctypes.data)
    for eb, ek, en, reps in ((0, 8192, 4, 1), (2, 8192, 0, 1),
                             (2, 3000, 4, 1), (2, 16384, 4, 1),
                             (2, 8192, 4, -1), (2, 8192, 65536 * 128 + 1, 1)):
        assert micro_emu.micro_emu_egather(*ptrs, eb, ek, en, reps, 1, 128,
                                           0) == 1
        assert micro_emu.micro_emu_error() == b"argument out of range"
    half = tab.reshape(4, 8192)[:2]
    assert micro_emu.micro_emu_egather(half.ctypes.data, *ptrs[1:], 2, 8192,
                                       4, 3, 1, 128, 0) == 0
    assert np.array_equal(out, micro.egather_plain(
        torch.from_numpy(np.ascontiguousarray(half)), torch.from_numpy(idx),
        3).numpy())


# ---- the CUDA source of K4.1, run on the CPU -----------------------------------

def rowgather_reps_kernel(reps, gn):
    """tools/pallas_micro.py:57-63 (``rowgather_kernel``) with ``reps`` in
    place of REPK (20) and ``gn`` gathered rows in place of GN."""
    def kernel(tab_ref, idx_ref, o_ref):
        tab = tab_ref[:]
        acc = jnp.zeros((gn, RW), jnp.int32)
        for r in range(reps):
            ii = (idx_ref[:] + r) & (KR - 1)
            acc = acc + jnp.take(tab, ii[:, 0], axis=0)
        o_ref[:] = acc
    return kernel


@pytest.mark.parametrize("reps", [0, 1, 20, 21])
def test_rowgather_kernel_source_matches_pallas(micro_emu, reps):
    """kernels/micro.cu rowgather_kernel (K4.1) itself, on the CPU: 37
    gathered rows (not a whole number of blocks) from the tool's (4096,
    128) table over the whole int32 range, at the launcher's rows a block
    (one) and at two and three, by 16-byte loads (the launcher's choice for
    16-byte aligned tables and outputs) and by 4-byte ones (a table and an
    output 4 bytes off), blocks and threads both ways, equals the Pallas
    body in interpret mode and ``rowgather_plain`` bit for bit; reps 0, 1,
    the tool's 20 (one unrolled group) and 21 (a group and the tail); the
    start rows include rows - 1, -1 and both int32 extremes, so gathers
    wrap at the table's end, and the sums wrap int32."""
    g = 37
    rng = np.random.default_rng([29, reps])
    tab = rng.integers(I32_MIN, I32_MAX, (KR, RW), dtype=np.int64).astype(
        np.int32)
    idx = rng.integers(0, KR, (g, RW), dtype=np.int64)
    idx[:6, 0] = [KR - 1, -1, I32_MIN, I32_MAX, KR - 3, -KR - 5]
    idx = idx.astype(np.int32)
    exp = call(rowgather_reps_kernel(reps, g), (g, RW), (V, V), tab, idx)
    plain = micro.rowgather_plain(torch.from_numpy(tab),
                                  torch.from_numpy(idx), reps).numpy()
    assert np.array_equal(plain, exp)
    for wide in (1, 0):
        if wide:
            t = _aligned(tab)
        else:                   # 4 bytes past a 16-byte boundary
            buf = _aligned(np.zeros(tab.size + 4, np.int32))
            t = buf[1:tab.size + 1].reshape(tab.shape)
            t[...] = tab
        for warps in (micro_emu.micro_emu_rowgather_warps(), 2, 3):
            for reverse in (0, 1):
                obuf = _aligned(np.full(g * RW + 4, 0x5A5A5A5A, np.int32))
                out = obuf[1 - wide:1 - wide + g * RW].reshape(g, RW)
                rc = micro_emu.micro_emu_rowgather(
                    t.ctypes.data, idx.ctypes.data, out.ctypes.data, g, KR,
                    reps, warps, wide, reverse)
                assert rc == 0, micro_emu.micro_emu_error().decode()
                assert np.array_equal(out, exp), (
                    f"wide {wide}, {warps} rows a block, reverse {reverse}: "
                    f"{int((out != exp).sum())} of {exp.size} sums differ")
    if reps:
        assert len(np.unique(exp)) > 1
    if reps > 1:
        rows = (idx[:, :1].astype(np.int64) + np.arange(reps)) & (KR - 1)
        exact = tab.astype(np.int64)[rows].sum(axis=1)
        assert (np.abs(exact) >= 1 << 31).any()     # the sums wrap int32


def test_rowgather_emulation_refuses_what_the_launcher_refuses(micro_emu):
    """micro_rowgather's refusals (no rows, a table that is not a power of
    two, negative reps), and 16-byte loads only from aligned pointers."""
    tab = _aligned(np.zeros((64, RW), np.int32))
    idx = np.zeros((4, RW), np.int32)
    out = _aligned(np.zeros((4, RW), np.int32))
    ptrs = (tab.ctypes.data, idx.ctypes.data, out.ctypes.data)
    for g, rows, reps, wide, p in ((0, 64, 1, 1, 0), (4, 48, 1, 1, 0),
                                   (4, 64, -1, 1, 0), (4, 64, 1, 1, 4)):
        assert micro_emu.micro_emu_rowgather(
            ptrs[0] + p, *ptrs[1:], g, rows, reps, 2, wide, 0) == 1
        assert micro_emu.micro_emu_error() == b"argument out of range"
    assert micro_emu.micro_emu_rowgather(*ptrs, 4, 64, 1, 2, 1, 0) == 0
