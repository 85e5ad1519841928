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
"""
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
