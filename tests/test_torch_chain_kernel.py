"""The chaining CUDA kernels' own source (kernels/chain.cu: ``chain_kernel``,
M2, and ``m3_kernel``, M3), compiled as host C++ over
tests/cuda_host/block_emu.h and run on the CPU at their launched block
shapes (M2 four warps a block, a read a warp; M3 8 or 4 warps), == the
JAX
``chain_kernel`` and ``m3_kernel`` and the port's eager ones (their plain
versions), bit for bit (tolerance 0): chains, n_out, pre and the overflow
flag.

Each case is one batch of seeded numpy anchors at the main path's shapes
(M2: 64 reads of ``A_CAP`` = 64 slots; M3: 8 reads of ``M3_A2`` = 512), so
that the JAX functions compile once per shape for the file: the random
sets of ``test_torch_stages`` (through the ladder pack and gather map),
reads that overflow the 16 chain slots, anchor counts at and above
``M3_ANCHOR_THRESHOLD`` and above the slots, wrapped-negative and
wrapping offsets, the duplicate bit, equal resolve-sort keys and equal DP
maxima, ``n_anc = 0`` padding rows, an M3 read with more than 16
run-chains and a with_top run past slot 16, and int32 extremes in every
field; M3 also one 512-node run whose windows pass 32 predecessors, more
runs than warps of 1 to 200 nodes, a valid sort key equal to the
padding's and a 64-read batch of 56 padding reads; M2 also a batch that
does not fill its last block and reads of 0 and 64 anchors side by side.
Each runs with every block's threads in order and in reverse between
barriers and collectives (and its blocks in reverse). The emulator's warp
collectives are held to their CUDA meaning by small probe kernels."""
import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_stages import (  # noqa: E402
    T,
    _chain_inputs,
    _rand_anchors,
    _rand_m3_anchors,
    assert_same,
)

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")
B2, A2 = 64, 64          # the main batch's reads (a tail) and A_CAP
BM, A3 = 8, 512          # an M3 sub-batch and M3_A2
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
OUTS = ("chains", "n_out", "pre", "ovf")
M3_BLOCKS = (8, 4)       # warps a block: both that m3_warps chooses from


@pytest.fixture(scope="module")
def chain_emu(tmp_path_factory):
    """kernels/chain.cu compiled as host C++ over block_emu.h, loaded with
    ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernels with")
    so = str(tmp_path_factory.mktemp("chain_emu") / "chain_emu.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", host,
                    "-I", KERNELS, os.path.join(host, "chain_emu.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.chain_emulate.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    lib.m3_emulate.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    lib.emu_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for entry in (lib.chain_emulate, lib.m3_emulate, lib.emu_probe):
        entry.restype = ctypes.c_int
    lib.chain_emu_error.restype = ctypes.c_char_p
    lib.m3_smem_bytes.argtypes = [ctypes.c_int]
    lib.m3_smem_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def chip_smoke():
    """chip_smoke.py as a module, for its ``m3_shape`` (``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _emulate(lib, kind, anc, n_anc, reverse, block):
    """The ``kind`` ("m2" / "m3") kernel's grid on the CPU (``block``: M3's
    warps a block); outputs start as garbage, so every element the kernel
    leaves unwritten shows."""
    B, W, _ = anc.shape
    anc = np.ascontiguousarray(anc, np.int32)
    n_anc = np.ascontiguousarray(n_anc, np.int32)
    chains = np.full((B, 16, 13), 0x5A5A5A5A, np.int32)
    n_out = np.full((B,), 0x5A5A5A5A, np.int32)
    pre = np.full((B, W), 0x5A5A5A5A, np.int32)
    ovf = np.full((B,), 0x5A, np.uint8)
    ptrs = [a.ctypes.data for a in (anc, n_anc, chains, n_out, pre, ovf)]
    run = lib.chain_emulate if kind == "m2" else lib.m3_emulate
    rc = run(*ptrs, B, W, *((block,) if block else ()), int(reverse))
    assert rc == 0, lib.chain_emu_error().decode()
    assert set(np.unique(ovf)) <= {0, 1}, "ovf holds a byte other than 0/1"
    return chains, n_out, pre, ovf.astype(bool)


def _gathered(packed, gidx):
    """``chain._gather_anchors`` in numpy: (B, A2, 7) anchor rows."""
    from desamba_tpu_torch.engine.device import chain as tc

    ext = np.concatenate([packed, np.zeros((1, packed.shape[1]), np.int32)])
    rows = ext[np.where(gidx >= 0, gidx, len(packed))]
    return rows[:, :, [tc.P_IIR, tc.P_ROFF, tc.P_MLEN, tc.P_SCORE, tc.P_REF,
                       tc.P_DIR, tc.P_USELESS]].astype(np.int32)


def _batch(rng, B, W, rows_fn, counts):
    """B reads of W slots: read b has counts[b] valid anchors from
    rows_fn(rng, n) and seeded garbage past them (which must not count)."""
    anc = rng.integers(I32_MIN, I32_MAX, (B, W, 7), dtype=np.int64)
    anc = anc.astype(np.int32)
    for b, n in enumerate(counts):
        k = min(int(n), W)
        if k > 0:
            anc[b, :k] = rows_fn(rng, k)
    return anc, np.asarray(counts, np.int32)


# ---- anchor sets -----------------------------------------------------------

def _scattered_chains(rng, n):
    """n anchors on distinct references: every anchor opens a chain."""
    rows = np.zeros((n, 7), np.int32)
    iir = np.sort(rng.integers(0, 5000, n))
    rows[:, 0] = iir
    rows[:, 1] = iir + rng.integers(0, 10 ** 6, n)
    rows[:, 2] = rng.integers(9, 60, n)
    rows[:, 3] = rng.integers(20, 300, n)
    rows[:, 4] = rng.permutation(n) + 3 * int(rng.integers(0, 100))
    rows[:, 5] = rng.integers(0, 2, n)
    rows[:, 6] = rng.integers(0, 2, n)
    return rows


def _wrapping(rng, n):
    """_rand_anchors with offsets around 0 (wrapped-negative roff, t_ed
    crossing 0 as uint32) and around INT32_MAX (roff + mlen wraps)."""
    rows = _rand_anchors(rng, n)
    pick = rng.random(n)
    near0 = pick < 0.4
    rows[near0, 1] = rng.integers(-120, 120, int(near0.sum()))
    top = pick > 0.8
    rows[top, 1] = I32_MAX - rng.integers(0, 100, int(top.sum()))
    rows[pick > 0.9, 0] = I32_MAX - 20
    return rows


def _equal_keys(rng, n):
    """Chains whose resolve keys tie: one-anchor chains with the same
    score, length and with_top on distinct references, and repeated
    anchors that extend them by the same amounts."""
    rows = np.zeros((n, 7), np.int32)
    k = int(rng.integers(3, 8))
    for i in range(n):
        c = i % k
        rows[i] = (10 * (i // k), 10 * (i // k) + 1000, 20, 50, c, 0,
                   int(c % 2 and i < k))
    return rows


def _extremes(rng, n):
    """int32 extremes and their neighbours in every numeric field; few
    references, so chains still form."""
    vals = np.array([I32_MIN, I32_MIN + 1, -1000, -1, 0, 1, 999, 1000, 1001,
                     I32_MAX - 1000, I32_MAX - 1, I32_MAX], np.int64)
    rows = rng.choice(vals, (n, 7)) + rng.integers(-2, 3, (n, 7))
    rows = np.clip(rows, I32_MIN, I32_MAX)
    rows[:, 4] = rng.integers(0, 2, n)
    rows[:, 5] = rng.integers(0, 2, n)
    rows[:, 6] = rng.integers(0, 4, n)
    return rows.astype(np.int32)


def _m3_identical(rng, n):
    """Each anchor of three diagonals repeated 2-3 times (equal sort keys),
    60 bases apart: every copy of a node gives the next node the same DP
    score, so its maximum is reached at several slots."""
    out, k = [], 0
    diags = rng.integers(0, 10 ** 6, 3)
    while len(out) < n:
        iir = 60 * k + int(rng.integers(0, 5))
        row = (iir, iir + int(diags[rng.integers(0, 3)]), 30, 40, 0, 0, 0)
        out += [row] * int(rng.integers(2, 4))
        k += 1
    return np.array(out[:n], np.int32)


def _m3_dup(rng, n):
    rows = _rand_m3_anchors(rng, n)
    rows[:, 6] = rng.choice([2, 3, 2, 0, 1], n)     # the duplicate bit
    return rows


def _m3_wrapped(rng, n):
    rows = _rand_m3_anchors(rng, n)
    m = rng.random(n) < 0.35
    rows[m, 1] = rng.integers(-3000, 40, int(m.sum()))
    return rows


def _one_run(rng, n):
    """One diagonal on one reference, 10-20 bases apart: a single run of n
    nodes whose windows reach back ~1,000 bases, past 32 predecessors,
    before a break."""
    rows = np.zeros((n, 7), np.int32)
    iir = np.cumsum(rng.integers(10, 21, n))
    rows[:, 0] = iir
    rows[:, 1] = iir + int(rng.integers(0, 10 ** 6)) + rng.integers(-3, 4, n)
    rows[:, 2] = rng.integers(15, 31, n)
    rows[:, 3] = rng.integers(20, 200, n)
    rows[:, 4] = int(rng.integers(0, 50))
    rows[:, 6] = rng.integers(0, 4, n)
    return rows


def _wide_ties(rng, n):
    """Groups of 30-80 identical anchors, 200 bases apart on one diagonal:
    a node's equal DP maxima lie at every copy of the group before it, on
    both sides of the 32 nearest slots and in several rounds past them."""
    out, g = [], 0
    diag = int(rng.integers(0, 10 ** 6))
    while len(out) < n:
        iir = 200 * g + int(rng.integers(0, 20))
        row = (iir, iir + diag, int(rng.integers(20, 41)),
               int(rng.integers(20, 200)), 1, 1, int(rng.integers(0, 4)))
        out += [row] * int(rng.integers(30, 81))
        g += 1
    return np.array(out[:n], np.int32)


def _below_neg(rng, n):
    """Scores below NEG = -2^30: six single anchors on references 0-5 (the
    first sorted runs), whose DP max is NEG at slot A2 - 1 and who take it
    all the same, as it stood (a valid slot when n fills A2); a run on
    reference 6 whose first three nodes do so and whose next ones chain on
    them; then four diagonals on references 8-11."""
    out = []
    for k in range(6):
        iir = int(rng.integers(0, 3000))
        out.append((iir, iir + int(rng.integers(0, 10 ** 6)), 20,
                    I32_MIN + int(rng.integers(0, 1000)), k, 0, 0))
    for j in range(20):
        out.append((100 + 30 * j, 5000 + 30 * j, 20,
                    I32_MIN + 5 if j < 3 else 50, 6, 0, 0))
    k = 0
    while len(out) < n:
        rows = _one_run(rng, (n - 26) // 4 + 1)
        rows[:, 4] = 8 + k
        out += [tuple(r) for r in rows]
        k += 1
    return np.array(out[:n], np.int32)


def _run_lengths(rng, n):
    """Runs of 1 to 200 nodes on distinct references, in random order:
    more runs than a block has warps, of very unequal lengths."""
    lengths = rng.permutation([1, 1, 1, 2, 2, 3, 5, 8, 13, 21, 40, 90, 200])
    out, ref = [], 7
    while len(out) < n:
        for k0 in lengths:
            iir = np.cumsum(rng.integers(8, 40, int(k0)))
            roff = iir + int(rng.integers(0, 10 ** 6))
            d = int(rng.integers(0, 2))
            for a, r in zip(iir, roff):
                out.append((a, r, int(rng.integers(9, 40)),
                            int(rng.integers(20, 200)), ref, d,
                            int(rng.integers(0, 4))))
            ref += 1
    return np.array(out[:n], np.int32)


def m3_key_tie():
    """Valid anchors on reference 2^29, direction 0 (sort key 2^30, the
    padding's), and padding slots with the same reference, direction and
    nearby offsets: they interleave, so runs start at invalid slots and
    hold valid nodes."""
    rng = np.random.default_rng(52)
    counts = [60, 120, 200, 300, 400, 450, 480, 90]
    anc, n_anc = _batch(rng, BM, A3, _rand_m3_anchors, counts)
    for b, n in enumerate(counts):
        tie = rng.random(n) < 0.5
        anc[b, :n][tie, 4] = 1 << 29
        anc[b, :n][tie, 5] = 0
        anc[b, n:, 4] = 1 << 29
        anc[b, n:, 5] = 0
        anc[b, n:, 1] = rng.integers(0, 200000, A3 - n)
    assert ((anc[:, :, 4] * 2 + anc[:, :, 5]) == 1 << 30).any()
    return anc, n_anc


def m3_padded():
    """A 64-read M3 bucket with 8 reads: 56 padding reads, half of them
    zero rows as the classifier pads (every key equal), half garbage."""
    anc, n_anc = _batch(np.random.default_rng(56), 64, A3, _rand_m3_anchors,
                        np.random.default_rng(57).permutation(
                            [0] * 56 + [50, 80, 120, 200, 300, 400, 480, 512]))
    pad = np.flatnonzero(n_anc == 0)
    anc[pad[::2]] = 0
    return anc, n_anc


def _many_runs(rng, n):
    """Runs on distinct references, 2-4 anchors each, all with_top: more
    than 16 run-chains, and the run of with_top chains after the top 5
    goes past slot 16."""
    out, ref = [], 0
    while len(out) < n:
        iir = int(rng.integers(0, 2000))
        roff = iir + int(rng.integers(0, 10 ** 6))
        for k in range(int(rng.integers(2, 5))):
            out.append((iir + 40 * k, roff + 40 * k, int(rng.integers(9, 40)),
                        int(rng.integers(20, 200)), ref, 0, 0))
        ref += 1
    return np.array(out[:n], np.int32)


# ---- the cases: name -> (anchors, n_anc), what the case must exercise ------

def m2_ragged():
    """61 reads: the last block holds one read."""
    rng = np.random.default_rng(32)
    return _batch(rng, 61, A2, _rand_anchors, rng.integers(1, 60, 61))


def m2_stages():
    packed, gidx, n_anc = _chain_inputs(np.random.default_rng(3), B2, A2,
                                        _rand_anchors, 0, 60)
    return _gathered(packed, gidx), n_anc


M2_CASES = {
    "stages": (m2_stages, lambda e, n, sh: e[3].any() and (~e[3]).sum() > 20),
    "slot_overflow": (
        lambda: _batch(np.random.default_rng(21), B2, A2, _scattered_chains,
                       np.random.default_rng(22).integers(10, 50, B2)),
        lambda e, n, sh: (e[3] & (n < 50)).any() and (~e[3]).any()),
    "threshold": (
        lambda: _batch(np.random.default_rng(23), B2, A2, _rand_anchors,
                       np.resize([49, 50, 51, 63, 64, 65, 80, 1000], B2)),
        lambda e, n, sh: e[3][n >= 50].all() and (n > A2).any()),
    "wrapped": (
        lambda: _batch(np.random.default_rng(24), B2, A2, _wrapping,
                       np.random.default_rng(25).integers(1, 49, B2)),
        lambda e, n, sh: (e[2] >= 0).sum() > 0),
    "equal_keys": (
        lambda: _batch(np.random.default_rng(26), B2, A2, _equal_keys,
                       np.random.default_rng(27).integers(6, 49, B2)),
        lambda e, n, sh: (e[1] >= 3).all()),
    "padding": (
        lambda: _batch(np.random.default_rng(28), B2, A2, _rand_anchors,
                       np.where(np.arange(B2) % 2, 0,
                                np.random.default_rng(29).integers(1, 49,
                                                                   B2))),
        lambda e, n, sh: (e[1][n == 0] == 0).all() and (e[1] > 0).any()),
    "extremes": (
        lambda: _batch(np.random.default_rng(30), B2, A2, _extremes,
                       np.random.default_rng(31).integers(0, 70, B2)),
        lambda e, n, sh: (e[2] >= 0).any()),
    "ragged": (m2_ragged,
               lambda e, n, sh: len(n) % 4 != 0 and (e[1][-1:] > 0).all()),
    "empty_beside_full": (
        lambda: _batch(np.random.default_rng(33), B2, A2, _rand_anchors,
                       np.resize([0, 64], B2)),
        lambda e, n, sh: (e[1][n == 0] == 0).all() and (e[1][n > 0] > 0).all()
        and (e[2][n == 64] >= 0).any()),
}


def m3_stages():
    packed, gidx, n_anc = _chain_inputs(np.random.default_rng(7), BM, A3,
                                        _rand_m3_anchors, 50, 480)
    return _gathered(packed, gidx), n_anc


M3_CASES = {
    "stages": (m3_stages, lambda e, n, sh: e[1].min() > 0),
    "threshold": (
        lambda: _batch(np.random.default_rng(41), BM, A3, _rand_m3_anchors,
                       [50, 51, 200, 511, 512, 513, 600, 50]),
        lambda e, n, sh: e[1].min() > 0),
    "wrapped": (
        lambda: _batch(np.random.default_rng(42), BM, A3, _m3_wrapped,
                       np.random.default_rng(43).integers(50, 480, BM)),
        lambda e, n, sh: e[1].min() > 0),
    "duplicate": (
        lambda: _batch(np.random.default_rng(44), BM, A3, _m3_dup,
                       np.random.default_rng(45).integers(50, 480, BM)),
        lambda e, n, sh: e[1].min() > 0),
    "equal_maxima": (
        lambda: _batch(np.random.default_rng(46), BM, A3, _m3_identical,
                       np.random.default_rng(47).integers(50, 480, BM)),
        lambda e, n, sh: (e[2] >= 0).sum() > 500),
    "padding": (
        lambda: _batch(np.random.default_rng(48), BM, A3, _rand_m3_anchors,
                       [0, 120, 0, 0, 300, 0, 51, 0]),
        lambda e, n, sh: (e[1][n == 0] == 0).all() and (e[1] > 0).any()),
    "many_runs": (
        lambda: _batch(np.random.default_rng(49), BM, A3, _many_runs,
                       [60, 100, 300, 480, 70, 52, 200, 400]),
        lambda e, n, sh: e[3].all() and (e[1] == 16).all()),
    "extremes": (
        lambda: _batch(np.random.default_rng(50), BM, A3, _extremes,
                       np.random.default_rng(51).integers(0, 600, BM)),
        lambda e, n, sh: (e[2] >= 0).any()),
    "one_run": (
        lambda: _batch(np.random.default_rng(53), BM, A3, _one_run,
                       [A3] * BM),
        lambda e, n, sh: sh[1] == A3 and sh[2] > 32),
    "wide_ties": (
        lambda: _batch(np.random.default_rng(58), BM, A3, _wide_ties,
                       np.random.default_rng(59).integers(300, 513, BM)),
        lambda e, n, sh: sh[2] > 64 and (e[2] >= 0).sum() > 1000),
    "below_neg": (
        lambda: _batch(np.random.default_rng(60), BM, A3, _below_neg,
                       [A3] * 7 + [600]),
        lambda e, n, sh: (e[0][:, 6:11, 3] == 2).all()),
    "run_lengths": (
        lambda: _batch(np.random.default_rng(54), BM, A3, _run_lengths,
                       np.random.default_rng(55).integers(300, 513, BM)),
        lambda e, n, sh: sh[3] > 8 and sh[1] == 200),
    "key_tie": (m3_key_tie,
                lambda e, n, sh: (e[0][:, :, 0] == 1 << 29).any()),
    "narrow": (
        lambda: _batch(np.random.default_rng(61), BM, 100, _rand_m3_anchors,
                       [0, 50, 99, 100, 101, 60, 75, 200]),
        lambda e, n, sh: (e[1][n > 0] > 0).all()),
    "wide": (
        lambda: _batch(np.random.default_rng(62), 4, 1024, _rand_m3_anchors,
                       [0, 700, 1024, 1100]),
        lambda e, n, sh: sh[0] == 700 + 2 * 1024),
    "padded_batch": (m3_padded,
                     lambda e, n, sh: (e[1][n == 0] == 0).all()
                     and (e[1][n > 0] > 0).all()),
}


def _check(lib, kind, anc, n_anc, want):
    """Kernel (both lane orders) == JAX == eager port, tolerance 0."""
    from desamba_tpu.engine.device import chain as jc
    from desamba_tpu_torch.engine.device import chain as tc

    jax_fn, plain = ((jc.chain_kernel, tc.chain_kernel) if kind == "m2"
                     else (jc.m3_kernel, tc.m3_kernel))
    exp = [np.asarray(x) for x in jax_fn(jnp.asarray(anc),
                                         jnp.asarray(n_anc))]
    for what, e, g in zip(OUTS, exp, plain(T(anc), T(n_anc))):
        assert_same(e, g, f"eager port {what}")
    shape = chip_smoke().m3_shape(T(anc), T(n_anc)) if kind == "m3" else None
    # M3 at both block shapes the wrapper chooses from
    for block in ((None,) if kind == "m2" else M3_BLOCKS):
        for reverse in (False, True):
            got = _emulate(lib, kind, anc, n_anc, reverse, block)
            for what, e, g in zip(OUTS, exp, got):
                assert_same(e, g, f"kernel {what}, {kind} block {block}, "
                                  f"reverse={reverse}")
    assert want(exp, n_anc, shape), \
        "the case does not exercise what it is for"


@pytest.mark.parametrize("case", list(M2_CASES))
def test_m2_kernel_source_matches_jax_and_plain(chain_emu, case):
    build, want = M2_CASES[case]
    anc, n_anc = build()
    assert anc.shape[1:] == (A2, 7)
    _check(chain_emu, "m2", anc, n_anc, want)


@pytest.mark.parametrize("case", list(M3_CASES))
def test_m3_kernel_source_matches_jax_and_plain(chain_emu, case):
    build, want = M3_CASES[case]
    anc, n_anc = build()
    assert anc.shape[2] == 7 and anc.shape[1] in (A3, 100, 1024)
    _check(chain_emu, "m3", anc, n_anc, want)


def test_blocks_cover_the_wrapper():
    """The emulated block shapes are the ones the wrappers launch: M3 at 8
    warps while a batch fits one wave of them, at 4 past it."""
    from desamba_tpu_torch.engine.device import chain as tc

    assert [tc.m3_warps(B, 132) for B in (8, 512, 528, 529, 1024)] == \
        [8, 8, 8, 4, 4]
    assert {tc.m3_warps(B, s) for B in (1, 64, 4096) for s in (1, 132)} \
        == set(M3_BLOCKS)


def _probe_expected(which, threads, skip):
    """What emu_probe's kernel ``which`` writes on the card (numpy)."""
    t = np.arange(threads, dtype=np.int64)
    lane, w0 = t & 31, t - (t & 31)
    v = t * 37 - 500
    half = lane & 16
    if which == "shfl":
        r = v[w0 + ((7 * lane + 3) & 31)] * 1000 + v[w0 + half + 5]
    elif which == "shfl_up":
        r = (np.where(lane >= 3, v[np.maximum(t - 3, 0)], v) * 1000
             + np.where((lane & 7) >= 3, v[np.maximum(t - 3, 0)], v))
    elif which == "ballot":
        full = np.zeros(threads, np.int64)
        halfb = np.zeros(threads, np.int64)
        for i in range(threads):
            for j in range(w0[i], w0[i] + 32):
                full[i] |= int(v[j] % 3 == 0) << (j - w0[i])
                if (j & 16) == half[i]:
                    halfb[i] |= int(lane[j] % 5 == 1) << (j - w0[i])
        r = full ^ halfb
    elif which == "reduce":
        r = np.zeros(threads, np.int64)
        for i in range(threads):
            ws = slice(w0[i], w0[i] + 32)
            x = v[ws] ^ (lane[ws] * 977)
            u = (v[ws] * 13) & 0xFFFFFFFF
            r[i] = (x.max() + 3 * x.min() + 5 * u.max() + 7 * u.min()
                    + 11 * (v[ws].sum() & 0xFFFFFFFF))
    elif which == "half":
        r = np.zeros(threads, np.int64)
        for i in range(threads):
            hs = slice(w0[i] + half[i], w0[i] + half[i] + 16)
            r[i] = ((v[hs] * (lane[hs] % 7 - 3)).max()
                    + (0xAAAA if half[i] == 0 else 0)
                    + 100 * lane[hs].sum())
    else:                                   # sync_or
        r = np.full(threads, 2 if 0 <= skip < threads else 0)
    return ((r & 0xFFFFFFFF).astype(np.uint32)).view(np.int32)


PROBES = ("shfl", "shfl_up", "ballot", "reduce", "half", "sync_or", "skip",
          "outside")


@pytest.mark.parametrize("which", PROBES)
def test_emulator_warp_collectives(chain_emu, which):
    """block_emu.h's warp collectives give what the card gives, over the
    full warp, a half-warp mask and shuffle widths 16 and 8, two warps a
    block, in both thread orders; a lane that leaves a collective out, or
    a shuffle from a lane outside its mask, stops the run."""
    threads, k = 64, PROBES.index(which)
    for reverse in (0, 1):
        for skip in ((5, 37, -1) if which == "sync_or" else (5,)):
            out = np.zeros(threads, np.int32)
            rc = chain_emu.emu_probe(k, threads, skip, reverse,
                                     out.ctypes.data)
            if which in ("skip", "outside"):
                assert rc == 1, which
                err = chain_emu.chain_emu_error().decode()
                assert ("different collectives" in err if which == "skip"
                        else "outside its mask" in err), err
                continue
            assert rc == 0, chain_emu.chain_emu_error().decode()
            np.testing.assert_array_equal(
                out, _probe_expected(which, threads, skip),
                err_msg=f"{which} reverse={reverse} skip={skip}")


def test_m3_shared_memory_count(chain_emu):
    """The wrapper's shared-memory count is the kernel's."""
    from desamba_tpu_torch.engine.device import chain as tc

    for w in (16, 64, 512, 2048):
        assert tc.m3_smem_bytes(w) == chain_emu.m3_smem_bytes(w)


def test_dispatch_by_device():
    """CPU tensors run the eager plain versions (their ``runs`` count, no
    launch); a CUDA wrapper refuses CPU tensors and an M3 width under 16
    slots; any other device raises."""
    from desamba_tpu_torch.engine.device import chain as tc

    anc, n_anc = _batch(np.random.default_rng(5), 4, 16, _rand_anchors,
                        [0, 3, 9, 16])
    runs = tc.chain_kernel.runs, tc.m3_kernel.runs
    launches = tc.chain_kernel_cuda.launches, tc.m3_kernel_cuda.launches
    for run, plain in ((tc.run_chain_kernel, tc.chain_kernel),
                       (tc.run_m3_kernel, tc.m3_kernel)):
        for g, e in zip(run(T(anc), T(n_anc)), plain(T(anc), T(n_anc))):
            assert torch.equal(g, e)
    assert (tc.chain_kernel.runs, tc.m3_kernel.runs) == (runs[0] + 2,
                                                         runs[1] + 2)
    assert (tc.chain_kernel_cuda.launches,
            tc.m3_kernel_cuda.launches) == launches
    for fn in (tc.chain_kernel_cuda, tc.m3_kernel_cuda):
        with pytest.raises(ValueError):
            fn(T(anc), T(n_anc))
    with pytest.raises(ValueError):
        tc.m3_kernel_cuda(T(anc[:, :8]), T(n_anc))
    for run in (tc.run_chain_kernel, tc.run_m3_kernel):
        with pytest.raises(ValueError):
            run(T(anc).to("meta"), T(n_anc).to("meta"))
