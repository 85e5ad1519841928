"""The ladder calls' two ends as kernels (``kernels/ladder_pack.cu``): the
read codes' ``pack2`` before B2 and B3, and the flat anchor pack with its
info rows after them.

Both kernels' own source runs here: compiled with g++ over
``tests/cuda_host/block_emu.h`` (``tests/cuda_host/ladder_pack_emu.cpp``: a
block's threads as coroutines, in order 0..n-1 or n-1..0 between barriers
and warp collectives, blocks first to last or last to first, shared memory
poisoned before each block), each must equal the JAX package's function
(``textwalk.pack2``; ``ladder.pack_anchors`` and ``ladder.pack_info``) and
the port's plain version on seeded numpy inputs, bit for bit (tolerance 0:
everything is int32). The anchor rows past each lane's count are poisoned
(0xA5 bytes): the kernel reads none of them. Copies of the source with one
of its barriers taken out must fail.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from desamba_tpu.engine.device import ladder as jladder  # noqa: E402
from desamba_tpu.engine.device import textwalk as jtw  # noqa: E402
from desamba_tpu_torch.engine.device import ladder  # noqa: E402
from desamba_tpu_torch.engine.device import textwalk as ttw  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")
SOURCE = os.path.join(KERNELS, "ladder_pack.cu")
A_NF, A_CAP = 12, 96
POISON = np.frombuffer(b"\xa5" * 4, np.int32)[0]
# the kernel's barriers, each taken out in turn by the fault cases
BARRIERS = ("__syncthreads();  // the warps' count sums are in",
            "__syncthreads();  // the warps' scan totals are in",
            "__syncthreads();  // the bases are in",
            "__syncthreads();  // the lanes' top scores are in\n",
            "__syncthreads();  // the staged rows before are written out",
            "__syncthreads();  // the staged rows are in\n",
            "__syncthreads();  // the lanes' top scores are in, two passes",
            "__syncthreads();  // the staged rows are out, two passes",
            "__syncthreads();  // the staged rows are in, two passes")


def _build(tmp, source_dir):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernels with")
    so = str(tmp / "ladder_pack_emu.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    host, "-I", source_dir,
                    os.path.join(host, "ladder_pack_emu.cpp"), "-o", so],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.pack2_emu.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    lib.anchor_pack_emu.argtypes = ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 6)
    lib.anchor_pack_emu_blocks.argtypes = [ctypes.c_int]
    for f in (lib.pack2_emu, lib.anchor_pack_emu, lib.anchor_pack_emu_blocks,
              lib.anchor_pack_emu_threads):
        f.restype = ctypes.c_int
    lib.ladder_pack_emu_error.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """kernels/ladder_pack.cu compiled as host C++ over block_emu.h."""
    return _build(tmp_path_factory.mktemp("ladder_pack_emu"), KERNELS)


# ---- pack2 ------------------------------------------------------------

def _codes(n, L, seed, top=4):
    """(n, L) uint8 codes from a seed, values below ``top``; row 0 all 3,
    so that every whole word has char 15 = 3 (a negative int32)."""
    rng = np.random.default_rng([seed, n, L, top])
    c = rng.integers(0, top, (n, L), dtype=np.uint8)
    c[0] = 3
    return c


def _emu_pack2(lib, codes, threads, wide, reverse):
    n, L = codes.shape
    out = np.full((n, (L + 15) // 16), -7, np.int32)
    rc = lib.pack2_emu(codes.ctypes.data, out.ctypes.data, n, L,
                       out.shape[1], threads, int(wide), int(reverse))
    assert rc == 0, lib.ladder_pack_emu_error().decode()
    return out


@pytest.mark.parametrize("L", [1, 15, 16, 37, 2048],
                         ids=lambda L: f"L{L}")
def test_pack2_kernel_source_matches_jax_and_plain(emu, L):
    """pack2_kernel on the CPU, at the launcher's block and at 96 threads
    (not a divisor of the words), threads and blocks both ways, by bytes
    and (rows of whole 16-byte words) by 16-byte loads == the JAX pack2
    (its uint32 words as int32) == the port's plain version; row 0's whole
    words are negative (char 15 = 3), and codes up to 255 show the words
    are the JAX sums, which wrap."""
    for top in (4, 256):
        codes = _codes(11, L, seed=5, top=top)
        exp = np.asarray(jtw.pack2(jnp.asarray(codes))).view(np.int32)
        plain = ttw.pack2(torch.from_numpy(codes)).numpy()
        assert np.array_equal(plain, exp)
        if L >= 16 and top == 4:
            assert (exp[0, : L // 16] < 0).all()
        for threads in (256, 96):
            for wide in (False, True) if L % 16 == 0 else (False,):
                for reverse in (False, True):
                    got = _emu_pack2(emu, codes, threads, wide, reverse)
                    assert np.array_equal(got, exp), (top, threads, wide,
                                                      reverse)


def test_pack2_emulation_refuses_what_the_launcher_refuses(emu):
    """Whole 16-byte loads only where the rows are whole, aligned words;
    an output width that is not ceil(L / 16) is refused."""
    buf = np.zeros(2 * 48 + 16, np.uint8)
    base = (-buf.ctypes.data) % 16
    aligned = buf[base:base + 96].reshape(2, 48)
    out = np.zeros((2, 3), np.int32)
    assert emu.pack2_emu(aligned.ctypes.data, out.ctypes.data, 2, 48, 3,
                         64, 1, 0) == 0
    assert emu.pack2_emu(aligned.ctypes.data + 1, out.ctypes.data, 2, 47, 3,
                         64, 1, 0) == 1                  # rows not whole
    assert emu.pack2_emu(aligned.ctypes.data, out.ctypes.data, 2, 48, 4,
                         64, 0, 0) == 1                  # the wrong width
    assert b"out of range" in emu.ladder_pack_emu_error()


# ---- the anchor pack ----------------------------------------------------

def _anchor_case(name, seed=3):
    """(anchors (NB, a_cap, 12), a_cnt, flag, iv_ovf, pack_cap) of one case
    from a seed: scores (column 1) in [0, 600), the other columns over the
    whole int32 range, the rows past each lane's count poisoned; a_cap is
    the path's 96 but in "big_cap" (130: lanes of more valid rows than a
    warp holds a row a thread)."""
    rng = np.random.default_rng([seed, len(name)] + list(name.encode()))
    NB = {"one_lane": 1, "no_anchors": 64, "wide": 1000}.get(name, 301)
    a_cap = 130 if name == "big_cap" else A_CAP
    a_cnt = rng.integers(0, 12, NB).astype(np.int32)
    a_cnt[rng.random(NB) < 0.25] = 0                  # lanes with none
    a_cnt[0] = 0
    a_cnt[-1] = 5            # the last lane (past the counts' 16-byte words)
    if NB > 8:
        a_cnt[NB // 2] = 0
        a_cnt[5] = a_cap + 7                          # a_cnt past a_cap
        a_cnt[6] = a_cap
        a_cnt[7] = 97
        a_cnt[8] = 40        # alone in a block of 32: two staged halves
    anchors = rng.integers(-(1 << 31), (1 << 31) - 1, (NB, a_cap, A_NF),
                           dtype=np.int64).astype(np.int32)
    anchors[:, :, 1] = rng.integers(0, 600, (NB, a_cap))
    if name == "low_scores":
        anchors[:, :, 1] = rng.integers(-50, 35, (NB, a_cap))
    if name == "ties":
        # each lane's top score on three of its rows
        for i in range(NB):
            c = min(int(a_cnt[i]), a_cap)
            if c >= 3:
                anchors[i, :c, 1] = rng.integers(30, 200, c)
                anchors[i, rng.choice(c, 3, replace=False), 1] = 250
    if name == "no_anchors":
        a_cnt[:] = 0
    cnt = np.minimum(a_cnt, a_cap)
    for i in range(NB):
        anchors[i, cnt[i]:] = POISON
    total = int(cnt.sum())
    flag = rng.integers(0, 2, NB).astype(np.int32)
    iv_ovf = rng.integers(0, 2, NB).astype(np.int32)
    base = np.cumsum(cnt) - cnt
    k = int(np.flatnonzero(cnt >= 2)[len(np.flatnonzero(cnt >= 2)) // 2]) \
        if total else 0
    pack_cap = {
        "fits": total + 50, "low_scores": total + 3, "ties": total,
        "exact": total,
        # a lane straddles pack_cap: half of its rows below, half past
        "straddle": int(base[k] + cnt[k] // 2),
        "far_past": 2 * NB, "wide": 2 * NB, "no_anchors": 2 * NB,
        "one_lane": 2, "zero_cap": 0, "big_cap": total - 100}[name]
    return anchors, a_cnt, flag, iv_ovf, pack_cap


ANCHOR_CASES = ["fits", "exact", "straddle", "far_past", "low_scores",
                "ties", "no_anchors", "one_lane", "zero_cap", "wide",
                "big_cap"]


def _aligned(a, off=0):
    """A copy of ``a`` at ``off`` bytes past a 16-byte aligned address (the
    card's allocations are aligned)."""
    buf = np.empty(a.nbytes + 32, np.uint8)
    at = -buf.ctypes.data % 16 + off
    out = buf[at:at + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def _jax_pack(anchors, a_cnt, flag, iv_ovf, pack_cap):
    packed, base, ovf = jladder.pack_anchors(
        jnp.asarray(anchors), jnp.asarray(a_cnt), pack_cap)
    info = jladder.pack_info(base, jnp.asarray(a_cnt), jnp.asarray(flag),
                             jnp.asarray(iv_ovf))
    return np.asarray(packed), np.asarray(info), bool(ovf)


def _plain_pack(anchors, a_cnt, flag, iv_ovf, pack_cap):
    t = {k: torch.from_numpy(v) for k, v in (
        ("anchors", anchors), ("a_cnt", a_cnt), ("flag", flag),
        ("iv_ovf", iv_ovf))}
    packed, info, ovf = ladder.ladder_outputs(t, pack_cap)
    assert isinstance(ovf, bool)          # the CPU path returns a bool
    return packed.numpy(), info.numpy(), ovf


def _emu_pack(lib, anchors, a_cnt, flag, iv_ovf, pack_cap, blocks, threads,
              reverse):
    """The kernel's grid on one case, on 16-byte aligned copies of the
    anchors and counts (as the card's allocations are)."""
    NB = len(a_cnt)
    anchors, a_cnt = _aligned(anchors), _aligned(a_cnt)
    packed = np.full((pack_cap, A_NF + 1), -9, np.int32)   # all written
    info = np.full((NB, 4), -9, np.int32)
    ovf = np.full(1, 7, np.uint8)
    rc = lib.anchor_pack_emu(
        anchors.ctypes.data, a_cnt.ctypes.data, flag.ctypes.data,
        iv_ovf.ctypes.data, packed.ctypes.data, info.ctypes.data,
        ovf.ctypes.data, NB, anchors.shape[1], pack_cap, blocks, threads,
        int(reverse))
    if rc != 0:
        return None, lib.ladder_pack_emu_error().decode()
    assert ovf[0] in (0, 1)
    return (packed, info, bool(ovf[0])), None


def _grids(lib, NB):
    """The launcher's grid, and blocks of one to three warps (so a block
    holds more rows than two a thread and takes the two-pass copy), ranges
    that do not divide NB, and more blocks than lanes."""
    grids = [(lib.anchor_pack_emu_blocks(NB), lib.anchor_pack_emu_threads())]
    for blocks, threads in ((3, 64), (7, 32), (1, 96), (NB + 2, 32)):
        # at most a lane a thread
        grids.append((max(blocks, -(-NB // threads)), threads))
    return grids


@pytest.mark.parametrize("case", ANCHOR_CASES)
def test_anchor_pack_kernel_source_matches_jax_and_plain(emu, case):
    """anchor_pack_kernel on the CPU, on every grid of ``_grids`` with its
    threads and blocks both ways == the JAX pack_anchors and pack_info ==
    the port's plain versions
    (packed rows, info rows, overflow), bit for bit, on: rows that fit,
    fill pack_cap exactly, straddle it, go far past it (many lanes dropped
    whole); a_cnt past a_cap; lanes with no anchors (and a call with
    none); every score below 35; ties at a lane's top score; a one-lane
    call; a pack of no rows; 1,000 lanes (a launcher grid of 63 blocks);
    an a_cap of 130, lanes of 97 to 130 valid rows (two passes)."""
    x = _anchor_case(case)
    exp = _jax_pack(*x)
    plain = _plain_pack(*x)
    for e, p in zip(exp, plain):
        assert np.array_equal(np.asarray(e), np.asarray(p)), case
    anchors, a_cnt, _, _, pack_cap = x
    cnt = np.minimum(a_cnt, anchors.shape[1])
    assert exp[2] == (cnt.sum() > pack_cap)
    for blocks, threads in _grids(emu, len(a_cnt)):
        for reverse in (False, True):
            got, err = _emu_pack(emu, *x, blocks, threads, reverse)
            assert err is None, err
            what = f"{case}: {blocks} blocks of {threads}, reverse {reverse}"
            assert np.array_equal(got[0], exp[0]), what
            assert np.array_equal(got[1], exp[1]), what
            assert got[2] == exp[2], what
    # what the cases are for
    written = min(int(cnt.sum()), pack_cap)
    assert not exp[0][written:].any()
    if case in ("straddle", "far_past"):
        assert exp[2] and (np.cumsum(cnt) > pack_cap).sum() >= 1
    if case == "straddle":
        k = int(np.flatnonzero(np.cumsum(cnt) - cnt < pack_cap)[-1])
        assert np.cumsum(cnt)[k] > pack_cap > np.cumsum(cnt)[k] - cnt[k]
    if case == "low_scores" and written:
        assert (exp[0][:written, 12] == 1).all()
    if case == "ties":
        marks = exp[0][:written, 12]
        assert (marks == 0).sum() >= 3 and (marks == 1).any()
    if case in ("fits", "exact"):
        assert not exp[2] and (a_cnt > A_CAP).any() and (a_cnt == 0).any()
    if case == "big_cap":
        assert cnt.max() > 96 and exp[2]


@pytest.mark.parametrize("nb, blocks", [(0, 1), (1, 1), (16, 1), (17, 2),
                                        (2112, 132), (4096, 132),
                                        (8192, 128), (16384, 64),
                                        (32768, 64), (67585, 133)])
def test_anchor_pack_blocks(emu, nb, blocks):
    """The launcher's grid: a block of 512 threads for every 16 lanes (a
    lane a warp) up to one an SM of the card's 132, fewer where the
    blocks' reading of every count would pass 2^20 counts in all, and
    never fewer than a lane a thread needs; one block for no lanes."""
    assert emu.anchor_pack_emu_threads() == 512
    assert emu.anchor_pack_emu_blocks(nb) == blocks


# runs a build of the emulation on one case in a process of its own (a
# source without a barrier may write outside its arrays): argv = the
# library, the case's .npz, [[blocks, threads], ...], the output .npz
_ISOLATED = r"""
import ctypes, json, sys
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
lib.anchor_pack_emu.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
x = dict(np.load(sys.argv[2]))
buf = np.empty(x["anchors"].nbytes + 16, np.uint8)
at = -buf.ctypes.data % 16
anchors = buf[at:at + x["anchors"].nbytes].view(np.int32).reshape(
    x["anchors"].shape)
anchors[...] = x["anchors"]
x["anchors"] = anchors
buf2 = np.empty(x["a_cnt"].nbytes + 16, np.uint8)
at = -buf2.ctypes.data % 16
a_cnt = buf2[at:at + x["a_cnt"].nbytes].view(np.int32)
a_cnt[...] = x["a_cnt"]
x["a_cnt"] = a_cnt
NB, pack_cap = len(x["a_cnt"]), int(x["pack_cap"])
out = {}
for k, (blocks, threads) in enumerate(json.loads(sys.argv[3])):
    for rev in (0, 1):
        packed = np.full((pack_cap, 13), -9, np.int32)
        info = np.full((NB, 4), -9, np.int32)
        ovf = np.full(1, 7, np.uint8)
        rc = lib.anchor_pack_emu(
            *(x[n].ctypes.data for n in ("anchors", "a_cnt", "flag",
                                         "iv_ovf")),
            packed.ctypes.data, info.ctypes.data, ovf.ctypes.data, NB,
            x["anchors"].shape[1], pack_cap, blocks, threads, rev)
        out[f"rc{k}_{rev}"] = np.array(rc)
        out[f"packed{k}_{rev}"], out[f"info{k}_{rev}"] = packed, info
        out[f"ovf{k}_{rev}"] = ovf
np.savez(sys.argv[4], **out)
"""


@pytest.mark.parametrize("barrier", range(len(BARRIERS)),
                         ids=["count_sums", "scan_totals", "bases", "tops",
                              "rows_out", "rows_staged", "tops_two_passes",
                              "rows_out_two_passes",
                              "rows_staged_two_passes"])
def test_anchor_pack_without_a_barrier_fails(tmp_path, emu, barrier):
    """A copy of the source without one of its nine barriers gives another
    pack, or a run that stops or crashes, on the ``fits`` case in one of
    the grids or orders of the emulation, where the source itself is exact
    (the test above): the emulation sees each barrier."""
    src = open(SOURCE).read()
    assert src.count(BARRIERS[barrier]) == 1
    work = tmp_path / "src"
    work.mkdir()
    (work / "ladder_pack.cu").write_text(src.replace(BARRIERS[barrier], ""))
    grids = _grids(emu, len(_anchor_case("fits")[1]))
    _build(tmp_path, str(work))
    x = _anchor_case("fits")
    exp = _jax_pack(*x)
    np.savez(tmp_path / "case.npz", anchors=x[0], a_cnt=x[1], flag=x[2],
             iv_ovf=x[3], pack_cap=np.array(x[4]))
    run = subprocess.run(
        [sys.executable, "-c", _ISOLATED, str(tmp_path / "ladder_pack_emu.so"),
         str(tmp_path / "case.npz"), json.dumps(grids),
         str(tmp_path / "out.npz")], capture_output=True, timeout=300)
    differs = run.returncode != 0
    if not differs:
        got = np.load(tmp_path / "out.npz")
        for k in range(len(grids)):
            for rev in (0, 1):
                differs |= bool(
                    got[f"rc{k}_{rev}"] != 0
                    or not np.array_equal(got[f"packed{k}_{rev}"], exp[0])
                    or not np.array_equal(got[f"info{k}_{rev}"], exp[1])
                    or bool(got[f"ovf{k}_{rev}"][0]) != exp[2])
    assert differs


def test_anchor_pack_emulation_refuses_what_the_launcher_refuses(emu):
    """Anchors or counts 4 bytes past a 16-byte boundary, more lanes a
    block than threads and a negative pack_cap are refused, as the
    launcher refuses them."""
    anchors, a_cnt, flag, iv_ovf, _ = _anchor_case("one_lane")
    packed = np.zeros((2, A_NF + 1), np.int32)
    info = np.zeros((1, 4), np.int32)
    ovf = np.zeros(1, np.uint8)
    for a, c, pack_cap, blocks, threads in (
            (_aligned(anchors, 4), _aligned(a_cnt), 2, 1, 32),
            (_aligned(anchors), _aligned(a_cnt, 4), 2, 1, 32),
            (_aligned(anchors), _aligned(a_cnt), 2, 1, 16),
            (_aligned(anchors), _aligned(a_cnt), -1, 1, 32)):
        assert emu.anchor_pack_emu(
            a.ctypes.data, c.ctypes.data, flag.ctypes.data,
            iv_ovf.ctypes.data, packed.ctypes.data, info.ctypes.data,
            ovf.ctypes.data, 1, A_CAP, pack_cap, blocks, threads, 0) == 1
        assert b"out of range" in emu.ladder_pack_emu_error()
    many = _anchor_case("fits")
    assert emu.anchor_pack_emu(
        _aligned(many[0]).ctypes.data, _aligned(many[1]).ctypes.data,
        *(v.ctypes.data for v in many[2:4]),
        np.zeros((many[4], A_NF + 1), np.int32).ctypes.data,
        np.zeros((301, 4), np.int32).ctypes.data, ovf.ctypes.data, 301,
        A_CAP, many[4], 2, 64, 0) == 1           # 151 lanes a block of 64
    assert not packed.any() and not info.any()


def test_wrappers_take_cuda_tensors_only():
    """On the CPU the ladders' ends are the plain versions (the overflow a
    bool); the kernels' wrappers refuse a CPU tensor rather than fall
    back."""
    codes = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        ladder.pack2_cuda(codes)
    x = [torch.from_numpy(v) for v in _anchor_case("one_lane")[:4]]
    with pytest.raises(ValueError, match="CUDA"):
        ladder.anchor_pack_cuda(*x, 2)
    assert ladder.pack2_cuda.launches == 0
    assert ladder.anchor_pack_cuda.launches == 0
