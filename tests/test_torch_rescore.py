"""The rescore kernel's plain version (rescore_ref) == the JAX Pallas kernel
(rescore_pl, interpret mode) on RescoreIn batches captured by spying on
``DeviceClassifier._k_rescore``, the way tests/test_rescore_pl.py captures
them (here the port's classifier on the CPU, which builds the batches
exactly as the JAX classifier does).

Chains, fallback flags, reason bits and step counts must be equal on every
row with n_chains > 0: mid-reference reads and reads in the last packed
reference row (main batch, 64 anchors), and the M3 sub-batch of the repeat
corpus (chain.M3_A2 = 512 anchors). The CUDA kernel's own source is also
run on the CPU against the plain version on those batches and on two whose
9-mer tables are too wide for the least fence stride: the mid-reference
batch widened to a 250-kb read's buffer, and a batch that holds a 250-kb
read with a chain."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_repeat_paths import (  # noqa: E402,F401
    repeat_genome,
    repeat_my_index,
    repeat_reads,
)
from test_rescore_pl import _Rec, _reads_from  # noqa: E402
from test_torch_stages import T, assert_same, port_index  # noqa: E402


def _capture(idx, recs):
    """Every RescoreIn (as numpy) the port's classifier hands its rescore:
    the main batch and the M3 sub-batch."""
    from desamba_tpu_torch.engine.device.classifier import DeviceClassifier
    from desamba_tpu_torch.engine.gold.classify import Options

    eng = DeviceClassifier(port_index(idx), Options(), "cpu")
    got = []
    orig = eng._k_rescore

    def spy(inp):
        got.append([f.numpy() for f in inp])
        return orig(inp)

    eng._k_rescore = spy
    list(eng.classify_reads(recs))
    return got


def _mid_reads(idx):
    """The reads of test_rescore_pl_matches_vm (same seed, same spans)."""
    rng = np.random.default_rng(11)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    spans = [(int(rng.integers(0, total - ln)), ln)
             for ln in rng.integers(250, 900, size=10)]
    return [_Rec(i, r) for i, r in enumerate(_reads_from(idx, spans, rng))]


def _tail_reads(idx):
    """Reads inside and across the last 2048-char packed reference row
    (the reads of test_rescore_pl_tail_of_reference)."""
    rng = np.random.default_rng(12)
    total = int(idx.ref_off[-1] + idx.ref_len[-1])
    spans = []
    for ln in (300, 400, 500, 600):
        spans.append((total - ln - 5, ln))
        spans.append((total - 2048 - ln // 2, ln))
    return [_Rec(i, r)
            for i, r in enumerate(_reads_from(idx, spans, rng, err=0.05))]


LONG_READ = 250_000      # bases of the long read (an ultra-long ONT read)
LONG_ROW = 10            # its row: after the ten mid-reference reads
ROWS_KEPT = 16           # rows of a long batch the tests run (all reads)


def _long_reads(idx):
    """The mid-reference reads and a 250-kb read: a 2-kb span of the
    reference with 5 % errors inside random sequence, so that its row has a
    chain and its batch's 9-mer tables are 250,880 wide."""
    rng = np.random.default_rng(13)
    seg = _reads_from(idx, [(5000, 2000)], rng, err=0.05)[0]
    fill = rng.integers(0, 4, LONG_READ - len(seg)).astype(np.uint8)
    read = np.concatenate([fill[:120_000], seg, fill[120_000:]])
    return _mid_reads(idx) + [_Rec(LONG_ROW, read)]


def table_width(read_len):
    """K, the 9-mer table width of a batch whose longest read has
    ``read_len`` bases: half its F+R buffer width, which the classifier
    rounds up to 2,048."""
    return -(-2 * read_len // 2048) * 2048 // 2


def _widen(inp, K):
    """The batch with its F+R read buffers zero-padded to 2K columns, as the
    classifier pads them when another read of the batch is longer."""
    codes = np.zeros((inp[5].shape[0], 2 * K), inp[5].dtype)
    codes[:, : inp[5].shape[1]] = inp[5]
    return inp[:5] + [codes] + inp[6:]


@pytest.fixture(scope="module")
def batches(small_my_index, repeat_my_index, repeat_reads):
    """{case: (index, first RescoreIn)}: the main batch of the
    mid-reference reads and of the tail reads, the M3 sub-batch of the
    repeat corpus, and two batches at a 250-kb read's table width (the
    first ROWS_KEPT rows, which hold every read): the mid-reference batch
    widened, and the main batch of the mid-reference reads with a 250-kb
    read."""
    from desamba_tpu.io.fastx import read_fastx

    out = {}
    for name, recs in (("mid_reference", _mid_reads(small_my_index)),
                       ("tail_of_reference", _tail_reads(small_my_index)),
                       ("long_read", _long_reads(small_my_index))):
        out[name] = (small_my_index, _capture(small_my_index, recs)[0])
    got = _capture(repeat_my_index, list(read_fastx(str(repeat_reads[0]))))
    wide = [g for g in got if g[2].shape[1] == 512]
    assert wide, "the repeat corpus never reached the M3 sub-batch"
    out["m3_width_512"] = (repeat_my_index, wide[0])
    out["long_read"] = (small_my_index,
                        [f[:ROWS_KEPT] for f in out["long_read"][1]])
    out["mid_reference_widened"] = (small_my_index, _widen(
        [f[:ROWS_KEPT] for f in out["mid_reference"][1]],
        table_width(LONG_READ)))
    return out


@pytest.mark.parametrize("case", ["mid_reference", "tail_of_reference",
                                  "m3_width_512"])
def test_rescore_ref_matches_pallas(batches, case):
    import desamba_tpu.engine.device.rescore as dr
    import desamba_tpu.engine.device.rescore_pl as drp
    from desamba_tpu.engine.device.arrays import DeviceIndex as JDix
    from desamba_tpu_torch.engine.device import rescore as tr
    from desamba_tpu_torch.engine.device import rescore_pl as trp
    from desamba_tpu_torch.engine.device.arrays import DeviceIndex

    idx, inp = batches[case]
    rows = np.flatnonzero(inp[1] > 0)
    assert len(rows) >= (1 if case == "m3_width_512" else 4), case
    sub = [f[rows] for f in inp]
    jd = JDix.build(idx)
    exp = drp.rescore_pl(dr.RescoreIn(*[jnp.asarray(f) for f in sub]),
                         jd.ref_pk, jd.ref_off, jd.ref_len_arr,
                         n_bases=jd.n_bases, interpret=True)
    tix = DeviceIndex.build(idx, "cpu")
    got = trp.rescore(tr.RescoreIn(*[T(f) for f in sub]),
                      trp.ref_words(tix.ref_pk), tix.ref_off,
                      tix.ref_len_arr, tix.n_bases)
    for what, e, g in zip(("chains", "fallback", "reason", "steps"), exp,
                          got):
        assert_same(e, g, f"{case} {what}")
    assert (~np.asarray(exp[1])).sum() >= 1, "every row fell back"
    if case == "m3_width_512":
        assert sub[2].shape[1] == 512


def test_sorted_9mer_tables_match_jax(batches):
    """The kernel's value-sorted per-direction 9-mer tables (stable sort,
    ties by ascending position) equal the JAX prep's."""
    from desamba_tpu.engine.device.rescore_pl import _build_sorted_rk as jb
    from desamba_tpu_torch.engine.device.rescore_pl import _build_sorted_rk

    _idx, inp = batches["mid_reference"]
    codes_fr, read_len = inp[5], inp[7]
    ev, ep, _coarse = jb(jnp.asarray(codes_fr), jnp.asarray(read_len))
    gv, gp = _build_sorted_rk(T(codes_fr), T(read_len))
    assert_same(ev, gv, "sorted 9-mer values")
    assert_same(ep, gp, "sorted 9-mer positions")
    assert gv.dtype == gp.dtype == torch.int32


# ---- the CUDA kernel's own source, run on the CPU ----------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = os.path.join(HERE, "..", "desamba_tpu_torch", "kernels")
EMU_ARGS = ("p" * 12) + ("i" * 9)


@pytest.fixture(scope="module")
def rescore_emu(tmp_path_factory):
    """kernels/rescore.cu compiled as host C++ over tests/cuda_host/warp_emu.h
    (each warp's 32 lanes as coroutines, collectives emulated), loaded with
    ctypes."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to emulate the kernel with")
    so = str(tmp_path_factory.mktemp("rescore_emu") / "rescore_emu.so")
    host = os.path.join(HERE, "cuda_host")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", host,
                    "-I", KERNELS, os.path.join(host, "rescore_emu.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.rescore_emulate.argtypes = [
        ctypes.c_void_p if c == "p" else ctypes.c_int for c in EMU_ARGS]
    lib.rescore_emulate.restype = ctypes.c_int
    lib.rescore_emu_error.restype = ctypes.c_char_p
    for fn in (lib.rescore_smem_bytes, lib.rescore_fence_stride):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def _prep(idx, inp):
    from desamba_tpu_torch.engine.device import rescore as tr
    from desamba_tpu_torch.engine.device import rescore_pl as trp
    from desamba_tpu_torch.engine.device.arrays import DeviceIndex

    tix = DeviceIndex.build(idx, "cpu")
    prep = trp.prepare(tr.RescoreIn(*[T(f) for f in inp]),
                       trp.ref_words(tix.ref_pk), tix.ref_off,
                       tix.ref_len_arr, tix.n_bases)
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in prep.items()}


def _emulate(lib, host, reverse):
    """The kernel's grid on the CPU: (chains, flags) as numpy int32."""
    B, A2, _ = host["anchors"].shape
    chains = np.full((B, 8, 10), -7, np.int32)     # every word is written
    flags = np.full((B, 3), -7, np.int32)
    arrs = [np.ascontiguousarray(host[k], dtype=np.int32) for k in (
        "scal", "chains", "anchors", "schash", "codes_pk", "rk_vals",
        "rk_pos", "ref_words", "ref_off", "ref_len")]
    rc = lib.rescore_emulate(
        *[a.ctypes.data for a in arrs], chains.ctypes.data, flags.ctypes.data,
        B, A2, host["codes_pk"].shape[1], host["rk_vals"].shape[2],
        host["ref_words"].shape[0] // 128, host["ref_off"].shape[0],
        host["n_bases"], host["last_char"], int(reverse))
    assert rc == 0, lib.rescore_emu_error().decode()
    return chains, flags


@pytest.mark.parametrize("reverse", [False, True], ids=["lanes_up",
                                                         "lanes_down"])
@pytest.mark.parametrize("case", ["mid_reference", "tail_of_reference",
                                  "m3_width_512", "mid_reference_widened",
                                  "long_read"])
def test_warp_kernel_source_matches_plain(batches, rescore_emu, case,
                                          reverse):
    """kernels/rescore.cu itself (one warp per read, state in shared memory)
    on every row of the captured batch, rows without chains included, run on
    the CPU with its lanes taken in one order and then the other between
    collectives: chains and all three flag columns equal the plain
    version's. A missing __syncwarp shows in one of the two orders. The two
    batches at a 250-kb read's width run with the fence stride doubled (the
    least one would not fit a block)."""
    from desamba_tpu_torch.engine.device import rescore_pl as trp
    from desamba_tpu_torch.engine.device import rescore_ref

    idx, inp = batches[case]
    host = _prep(idx, inp)
    A2, K = host["anchors"].shape[1], host["rk_vals"].shape[2]
    stride = trp.fence_stride(A2, K)
    assert stride == rescore_emu.rescore_fence_stride(A2, K)
    if case in ("mid_reference_widened", "long_read"):
        assert K == table_width(LONG_READ) and stride == 2 * trp.FENCE
    else:
        assert stride == trp.FENCE
    if case == "long_read":
        assert host["scal"][LONG_ROW, 2] == LONG_READ
        assert host["scal"][LONG_ROW, 0] > 0, "the long read has no chain"
    exp_c, exp_f = rescore_ref.rescore_rows(host)
    got_c, got_f = _emulate(rescore_emu, host, reverse)
    rows = np.flatnonzero(host["scal"][:, 0] > 0)
    assert len(rows) >= 1, "the batch should hold rows with chains"
    if case != "m3_width_512":
        assert len(rows) < len(host["scal"]), "and rows without"
    np.testing.assert_array_equal(got_c, exp_c, err_msg=f"{case} chains")
    np.testing.assert_array_equal(got_f, exp_f, err_msg=f"{case} flags")
    assert exp_f[rows, 2].min() > 0, "a row with chains took no step"


def test_kernel_shared_memory_fits_and_is_sized_alike(batches, rescore_emu):
    """smem_bytes and fence_stride (the wrapper's) equal the kernel's own
    at both anchor widths, at today's widths and the fixtures' widest table
    and at a 250-kb, a 1-Mb and a 4-Mb read's: the block stays within 227
    KB at any read length (the fence stride grows with K), today's widths
    keep the least stride, and only a shape with too many anchors for any
    stride raises, before anything is launched."""
    from desamba_tpu_torch.engine.device import rescore_pl as trp

    widest = max(inp[5].shape[1] // 2 for _idx, inp in batches.values())
    long_widths = [table_width(n) for n in (250_000, 1_000_000, 4_000_000)]
    for A2 in (64, 512):
        for K in [1024, 11264, widest] + long_widths:
            n = trp.smem_bytes(A2, K)
            stride = trp.fence_stride(A2, K)
            assert n == rescore_emu.rescore_smem_bytes(A2, K), (A2, K)
            assert stride == rescore_emu.rescore_fence_stride(A2, K), (A2, K)
            assert n % 16 == 0 and n <= trp.SMEM_MAX == 227 * 1024, (A2, K)
            assert (stride == trp.FENCE) == (K <= 11264), (A2, K)
        # the least stride that fits: half of it would not
        for K in long_widths:
            stride = trp.fence_stride(A2, K)
            assert trp.WARPS_PER_BLOCK * 4 * trp._region_words(
                A2, K, stride // 2) > trp.SMEM_MAX, (A2, K)
    assert trp.fence_stride(64, table_width(4_000_000)) == 1024
    assert trp.smem_bytes(512, 11264) > 48 * 1024   # needs the opt-in
    with pytest.raises(ValueError, match="shared memory"):
        trp.smem_bytes(16384, 1024)
    idx, inp = batches["mid_reference"]
    host = _prep(idx, inp)
    prep = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in host.items()}
    wide = dict(prep, anchors=torch.zeros((2, 16384, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        trp.rescore_cuda(wide)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trp.rescore_cuda(prep)
