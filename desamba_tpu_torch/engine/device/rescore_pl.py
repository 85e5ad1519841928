"""Per-read 9-mer sparse-DP rescore: the kernel's prep and its wrapper.

Counterpart of ``desamba_tpu/engine/device/rescore_pl.py``. The Pallas
kernel there (``rescore_kernel_pl``) becomes the hand-written CUDA kernel
``kernels/rescore.cu``; its plain version is ``rescore_ref.py``. This
module holds what runs outside the kernel: the value-sorted per-direction
9-mer tables (``_build_sorted_rk``, a stable sort), the packed read and
reference words, and ``rescore``, which launches the kernel for CUDA
tensors and runs the plain version only for CPU tensors.
"""
from __future__ import annotations

import torch

from .intops import I32, I64
from .rescore import C_CAP, CF_N, K9, S_CAP, RescoreIn, _pack2
from . import rescore_ref

INT32_MAX = (1 << 31) - 1
LANES = 128
HASH_CAP = 2 * C_CAP          # combine-hash entries per read
WARPS_PER_BLOCK = 4           # reads per block of the kernel (one warp each)
FENCE = 32                    # least fence stride of the sorted 9-mer tables
SMEM_MAX = 232448             # shared memory one block may use (227 KB)


def _build_sorted_rk(codes_fr, read_len):
    """Value-sorted per-(read, direction) 9-mer tables.

    Returns (vals, pos), each (B, 2, K) int32 with K = width // 2; axis 1
    is indexed by direction value (0 = REVERSE strand at [rl:2rl],
    1 = FORWARD at [0:rl]). Invalid tails sort last as INT32_MAX; ties keep
    ascending position (stable sort)."""
    B, L2 = codes_fr.shape
    K = L2 // 2
    n_k_full = L2 - K9 + 1
    c64 = codes_fr.to(I64)
    vals_full = torch.zeros((B, n_k_full), dtype=I64, device=codes_fr.device)
    for j in range(K9):
        vals_full = vals_full | (c64[:, j : j + n_k_full] << (2 * (K9 - 1 - j)))
    vals_full = vals_full.to(I32)
    ar = torch.arange(K, dtype=I32, device=codes_fr.device)[None, :]
    valid = ar < (read_len - K9 + 1).clamp(min=0)[:, None]
    rev_idx = (read_len[:, None] + ar).clamp(0, n_k_full - 1).long()
    fwd = torch.where(valid, vals_full[:, :K], INT32_MAX)
    rev = torch.where(valid, torch.gather(vals_full, 1, rev_idx), INT32_MAX)
    sf = torch.sort(fwd, dim=1, stable=True)
    sr = torch.sort(rev, dim=1, stable=True)
    vals = torch.stack([sr.values, sf.values], dim=1).contiguous()
    pos = torch.stack([sr.indices, sf.indices], dim=1).to(I32).contiguous()
    return vals, pos


def ref_words(ref_pk):
    """Packed reference words (16 chars each) as one flat int32 tensor,
    padded to whole 128-word rows plus ONE zero row, so a two-row window
    read starting in the last data row stays in range."""
    rw = ref_pk.reshape(-1)
    pad = (-rw.shape[0]) % LANES
    return torch.cat([rw, torch.zeros(pad + LANES, dtype=rw.dtype,
                                      device=rw.device)]).contiguous()


def last_char(words, n_bases: int) -> int:
    w = int(words[(n_bases - 1) >> 4]) & 0xFFFFFFFF
    return (w >> (2 * ((n_bases - 1) & 15))) & 3


def prepare(inp: RescoreIn, words, ref_off, ref_len_arr, n_bases: int):
    """Everything the kernel reads, as contiguous int32 tensors on the
    inputs' device (plus the scalar geometry)."""
    vals, pos = _build_sorted_rk(inp.codes_fr, inp.read_len)
    return dict(
        scal=torch.stack([inp.n_chains, inp.n_hash, inp.read_len,
                          inp.buf_len], dim=1).to(I32).contiguous(),
        chains=inp.chains.to(I32).contiguous(),
        anchors=inp.anchors.to(I32).contiguous(),
        schash=inp.schash.to(I32).contiguous(),
        codes_pk=_pack2(inp.codes_fr).contiguous(),
        rk_vals=vals, rk_pos=pos, ref_words=words,
        ref_off=ref_off.to(I32).contiguous(),
        ref_len=ref_len_arr.to(I32).contiguous(),
        n_bases=int(n_bases), last_char=last_char(words, n_bases))


def rescore_plain(prep, rows=None):
    """The plain version on a prepared batch (any device; runs on the
    host). Returns (chains, flags) int32 tensors on the CPU."""
    host = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in prep.items()}
    chains, flags = rescore_ref.rescore_rows(host, rows)
    return torch.from_numpy(chains), torch.from_numpy(flags)


def _region_words(A2: int, K: int, stride: int) -> int:
    """One warp's shared-memory words at fence stride ``stride``: its read's
    chains, combine-hash entries, sms slots, window, A2 anchor records and
    the fence tables of both directions (every stride-th of K sorted
    values), rounded up to 4 words (``region_words`` in
    ``kernels/rescore.cu``)."""
    words = (C_CAP * CF_N + 10 * HASH_CAP + 4 * S_CAP + LANES + 4 * A2
             + 2 * -(-K // stride))
    return -(-words // 4) * 4


def fence_stride(A2: int, K: int) -> int:
    """The kernel's fence stride for a batch: FENCE * 2^j for the least j
    whose block of WARPS_PER_BLOCK regions fits the card's 227 KB, or the
    stride that leaves one fence a direction if none does
    (``fence_shift`` in ``kernels/rescore.cu``). FENCE up to K ~ 214,000
    at 64 anchors and ~185,000 at 512; longer reads double it."""
    stride = FENCE
    while (stride < K and WARPS_PER_BLOCK * 4 * _region_words(A2, K, stride)
           > SMEM_MAX):
        stride *= 2
    return stride


def smem_bytes(A2: int, K: int) -> int:
    """Dynamic shared memory of one block of the kernel: WARPS_PER_BLOCK
    warps' regions at the batch's ``fence_stride`` (the kernel's
    ``rescore_smem_bytes``). Raises ValueError on a shape whose block would
    not fit the card's 227 KB even with one fence a direction (too many
    anchors)."""
    if A2 <= 0 or K <= 0:
        raise ValueError(f"rescore kernel: anchors {A2} and table width {K} "
                         f"must be positive")
    nbytes = WARPS_PER_BLOCK * 4 * _region_words(A2, K, fence_stride(A2, K))
    if nbytes > SMEM_MAX:
        raise ValueError(f"rescore kernel: {A2} anchors and a {K}-wide 9-mer "
                         f"table need {nbytes} bytes of shared memory per "
                         f"block, more than the card's {SMEM_MAX}")
    return nbytes


def rescore_cuda(prep):
    """Launch the CUDA kernel on a prepared batch of CUDA tensors.
    Returns (chains (B, C_CAP, CF_N), flags (B, 3)) int32 on the card."""
    from ...kernels.build import LAUNCH_LOCK, rescore_lib

    B, A2, af = prep["anchors"].shape
    if af != 4 or prep["chains"].shape[1:] != (C_CAP, CF_N):
        raise ValueError("rescore kernel: bad chain or anchor record shape")
    if prep["schash"].shape[1:] != (HASH_CAP, 3):
        raise ValueError("rescore kernel: schash must be (B, 16, 3)")
    K = prep["rk_vals"].shape[2]
    nbytes = smem_bytes(A2, K)
    dev = prep["scal"].device
    for k in ("scal", "chains", "anchors", "schash", "codes_pk", "rk_vals",
              "rk_pos", "ref_words", "ref_off", "ref_len"):
        t = prep[k]
        if t.device.type != "cuda" or t.dtype != I32 or not t.is_contiguous():
            raise ValueError(f"rescore kernel: {k} must be a contiguous "
                             f"int32 CUDA tensor")
        if t.device != dev:
            raise ValueError(f"rescore kernel: {k} is on {t.device}, the "
                             f"batch on {dev}")
    chains_out = torch.empty((B, C_CAP, CF_N), dtype=I32, device=dev)
    flags = torch.empty((B, 3), dtype=I32, device=dev)
    lib = rescore_lib()
    with LAUNCH_LOCK:
        rc = lib.rescore_launch(
            prep["scal"].data_ptr(), prep["chains"].data_ptr(),
            prep["anchors"].data_ptr(), prep["schash"].data_ptr(),
            prep["codes_pk"].data_ptr(), prep["rk_vals"].data_ptr(),
            prep["rk_pos"].data_ptr(), prep["ref_words"].data_ptr(),
            prep["ref_off"].data_ptr(), prep["ref_len"].data_ptr(),
            chains_out.data_ptr(), flags.data_ptr(),
            B, A2, prep["codes_pk"].shape[1], K,
            prep["ref_words"].shape[0] // LANES, prep["ref_off"].shape[0],
            prep["n_bases"], prep["last_char"], nbytes, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rescore kernel launch failed: CUDA error "
                               f"{rc}")
        rescore_cuda.launches += 1
    return chains_out, flags


rescore_cuda.launches = 0


def rescore(inp: RescoreIn, words, ref_off, ref_len_arr, n_bases: int):
    """Rescore every read of ``inp``: (chains, fallback, reason, iters).

    CUDA inputs launch the kernel; CPU inputs run the plain version. There
    is no other path: a CUDA launch that fails raises."""
    prep = prepare(inp, words, ref_off, ref_len_arr, n_bases)
    if inp.n_chains.device.type == "cuda":
        chains, flags = rescore_cuda(prep)
    elif inp.n_chains.device.type == "cpu":
        chains, flags = rescore_plain(prep)
    else:
        raise ValueError(f"unsupported device {inp.n_chains.device}")
    return chains, flags[:, 0] != 0, flags[:, 1], flags[:, 2]
