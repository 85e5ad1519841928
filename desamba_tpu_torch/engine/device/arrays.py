"""DeviceIndex: device-resident gather tables derived from IndexData.

Counterpart of ``desamba_tpu/engine/device/arrays.py``: the same fields,
built by the same numpy construction, held as torch tensors on an
explicit device. uint32 tables travel as int32 bit patterns (package
docstring); ``hash13`` holds 2^26+1 of them (256 MB).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 32  # rows per rank checkpoint

# fields held as tensors, in the JAX DeviceIndex's order
TENSOR_FIELDS = (
    "fm_blocks", "lf", "lfc", "row_char", "row_pos", "hash13", "rank",
    "ekmer0", "ekmer1", "uni_start", "uni_len", "uni_ref_list",
    "rp_global_off", "rp_ref_id", "ref_off", "ref_len_arr", "ref_bin",
    "q_mem", "q_lv", "ref_pk", "text_pk", "sep_any", "sep_hash",
    "samp_bits", "isa", "pos2uni")
SCALAR_FIELDS = ("n_rows", "dollar_pos", "len_e_kmer", "single_base_max",
                 "mask_bits", "text_len", "n_uni", "n_bases")


def _to_tensor(a, device):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)          # u32 -> int32 bit pattern
    elif a.dtype == np.uint64 or a.dtype == np.int64:
        a = a.astype(np.int32)
    if not a.flags.writeable:
        a = a.copy()    # the tensor may be updated; never alias read-only
    return torch.from_numpy(a).to(device)


def build_arrays(idx) -> dict:
    """The numpy construction of the JAX ``DeviceIndex.build``: every field
    as a numpy array (uint32 where the JAX field is uint32) plus the
    scalar geometry."""
    chars = idx.row_char
    n = len(chars)
    n_blocks = (n + BLOCK - 1) // BLOCK
    blocks = np.zeros((n_blocks, 9), dtype=np.uint32)
    counts = np.zeros((5, n + 1), dtype=np.int64)
    for c in range(5):
        np.cumsum(chars == c, out=counts[c, 1:])
    for c in range(5):
        blocks[:, c] = counts[c, : n_blocks * BLOCK : BLOCK].astype(np.uint32)
    padded = np.concatenate(
        [chars, np.full(n_blocks * BLOCK - n, 0xF, dtype=np.uint8)])
    nib = padded.reshape(n_blocks, 4, 8).astype(np.uint32)
    words = np.zeros((n_blocks, 4), dtype=np.uint32)
    for k in range(8):
        words |= nib[:, :, k] << np.uint32(4 * k)
    blocks[:, 5:9] = words

    rank = (idx.rank.astype(np.uint64) & 0xFFFFFFFF).astype(np.uint32)
    # LF for each row's own char ('$' rows step to dollar_pos + rank[5])
    cidx = np.minimum(chars, 4).astype(np.int64)
    lf = counts[cidx, np.arange(n)] + idx.rank[cidx]
    lf[chars == 5] = idx.dollar_pos + idx.rank[5]
    from ..gold.mapq import mapq_tables

    q_mem, q_lv = mapq_tables(len(idx.ref_bin) * 4)
    if n >= (1 << 28):
        raise ValueError("lfc packing needs n_rows < 2^28")

    # position-space walk tables: row_pos is a full SA (bijection)
    L = int(idx.text_len)
    if L != n:
        raise ValueError("full-SA position tables need n_rows == text_len")
    pos = idx.row_pos.astype(np.int64)
    text = np.zeros(L, np.uint8)
    text[(pos - 1) % L] = chars
    isa = np.zeros(L, np.int32)
    isa[pos] = np.arange(n, dtype=np.int32)

    def bitmap32(mask):
        W = (L + 31) // 32
        m = np.zeros(W * 32, np.uint32)
        m[:L] = mask
        return (m.reshape(W, 32)
                << np.arange(32, dtype=np.uint32)[None, :]).sum(
                    axis=1, dtype=np.uint32)

    def pack16(ch):
        Wp = (len(ch) + 15) // 16
        tp = np.zeros(Wp * 16, np.uint32)
        tp[: len(ch)] = ch
        return (tp.reshape(Wp, 16)
                << (np.arange(16, dtype=np.uint32) * 2)[None, :]).sum(
                    axis=1, dtype=np.uint32)[None, :]

    rb = idx.ref_bin
    ref_chars = np.empty(len(rb) * 4, np.uint8)
    for j, sh in enumerate((6, 4, 2, 0)):
        ref_chars[j::4] = (rb >> sh) & 3
    ref_pk = pack16(ref_chars)
    del ref_chars
    bounds = np.concatenate([
        [0], idx.uni_start[1 : idx.n_uni + 1].astype(np.int64), [L]])
    pos2uni = np.repeat(np.arange(idx.n_uni + 1, dtype=np.int32),
                        np.diff(bounds))
    lf32 = lf.astype(np.uint32)
    return dict(
        fm_blocks=blocks, lf=lf32,
        lfc=(lf32 << 3) | chars.astype(np.uint32),
        row_char=chars, row_pos=idx.row_pos.astype(np.int32),
        hash13=idx.hash13.astype(np.uint32), rank=rank,
        ekmer0=idx.ekmer0, ekmer1=idx.ekmer1,
        uni_start=idx.uni_start[: idx.n_uni + 1].astype(np.int32),
        uni_len=idx.uni_len[: idx.n_uni + 1].astype(np.int32),
        uni_ref_list=idx.uni_ref_list[: idx.n_uni + 1].astype(np.int32),
        rp_global_off=idx.rp_global_off.astype(np.int32),
        rp_ref_id=idx.rp_ref_id.astype(np.int32),
        ref_off=idx.ref_off.astype(np.int32),
        ref_len_arr=idx.ref_len.astype(np.int32),
        ref_bin=idx.ref_bin,
        q_mem=q_mem.astype(np.int32), q_lv=q_lv.astype(np.int32),
        ref_pk=ref_pk, text_pk=pack16(text & 3),
        sep_any=bitmap32(text >= 4), sep_hash=bitmap32(text == 4),
        samp_bits=bitmap32(isa % 8 == 0), isa=isa, pos2uni=pos2uni,
        n_rows=n, dollar_pos=int(idx.dollar_pos),
        len_e_kmer=int(idx.len_e_kmer),
        single_base_max=int(idx.single_base_max),
        mask_bits=int(idx.e_hash_mask).bit_length(),
        text_len=L, n_uni=int(idx.n_uni), n_bases=len(idx.ref_bin) * 4)


@dataclasses.dataclass
class DeviceIndex:
    fm_blocks: torch.Tensor   # (n_blocks, 9) u32 bits
    lf: torch.Tensor          # (n_rows,) u32 bits
    lfc: torch.Tensor         # (n_rows,) u32 bits: (lf << 3) | char
    row_char: torch.Tensor    # (n_rows,) uint8
    row_pos: torch.Tensor     # (n_rows,) int32
    hash13: torch.Tensor      # (2^26+1,) u32 bits
    rank: torch.Tensor        # (6,) u32 bits
    ekmer0: torch.Tensor      # uint8 existence bit tables
    ekmer1: torch.Tensor
    uni_start: torch.Tensor   # (n_uni + 1,) int32
    uni_len: torch.Tensor     # (n_uni + 1,) int32
    uni_ref_list: torch.Tensor  # (n_uni + 1,) int32 CSR into rp_*
    rp_global_off: torch.Tensor  # (n_occ,) int32
    rp_ref_id: torch.Tensor   # (n_occ,) int32
    ref_off: torch.Tensor     # (n_ref,) int32
    ref_len_arr: torch.Tensor  # (n_ref,) int32
    ref_bin: torch.Tensor     # packed 2-bit reference, uint8
    q_mem: torch.Tensor       # (Q_MEM_MAX,) int32
    q_lv: torch.Tensor        # (20, 20) int32
    ref_pk: torch.Tensor      # (1, ceil(n_bases/16)) u32 bits
    text_pk: torch.Tensor     # (1, ceil(L/16)) u32 bits
    sep_any: torch.Tensor     # (ceil(L/32),) u32 bits: text[q] >= 4
    sep_hash: torch.Tensor    # (ceil(L/32),) u32 bits: text[q] == '#'
    samp_bits: torch.Tensor   # (ceil(L/32),) u32 bits: isa[q] % 8 == 0
    isa: torch.Tensor         # (L,) int32
    pos2uni: torch.Tensor     # (L,) int32
    n_rows: int
    dollar_pos: int
    len_e_kmer: int
    single_base_max: int
    mask_bits: int
    text_len: int
    n_uni: int
    n_bases: int
    device: torch.device

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "DeviceIndex":
        """From the JAX DeviceIndex fields as numpy arrays (plus the scalar
        geometry): the state both packages share, so tests can run them
        on one index."""
        device = torch.device(device)
        kw = {f: _to_tensor(arrays[f], device) for f in TENSOR_FIELDS}
        kw.update({f: int(arrays[f]) for f in SCALAR_FIELDS})
        return cls(**kw, device=device)

    @classmethod
    def build(cls, idx, device) -> "DeviceIndex":
        return cls.from_arrays(build_arrays(idx), device)

    def index_refs(self):
        from .mapseed import IndexRefs

        return IndexRefs(
            lf=self.lf, lfc=self.lfc, row_char=self.row_char,
            row_pos=self.row_pos, uni_start=self.uni_start,
            uni_len=self.uni_len, uni_ref_list=self.uni_ref_list,
            rp_global_off=self.rp_global_off, rp_ref_id=self.rp_ref_id,
            ref_off=self.ref_off, ref_bin=self.ref_bin, ref_pk=self.ref_pk,
            text_pk=self.text_pk, sep_any=self.sep_any,
            sep_hash=self.sep_hash, samp_bits=self.samp_bits,
            isa=self.isa, pos2uni=self.pos2uni, text_len=self.text_len,
            n_uni=self.n_uni, n_bases=self.n_bases)
