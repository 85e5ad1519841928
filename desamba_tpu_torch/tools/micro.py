"""Primitive benches: what a gather, dynamic-offset row loads, a block, an
asynchronous copy and a launch cost on the card.

    python -m desamba_tpu_torch.tools.micro [which] [--device cuda]

Counterpart of ``tools/pallas_micro.py``, ``tools/pallas_micro3.py`` and
``tools/pallas_micro2.py`` in one entry point; ``which`` is ``micro``,
``micro3``, ``micro2`` (one tool's sites) or ``all`` (default). Each of the
16 sites is one Pallas kernel of those tools, computed here by a kernel of
``kernels/micro.cu``; it prints one line: milliseconds per call and ns per
unit (a gathered row or element, a loop trip, a block, a copy; where the
kernel spreads the trips over the card, as for the copy and scalar loops,
K6.2's and K6.3's gathers and K5.c's chain, the call's time over its
trips), or, for the dynamic-slice sites, a throughput (trips and bytes of
summed rows per second).

  micro    K4.1 row gather, K4.2 element gather, K4.3 dynamic-slice loop,
           K4.4 grid of 2,048 blocks, K4.5 loop of 4-KB asynchronous copies
  micro3   K6.0 empty kernel (the launch floor: per launch in a replayed
           CUDA graph, by CUDA events over back-to-back eager launches, and
           host time per launch-and-synchronize), K6.1a/b
           dynamic-slice loops of 8-row and 1-row slices, K6.2 gather from a
           32-row table, K6.3 gather from a 4,096-row table (a column
           staged a block), K6.4 grid of 32,768 blocks, K6.5 loop of
           copies
  micro2   K5.a scalar loop, K5.b aligned 8-row slices, K5.b2 single rows,
           K5.c a multiply-add chain (the TPU's one program; here an
           ordered scan of affine maps over the card), K5.d elementwise
           int32 throughput

The tables' shapes and the trip counts (``FULL``) are the TPU tools' own.
The counts were chosen there to outlast a relay's round trip and carry no
other meaning on this card. The tools filled some inputs with zeros, which
check no addressing; ``make_inputs`` fills every table from the seed. Inputs
stay fixed between timed calls (nothing here memoizes). Times are CUDA
events around a replayed CUDA graph of the calls on the card (the card's
time per call, without the tens of microseconds a Python wrapper takes to
submit a launch), the host clock with ``--device cpu``.

Each wrapper (``rowgather`` ... ``vecwork``) launches its kernel for CUDA
tensors on torch's current stream (or raises) and adds one to its
``launches``; for CPU tensors it runs its plain version (``*_plain``: the
same function in torch tensor operations, vectorised over the trip index in
chunks). There is no other path. All arithmetic is int32 and wraps.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..engine.device.intops import M32, i32
from .gather_bench import time_ms

I32 = torch.int32
I64 = torch.int64
RW = 128
TOOLS = ("micro", "micro3", "micro2")
# the TPU tools' shapes and trip counts (tools/pallas_micro*.py)
FULL = dict(
    KR=4096, GN=256, REPK=20, EB=8, EK=4096, EN=512, LOOPN=4096, GS=2048,
    HBROWS=1 << 15, DMAN=1024,                                   # micro
    N3=1 << 23, GK=32, GR=1 << 21, RGN=256, RGR=1 << 13, GS3=1 << 15,
    DMAN3=1 << 15,                                               # micro3
    LOOPN2=1 << 21, ONEP=1 << 19, VB=512, VPASS=256)             # micro2
CHUNK_ELEMS = 1 << 24   # elements a plain version gathers per chunk
DS_MIN_CHUNK = 32       # fewest trips a dynslice block takes
DMA_MIN_CHUNK = 8       # fewest copies a dmaloop block takes
SL_MIN_CHUNK = 2048     # fewest trips a scalarloop block takes (8 a thread)
LG_MIN_CHUNK = 64       # fewest trips an lgather block takes
OP_MIN_CHUNK = 2048     # fewest trips a oneprog block takes (8 a thread)
RG_MIN_CHUNK = 256      # fewest trips an rgather block takes (8 a lane)
# kernels of micro.cu whose trips are split over the card
# (micro_resident_blocks)
RESIDENT = {"dynslice8": 0, "dynslice1": 1, "dmaloop8": 2, "dmaloop1": 3,
            "scalarloop": 4, "lgather": 5, "oneprog": 6}
# kernels/micro.cu rgather_kernel: the rows a staged column runs on past its
# end, and a block's shared memory (bytes)
RG_PAD, RG_MAX_SMEM = 256, 232448


def _check(name, *tensors):
    """Tensors of one wrapper call: int32, on one cpu or cuda device.
    Returns True for cuda."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != I32:
            raise ValueError(f"{name}: tensors must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _shape(name, t, *shape):
    """t must have this shape (None = any size)."""
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def _pow2(name, n):
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{name}: the table's rows must be a power of two, "
                         f"got {n}")


def _launch(fn, symbol, *args):
    """Call launcher ``symbol`` of kernels/micro.cu (tensors become
    pointers, the stream is appended) and count it on wrapper ``fn``."""
    from ..kernels.build import micro_lib

    dev = next(a for a in args if torch.is_tensor(a)).device
    raw = [a.data_ptr() if torch.is_tensor(a) else int(a) for a in args]
    rc = getattr(micro_lib(), symbol)(
        *raw, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
    fn.launches += 1


def _arange(a, b, dev):
    return torch.arange(a, b, dtype=I64, device=dev)


# ---- gathers ----------------------------------------------------------------

def rowgather_plain(tab, idx, reps):
    acc = torch.zeros(idx.shape[0], RW, dtype=I64, device=tab.device)
    for r in range(reps):
        acc += tab[(idx[:, 0].long() + r) & (tab.shape[0] - 1)]
    return i32(acc)


def rowgather(tab, idx, reps):
    """out[g, :] = sum_{r < reps} tab[(idx[g, 0] + r) & (rows - 1), :]."""
    cuda = _check("rowgather", tab, idx)
    _shape("rowgather", tab, None, RW)
    _shape("rowgather", idx, None, RW)
    _pow2("rowgather", tab.shape[0])
    if not cuda:
        return rowgather_plain(tab, idx, reps)
    tab, idx = tab.contiguous(), idx.contiguous()
    out = torch.empty_like(idx)
    _launch(rowgather, "micro_rowgather", tab, idx, out, idx.shape[0],
            tab.shape[0], reps)
    return out


def egather_plain(tab, idx, reps):
    acc = torch.zeros(idx.shape, dtype=I64, device=tab.device)
    for r in range(reps):
        acc += torch.gather(tab, 1, (idx.long() + r) & (tab.shape[1] - 1))
    return i32(acc)


def egather(tab, idx, reps):
    """out[b, n] = sum_{r < reps} tab[b, (idx[b, n] + r) & (ek - 1)]."""
    cuda = _check("egather", tab, idx)
    _shape("egather", tab, None, None)
    _shape("egather", idx, tab.shape[0], None)
    _pow2("egather", tab.shape[1])
    if not cuda:
        return egather_plain(tab, idx, reps)
    tab, idx = tab.contiguous(), idx.contiguous()
    out = torch.empty_like(idx)
    _launch(egather, "micro_egather", tab, idx, out, tab.shape[0],
            tab.shape[1], idx.shape[1], reps)
    return out


def colgather_plain(tab, idx, n, chunk_elems=CHUNK_ELEMS):
    rows, dev = tab.shape[0], tab.device
    acc = torch.zeros(idx.shape, dtype=I64, device=dev)
    step = max(1, chunk_elems // idx.numel())
    for i0 in range(0, n, step):
        i = _arange(i0, min(n, i0 + step), dev)
        ii = (idx.long()[None] + i[:, None, None]) & (rows - 1)
        acc += torch.gather(tab, 0, ii.view(-1, RW)).view(ii.shape).sum(
            0, dtype=I64)
    return i32(acc)


def rgather_smem(rows):
    """Shared bytes of an rgather block (kernels/micro.cu rg_smem): the
    staged column and RG_PAD rows of it again."""
    return 4 * (rows + RG_PAD)


def colgather(tab, idx, n, whole):
    """out[r, l] = sum_{i < n} tab[(idx[r, l] + i) & (rows - 1), l]. Both
    kernels split the trips over a grid (``grid_split``), each block
    staging in shared memory and adding its partial sums into a zeroed
    output. ``whole`` (K6.2): a block stages the whole table (within 48 KB),
    as many blocks as the card holds at once; otherwise (K6.3) a block
    stages one column, the 128 columns x the trip ranges one block a SM."""
    cuda = _check("colgather", tab, idx)
    _shape("colgather", tab, None, RW)
    _shape("colgather", idx, None, RW)
    rows = tab.shape[0]
    _pow2("colgather", rows)
    if whole and tab.numel() * 4 > 48 * 1024:
        raise ValueError("colgather: a staged table must fit 48 KB")
    if not whole and rgather_smem(rows) > RG_MAX_SMEM:
        raise ValueError(f"colgather: one column of {rows} rows cannot be "
                         f"staged in a block's {RG_MAX_SMEM} bytes of shared "
                         f"memory")
    if not cuda:
        return colgather_plain(tab, idx, n)
    tab, idx = tab.contiguous(), idx.contiguous()
    out = torch.zeros_like(idx)
    if whole:
        # the kernel's shared memory is twice the table (kernels/micro.cu)
        blocks, chunk = grid_split(
            n, _resident_blocks("lgather", 8 * tab.numel()), LG_MIN_CHUNK)
        if blocks:
            _launch(colgather, "micro_lgather", tab, idx, out, idx.shape[0],
                    rows, n, blocks, chunk)
        return out
    # one block a SM: beside its trips a block's cost is staging its column
    # (a 32-byte sector of every row), which a second block on the SM would
    # pay again for no more shared-memory loads a clock
    sms = torch.cuda.get_device_properties(tab.device).multi_processor_count
    splits, chunk = grid_split(n, max(1, sms // RW), RG_MIN_CHUNK)
    if splits:
        _launch(colgather, "micro_rgather", tab, idx, out, idx.shape[0], rows,
                n, splits, chunk)
    return out


# ---- loops of dynamic-offset loads -----------------------------------------

def slice_offsets(s, i, mul, scale, mask):
    """off_i = ((s + i * mul) * scale) & mask, for a tensor of trips i."""
    return ((s.long() + i * mul) * scale) & mask


def dynslice_plain(tab, s, n, mul, scale, mask, rows_out,
                   chunk_elems=CHUNK_ELEMS):
    dev = tab.device
    acc = torch.zeros(rows_out, RW, dtype=I64, device=dev)
    step = max(1, chunk_elems // (rows_out * RW))
    r = _arange(0, rows_out, dev)
    for i0 in range(0, n, step):
        off = slice_offsets(s, _arange(i0, min(n, i0 + step), dev), mul,
                            scale, mask)
        acc += tab[off[:, None] + r].sum(0, dtype=I64)
    return i32(acc)


def _check_loop(name, tab, s, mask, sl, rows_out):
    cuda = _check(name, tab, s)
    _shape(name, tab, None, RW)
    _shape(name, s, 1)
    if (sl, rows_out) not in ((8, 8), (8, 1), (1, 1)):
        raise ValueError(f"{name}: (slice rows, summed rows) must be (8, 8), "
                         f"(8, 1) or (1, 1)")
    if mask < 0 or mask + sl > tab.shape[0]:
        raise ValueError(f"{name}: mask {mask} lets a {sl}-row slice leave "
                         f"the table's {tab.shape[0]} rows")
    return cuda


def grid_split(n, max_blocks, min_chunk):
    """A grid-split kernel's grid for n trips: (blocks, chunk). Block b
    takes trips [b * chunk, min(n, (b + 1) * chunk)): at most
    ``max_blocks`` blocks (what the card holds at once) and at least
    ``min_chunk`` trips each, so that a short loop does not pay one block's
    atomics per trip. (0, 0) for no trips."""
    if n <= 0:
        return 0, 0
    chunk = max(min_chunk, -(-n // max_blocks))
    return -(-n // chunk), chunk


_RESIDENT_BLOCKS: dict = {}   # (device, kernel, smem) -> resident blocks


def _resident_blocks(kernel, smem=0):
    """The most blocks of ``kernel`` (a key of RESIDENT), with ``smem``
    bytes of dynamic shared memory a block, the current card holds at
    once."""
    from ..kernels.build import micro_lib

    key = (torch.cuda.current_device(), kernel, smem)
    if key not in _RESIDENT_BLOCKS:
        nb = micro_lib().micro_resident_blocks(RESIDENT[kernel], smem)
        if nb <= 0:
            raise RuntimeError(f"micro_resident_blocks failed: CUDA error "
                               f"{-nb}")
        _RESIDENT_BLOCKS[key] = nb
    return _RESIDENT_BLOCKS[key]


def dynslice(tab, s, n, mul, scale, mask, sl, rows_out):
    """out[r, :] = sum_{i < n} tab[off_i + r, :] for r < rows_out, off_i =
    ((s + i * mul) * scale) & mask. ``sl`` is the TPU kernel's slice height
    (8 or 1); the kernel loads only the ``rows_out`` rows that are summed,
    over a grid of blocks that each take a contiguous range of trips
    (``grid_split``) and add their sums into a zeroed output."""
    if not _check_loop("dynslice", tab, s, mask, sl, rows_out):
        return dynslice_plain(tab, s, n, mul, scale, mask, rows_out)
    tab = tab.contiguous()
    if tab.data_ptr() % 16:
        raise ValueError("dynslice: the table must be 16-byte aligned")
    out = torch.zeros(rows_out, RW, dtype=I32, device=tab.device)
    blocks, chunk = grid_split(n, _resident_blocks(f"dynslice{rows_out}"),
                               DS_MIN_CHUNK)
    if blocks:
        _launch(dynslice, "micro_dynslice", tab, s, out, n, blocks, chunk,
                mul, scale, mask, rows_out)
    return out


def dmaloop(hbm, s, n, rows_out):
    """out[r, :] = sum_{i < n} hbm[off_i + r, :] for r < rows_out (8 or 1),
    off_i = ((s + 37 i) * 8) & (rows - 9); the kernel copies each trip's
    8-row slice into shared memory asynchronously, several copies in
    flight in each block of a grid over the trips (``grid_split``), and
    adds the blocks' sums into a zeroed output."""
    mask = hbm.shape[0] - 9
    if not _check_loop("dmaloop", hbm, s, mask, 8, rows_out):
        return dynslice_plain(hbm, s, n, 37, 8, mask, rows_out)
    hbm = hbm.contiguous()
    if hbm.data_ptr() % 16:
        raise ValueError("dmaloop: the table must be 16-byte aligned")
    out = torch.zeros(rows_out, RW, dtype=I32, device=hbm.device)
    blocks, chunk = grid_split(n, _resident_blocks(f"dmaloop{rows_out}"),
                               DMA_MIN_CHUNK)
    if blocks:
        _launch(dmaloop, "micro_dmaloop", hbm, s, out, n, blocks, chunk, mask,
                rows_out)
    return out


def scalarloop_plain(s, n, chunk_elems=CHUNK_ELEMS):
    tot = torch.zeros((), dtype=I64, device=s.device)
    for i0 in range(0, n, chunk_elems):
        i = _arange(i0, min(n, i0 + chunk_elems), s.device)
        tot += ((s.long() + 7 * i) & 1023).sum()
    return i32(tot).expand(8, RW).contiguous()


def scalarloop(s, n):
    """(8, 128) filled with sum_{i < n} ((s + 7 i) & 1023); the kernel
    splits the trips over a grid (``grid_split``) and adds the blocks'
    sums into a zeroed word, which the last block writes out."""
    cuda = _check("scalarloop", s)
    _shape("scalarloop", s, 1)
    if not cuda:
        return scalarloop_plain(s, n)
    blocks, chunk = grid_split(n, _resident_blocks("scalarloop"),
                               SL_MIN_CHUNK)
    if not blocks:
        return torch.zeros(8, RW, dtype=I32, device=s.device)
    acc = torch.zeros(2, dtype=I32, device=s.device)
    out = torch.empty(8, RW, dtype=I32, device=s.device)
    _launch(scalarloop, "micro_scalarloop", s, acc, out, n, blocks, chunk)
    return out


def oneprog_plain(x, n):
    """The accumulator is the same on every element: a scalar recurrence on
    the host, broadcast."""
    acc = 0
    for i in range(n):
        acc = (acc * 3 + i) & M32
    return i32(x.long() + acc)


def oneprog(x, n):
    """x + acc_n, acc_0 = 0, acc_{i+1} = acc_i * 3 + i (int32, wrapping).
    The kernel splits the trips over a grid (``grid_split``); each thread
    folds a contiguous span of them into an affine map, the maps are
    composed in trip order in each block and then, by the last block to
    finish, over the blocks."""
    cuda = _check("oneprog", x)
    _shape("oneprog", x, 8, RW)
    if not cuda:
        return oneprog_plain(x, n)
    x = x.contiguous()
    blocks, chunk = grid_split(n, _resident_blocks("oneprog"), OP_MIN_CHUNK)
    if not blocks:
        return x.clone()
    scratch = torch.zeros(1 + 2 * blocks, dtype=I32, device=x.device)
    out = torch.empty_like(x)
    _launch(oneprog, "micro_oneprog", x, scratch, out, n, blocks, chunk)
    return out


# ---- blocks and elementwise work --------------------------------------------

def gridstep_plain(x, base):
    n = x.shape[0] // 8
    add = (base + torch.arange(n, dtype=I32, device=x.device))
    return (x.view(n, 8, RW) + add[:, None, None]).view(x.shape)


def gridstep(x, base=0):
    """Program i of x.shape[0] / 8 writes x[8i : 8i + 8, :] + (base + i);
    one block per program. With one program and base 1 it is the tools'
    empty kernel, x + 1."""
    cuda = _check("gridstep", x)
    _shape("gridstep", x, None, RW)
    if x.shape[0] == 0 or x.shape[0] % 8:
        raise ValueError("gridstep: rows must be a positive multiple of 8")
    if not cuda:
        return gridstep_plain(x, base)
    x = x.contiguous()
    out = torch.empty_like(x)
    _launch(gridstep, "micro_gridstep", x, out, x.shape[0] // 8, base)
    return out


def vecwork_plain(v, passes):
    acc = torch.zeros(8, RW, dtype=I64, device=v.device)
    for r in range(passes):
        acc += (v ^ (v >> min(r + 1, 31))).view(-1, 8, RW).sum(0, dtype=I64)
    return i32(acc)


def vecwork(v, passes):
    """out (8, 128) = sum_{r < passes} of (v ^ (v >> (r + 1))) summed over
    v's (8, 128) tiles. The shift is arithmetic and a count of 32 or more
    fills with the sign (the count is clamped to 31)."""
    cuda = _check("vecwork", v)
    _shape("vecwork", v, None, RW)
    if v.shape[0] == 0 or v.shape[0] % 8:
        raise ValueError("vecwork: rows must be a positive multiple of 8")
    if not cuda:
        return vecwork_plain(v, passes)
    v = v.contiguous()
    out = torch.zeros(8, RW, dtype=I32, device=v.device)
    _launch(vecwork, "micro_vecwork", v, out, v.shape[0] // 8, passes)
    return out


WRAPPERS = (rowgather, egather, colgather, dynslice, dmaloop, scalarloop,
            oneprog, gridstep, vecwork)
for _f in WRAPPERS:
    _f.launches = 0


# ---- the bench --------------------------------------------------------------

def make_inputs(device, seed=0, sizes=None):
    """Every table, index and scalar of the three tools, made with numpy
    from ``seed``: values below 2^20, indices inside their tables. The
    tools' ``start`` scalars and their grid and copy inputs were zeros;
    here they are seeded too, so that a wrong offset shows."""
    z = dict(FULL, **(sizes or {}))
    rng = np.random.default_rng(seed)

    def t(hi, *shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(
            np.int32)).to(device)

    big = 1 << 20
    return dict(
        tab=t(big, z["KR"], RW), idxc=t(z["KR"], z["GN"], RW),
        tab2=t(big, z["EB"], z["EK"]), idx2=t(z["EK"], z["EB"], z["EN"]),
        start=t(big, 1), xgrid=t(big, 8 * max(z["GS"], z["GS3"]), RW),
        hbm=t(big, z["HBROWS"], RW), x8=t(big, 8, RW),
        tabg=t(big, z["GK"], RW), idxg=t(z["GK"], 8, RW),
        idxr=t(z["KR"], z["RGN"], RW), xv=t(big, 8 * z["VB"], RW))


def _distinct_rows(off, rows_out):
    r = torch.arange(rows_out, device=off.device)
    return int(torch.unique(off[:, None] + r).numel())


def sites(x, sizes=None):
    """The 16 sites over inputs ``x``: [dict(key, tool, name, replaces,
    label, unit, units, fn, plain, library, ops, nbytes)]. ``fn`` calls the
    wrapper, ``plain`` its plain version; ``library`` is one index or
    elementwise PyTorch call with a sum that computes the same function:
    the plain version in a single chunk (for K5.a, one elementwise
    expression over every trip index, summed; for K5.d, one broadcast
    expression over the passes' shift counts, clamped to 31, 0.5 GB of
    int32 at the tools' size). None where there is none: the trips of K6.2
    would need a 16-GB index, and K5.c is a recurrence.
    ``ops()`` is the least int32 operations the function needs on these
    inputs: one add per summed element, for K5.a and K5.c one per trip
    (a closed form is not the function's work), and for K5.d three per
    element and pass (the shift, the xor and the add, as the TPU tool
    counts them). ``nbytes()`` is what it
    must move: the distinct table rows or elements it reads, the index
    words it uses, its scalar, and its output once. K4.4 also has ``cold``:
    its 16 MB of traffic fit the card's 50-MB L2, so repeated calls on one
    array never reach device memory; ``cold`` is the same call on
    successive slices of the larger grid's array, to be timed against a
    bound that assumes device memory."""
    z = dict(FULL, **(sizes or {}))
    kr, dev = z["KR"], x["tab"].device
    s = x["start"]
    out = []

    def add(key, tool, name, replaces, label, unit, units, fn, plain, library,
            ops, nbytes):
        out.append(dict(key=key, tool=tool, name=name, replaces=replaces,
                        label=label, unit=unit, units=units, fn=fn,
                        plain=plain, library=library, ops=lambda: ops,
                        nbytes=nbytes))

    def loop(key, tool, name, replaces, label, unit, tab, n, mul, scale, mask,
             sl, rows_out, dma=False):
        fn = ((lambda: dmaloop(tab, s, n, rows_out)) if dma else
              (lambda: dynslice(tab, s, n, mul, scale, mask, sl, rows_out)))
        add(key, tool, name, replaces, label, unit, n, fn,
            lambda: dynslice_plain(tab, s, n, mul, scale, mask, rows_out),
            lambda: dynslice_plain(tab, s, n, mul, scale, mask, rows_out,
                                   chunk_elems=max(1, n) * rows_out * RW),
            n * rows_out * RW,
            lambda: 4 * RW * (_distinct_rows(slice_offsets(
                s, _arange(0, n, dev), mul, scale, mask), rows_out)
                + rows_out) + 4)
        if not dma:     # the trips run in parallel: a rate, not a trip's time
            out[-1]["row_bytes"] = 4 * n * rows_out * RW

    # -- tools/pallas_micro.py
    tab, idxc, reps = x["tab"], x["idxc"], z["REPK"]
    rr = _arange(0, reps, dev)
    add("K4.1", "micro", "micro_rowgather", "tools/pallas_micro.py:68",
        f"row gather {z['GN']} rows x{reps}", "row", z["GN"] * reps,
        lambda: rowgather(tab, idxc, reps),
        lambda: rowgather_plain(tab, idxc, reps),
        lambda: i32(tab[(idxc[:, :1].long() + rr) & (kr - 1)].sum(
            1, dtype=I64)),
        z["GN"] * reps * RW,
        lambda: 4 * RW * (int(torch.unique(
            (idxc[:, :1].long() + rr) & (kr - 1)).numel()) + z["GN"])
        + 4 * z["GN"])
    tab2, idx2, ek = x["tab2"], x["idx2"], z["EK"]
    cols = (idx2.long()[:, :, None] + rr) & (ek - 1)
    add("K4.2", "micro", "micro_egather", "tools/pallas_micro.py:104",
        f"element gather ({z['EB']}x{z['EN']}) x{reps}", "element",
        idx2.numel() * reps,
        lambda: egather(tab2, idx2, reps),
        lambda: egather_plain(tab2, idx2, reps),
        lambda: i32(torch.gather(tab2, 1, cols.view(z["EB"], -1)).view(
            cols.shape).sum(2, dtype=I64)),
        idx2.numel() * reps,
        lambda: 4 * (int(torch.unique(
            cols + ek * _arange(0, z["EB"], dev)[:, None, None]).numel())
            + 2 * idx2.numel()))
    loop("K4.3", "micro", "micro_dynslice", "tools/pallas_micro.py:137",
         f"dyn-slice loop x{z['LOOPN']} (8x{RW})", "trip", tab, z["LOOPN"],
         7, 1, kr - 9, 8, 8)
    xg = x["xgrid"][:8 * z["GS"]]
    add("K4.4", "micro", "micro_gridstep", "tools/pallas_micro.py:164",
        f"grid of {z['GS']} blocks", "block", z["GS"],
        lambda: gridstep(xg), lambda: gridstep_plain(xg, 0),
        lambda: gridstep_plain(xg, 0), xg.numel(),
        lambda: 8 * xg.numel())
    out[-1]["cold"] = [
        (lambda a=a: gridstep(a)) for a in x["xgrid"].split(8 * z["GS"])
        if a.shape[0] == 8 * z["GS"]]
    hbm = x["hbm"]
    loop("K4.5", "micro", "micro_dmaloop", "tools/pallas_micro.py:206",
         f"async copy loop x{z['DMAN']} (4096 B), 8 rows summed", "copy",
         hbm, z["DMAN"], 37, 8, z["HBROWS"] - 9, 8, 8, dma=True)

    # -- tools/pallas_micro3.py
    x8 = x["x8"]
    add("K6.0", "micro3", "micro3_empty", "tools/pallas_micro3.py:58",
        "empty kernel (x + 1)", "launch", 1,
        lambda: gridstep(x8, 1), lambda: gridstep_plain(x8, 1),
        lambda: x8 + 1, x8.numel(), lambda: 8 * x8.numel())
    for key, nm, sl in (("K6.1a", "aligned (8,128)", 8),
                        ("K6.1b", "row (1,128)", 1)):
        loop(key, "micro3", f"micro3_dynslice_{sl}row",
             "tools/pallas_micro3.py:92",
             f"dyn-slice {nm} x{z['N3']}, row 0 summed", "trip", tab,
             z["N3"], 7, 1, kr - 9, sl, 1)
    for key, name, replaces, label, t_, i_, n, whole in (
            ("K6.2", "micro3_lgather", "tools/pallas_micro3.py:118",
             f"gather (8x{RW} from {z['GK']}x{RW}, shared) x{z['GR']}",
             x["tabg"], x["idxg"], z["GR"], True),
            ("K6.3", "micro3_rgather", "tools/pallas_micro3.py:152",
             f"gather ({z['RGN']}x{RW} from {kr}x{RW}, a column shared) "
             f"x{z['RGR']}", tab, x["idxr"], z["RGR"], False)):
        add(key, "micro3", name, replaces, label, "element", n * i_.numel(),
            lambda t_=t_, i_=i_, n=n, whole=whole: colgather(t_, i_, n, whole),
            lambda t_=t_, i_=i_, n=n: colgather_plain(t_, i_, n),
            None if whole else (lambda t_=t_, i_=i_, n=n: colgather_plain(
                t_, i_, n, chunk_elems=max(1, n) * i_.numel())),
            n * i_.numel(),
            lambda t_=t_, i_=i_, n=n: 8 * i_.numel() + 4 * (
                t_.numel() if n >= t_.shape[0] else int(torch.unique(
                    ((i_.long()[None] + _arange(0, n, dev)[:, None, None])
                     & (t_.shape[0] - 1)) * RW
                    + _arange(0, RW, dev)).numel())))
    xg3 = x["xgrid"][:8 * z["GS3"]]
    add("K6.4", "micro3", "micro3_gridstep", "tools/pallas_micro3.py:179",
        f"grid of {z['GS3']} blocks", "block", z["GS3"],
        lambda: gridstep(xg3), lambda: gridstep_plain(xg3, 0),
        lambda: gridstep_plain(xg3, 0), xg3.numel(),
        lambda: 8 * xg3.numel())
    loop("K6.5", "micro3", "micro3_dmaloop", "tools/pallas_micro3.py:217",
         f"async copy loop x{z['DMAN3']} (4096 B), row 0 summed", "copy",
         hbm, z["DMAN3"], 37, 8, z["HBROWS"] - 9, 8, 1, dma=True)

    # -- tools/pallas_micro2.py
    n2 = z["LOOPN2"]
    add("K5.a", "micro2", "micro2_scalarloop", "tools/pallas_micro2.py:58",
        f"scalar loop x{n2}", "trip", n2,
        lambda: scalarloop(s, n2), lambda: scalarloop_plain(s, n2),
        lambda: scalarloop_plain(s, n2, chunk_elems=max(1, n2)),
        n2, lambda: 4 + 4 * 8 * RW)
    loop("K5.b", "micro2", "micro2_dynal", "tools/pallas_micro2.py:81",
         f"aligned dyn-slice loop x{n2 // 4} (8x{RW})", "trip", tab, n2 // 4,
         1, 8, kr - 9, 8, 8)
    loop("K5.b2", "micro2", "micro2_dynrow", "tools/pallas_micro2.py:107",
         f"single-row dyn load loop x{n2 // 4} (1x{RW})", "trip", tab,
         n2 // 4, 7, 1, kr - 2, 1, 1)
    onep = z["ONEP"]
    add("K5.c", "micro2", "micro2_oneprog", "tools/pallas_micro2.py:130",
        f"multiply-add chain x{onep}, an ordered scan", "trip", onep,
        lambda: oneprog(x8, onep), lambda: oneprog_plain(x8, onep), None,
        onep + x8.numel(), lambda: 8 * x8.numel())
    xv, vp = x["xv"], z["VPASS"]
    shift = _arange(1, vp + 1, dev).clamp(max=31).to(I32)
    add("K5.d", "micro2", "micro2_vecwork", "tools/pallas_micro2.py:157",
        f"elementwise xor/shift/add, {vp} passes over {xv.numel()} words",
        "element pass", xv.numel() * vp,
        lambda: vecwork(xv, vp), lambda: vecwork_plain(xv, vp),
        lambda: i32((xv[None] ^ (xv[None] >> shift[:, None, None])).view(
            vp, -1, 8, RW).sum((0, 1), dtype=I64)),
        3 * xv.numel() * vp, lambda: 4 * xv.numel() + 4 * 8 * RW)
    return out


def graph_ms(fn, device, n=20):
    """Mean device milliseconds of fn() inside a replayed CUDA graph of n
    calls: what the card takes per call when the host's cost of submitting a
    launch (tens of microseconds through a Python wrapper) is out of the
    way. ``fn`` may be a sequence of calls, taken in turn (a site's
    ``cold`` calls). On the CPU, the host-clock time of fn()."""
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    if device.type != "cuda":
        return time_ms(fns[0], device, n)
    fns[0]()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize(device)
    return a.elapsed_time(b) / n


def launch_floor(fn, device, n=200):
    """The cost of one launch of fn(), three ways: (device ms per launch in
    a replayed CUDA graph, ms per launch by CUDA events over n back-to-back
    eager launches, host ms per launch-and-synchronize). The second is the
    host's rate of submitting launches where the kernel is shorter than that;
    the eager ladders pay the third once per trip. On the CPU all three are
    host-clock times of the plain version."""
    dev_ms = time_ms(fn, device, n)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        sync()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    return graph_ms(fn, device, n), dev_ms, host_ms


def main(argv=None, reps: int = 3, sizes=None):
    """Run the selected tools' sites. Each is called once (the result is
    kept), timed over ``reps`` eager calls to size its graph, then timed in
    a replayed CUDA graph (``graph_ms``: the card's time per call; most
    sites are shorter than the host takes to submit a launch). Returns {key:
    site record}: the site's dict from ``sites`` plus ``out``, ``ms``,
    ``ns_per_unit`` and ``launches`` (and, for K6.0, ``graph_ms``,
    ``eager_ms`` and ``host_sync_ms`` of ``launch_floor``). ``sizes``
    overrides entries of ``FULL`` (the tests run small trip counts)."""
    ap = argparse.ArgumentParser(prog="micro",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all",) + TOOLS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("micro: no CUDA device is available")
    tools = TOOLS if args.which == "all" else (args.which,)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"primitive benches, device={name}"
          + (" (the plain versions)" if dev.type == "cpu" else ""), flush=True)
    x = make_inputs(dev, args.seed, sizes)
    res = {}
    for site in sites(x, sizes):
        if site["tool"] not in tools:
            continue
        n0 = sum(f.launches for f in WRAPPERS)
        out = site["fn"]()
        eager = time_ms(site["fn"], dev, reps)
        # as many calls as fit about 20 ms (1 to 50) in one graph
        ms = graph_ms(site.get("cold") or site["fn"], dev,
                      max(1, min(50, int(20 / eager))))
        extra = ""
        if site["key"] == "K6.0":
            site["graph_ms"], site["eager_ms"], site["host_sync_ms"] = floor \
                = launch_floor(site["fn"], dev)
            ms = floor[0]
            extra = (f"  (eager launches back to back {floor[1] * 1e3:.2f} "
                     f"us, host launch+sync {floor[2] * 1e3:.2f} us)")
        per = ms * 1e6 / site["units"]
        if "row_bytes" in site:
            rate = (f"throughput {site['units'] / ms / 1e6:10.4f} G "
                    f"{site['unit']}s/s, {site['row_bytes'] / ms / 1e6:.1f} "
                    f"GB/s of summed rows")
        else:
            rate = f"{per:12.4f} ns/{site['unit']}"
        print(f"{site['key']:6s}{site['label']:58s} {ms:11.5f} ms  "
              f"{rate}{extra}", flush=True)
        res[site["key"]] = dict(
            site, out=out, ms=ms, ns_per_unit=per,
            launches=sum(f.launches for f in WRAPPERS) - n0)
    return res


if __name__ == "__main__":
    main()
