"""Vector helpers over an (R, 128) int32 tile, and their kernels' harness.

Counterpart of ``desamba_tpu/engine/device/plops.py``: the helper library of
the TPU's per-read kernel, which builds a vector gather, unsigned compares
and reductions, rolls and reversals from the few primitives its compiler
lowers. On the card each is a few lines of ``kernels/plops.cuh`` (an indexed
read, an unsigned compare, ``__popc``, a shuffle scan). This module holds

- the plain versions: one torch function per helper, under the TPU
  library's names, on (R, 128) int32 tensors (uint32 values travel as int32
  bit patterns, sums wrap);
- the harness: one ``body_*`` function per kernel body of
  ``tests/test_plops.py`` (seven) and three for the helpers that file never
  calls directly (``umin``, ``ule``, ``reverse_lanes``). Each returns the
  output tile its body writes; the lanes, offsets and values a body fixes
  are arguments. For CUDA tensors a ``body_*`` launches its kernel of
  ``kernels/plops.cu`` on torch's current stream (or raises) and adds one to
  its ``launches``; for CPU tensors it runs its entry of ``PLAIN``, the
  plain versions composed as the body composes them. There is no other
  path.
"""
from __future__ import annotations

import torch

from .intops import i32, popc, u32

I32 = torch.int32
LANES = 128
I32_MIN = -(1 << 31)
MAX_ROWS = 64       # a tile of the harness stays well inside shared memory


# ---- the plain versions -----------------------------------------------------

def lane_iota(shape, device=None):
    return torch.arange(shape[-1], dtype=I32, device=device).expand(shape)


def sub_iota(shape, device=None):
    return torch.arange(shape[-2], dtype=I32,
                        device=device)[:, None].expand(shape)


def shuffle_lanes(v, idx):
    """``take_along_axis`` along lanes, v broadcast to idx's shape."""
    return torch.gather(v.expand(idx.shape), -1, idx.long())


def bcast_lane(v, lane, rows=None):
    """v[..., lane] across all lanes (0 <= lane < 128)."""
    return v[..., int(lane)][..., None].expand(v.shape)[:rows]


def extract(v, lane):
    """v[0, lane] as a scalar; INT32_MIN when the lane is out of range."""
    return torch.where(lane_iota(v.shape, v.device) == lane, v,
                       I32_MIN)[0:1].max()


def extract_rc(v, row, lane):
    """v[row, lane] as a scalar; INT32_MIN when either is out of range."""
    hit = ((lane_iota(v.shape, v.device) == lane)
           & (sub_iota(v.shape, v.device) == row))
    return torch.where(hit, v, I32_MIN).max()


def set_lane(v, lane, new, mask=True):
    """v with v[..., lane] = new, where mask."""
    hit = (lane_iota(v.shape, v.device) == lane) & torch.as_tensor(
        mask, device=v.device)
    return torch.where(hit, torch.as_tensor(new, dtype=I32, device=v.device),
                       v)


def umax_reduce(v):
    """Unsigned max of the tile, as an int32 bit pattern."""
    return (v ^ I32_MIN).max() ^ I32_MIN


def umin(a, b):
    return torch.minimum(a ^ I32_MIN, b ^ I32_MIN) ^ I32_MIN


def ult(a, b):
    return (a ^ I32_MIN) < (b ^ I32_MIN)


def ule(a, b):
    return (a ^ I32_MIN) <= (b ^ I32_MIN)


def roll_flat(pair, off, rows_out=1):
    """pair (2, 128) read as 256 flat words: (rows_out, 128) starting at
    flat offset off (0 <= off < 128), wrapping at 256."""
    return torch.roll(pair.reshape(-1), -int(off)).reshape(2, LANES)[:rows_out]


def gather_rows_table(get_row, n_rows, idx):
    """tab[idx] for the table of n_rows x 128 whose (1, 128) row r is
    get_row(r), read flat; 0 where idx is outside it."""
    flat = torch.cat([get_row(r) for r in range(n_rows)]).reshape(-1)
    ok = (idx >= 0) & (idx < n_rows * LANES)
    return torch.where(ok, flat[torch.where(ok, idx, 0).long()], 0)


def prefix_sum_colmajor(v):
    """Inclusive prefix sum in column-major order (flat = lane * R + row)."""
    return i32(v.t().reshape(-1).cumsum(0)).reshape(v.shape[1], -1).t()


def reverse_lanes(v):
    return v.flip(-1)


def reverse_colmajor(v):
    """Element (r, l) <- (R - 1 - r, 127 - l)."""
    return v.flip(0, 1)


def popc32(v):
    return popc(u32(v))


# ---- the harness ------------------------------------------------------------

BODIES = ("bcast_extract_setlane", "unsigned", "roll_flat",
          "gather_rows_table", "prefix_sum_colmajor", "reverse_colmajor",
          "popc32", "umin", "ule", "reverse_lanes")     # kernels/plops.cu enum


def _check(name, *tiles, rows=None):
    dev = tiles[0].device
    for t in tiles:
        if t.dim() != 2 or t.shape[1] != LANES or t.dtype != I32:
            raise ValueError(f"{name}: tiles must be (R, 128) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not 1 <= t.shape[0] <= MAX_ROWS:
            raise ValueError(f"{name}: 1 <= R <= {MAX_ROWS}, got "
                             f"{t.shape[0]}")
        if t.device != dev:
            raise ValueError(f"{name}: tiles must be on one device")
    if rows is not None and tiles[0].shape[0] != rows:
        raise ValueError(f"{name}: expected {rows} rows, got "
                         f"{tiles[0].shape[0]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def _same_shape(name, a, b):
    if a.shape != b.shape:
        raise ValueError(f"{name}: a and b must have one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")


def _launch(fn, out_rows, a, b=None, n_rows=0, params=()):
    """Launch body ``fn`` of kernels/plops.cu into a new (out_rows, 128)
    tile."""
    from ...kernels.build import plops_lib

    a = a.contiguous()
    b = a if b is None else b.contiguous()
    out = torch.empty((out_rows, LANES), dtype=I32, device=a.device)
    p = [int(x) for x in params] + [0] * (8 - len(params))
    rc = plops_lib().plops_launch(
        BODIES.index(fn.__name__[len("body_"):]), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), out_rows, n_rows, *p,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"plops kernel {fn.__name__} launch failed: CUDA "
                           f"error {rc}")
    fn.launches += 1
    return out


def plain_bcast_extract_setlane(v, lane_b=37, lane_e=5, row_rc=2, lane_rc=9,
                                lane_s1=3, new1=555, lane_s2=7, new2=-9):
    out = bcast_lane(v, lane_b).clone()
    out[0, 0] = extract(v, lane_e)
    out[0, 1] = extract_rc(v, row_rc, lane_rc)
    out[1, :] = set_lane(v, lane_s1, new1)[1]
    out[3, :] = set_lane(v, lane_s2, new2)[3]
    return out


def plain_unsigned(a, b):
    out = ult(a, b).to(I32)
    out[0, 10] = umax_reduce(a)
    return out


# body -> its plain version: the helpers above composed as the body composes
# them, on tensors of any device
PLAIN = {
    "bcast_extract_setlane": plain_bcast_extract_setlane,
    "unsigned": plain_unsigned,
    "roll_flat": lambda pair, off=37, rows_out=1: roll_flat(
        pair, off, rows_out).clone(),
    "gather_rows_table": lambda tab, idx: gather_rows_table(
        lambda r: tab[r:r + 1], tab.shape[0], idx),
    "prefix_sum_colmajor": lambda v: prefix_sum_colmajor(v).contiguous(),
    "reverse_colmajor": lambda v: reverse_colmajor(v).contiguous(),
    "popc32": popc32,
    "umin": umin,
    "ule": lambda a, b: ule(a, b).to(I32),
    "reverse_lanes": lambda v: reverse_lanes(v).contiguous(),
}
assert tuple(PLAIN) == BODIES


def body_bcast_extract_setlane(v, lane_b=37, lane_e=5, row_rc=2, lane_rc=9,
                               lane_s1=3, new1=555, lane_s2=7, new2=-9):
    """tests/test_plops.py:25-35. R >= 4; 0 <= lane_b < 128; the other
    lanes and the row may be out of range (an extraction then gives
    INT32_MIN, a set-lane changes nothing)."""
    cuda = _check("body_bcast_extract_setlane", v)
    if v.shape[0] < 4 or not 0 <= lane_b < LANES:
        raise ValueError("body_bcast_extract_setlane: R >= 4 and "
                         "0 <= lane_b < 128")
    params = (lane_b, lane_e, row_rc, lane_rc, lane_s1, new1, lane_s2, new2)
    if cuda:
        return _launch(body_bcast_extract_setlane, v.shape[0], v,
                       params=params)
    return plain_bcast_extract_setlane(v, *params)


def body_unsigned(a, b):
    """tests/test_plops.py:48-50: ult(a, b) as 0/1, umax_reduce(a) at
    [0, 10]."""
    cuda = _check("body_unsigned", a, b)
    _same_shape("body_unsigned", a, b)
    if cuda:
        return _launch(body_unsigned, a.shape[0], a, b)
    return plain_unsigned(a, b)


def body_roll_flat(pair, off=37, rows_out=1):
    """tests/test_plops.py:62-63."""
    cuda = _check("body_roll_flat", pair, rows=2)
    if not (0 <= off < LANES and 1 <= rows_out <= 2):
        raise ValueError("body_roll_flat: 0 <= off < 128, rows_out 1 or 2")
    if cuda:
        return _launch(body_roll_flat, rows_out, pair, params=(off,))
    return PLAIN["roll_flat"](pair, off, rows_out)


def body_gather_rows_table(tab, idx):
    """tests/test_plops.py:75-77: tab[idx], tab (n_rows, 128) read flat."""
    cuda = _check("body_gather_rows_table", tab, idx)
    if cuda:
        return _launch(body_gather_rows_table, idx.shape[0], tab, idx,
                       n_rows=tab.shape[0])
    return PLAIN["gather_rows_table"](tab, idx)


def _one_tile(fn, v):
    if _check(fn.__name__, v):
        return _launch(fn, v.shape[0], v)
    return PLAIN[fn.__name__[len("body_"):]](v)


def _two_tiles(fn, a, b):
    cuda = _check(fn.__name__, a, b)
    _same_shape(fn.__name__, a, b)
    if cuda:
        return _launch(fn, a.shape[0], a, b)
    return PLAIN[fn.__name__[len("body_"):]](a, b)


def body_prefix_sum_colmajor(v):
    """tests/test_plops.py:87-88."""
    return _one_tile(body_prefix_sum_colmajor, v)


def body_reverse_colmajor(v):
    """tests/test_plops.py:100-101."""
    return _one_tile(body_reverse_colmajor, v)


def body_popc32(v):
    """tests/test_plops.py:112-113."""
    return _one_tile(body_popc32, v)


def body_reverse_lanes(v):
    return _one_tile(body_reverse_lanes, v)


def body_umin(a, b):
    return _two_tiles(body_umin, a, b)


def body_ule(a, b):
    """ule(a, b) as 0/1."""
    return _two_tiles(body_ule, a, b)


HARNESS = {f.__name__[len("body_"):]: f for f in (
    body_bcast_extract_setlane, body_unsigned, body_roll_flat,
    body_gather_rows_table, body_prefix_sum_colmajor, body_reverse_colmajor,
    body_popc32, body_umin, body_ule, body_reverse_lanes)}
assert tuple(HARNESS) == BODIES
for _f in HARNESS.values():
    _f.launches = 0


def harness_cases(seed=0):
    """[(body, case, CPU tiles, keyword arguments)]: every body on seeded
    tiles with the edge cases (lanes 0 and 127, offsets 0 and 127,
    INT32_MIN and -1 among the unsigned values, R = 1, out-of-range
    extractions and gather indices)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def tile(lo, hi, rows):
        return torch.from_numpy(rng.integers(lo, hi, (rows, LANES)).astype(
            np.int64).astype(np.int32))

    edge = torch.tensor([0, -1, I32_MIN, I32_MIN + 1, (1 << 31) - 1, 5, -100],
                        dtype=I32)
    cases = []
    for rows in (4, 8):
        v = tile(-100, 100, rows)
        cases += [("bcast_extract_setlane", f"R{rows} lanes {lb}/{le}",
                   (v,), dict(lane_b=lb, lane_e=le, row_rc=rr, lane_rc=lr,
                              lane_s1=s1, lane_s2=s2))
                  for lb, le, rr, lr, s1, s2 in (
                      (37, 5, 2, 9, 3, 7), (0, 127, rows - 1, 0, 127, 0),
                      (127, 0, 0, 127, 0, 127), (5, 128, rows, 3, -1, 200))]
    for rows in (4, 1, 16):
        a, b = tile(-(1 << 31), 1 << 31, rows), tile(-(1 << 31), 1 << 31, rows)
        a[0, :7], b[0, :7] = edge, edge.flip(0)
        a[0, 20:27], b[0, 20:27] = edge, edge
        for name in ("unsigned", "umin", "ule"):
            cases.append((name, f"R{rows}", (a, b), {}))
        for name in ("popc32", "reverse_lanes", "reverse_colmajor"):
            cases.append((name, f"R{rows}", (a,), {}))
        cases.append(("prefix_sum_colmajor", f"R{rows} small",
                      (tile(0, 5, rows),), {}))
        cases.append(("prefix_sum_colmajor", f"R{rows} wrapping", (a,), {}))
        idx = tile(0, 16 * LANES, rows)
        idx[0, :4] = torch.tensor([0, 16 * LANES - 1, 16 * LANES, -1],
                                  dtype=I32)
        cases.append(("gather_rows_table", f"R{rows}",
                      (tile(0, 1 << 20, 16), idx), {}))
    pair = tile(0, 1000, 2)
    cases += [("roll_flat", f"off {off} rows {ro}", (pair,),
               dict(off=off, rows_out=ro))
              for off in (37, 0, 127) for ro in (1, 2)]
    return cases


def run_harness(device, seed=0):
    """Every case of ``harness_cases`` through its body on ``device``:
    [dict(body, case, inputs, kw, out, plain_out)], ``plain_out`` from the
    plain version on the CPU tiles. On the card ``out`` comes from the
    kernels, so this is their check."""
    dev = torch.device(device)
    out = []
    for name, case, tiles, kw in harness_cases(seed):
        inputs = tuple(t.to(dev) for t in tiles)
        out.append(dict(body=name, case=case, inputs=inputs, kw=kw,
                        out=HARNESS[name](*inputs, **kw),
                        plain_out=PLAIN[name](*tiles, **kw)))
    return out
