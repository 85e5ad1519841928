"""Capability probes: is the card's form of each primitive right.

    python -m desamba_tpu_torch.tools.caps [--device cuda]

Counterpart of ``tools/pallas_caps.py``. There a probe asked whether a
primitive lowers on the TPU's compiler at all; on the card everything
compiles, so a probe runs the Hopper form of the primitive (a kernel of
``kernels/caps.cu``) and holds its result against the numpy expression the
TPU probe checks, or, for the five probes the TPU tool runs without a
check, against the numpy restatement of their body. An index or a start
outside its array follows the JAX body's rules (``_take``, ``_start``);
the tool's inputs have none. It prints ``<probe>: OK`` per probe and,
unlike the TPU tool, which prints FAIL and goes on, raises on the first
probe whose result is wrong or whose launch fails.

The three wrappers are the tool's three call sites: ``call_probe`` (its
``call``, thirteen probes over twelve bodies), ``smem_sum`` (``f_smem``: a
1-element output) and ``scalar_block`` (``f_s2``: a (1, 1) scalar operand).
For CUDA tensors each launches its kernel on torch's current stream (or
raises) and adds one to its ``launches``; for CPU tensors it runs the
probe's plain torch version. There is no other path.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..engine.device.intops import M32, i32, u32

I32 = torch.int32
I64 = torch.int64
LANES = 128


I32_MIN = -(1 << 31)


def _take(axis):
    """take_along_axis as the JAX body computes it: a negative index counts
    from the end, and one still outside the table reads INT32_MIN."""
    def f(t, i):
        n = t.shape[axis]
        i = i.long()
        i = torch.where(i < 0, i + n, i)
        ok = (i >= 0) & (i < n)
        return torch.where(ok, torch.gather(t, axis, torch.where(ok, i, 0)),
                           I32_MIN).to(I32)
    return f


def _np_take(axis):
    def f(t, i):
        n = t.shape[axis]
        i = i.astype(np.int64)
        i = np.where(i < 0, i + n, i)
        ok = (i >= 0) & (i < n)
        return np.where(ok, np.take_along_axis(t, np.where(ok, i, 0), axis),
                        I32_MIN).astype(np.int32)
    return f


def _start(s, n, size):
    """A dynamic start of a ``size``-long slice of n entries as the JAX
    body takes it: a negative one counts from the end, then it is clamped
    so that the slice lies inside."""
    s = int(s)
    return min(max(s + n if s < 0 else s, 0), n - size)


def _roll(axis):
    return lambda t, s: torch.roll(t, int(s[0]), axis)


def _lane_ds(t, s):
    o = _start(s[0], t.shape[1], LANES)
    return t[:, o:o + LANES]


def _ds2d(t, s):
    o0 = _start(s[0], t.shape[0], 8)
    o1 = _start(s[1], t.shape[1], LANES)
    return t[o0:o0 + 8, o1:o1 + LANES]


def _u32hash(t):
    v = u32(t)
    v = v ^ (v >> 7)
    v = (v * 0x9E3779B1) & M32
    return (v >> 16).to(I32)


def _np_u32hash(t):
    v = t.view(np.uint32)
    v = v ^ (v >> np.uint32(7))
    v = v * np.uint32(0x9E3779B1)
    return (v >> np.uint32(16)).astype(np.int32)


def _while_rows(t):
    i, acc = 0, torch.zeros((), dtype=I64, device=t.device)
    while i < 8:
        acc, i = acc + t[i].sum(), i + 1
    return i32(acc).expand(8, LANES)


def _argmax(t):
    m = t.max(dim=1, keepdim=True).values
    lanes = torch.arange(LANES, device=t.device)
    am = torch.where(t == m, lanes, LANES).min(dim=1, keepdim=True).values
    return i32(m.long() + am).expand(8, LANES)


def _dynrow(t, s):
    out = torch.zeros(8, LANES, dtype=I32, device=t.device)
    out[_start(s[0], 8, 1)] = t[0]
    return out


def _np_dynrow(t, s):
    out = np.zeros((8, LANES), np.int32)
    out[_start(s[0], 8, 1)] = t[0]
    return out


def _wrap(a):
    return np.asarray(a).astype(np.int64).astype(np.int32)


# (probe's name in the TPU tool, kernel of caps.cu, inputs by name, the plain
# torch version, the numpy expectation); the order of the call-site probes is
# the tool's
CALL_PROBES = (
    ("take_along_axis axis=0 (8,128) from (8,128)", "take0", ("tab8", "idx8"),
     _take(0), _np_take(0)),
    ("take_along_axis axis=0 (8,128) from (32,128)", "take0",
     ("tab32", "idx32"), _take(0), _np_take(0)),
    ("take_along_axis axis=1 (8,128) from (8,128)", "take1", ("tab8", "idxl"),
     _take(1), _np_take(1)),
    ("roll dynamic shift axis=1", "roll1", ("tab8", "sh"), _roll(1),
     lambda t, s: np.roll(t, s[0], 1)),
    ("roll dynamic shift axis=0", "roll0", ("tab8", "sh"), _roll(0),
     lambda t, s: np.roll(t, s[0], 0)),
    ("lane-dim dynamic slice (8, 512)[:, o:o+128]", "lane_ds", ("big", "off"),
     _lane_ds, _lane_ds),
    ("dynamic_slice both dims (64,512)->(8,128)", "ds2d", ("big2", "off2"),
     _ds2d, _ds2d),
    ("uint32 mul/xor/shift", "u32", ("u",), _u32hash, _np_u32hash),
    ("while_loop scalar state + row reads", "while", ("tab8",), _while_rows,
     lambda t: np.full((8, LANES), _wrap(t.sum(dtype=np.int64)))),
    ("uint8 load + cast", "u8", ("b8",), lambda t: t[:8].to(I32) + 1,
     lambda t: t[:8].astype(np.int32) + 1),
    ("max/argmax along lanes", "argmax", ("tab8",), _argmax,
     lambda t: np.broadcast_to(_wrap(
         t.max(1).astype(np.int64) + t.argmax(1))[:, None], (8, LANES))),
    ("dynamic row write o[i] = v", "dynrow", ("tab8", "row"), _dynrow,
     _np_dynrow),
    ("cumsum along lanes", "cumsum", ("tab8",), lambda t: i32(t.cumsum(1)),
     lambda t: _wrap(np.cumsum(t, 1, dtype=np.int64))),
)
SUM_PROBE = ("1-element output (the tile's sum)", "sum", ("tab8",),
             lambda t: i32(t.sum()).reshape(1),
             lambda t: _wrap(t.sum(dtype=np.int64)).reshape(1))
S2_PROBE = ("(1,1) scalar operand", "s2", ("tab8", "s2"),
            lambda t, s: t + s[0, 0],
            lambda t, s: _wrap(t.astype(np.int64) + s[0, 0]))
# kernels/caps.cu's table of probes
KERNELS = ("take0", "take1", "roll1", "roll0", "lane_ds", "ds2d", "u32",
           "sum", "while", "u8", "argmax", "dynrow", "cumsum", "s2")
# the kernels that load their first input in 16-byte words
WIDE = ("u32", "u8", "s2")
# (first input's shape, or None for any (n, 128); its dtype; second input's
# shape)
SHAPES = {
    "take0": (None, I32, (8, LANES)), "take1": ((8, LANES), I32, (8, LANES)),
    "roll1": ((8, LANES), I32, (1,)), "roll0": ((8, LANES), I32, (1,)),
    "lane_ds": ((8, 512), I32, (1,)), "ds2d": ((64, 512), I32, (2,)),
    "u32": ((8, LANES), I32, None), "sum": ((8, LANES), I32, None),
    "while": ((8, LANES), I32, None), "u8": ((32, LANES), torch.uint8, None),
    "argmax": ((8, LANES), I32, None), "dynrow": ((8, LANES), I32, (1,)),
    "cumsum": ((8, LANES), I32, None), "s2": ((8, LANES), I32, (1, 1)),
}


def _run(wrapper, probe, tensors):
    """Check the probe's inputs; the plain version for CPU tensors, the
    kernel for CUDA ones."""
    kernel, plain = probe[1], probe[3]
    shape_a, dtype_a, shape_b = SHAPES[kernel]
    if len(tensors) != 1 + (shape_b is not None):
        raise ValueError(f"{kernel}: expected {1 + (shape_b is not None)} "
                         f"inputs, got {len(tensors)}")
    a = tensors[0]
    ok = (a.dtype == dtype_a and (tuple(a.shape) == shape_a or (
        shape_a is None and a.dim() == 2 and a.shape[1] == LANES
        and a.shape[0] >= 1)))
    if shape_b is not None:
        b = tensors[1]
        ok = (ok and b.dtype == I32 and tuple(b.shape) == shape_b
              and b.device == a.device)
    if not ok:
        got = [(tuple(t.shape), t.dtype) for t in tensors]
        raise ValueError(f"{kernel}: inputs must be {shape_a} {dtype_a}"
                         + (f" and {shape_b} int32 on one device"
                            if shape_b else "") + f", got {got}")
    if a.device.type == "cpu":
        return plain(*tensors).contiguous()
    if a.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {a.device}")
    from ..kernels.build import caps_lib

    a = a.contiguous()
    if kernel in WIDE and a.data_ptr() % 16:
        raise ValueError(f"{kernel}: the tile must be 16-byte aligned (the "
                         f"kernel loads it 16 bytes a thread)")
    b = tensors[1].contiguous() if shape_b is not None else a
    out = torch.empty((1,) if kernel == "sum" else (8, LANES), dtype=I32,
                      device=a.device)
    rc = caps_lib().caps_launch(
        KERNELS.index(kernel), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.shape[0], torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"caps kernel {kernel} launch failed: CUDA error "
                           f"{rc}")
    wrapper.launches += 1
    return out


def call_probe(name, *tensors):
    """One of the thirteen probes of the tool's ``call`` site, by its
    name in ``CALL_PROBES``: an (8, 128) int32 tile."""
    probe = next((p for p in CALL_PROBES if p[0] == name), None)
    if probe is None:
        raise ValueError(f"call_probe: no probe named {name!r}")
    return _run(call_probe, probe, tensors)


def smem_sum(t):
    """The (8, 128) tile's wrapping sum as a (1,) int32 tensor."""
    return _run(smem_sum, SUM_PROBE, (t,))


def scalar_block(t, s):
    """The (8, 128) tile plus the (1, 1) scalar s."""
    return _run(scalar_block, S2_PROBE, (t, s))


WRAPPERS = (call_probe, smem_sum, scalar_block)
for _f in WRAPPERS:
    _f.launches = 0


def make_inputs(seed=0):
    """The tool's inputs as numpy arrays, drawn from ``seed`` in the tool's
    order, and its scalars."""
    rng = np.random.default_rng(seed)

    def r(hi, *shape):
        return rng.integers(0, hi, shape).astype(np.int32)

    x = dict(tab8=r(100, 8, LANES), idx8=r(8, 8, LANES),
             tab32=r(100, 32, LANES), idx32=r(32, 8, LANES),
             idxl=r(LANES, 8, LANES), big=r(100, 8, 512),
             big2=r(100, 64, 512))
    x["u"] = rng.integers(0, 1 << 32, (8, LANES), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    x["b8"] = rng.integers(0, 4, (32, LANES)).astype(np.uint8)
    for k, v in dict(sh=[5], off=[37], off2=[3, 37], row=[3],
                     s2=[[7]]).items():
        x[k] = np.array(v, np.int32)
    return x


def probes():
    """[(site, wrapper call, probe)] for the fifteen probes, in the tool's
    order (its probes 6 and 12 are the two other call sites)."""
    out = [("tools/pallas_caps.py:36",
            lambda *t, name=p[0]: call_probe(name, *t), p)
           for p in CALL_PROBES]
    out.insert(8, ("tools/pallas_caps.py:153", smem_sum, SUM_PROBE))
    out.append(("tools/pallas_caps.py:225", scalar_block, S2_PROBE))
    return out


def main(argv=None):
    """Run every probe; print ``<probe>: OK`` or raise. Returns {probe's
    name: dict(site, fn, plain, inputs, out)}, ``fn`` and ``plain`` taking
    the inputs."""
    ap = argparse.ArgumentParser(prog="caps",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("caps: no CUDA device is available")
    x = make_inputs(args.seed)
    res = {}
    for site, fn, (name, _, args_, plain, expect) in probes():
        inputs = tuple(torch.from_numpy(x[a]).to(dev) for a in args_)
        out = fn(*inputs)
        exp = expect(*(x[a] for a in args_))
        if not np.array_equal(out.cpu().numpy(), exp):
            raise RuntimeError(f"{name}: WRONG RESULT")
        print(f"{name}: OK", flush=True)
        res[name] = dict(site=site, fn=fn, plain=plain, inputs=inputs,
                         out=out)
    return res


if __name__ == "__main__":
    main()
