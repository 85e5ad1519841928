"""Device mesh for the port: a (dp, idx) grid of torch devices.

Counterpart of ``desamba_tpu/parallel/mesh.py``. The reference scales by
pthreads over reads with the index in shared memory
(src/lib/kthread.c:32-57); the mesh maps those axes onto devices:

  - ``dp``  -- reads. Each dp row classifies its own share of a batch's
    reads (or ladder lanes) end to end on its first device,
    ``devices[d, 0]``.
  - ``idx`` -- index memory. The existence-filter bit tables are cut into
    ``n_idx`` byte ranges; shard i lives on ``devices[d, i]`` of every dp
    row, answers the probes whose bytes it owns, and the answers are
    OR-merged (summed) on the row's first device. The other tables are
    replicated on every dp row's first device.

Like ``jax.sharding.Mesh``, one process drives the whole grid: the merges
are PyTorch copies and sums between the kernels, never inside one. A
device may repeat in the grid (the tests and ``chip_smoke.py`` build a
mesh of one device several times, which runs every split and merge on
one card); a table then placed twice on one device is the same tensor,
not a copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.device.intops import I32
from ..engine.device.islands import ekmer_probe_indices
from ..engine.device.pipeline import mem_wave

AXES = ("dp", "idx")


class Mesh:
    """A (n_dp, n_idx) grid of devices (``torch.device``, or any record
    with a ``process_index`` for ``distributed.host_mesh``)."""

    axis_names = AXES

    def __init__(self, grid):
        grid = np.asarray(grid, dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid, not "
                             f"{grid.shape}")
        self.devices = grid

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))


def _canonical(device) -> torch.device:
    """``device`` with its index filled in (``cuda`` -> ``cuda:<current>``),
    so that two names of one device compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_dp: int, n_idx: int = 1, devices=None) -> Mesh:
    """A (n_dp, n_idx) mesh over the first ``n_dp * n_idx`` of ``devices``,
    dp-major. ``devices`` defaults to every CUDA device, each once; a
    device repeats only where the caller's list repeats it. Raises where
    there are too few."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass the devices")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    need = n_dp * n_idx
    if n_dp < 1 or n_idx < 1 or len(devices) < need:
        raise ValueError(f"a ({n_dp}, {n_idx}) mesh needs {need} devices, "
                         f"have {len(devices)}")
    grid = np.empty((n_dp, n_idx), dtype=object)
    for k in range(need):
        grid[k // n_idx, k % n_idx] = devices[k]
    return Mesh(grid)


def replicate(dix, device):
    """``dix`` (a ``DeviceIndex``) on ``device``: ``dix`` itself where it
    is there already, else a copy of every table."""
    device = _canonical(device)
    if _canonical(dix.device) == device:
        return dix
    tensors = {f.name: getattr(dix, f.name).to(device)
               for f in dataclasses.fields(dix)
               if isinstance(getattr(dix, f.name), torch.Tensor)}
    return dataclasses.replace(dix, device=device, **tensors)


def shard_index(mesh: Mesh, dix) -> dict:
    """Place a ``DeviceIndex`` on the mesh.

    Returns {"tables": [the index on ``devices[d, 0]``, for each dp row d],
    "ekmer0"/"ekmer1": [[byte range i of the table on ``devices[d, i]``,
    for each i] for each d]}. The existence tables are cut into ``n_idx``
    equal byte ranges (a length that ``n_idx`` does not divide raises); a
    range is a view of the table, so the ranges concatenate back to it
    and share its storage wherever the device repeats."""
    n_dp, n_idx = mesh.devices.shape
    placed = {"tables": [replicate(dix, mesh.devices[d, 0])
                         for d in range(n_dp)]}
    for name in ("ekmer0", "ekmer1"):
        tab = getattr(dix, name)
        if tab.dim() != 1 or tab.shape[0] % n_idx:
            raise ValueError(f"{name}: {tuple(tab.shape)} bytes do not cut "
                             f"into {n_idx} equal ranges")
        span = tab.shape[0] // n_idx
        placed[name] = [[tab[i * span:(i + 1) * span].to(mesh.devices[d, i])
                         for i in range(n_idx)] for d in range(n_dp)]
    return placed


def _owned_bits(tab, byte_idx, shift, first):
    """The probe bits that the byte range ``tab`` (bytes ``first`` ..
    ``first + len(tab) - 1`` of its table) owns; 0 where another range
    owns the byte."""
    span = tab.shape[0]
    local = byte_idx - first
    own = (local >= 0) & (local < span)
    byte = tab[local.clamp(0, span - 1).long()].to(I32)
    return torch.where(own, (byte >> shift) & 1, 0)


def bloom_rows(mesh: Mesh, placed: dict, d: int, codes, lengths, l_ek: int,
               single_base_max: int, mask_bits: int):
    """(rows, L - l_ek + 1) bool on ``devices[d, 0]``: each e-kmer of dp
    row d's reads passes the complexity filter and both existence tables.
    Every idx shard computes the probe addresses, answers those it owns,
    and the answers are summed on the row's first device (an OR: exactly
    one shard owns each byte)."""
    home = mesh.devices[d, 0]
    hits = [None, None]
    valid = None
    for i in range(mesh.devices.shape[1]):
        dev = mesh.devices[d, i]
        b1, s1, b2, s2, v = ekmer_probe_indices(
            codes.to(dev), lengths.to(dev), l_ek, single_base_max, mask_bits)
        if valid is None:
            valid = v.to(home)
        for t, (name, b, s) in enumerate((("ekmer0", b1, s1),
                                          ("ekmer1", b2, s2))):
            tab = placed[name][d][i]
            h = _owned_bits(tab, b, s, i * tab.shape[0]).to(home)
            hits[t] = h if hits[t] is None else hits[t] + h
    return (hits[0] > 0) & (hits[1] > 0) & valid


def sharded_seed_step(mesh: Mesh, placed: dict, l_ek: int,
                      single_base_max: int, mask_bits: int,
                      n_probes: int = 8):
    """The seeding step on the mesh: ``run(codes, lengths) -> (hit_count,
    mem_len, mem_valid)``, equal to ``pipeline.seed_wave_step`` on one
    device. The reads (codes (B, L) uint8, lengths (B,)) are cut into
    ``n_dp`` equal row ranges; each dp row's existence probes are answered
    by its idx shards (``bloom_rows``) and its first ``n_probes`` hit
    positions MEM-probed (fast-mode parameters) on its first device. The
    results come back on the device of ``codes``."""
    n_dp = mesh.devices.shape[0]

    def run(codes, lengths):
        B = codes.shape[0]
        if B % n_dp:
            raise ValueError(f"{B} reads do not cut into {n_dp} dp rows")
        r = B // n_dp
        outs = []
        for d in range(n_dp):
            home = mesh.devices[d, 0]
            c = codes[d * r:(d + 1) * r].to(home)
            lens = lengths[d * r:(d + 1) * r].to(home)
            hit = bloom_rows(mesh, placed, d, c, lens, l_ek,
                             single_base_max, mask_bits)
            t = placed["tables"][d]
            outs.append(mem_wave(t.index_refs(), t.fm_blocks, t.rank,
                                 t.hash13, c, hit, l_ek, n_probes))
        return tuple(torch.cat([o[k].to(codes.device) for o in outs])
                     for k in range(3))

    return run

