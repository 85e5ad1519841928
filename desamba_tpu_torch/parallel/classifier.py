"""MeshClassifier: the classify pass on a (dp, idx) mesh of devices.

Counterpart of ``desamba_tpu/parallel/classifier.py``, to its layout
contract with ``DeviceClassifier`` (which this subclasses):

  dp  -- reads. Every per-lane stage runs on each dp row's first device
         over that row's share: the existence probe and the rescore (and
         its prep) over batch rows, the ladders over lane columns, the M2
         chaining over reads with the ladder pack on every row. Each row
         runs its own kernels over its own lanes: no cross-device
         lockstep.
  idx -- index memory. The existence-filter bit tables are cut into byte
         ranges over ``idx``: each shard answers the probes it owns and the
         answers are OR-merged (``mesh.bloom_rows``). The tables read
         inside the kernels (FM blocks, hash13, the reference) are
         replicated on every dp row.

  - batch rows and ladder lanes are power-of-two buckets, so a
    power-of-two ``n_dp`` divides them;
  - ladder packs are per shard, ``2 * NB // n_dp`` rows each: a lane
    overflows against its shard's pack (so ``fallback_stats()`` is the
    JAX ``MeshClassifier``'s, not the single device's), and the host
    globalizes the pack offsets (``_globalize_base``) before it builds the
    gather maps;
  - the M3 sub-batch (chaining and rescore) runs on one device, as in the
    JAX package.

The merges (concatenations on the first device, the OR of the existence
answers) are PyTorch copies and sums between the kernels, never inside
one. ``shard_full=True`` (every gather table split by row range over
``idx``, the JAX package's ``parallel/sharded.py``) needs kernels that
gather from row-range shards, and raises until they exist.
"""
from __future__ import annotations

import numpy as np
import torch

from ..engine.device import chain as dc
from ..engine.device import rescore as dr
from ..engine.device import rescore_pl as drp
from ..engine.device.classifier import A_CAP, M_CAP, DeviceClassifier
from ..engine.device.ladder import IV_HOT, run_fast_ladder, run_slow_ladder
from .mesh import bloom_rows, make_mesh, shard_index


class MeshClassifier(DeviceClassifier):
    def __init__(self, idx, opts=None, mesh=None, batch_size: int = 2048,
                 shard_full: bool = False):
        """``mesh`` defaults to every CUDA device over ``dp``. The
        classifier's own device (its host uploads, the M3 sub-batch and
        the merged outputs) is ``mesh.devices[0, 0]``."""
        if shard_full:
            raise NotImplementedError(
                "MeshClassifier(shard_full=True): every gather table split "
                "by row range over idx needs kernels that gather from the "
                "shards; it is the next slice of the port (ROADMAP.md, "
                "Queue 1)")
        if mesh is None:
            if not torch.cuda.is_available():
                raise RuntimeError("MeshClassifier: no CUDA device is "
                                   "available; pass a mesh")
            mesh = make_mesh(torch.cuda.device_count(), 1)
        n_dp = mesh.shape["dp"]
        if n_dp & (n_dp - 1):
            raise ValueError(f"dp size {n_dp} must be a power of two "
                             f"(bucketed shapes divide only then)")
        super().__init__(idx, opts, device=mesh.devices[0, 0],
                         batch_size=batch_size)
        self.mesh = mesh
        self.n_dp = n_dp
        self.placed = shard_index(mesh, self.dix)
        # each dp row's (device, index, IndexRefs, reference words)
        self._rows = [(t.device, t, t.index_refs(),
                       self.ref_words.to(t.device))
                      for t in self.placed["tables"]]

    def _split(self, n, k=None):
        """Row ranges of ``n`` rows over ``k`` (default ``n_dp``) dp rows:
        [(dp row, slice)]."""
        k = self.n_dp if k is None else k
        if n % k:
            raise ValueError(f"{n} rows do not cut into {k} dp rows")
        r = n // k
        return [(d, slice(d * r, (d + 1) * r)) for d in range(k)]

    def _gather(self, parts):
        """Concatenate per-row results (tuples of tensors) in row order on
        the classifier's device."""
        return tuple(torch.cat([p[j].to(self.device) for p in parts])
                     for j in range(len(parts[0])))

    # ---- sharded stages ----------------------------------------------------
    def _k_bloom(self, strands, lens):
        return torch.cat([
            bloom_rows(self.mesh, self.placed, d, strands[sl], lens[sl],
                       self.idx.len_e_kmer, self.idx.single_base_max,
                       self.dix.mask_bits).to(self.device)
            for d, sl in self._split(strands.shape[0])])

    def _pack_cap_local(self, NB):
        # each shard's pack capacity (pack offsets are shard-local before
        # _globalize_base)
        return 2 * NB // self.n_dp

    def _globalize_base(self, base, NB):
        shard = np.arange(len(base)) // (NB // self.n_dp)
        return base + shard * self._pack_cap_local(NB)

    def _k_ladder(self, kind, codes_fr, buf_len, pre13, lane_args, NB,
                  iv_cap=IV_HOT):
        # the reads go to every row (a read's lanes may land on any
        # shard); the lane columns split over dp
        run = run_fast_ladder if kind == "fast" else run_slow_ladder
        kw = dict(l_ek=self.idx.len_e_kmer, a_cap=A_CAP,
                  pack_cap=self._pack_cap_local(NB), iv_cap=iv_cap)
        if kind != "fast":
            kw["m_cap"] = M_CAP
        parts, ovf = [], False
        for d, sl in self._split(NB):
            dev, t, ixr, _ = self._rows[d]
            packed, info, p_ovf = run(
                ixr, t.fm_blocks, t.rank, t.hash13, codes_fr.to(dev),
                buf_len.to(dev), pre13.to(dev), t.q_mem, t.q_lv,
                lane_args[:, sl].to(dev).contiguous(), **kw)
            parts.append((packed, info))
            ovf |= p_ovf
        packed, info = self._gather(parts)
        return packed, info, ovf

    def _k_chain(self, packed, gidx, nanc):
        # the pack on every row; the reads split over dp
        parts = []
        for d, sl in self._split(gidx.shape[0]):
            dev = self._rows[d][0]
            parts.append(dc.chain_step(
                packed.to(dev), torch.as_tensor(gidx[sl]).to(dev),
                torch.as_tensor(nanc[sl]).to(dev)))
        return self._gather(parts)

    def _k_prep(self, sel, chs3, ns3, pre3, anc3):
        # the batch axis: axis 0 of sel, axis 1 of the stacked inputs; a
        # batch smaller than n_dp (the M3 sub-batch, 8 rows and up) takes
        # its first dp rows
        parts = []
        for d, sl in self._split(len(sel), min(self.n_dp, len(sel))):
            dev = self._rows[d][0]
            parts.append(dc.prep_rescore(
                torch.as_tensor(sel[sl]).to(dev), chs3[:, sl].to(dev),
                ns3[:, sl].to(dev), pre3[:, sl].to(dev), anc3[:, sl].to(dev)))
        return self._gather(parts)

    def _k_rescore(self, inp):
        parts = []
        for d, sl in self._split(inp.n_chains.shape[0]):
            dev, t, _, words = self._rows[d]
            part = dr.RescoreIn(*(x[sl].to(dev) for x in inp))
            parts.append(drp.rescore(part, words, t.ref_off, t.ref_len_arr,
                                     t.n_bases))
        return self._gather(parts)

    def _k_rescore_m3(self, inp):
        # one device, as in the JAX package
        return DeviceClassifier._k_rescore(self, inp)
