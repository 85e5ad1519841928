"""Row-range shards of the index's gather tables over the mesh's ``idx`` axis.

Counterpart of ``desamba_tpu/parallel/sharded.py``, the layout for an index
larger than one card: every large gather table is flattened, zero-padded
to a multiple of ``n_idx * ROW_ALIGN`` elements and cut into ``n_idx``
equal ranges, range i on ``devices[d, i]`` of every dp row d. No device
holds a whole table.

``ShardedArray`` and ``ShardedRows`` give the global table's surface
(``shape``, ``dtype``, ``reshape(-1)``, ``reshape(-1, row_b)``,
``as_rows(row_b)``, ``a[i]`` and ``a[0, i]``), so the eager stages (the
plain versions of the ladder and rescore kernels) run on them unchanged.
Their ``__getitem__`` is the plain version of the JAX package's mask and
``psum`` over ``idx``: each shard gathers at the indices it owns, 0
elsewhere, and the parts are summed on the dp row's first device (in
int32 for uint8 tables). An index outside ``[0, n)`` has no owner, or
lands in the zero padding, so it reads 0 where a whole table's gather
(``intops.take``) would clamp it; ``intops.take`` hands these classes
their own ``__getitem__``, so the eager stages give the JAX sharded
result.

The kernels (``kernels/ladder.cu``, ``kernels/rescore.cu``) read the same
shards through their ``ShardTab`` accessor: the shard pointers, by value in
the launch's argument block (``shard_tab``).
"""
from __future__ import annotations

import math

import torch

from ..engine.device.intops import I32, I64
from ..kernels.build import MAX_IDX, ShardTab

# Index tables big enough to be worth sharding (everything whose size
# scales with the reference collection); ref_off, rank, q_mem and q_lv stay
# whole (O(n_ref) or O(1)).
SHARDED_IXR_FIELDS = frozenset({
    "lf", "lfc", "row_char", "row_pos", "uni_start", "uni_len",
    "uni_ref_list", "rp_global_off", "rp_ref_id", "ref_bin", "ref_pk",
    "text_pk", "sep_any", "sep_hash", "samp_bits", "isa", "pos2uni",
})
# DeviceIndex tables sharded beside them: the FM blocks and the 13-mer
# jump table (read inside the ladders)
SHARDED_DIX_FIELDS = SHARDED_IXR_FIELDS | {"fm_blocks", "hash13"}

# Shard lengths are a multiple of ROW_ALIGN, so as_rows(row_b) is legal for
# every row_b that divides it: the powers of two up to 256 (the rescore
# kernel's 128-word reference rows among them) and the 9-word FM block
# rows (2304 = 256 * 9). A row never straddles two shards.
ROW_ALIGN = 2304


def _flat_pad(arr, n_idx: int):
    """Flatten row-major and zero-pad to a multiple of ``n_idx *
    ROW_ALIGN`` elements. Returns (flat, the table's shape)."""
    t = torch.as_tensor(arr)
    flat = t.reshape(-1)
    pad = (-flat.shape[0]) % (n_idx * ROW_ALIGN)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, tuple(t.shape)


def shard_table(mesh, arr):
    """Cut one table by row range over ``idx``.

    Returns ([[flat shard i on ``mesh.devices[d, i]`` for each i] for each
    dp row d], the table's shape). Each shard is an allocation of its own;
    one placed twice on a device (a dp row that repeats another's devices)
    is the same tensor."""
    from .mesh import _canonical

    n_dp, n_idx = mesh.devices.shape
    if n_idx > MAX_IDX:
        raise ValueError(f"an idx axis of {n_idx} shards: the kernels' "
                         f"accessor holds at most {MAX_IDX}")
    flat, gshape = _flat_pad(arr, n_idx)
    span = flat.shape[0] // n_idx
    placed, rows = {}, []
    for d in range(n_dp):
        row = []
        for i in range(n_idx):
            dev = _canonical(mesh.devices[d, i])
            key = (str(dev), i)
            if key not in placed:
                placed[key] = flat[i * span:(i + 1) * span].to(
                    dev, copy=True).contiguous()
            row.append(placed[key])
        rows.append(row)
    return rows, gshape


def _owned_sum(shards, span, idx, home, rows: bool):
    """The plain version of the JAX mask and psum: each shard gathers at
    the indices it owns (span elements, or rows, each), 0 elsewhere; the
    parts summed on ``home``."""
    idx = torch.as_tensor(idx, device=home).to(I64)
    out, dtype = None, shards[0].dtype
    for i, s in enumerate(shards):
        loc = idx.to(s.device) - i * span
        own = (loc >= 0) & (loc < span)
        v = s[torch.where(own, loc, 0)]
        z = torch.where(own[..., None] if rows else own, v,
                        torch.zeros((), dtype=dtype, device=s.device))
        if z.element_size() < 4:        # uint8 tables: sum in int32
            z = z.to(I32)
        z = z.to(home)
        out = z if out is None else out + z
    return out.to(dtype)


class ShardedArray:
    """A table as ``n_idx`` equal flat shards (``shards``, each on its
    device) of its row-major flattening; ``global_shape`` is the table's
    shape. ``home`` is the device the gathers answer on (the dp row's
    first)."""

    def __init__(self, shards, global_shape, home=None):
        self.shards = list(shards)
        self.global_shape = tuple(global_shape)
        self.shard_len = self.shards[0].shape[0]
        if any(s.dim() != 1 or s.shape[0] != self.shard_len
               for s in self.shards):
            raise ValueError("shards must be 1-D and of one length")
        if self.shard_len * len(self.shards) < self.numel():
            raise ValueError("the shards are shorter than the table")
        self.home = torch.device(home if home is not None
                                 else self.shards[0].device)

    @property
    def shape(self):
        return self.global_shape

    @property
    def dtype(self):
        return self.shards[0].dtype

    def numel(self) -> int:
        return math.prod(self.global_shape)

    def __len__(self):
        return self.global_shape[0]

    def reshape(self, *shape):
        if len(shape) == 1 and not isinstance(shape[0], int):
            shape = tuple(shape[0])
        if len(shape) == 2 and shape[0] == -1 and shape[1] > 0:
            return ShardedArray(self.shards, (self.numel(),),
                                self.home).as_rows(shape[1])
        if shape != (-1,):
            raise ValueError("a ShardedArray takes reshape(-1) or "
                             "reshape(-1, row_b)")
        return ShardedArray(self.shards, (self.numel(),), self.home)

    def as_rows(self, row_b: int) -> "ShardedRows":
        """The flat table as (ceil(n / row_b), row_b) rows; row_b must
        divide the shard length, so no row straddles two shards."""
        if self.shard_len % row_b:
            raise ValueError(f"shard length {self.shard_len} is not a "
                             f"multiple of {row_b}")
        return ShardedRows([s.view(-1, row_b) for s in self.shards],
                           -(-self.numel() // row_b), self.home)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            # (0, i) on a (1, W) packed table: flat index i
            if len(idx) != 2 or self.global_shape[0] != 1:
                raise IndexError("a ShardedArray takes a[i], or a[0, i] on a "
                                 "(1, W) table")
            idx = idx[1]
        if isinstance(idx, slice):
            idx = torch.arange(*idx.indices(self.numel()))
        return _owned_sum(self.shards, self.shard_len, idx, self.home, False)

    def to(self, device) -> "ShardedArray":
        """The shards and the home on ``device`` (the host view that the
        rescore kernel's plain version reads)."""
        return ShardedArray([s.to(device) for s in self.shards],
                            self.global_shape, device)

    def cpu(self) -> "ShardedArray":
        return self.to("cpu")


class ShardedRows:
    """A row view (n_rows, row_b) of a ShardedArray: ``a[i]`` with i (...)
    gives (..., row_b) rows, a zero row where no shard owns row i."""

    def __init__(self, rows, n_rows: int, home):
        self.rows = list(rows)
        self.n_rows = int(n_rows)
        self.home = torch.device(home)

    @property
    def shards(self):
        """The flat shards (the kernels' accessor reads these)."""
        return [r.reshape(-1) for r in self.rows]

    @property
    def shard_len(self) -> int:
        return self.rows[0].numel()

    @property
    def shape(self):
        return (self.n_rows, self.rows[0].shape[1])

    @property
    def dtype(self):
        return self.rows[0].dtype

    def __getitem__(self, idx):
        return _owned_sum(self.rows, self.rows[0].shape[0], idx, self.home,
                          True)


def shard_tab(t) -> ShardTab:
    """The kernels' accessor of sharded table ``t`` (``ShardTab`` of
    kernels/shard.cuh): its shard pointers, the shard length and count."""
    shards = t.shards
    if len(shards) > MAX_IDX:
        raise ValueError(f"{len(shards)} shards: the accessor holds at most "
                         f"{MAX_IDX}")
    tab = ShardTab()
    for i, s in enumerate(shards):
        tab.p[i] = s.data_ptr()
    tab.len = int(t.shard_len)
    tab.shards = len(shards)
    return tab
