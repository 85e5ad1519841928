"""The classify pass on several devices and processes.

Counterpart of ``desamba_tpu/parallel``: ``mesh`` (the (dp, idx) device
grid, the index placed on it, the sharded seeding step), ``sharded`` (the
gather tables cut by row range over idx, for ``shard_full``),
``classifier`` (``MeshClassifier``) and ``distributed`` (the multi-process
bootstrap over ``torch.distributed`` and the process-aware mesh).
"""
from .classifier import MeshClassifier
from .mesh import Mesh, make_mesh, shard_index, sharded_seed_step

__all__ = ["Mesh", "MeshClassifier", "make_mesh", "shard_index",
           "sharded_seed_step"]
