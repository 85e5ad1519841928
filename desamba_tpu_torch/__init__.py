"""desamba_tpu_torch: the deSAMBA device classifier in PyTorch + CUDA.

A port of ``desamba_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; every module of
``desamba_tpu/engine/device`` that the classify pass runs has a
counterpart at the same path here, held bit-for-bit against it by the
``tests/test_torch_*.py`` parity tests. The framework-free host code it
needs from ``desamba_tpu`` is copied here at the same relative paths
(``constants``, ``io``, ``index``, ``engine/gold``), and the copies are
held equal to the originals by ``tests/test_torch_copies.py``. This
package imports neither ``jax`` nor anything of ``desamba_tpu``
(``tests/test_torch_import.py``); ``io/native.py`` builds the repo's C
runtime (``csrc/``) into ``io/_build/``.

Integer conventions (the pipeline is integer throughout, so "equal"
means bit-equal):

- u32 values travel as ``int32`` bit patterns, exactly like the JAX
  package's ``int32``-carried coordinates. ``torch.uint32`` supports too
  few ops; where the JAX code computes in ``uint32`` (hashes, packed
  words, bitmaps) the port widens to ``int64`` and masks with
  ``0xFFFFFFFF`` (``intops.u32``), and narrows back with ``intops.i32``.
- Compares are unsigned only where the JAX code casts to ``U32``
  (``chain._absu``, the ``po.ult``/``po.ule`` points of the rescore
  kernel); everywhere else they are signed ``int32`` compares.
- ``torch.arange`` and ``torch.cumsum`` default to ``int64`` where
  ``jnp`` returns ``int32``: the port passes ``dtype=`` or narrows
  explicitly wherever the width matters.
- JAX gathers clamp out-of-range indices (after wrapping negatives once)
  and its scatters drop them; torch raises on both, and a CUDA
  out-of-bounds access is a device fault. The port therefore clamps
  gathers (``intops.take``) and masks scatters explicitly, never clamping
  them (``compaction.compact_rows``, ``fm._interval_sa``), at every point
  the JAX code relies on either rule.

Every stage takes an explicit ``device``; the entry points
(``DeviceClassifier``, ``cli``, ``tools.gather_bench``, ``tools.micro``,
``tools.caps``) default to ``cuda``, and there is no ``torch.compile``. The
hand-written kernels live in ``kernels/*.cu`` and are built with ``nvcc``
at first use (``kernels/build.py``): the per-read 9-mer SDP rescore
(``rescore.cu``), the compare-count lookup (``cmpcount.cu``, wrapped by
``tools/cmpcount.py``), the tile helpers (``plops.cuh`` and its harness
``plops.cu``, wrapped by ``engine/device/plops.py``), the primitive benches
(``micro.cu``, ``tools/micro.py``), the capability probes (``caps.cu``,
``tools/caps.py``), the fast and slow ladders (``ladder.cu`` over the
device functions of ``ladder.cuh``, a warp a lane, wrapped by
``engine/device/ladder.py``) and the M2/M3 chaining (``chain.cu``, wrapped
by ``engine/device/chain.py``).
"""
