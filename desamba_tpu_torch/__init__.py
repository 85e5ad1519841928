"""desamba_tpu_torch: the deSAMBA device classifier in PyTorch + CUDA.

A port of ``desamba_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
The JAX package stays the reference; every module of
``desamba_tpu/engine/device`` that the classify pass runs has a
counterpart at the same path here, held bit-for-bit against it by the
``tests/test_torch_*.py`` parity tests. The framework-free parts of
``desamba_tpu`` (constants, index, io, the gold oracle, analysis) are
imported, not copied. This package never imports ``jax``.

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

Every stage takes an explicit ``device``; there is no global default
device and no ``torch.compile``. The one hand-written kernel, the per-read
9-mer SDP rescore, lives in ``kernels/rescore.cu`` and is built with
``nvcc`` at first use (``kernels/build.py``).
"""
