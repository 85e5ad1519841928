"""Port DeviceIndex == JAX DeviceIndex, field for field, bit for bit."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")


@pytest.fixture(scope="module")
def jax_fields(small_my_index):
    from desamba_tpu.engine.device.arrays import DeviceIndex

    dix = DeviceIndex.build(small_my_index)
    from desamba_tpu_torch.engine.device.arrays import (SCALAR_FIELDS,
                                                        TENSOR_FIELDS)

    out = {f: np.asarray(getattr(dix, f)) for f in TENSOR_FIELDS}
    out.update({f: getattr(dix, f) for f in SCALAR_FIELDS})
    return out


@pytest.mark.parametrize("how", ["build", "from_arrays"])
def test_device_index_fields_equal_jax(small_my_index, jax_fields, how):
    from desamba_tpu_torch.engine.device.arrays import (SCALAR_FIELDS,
                                                        TENSOR_FIELDS,
                                                        DeviceIndex)

    if how == "build":
        tix = DeviceIndex.build(small_my_index, "cpu")
    else:
        tix = DeviceIndex.from_arrays(jax_fields, "cpu")
    for f in TENSOR_FIELDS:
        exp = jax_fields[f]
        got = getattr(tix, f)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", f
        got = got.numpy()
        if exp.dtype == np.uint32:
            assert got.dtype == np.int32, f   # u32 as int32 bit patterns
            got = got.view(np.uint32)
        assert got.dtype == exp.dtype, (f, got.dtype, exp.dtype)
        assert got.shape == exp.shape, f
        assert np.array_equal(got, exp), f
    for f in SCALAR_FIELDS:
        assert getattr(tix, f) == jax_fields[f], f
    assert tix.hash13.shape == ((1 << 26) + 1,)
