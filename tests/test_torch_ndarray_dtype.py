"""``NDArray.dtype`` in the port against the JAX package's: the numpy
scalar type (``mxnet_tpu/ndarray.py:167-169``), compared in exact
equality.  float64 and int64 are compared with JAX's 64-bit types on
(``jax.enable_x64``): without it the JAX package narrows them to 32 bits,
where the port keeps what it was given.  bfloat16 is the stated
divergence: the port answers the string ``"bfloat16"``, the name of the
reference's ``ml_dtypes.bfloat16`` type."""
import jax
import ml_dtypes
import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

DTYPES = ["float32", "float16", "float64", "int32", "int64", "uint8"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_dtype_is_the_numpy_type_of_the_reference(dtype):
    src = np.arange(24).reshape(4, 6).astype(dtype)
    with jax.enable_x64(True):
        refs = (mxj.nd.array(src, dtype=dtype).dtype,
                mxj.nd.zeros((2, 3), dtype=dtype).dtype)
    gots = (mxt.nd.array(src, ctx=mxt.cpu(), dtype=dtype).dtype,
            mxt.nd.zeros((2, 3), ctx=mxt.cpu(), dtype=dtype).dtype)
    for got, ref in zip(gots, refs):
        assert got is ref is np.dtype(dtype).type
        assert got == np.dtype(dtype).type


def test_float32_array_compares_equal_to_np_float32():
    """The reference's own example: a float32 array's dtype equals
    ``np.float32``, and passes back into the port's constructors."""
    a = mxt.nd.array(np.arange(24, dtype="f"), ctx=mxt.cpu())
    assert a.dtype == np.float32 == mxj.nd.array(np.arange(24,
                                                           dtype="f")).dtype
    b = mxt.nd.zeros(a.shape, ctx=mxt.cpu(), dtype=a.dtype)
    assert b.dtype is np.float32 and b._data.dtype == a._data.dtype


def test_bfloat16_answers_its_name():
    """bfloat16: the port answers ``"bfloat16"``, the name of the type the
    reference answers, and that answer round-trips through ``zeros``."""
    ref = mxj.nd.zeros((2, 3), dtype="bfloat16").dtype
    assert ref is ml_dtypes.bfloat16
    got = mxt.nd.zeros((2, 3), ctx=mxt.cpu(), dtype="bfloat16").dtype
    assert got == "bfloat16" == np.dtype(ref).name
    again = mxt.nd.zeros((1,), ctx=mxt.cpu(), dtype=got)
    assert again.dtype == "bfloat16"
    assert str(again._data.dtype) == "torch.bfloat16"


def test_optimizer_state_keeps_the_weight_dtype():
    """The internal readers take ``._data.dtype``: an optimizer state and
    a module's host parameter copies have the weight's torch dtype."""
    w = mxt.nd.array(np.ones((2, 3), np.float16), ctx=mxt.cpu(),
                     dtype="float16")
    mom = mxt.optimizer.SGD(momentum=0.9).create_state(0, w)
    m, v = mxt.optimizer.Adam().create_state(0, w)
    for s in (mom, m, v):
        assert s.dtype is np.float16 and s._data.dtype == w._data.dtype
