"""The port's random state (``mxnet_tpu_torch/random.py``) on the CPU:
``get_state``/``set_state`` round-trip every stream (device generators,
the forwards' seeds), ``randint``'s range and dtype, seed determinism, and
``uniform``/``normal`` moments through the ``_sample_*`` ops.  The two
packages' streams differ by design, so nothing here matches the JAX
package's numbers; the moment checks hold both to the distribution's
mean and variance within 5 standard errors over 10^5 draws.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

HOST = mx.cpu()


def _draws():
    """One of each kind of draw the state governs."""
    ex = mx.sym.Dropout(mx.sym.var("x"), p=0.5).simple_bind(HOST, x=(4, 8))
    ex.arg_dict["x"][:] = 1.0
    return [mx.random.uniform(0, 1, shape=(5,), ctx=HOST).asnumpy(),
            mx.random.normal(0, 1, shape=(5,), ctx=HOST).asnumpy(),
            mx.nd.uniform(shape=(3,), ctx=HOST).asnumpy(),
            mx.random.randint(0, 100, (6,), ctx=HOST).asnumpy(),
            ex.forward(is_train=True)[0].asnumpy(),
            np.array([mx.random.next_seed()])]


def test_get_state_set_state_round_trip():
    mx.random.seed(11)
    _draws()                          # advance every stream
    state = mx.random.get_state()
    first = _draws()
    _draws()
    mx.random.set_state(state)
    again = _draws()
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert mx.random.get_seed() == 11
    # the state object is opaque and a snapshot: drawing does not move it
    assert mx.random.get_state()["forwards"] != state["forwards"]


def test_seed_determinism():
    runs = []
    for _ in range(2):
        mx.random.seed(42)
        runs.append(_draws())
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    mx.random.seed(43)
    assert not np.array_equal(_draws()[0], runs[0][0])


@pytest.mark.parametrize("dtype", ["int32", "int64", "uint8"])
def test_randint_range_and_dtype(dtype):
    mx.random.seed(1)
    r = mx.random.randint(-3, 9, (2000,), ctx=HOST, dtype=dtype) \
        if dtype != "uint8" else \
        mx.random.randint(3, 9, (2000,), ctx=HOST, dtype=dtype)
    lo = -3 if dtype != "uint8" else 3
    v = r.asnumpy()
    assert v.dtype == np.dtype(dtype) and r.shape == (2000,)
    assert v.min() == lo and v.max() == 8
    jv = jmx.random.randint(lo, 9, (2000,)).asnumpy()
    assert jv.dtype == np.int32 and jv.min() >= lo and jv.max() <= 8
    assert mx.random.randint(0, 4, 5, ctx=HOST).shape == (5,)


@pytest.mark.parametrize("kind, kwargs, mean, var", [
    ("uniform", {"low": 2.0, "high": 5.0}, 3.5, 9.0 / 12),
    ("normal", {"loc": -1.0, "scale": 0.5}, -1.0, 0.25),
], ids=["uniform", "normal"])
def test_sampler_moments_and_out(kind, kwargs, mean, var):
    n = 100000
    fn = getattr(mx.random, kind)
    mx.random.seed(9)
    x = fn(shape=(n,), ctx=HOST, **kwargs).asnumpy().astype(np.float64)
    assert abs(x.mean() - mean) <= 5 * np.sqrt(var / n)
    m4 = np.mean((x - x.mean()) ** 4)
    assert abs(x.var() - var) <= 5 * np.sqrt((m4 - var ** 2) / n)
    jx = getattr(jmx.random, kind)(shape=(n,), **kwargs).asnumpy() \
        .astype(np.float64)
    assert abs(jx.mean() - mean) <= 5 * np.sqrt(var / n)
    # out= fills the array's own storage, in its shape and dtype
    out = mx.nd.zeros((4, 6), ctx=HOST, dtype="float16")
    storage = out._data
    res = fn(out=out, **kwargs)
    assert res is out and out._data is storage
    assert out.dtype == np.float16 and out.shape == (4, 6)
    assert np.all(out.asnumpy() != 0)
