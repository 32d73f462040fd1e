"""The port's image I/O ops (``mxnet_tpu_torch/ops/image_io.py``) against the
JAX package's on the CPU.

Tolerances: ``imdecode`` and ``copyMakeBorder`` exact.  ``imresize``
against ``jax.image.resize`` for every ``interp``: uint8 within 1 level;
float32 within 1e-5 of the image's largest magnitude (the two sum the
same weights in another order).  The port's weight matrices equal JAX's
own ``compute_weight_mat`` within 1e-6."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import image_io as tio
from mxnet_tpu_torch.ops import registry as treg


def _jpeg_png():
    import cv2
    rs = np.random.RandomState(0)
    img = (rs.rand(21, 30, 3) * 255).astype(np.uint8)
    return [cv2.imencode(".jpg", img)[1].tobytes(),
            cv2.imencode(".png", img)[1].tobytes(),
            cv2.imencode(".png", img[:, :, 0])[1].tobytes()]


@pytest.mark.parametrize("flag,to_rgb", [(1, 1), (1, 0), (0, 1), (-1, 1)])
def test_imdecode_exact(flag, to_rgb):
    for buf in _jpeg_png():
        j = jmx.nd.imdecode(jmx.nd.array(np.frombuffer(buf, np.uint8),
                                         dtype="uint8"),
                            flag=flag, to_rgb=to_rgb).asnumpy()
        with tmx.cpu():
            t = tmx.nd.imdecode(tmx.nd.array(np.frombuffer(buf, np.uint8),
                                             dtype="uint8"),
                                flag=flag, to_rgb=to_rgb)
        assert t.dtype == np.uint8
        np.testing.assert_array_equal(t.asnumpy(), j)
    with tmx.cpu(), pytest.raises(tmx.MXNetError):
        tmx.nd.imdecode(tmx.nd.array(np.zeros((2, 2), np.uint8),
                                     dtype="uint8"))


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_imresize_matches_jax_image_resize(interp, dtype):
    rs = np.random.RandomState(interp)
    src = (rs.rand(37, 45, 3) * 255).astype(dtype)
    for h, w in ((20, 30), (64, 70), (37, 60), (11, 45)):
        j = jmx.nd.imresize(jmx.nd.array(src, dtype=dtype), w=w, h=h,
                            interp=interp).asnumpy()
        with tmx.cpu():
            t = tmx.nd.imresize(tmx.nd.array(src, dtype=dtype), w=w, h=h,
                                interp=interp).asnumpy()
        assert t.dtype == j.dtype and t.shape == j.shape == (h, w, 3)
        d = np.abs(t.astype(np.float64) - j.astype(np.float64)).max()
        if dtype == "uint8":
            assert d <= 1, (h, w, d)
        else:
            assert d <= 1e-5 * np.abs(j).max(), (h, w, d)


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3"])
def test_resize_weights_match_jax(method):
    from jax._src.image import scale as jscale
    import jax.numpy as jnp
    kernel = jscale._kernels[jscale.ResizeMethod.from_string(method)]
    for m, n in ((37, 20), (20, 37), (45, 45), (8, 3)):
        j = np.asarray(jscale.compute_weight_mat(
            m, n, jnp.float32(n / m), jnp.float32(0.0), kernel, True))
        t = tio.resize_weights(m, n, method).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_copy_make_border_exact():
    rs = np.random.RandomState(1)
    for dtype in ("uint8", "float32"):
        src = (rs.rand(9, 7, 3) * 200).astype(dtype)
        kw = dict(top=1, bot=2, left=3, right=4, value=17.0)
        j = jmx.nd.copyMakeBorder(jmx.nd.array(src, dtype=dtype),
                                  **kw).asnumpy()
        with tmx.cpu():
            t = tmx.nd.copyMakeBorder(tmx.nd.array(src, dtype=dtype),
                                      **kw).asnumpy()
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    with tmx.cpu(), pytest.raises(tmx.MXNetError):
        tmx.nd.copyMakeBorder(tmx.nd.array(src), top=1, type=1)


def test_symbol_ops_and_gradient():
    """imresize/copyMakeBorder bind like any op; their gradients are the
    transposed products of the forward."""
    rs = np.random.RandomState(2)
    x = rs.rand(6, 8, 3).astype(np.float32)
    with tmx.cpu():
        data = tmx.sym.Variable("data")
        net = tmx.sym.copyMakeBorder(
            tmx.sym.imresize(data, w=5, h=4, interp=2), top=1, left=2)
        ex = net.simple_bind(tmx.cpu(), data=x.shape)
        out = ex.forward(is_train=True, data=x)[0]
        assert out.shape == (5, 7, 3)
        ex.backward([tmx.nd.ones(out.shape)])
        g = ex.grad_dict["data"].asnumpy()
    wh = tio.resize_weights(6, 4, "cubic").numpy()
    ww = tio.resize_weights(8, 5, "cubic").numpy()
    expect = wh.sum(1)[:, None, None] * ww.sum(1)[None, :, None] * \
        np.ones((1, 1, 3), np.float32)
    np.testing.assert_allclose(g, expect, rtol=1e-5, atol=1e-6)


def test_registry_holds_the_image_io_ops():
    names = [k for k, v in jreg.OP_REGISTRY.items()
             if v.fn.__module__ == "mxnet_tpu.ops.image_io"]
    assert sorted(names) == sorted(["imdecode", "_cvimdecode", "imresize",
                                    "_cvimresize", "copyMakeBorder",
                                    "_cvcopyMakeBorder"])
    for name in names:
        j, t = jreg.OP_REGISTRY[name], treg.OP_REGISTRY[name]
        assert t.name == j.name and t.aliases == j.aliases
        assert t.get_input_names({}) == j.get_input_names({})
    # counted in a fresh process: other tests register ops of their own
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch as mx\n"
         "print(len({v.name for v in mx.ops.OP_REGISTRY.values()}))"],
        capture_output=True, text=True, timeout=120)
    assert res.stdout.split() == ["187"], res.stderr[-2000:]
    assert torch.equal(tio.imdecode_op(torch.from_numpy(np.frombuffer(
        _jpeg_png()[0], np.uint8).copy())), torch.from_numpy(
            tmx.image.imdecode(_jpeg_png()[0])))
