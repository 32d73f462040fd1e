"""The vision ops of ``mxnet_tpu_torch/ops/vision.py`` (ROIPooling,
BilinearSampler, GridGenerator, SpatialTransformer, Correlation) against
the JAX package's on the CPU: forward values and the gradients for one
random head gradient (``jax.vjp`` of the jitted op, as the JAX package's
executor and imperative calls run it, against torch autograd), on the
same numpy inputs from a seed, float32.

Tolerances:
- ROIPooling: values exact (maxima of the same numbers, over the same
  integer bins); gradients within 1e-6 relative, 1e-7 absolute (ROIs that
  overlap add into one input in another order), ties included: both
  split a gradient evenly among equal maxima at each of the two stages (W,
  then H), and ReLU'd inputs have whole bins of zeros.
- BilinearSampler, GridGenerator, SpatialTransformer: rtol 1e-5 / atol
  1e-6 (the same four-corner arithmetic; the affine grid is a 3-term
  matmul, and autodiff orders the gradient's products its own way).
- Correlation: rtol 1e-5 / atol 1e-6 (the channel mean sums up to a few
  hundred terms in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import vision as jv
from mxnet_tpu_torch.ops import vision as tv

RTOL, ATOL = 1e-5, 1e-6


def _both(jfn, tfn, arrays, diff, seed, **kw):
    """Outputs and gradients of both for one random cotangent."""
    ja = [jnp.asarray(a) for a in arrays]

    def f(*d):
        full = list(ja)
        for i, v in zip(diff, d):
            full[i] = v
        return jfn(*full, **kw)

    jout, vjp = jax.vjp(jax.jit(f), *[ja[i] for i in diff])
    cot = np.random.RandomState(seed).standard_normal(jout.shape) \
        .astype(np.float32)
    jg = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    ta = [torch.from_numpy(np.array(a, copy=True)) for a in arrays]
    for i in diff:
        ta[i].requires_grad_(True)
    tout = tfn(*ta, **kw)
    tg = torch.autograd.grad(tout, [ta[i] for i in diff],
                             torch.from_numpy(cot))
    return tout.detach().numpy(), np.asarray(jout), \
        [g.numpy() for g in tg], jg


ROIS = np.array([
    [0, 0, 0, 11, 11],          # the whole image
    [1, 2, 2, 9, 9],            # another batch item
    [0, 4, 4, 20, 20],          # past the border
    [1, 5, 3, 5.6, 3.4],        # one pixel: every bin repeats it
    [0, 30, 30, 40, 40],        # outside: every bin empty, 0
    [2, 1, 7, 10, 8],           # two rows, overlapping bins
    [0, 3, 3, 11, 7],           # overlaps the first ROI
    [1.7, 0, 0, 5, 5],          # batch index truncated to 1
], np.float32)


@pytest.mark.parametrize("pooled,scale", [((3, 3), 0.5), ((2, 4), 1.0),
                                          ((7, 7), 0.25)])
def test_roi_pooling_relu_ties(pooled, scale):
    rs = np.random.RandomState(1)
    x = np.maximum(rs.standard_normal((3, 4, 12, 12)), 0).astype(np.float32)
    x[1, :, 2:8, 2:8] = 0.0                  # a plateau of zeros
    got, want, tg, jg = _both(jv.roi_pooling, tv.roi_pooling, [x, ROIS],
                              (0,), 2, pooled_size=pooled,
                              spatial_scale=scale)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-6, atol=1e-7)
    assert (got == 0).any()
    # the split is fractional somewhere: ties shared the gradient
    assert (np.abs(tg[0]) % 1 > 0).any()


def test_roi_pooling_chunks_and_symbol(monkeypatch):
    """A chunk of one ROI gives what one chunk gives; the op binds through
    ``mx.sym`` with the JAX package's shapes."""
    rs = np.random.RandomState(3)
    x = np.maximum(rs.standard_normal((3, 4, 12, 12)), 0).astype(np.float32)
    kw = dict(pooled_size=(3, 3), spatial_scale=0.5)
    ref = _both(jv.roi_pooling, tv.roi_pooling, [x, ROIS], (0,), 4, **kw)
    monkeypatch.setattr(tv, "ROI_CHUNK_ELEMENTS", 1)
    got = _both(jv.roi_pooling, tv.roi_pooling, [x, ROIS], (0,), 4, **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2][0], ref[2][0])
    outs = []
    for mx in (jmx, tmx):
        sym = mx.sym.ROIPooling(mx.sym.Variable("data"),
                                mx.sym.Variable("rois"), **kw)
        assert sym.list_arguments() == ["data", "rois"]
        ex = sym.simple_bind(mx.cpu(), data=x.shape, rois=ROIS.shape,
                             grad_req={"data": "write", "rois": "null"})
        ex.arg_dict["data"][:] = x
        ex.arg_dict["rois"][:] = ROIS
        out = ex.forward(is_train=True)[0]
        ex.backward([mx.nd.ones(out.shape, ctx=mx.cpu())])
        outs.append((out.asnumpy(), ex.grad_dict["data"].asnumpy()))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-7)


def test_bilinear_sampler_inside_and_outside():
    rs = np.random.RandomState(5)
    data = rs.standard_normal((2, 3, 5, 7)).astype(np.float32)
    grid = rs.uniform(-1.3, 1.3, (2, 2, 4, 6)).astype(np.float32)
    grid[0, :, 0, 0] = [-1.0, 1.0]           # on the corners
    grid[1, :, 1, :2] = 1.0
    got, want, tg, jg = _both(jv.bilinear_sampler, tv.bilinear_sampler,
                              [data, grid], (0, 1), 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("target", [(4, 5), (1, 3), (6, 6)])
def test_grid_generator_affine(target):
    rs = np.random.RandomState(7)
    theta = rs.standard_normal((2, 6)).astype(np.float32)
    got, want, tg, jg = _both(jv.grid_generator, tv.grid_generator, [theta],
                              (0,), 8, transform_type="affine",
                              target_shape=target)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg[0], jg[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 2, 4, 5), (1, 2, 1, 3)])
def test_grid_generator_warp(shape):
    """warp divides by max(w - 1, 1): a width or height of 1 too."""
    flow = np.random.RandomState(9).standard_normal(shape) \
        .astype(np.float32)
    got, want, tg, jg = _both(jv.grid_generator, tv.grid_generator, [flow],
                              (0,), 10, transform_type="warp")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg[0], jg[0], rtol=RTOL, atol=ATOL)


def test_spatial_transformer():
    rs = np.random.RandomState(11)
    data = rs.standard_normal((2, 3, 8, 8)).astype(np.float32)
    loc = np.array([[0.9, 0.1, 0.05, -0.1, 0.8, 0.0],
                    [1.2, -0.3, 0.2, 0.25, 0.7, -0.4]], np.float32)
    got, want, tg, jg = _both(jv.spatial_transformer, tv.spatial_transformer,
                              [data, loc], (0, 1), 12, target_shape=(5, 6))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    with pytest.raises(tmx.MXNetError):
        tv.spatial_transformer(torch.zeros(1, 1, 2, 2), torch.zeros(1, 6),
                               target_shape=(2, 2), transform_type="warp")


CORRELATION_CASES = {
    "k1_multiply": dict(kernel_size=1, max_displacement=2, stride1=1,
                        stride2=1, pad_size=2),
    "k1_abs": dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1,
                   pad_size=2, is_multiply=False),
    "k3_strides_abs": dict(kernel_size=3, max_displacement=2, stride1=2,
                           stride2=2, pad_size=3, is_multiply=False),
    "k1_stride2_flownet": dict(kernel_size=1, max_displacement=4, stride1=2,
                               stride2=2, pad_size=4),
    "k3_no_pad": dict(kernel_size=3, max_displacement=1, stride1=1,
                      stride2=1, pad_size=0),
    "k2_even": dict(kernel_size=2, max_displacement=2, stride1=3, stride2=1,
                    pad_size=1),
}


@pytest.mark.parametrize("case", sorted(CORRELATION_CASES))
def test_correlation(case):
    kw = CORRELATION_CASES[case]
    rs = np.random.RandomState(13)
    a = rs.standard_normal((2, 4, 9, 10)).astype(np.float32)
    b = rs.standard_normal((2, 4, 9, 10)).astype(np.float32)
    b[0, :, 3, 3] = a[0, :, 3, 3]            # abs at 0: JAX's gradient 1
    got, want, tg, jg = _both(jv.correlation, tv.correlation, [a, b],
                              (0, 1), 14, **kw)
    assert got.shape == want.shape
    assert tv._corr_infer(kw, [a.shape, b.shape])[1] == \
        jv._corr_infer(kw, [a.shape, b.shape])[1]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for x, y in zip(tg, jg):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)
