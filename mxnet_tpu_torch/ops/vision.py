"""Vision ops (port of ``mxnet_tpu/ops/vision.py``): ROIPooling,
SpatialTransformer, GridGenerator, BilinearSampler, Correlation.

The arithmetic is the JAX package's, in its order.  Two ops keep their
memory bounded where eager autograd would not:

- ``ROIPooling`` reduces masked windows ``[R, C, H, pw, W]`` densely, as
  the JAX package does, but a chunk of ROIs at a time inside
  ``_ROIPoolFn``, whose backward recomputes each chunk.  Its maxima
  reduce over W, then over H, with ``amax``, whose gradient splits evenly
  among equal values at each stage, as JAX's reduce-max gradient does.
- ``Correlation`` is ``_CorrelationFn``: the forward reads each
  displacement's shifted window of the padded second map and the backward
  recomputes them, so no shifted copy is saved.  ``jnp.roll``'s
  wraparound is never read: the picked outputs' windows, shifted by at
  most the border, stay inside the padded map (``_corr_geometry``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register
from ..base import MXNetError


def _recip(c):
    """float32(1 / c): XLA compiles the JAX package's ``x / c`` for a
    constant ``c`` as ``x * (1 / c)`` in float32 (under ``jit``, where
    both its executor and its imperative ops run), so the port multiplies
    by the same reciprocal."""
    return float(np.float32(1.0) / np.float32(c))


def _pair(x):
    if isinstance(x, (tuple, list)):
        return tuple(int(v) for v in x)
    return (int(x), int(x))


# ---------------------------------------------------------------------------
# ROIPooling — src/operator/roi_pooling-inl.h (pooled_size, spatial_scale)
# ---------------------------------------------------------------------------

def _roi_infer(attrs, in_shapes):
    data, rois = in_shapes[0], in_shapes[1]
    ph, pw = _pair(attrs["pooled_size"])
    if data is None or rois is None:
        return list(in_shapes), [None], []
    out = (rois[0], data[1], ph, pw)
    return [tuple(data), tuple(rois)], [out], []


#: elements of the dense masked window tensor [R, C, H, pw, W] one ROI
#: chunk may hold (64 Mi floats: 256 MiB in float32)
ROI_CHUNK_ELEMENTS = 64 << 20


def _roi_bins(rois, spatial_scale, pooled, size, start_col):
    """Integer bin bounds of every ROI along one axis (the JAX package's
    round / floor / ceil / clip): a mask [R, pooled, size]."""
    dev = rois.device
    lo = torch.round(rois[:, start_col] * spatial_scale).to(torch.int32)
    hi = torch.round(rois[:, start_col + 2] * spatial_scale).to(torch.int32)
    extent = (hi - lo + 1).clamp(min=1).to(torch.float32)
    bin_size = extent * _recip(pooled)                      # [R]
    i = torch.arange(pooled, dtype=torch.float32, device=dev)
    start = torch.floor(i * bin_size[:, None]).to(torch.int32) + lo[:, None]
    end = torch.ceil((i + 1) * bin_size[:, None]).to(torch.int32) \
        + lo[:, None]
    start = start.clamp(0, size)
    end = end.clamp(0, size)
    pos = torch.arange(size, device=dev)
    return (pos >= start[..., None]) & (pos < end[..., None])


def _roi_chunk(img, rois, ph, pw, spatial_scale):
    """Pooled maxima of one chunk: img [R, C, H, W] (each ROI's image),
    rois [R, 5] -> [R, C, ph, pw]; empty bins give 0."""
    _, _, h, w = img.shape
    mask_h = _roi_bins(rois, spatial_scale, ph, h, 2)      # [R, ph, H]
    mask_w = _roi_bins(rois, spatial_scale, pw, w, 1)      # [R, pw, W]
    neg = torch.finfo(img.dtype).min
    # max over W per output column: [R, C, H, pw]
    t = torch.where(mask_w[:, None, None], img[:, :, :, None, :], neg)
    t = t.amax(-1)
    # then max over H per output row: [R, C, ph, pw]
    o = torch.where(mask_h[:, None, :, None, :],
                    t.transpose(2, 3)[:, :, None], neg)
    o = o.amax(-1)
    return torch.where(o == neg, 0.0, o).to(img.dtype)


def _roi_index(rois, n):
    """Batch index of each ROI (truncated; a negative index wraps and an
    out-of-range one clamps, as JAX's gather does)."""
    b = rois[:, 0].to(torch.int64)
    return torch.where(b < 0, b + n, b).clamp(0, n - 1)


class _ROIPoolFn(torch.autograd.Function):
    """ROIPooling a chunk of ROIs at a time; the backward recomputes each
    chunk under autograd and adds its gradient into the batch item's."""

    @staticmethod
    def forward(ctx, data, rois, ph, pw, spatial_scale):
        n, c, h, w = data.shape
        chunk = max(1, ROI_CHUNK_ELEMENTS // max(1, c * h * pw * w))
        ctx.save_for_backward(data, rois)
        ctx.geometry = (ph, pw, spatial_scale, chunk)
        idx = _roi_index(rois, n)
        outs = [_roi_chunk(data.index_select(0, idx[s:s + chunk]),
                           rois[s:s + chunk], ph, pw, spatial_scale)
                for s in range(0, rois.shape[0], chunk)]
        if not outs:
            return data.new_zeros((0, c, ph, pw))
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, grad):
        data, rois = ctx.saved_tensors
        ph, pw, spatial_scale, chunk = ctx.geometry
        idx = _roi_index(rois, data.shape[0])
        gdata = torch.zeros_like(data)
        for s in range(0, rois.shape[0], chunk):
            sel = idx[s:s + chunk]
            with torch.enable_grad():
                img = data.index_select(0, sel).detach().requires_grad_()
                out = _roi_chunk(img, rois[s:s + chunk], ph, pw,
                                 spatial_scale)
                (gimg,) = torch.autograd.grad(out, img, grad[s:s + chunk])
            gdata.index_add_(0, sel, gimg)
        return gdata, None, None, None, None


@register("ROIPooling", input_names=("data", "rois"), infer_shape=_roi_infer)
def roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0):
    """Max-pool regions of interest to a fixed size.  rois are [batch_idx,
    x1, y1, x2, y2] in image coordinates, scaled by spatial_scale and
    rounded half to even."""
    ph, pw = _pair(pooled_size)
    return _ROIPoolFn.apply(data, rois.detach(), ph, pw,
                            float(spatial_scale))


# ---------------------------------------------------------------------------
# BilinearSampler — src/operator/bilinear_sampler-inl.h
# ---------------------------------------------------------------------------

def _bilinear_sample(data, grid):
    """Sample data [N, C, H, W] at the normalized grid [N, 2, Ho, Wo]
    ((x, y) in [-1, 1]); zero outside the image, the four corners summed
    in the JAX package's order."""
    n, c, h, w = data.shape
    ho, wo = grid.shape[2], grid.shape[3]
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = data.reshape(n, c, h * w)
    out = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi = x0 + dx
        yi = y0 + dy
        wgt = (wx if dx else (1 - wx)) * (wy if dy else (1 - wy))
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).to(torch.int64)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, 1, ho * wo).expand(n, c, ho * wo)
        val = torch.gather(flat, 2, idx).reshape(n, c, ho, wo)
        out = out + torch.where(inb, wgt, 0.0)[:, None] * val
    return out


def _bs_infer(attrs, in_shapes):
    data, grid = in_shapes[:2]
    if data is None or grid is None:
        return list(in_shapes), [None], []
    out = (data[0], data[1], grid[2], grid[3])
    return [tuple(data), tuple(grid)], [out], []


@register("BilinearSampler", input_names=("data", "grid"),
          infer_shape=_bs_infer)
def bilinear_sampler(data, grid):
    """data [N, C, H, W], grid [N, 2, Ho, Wo] normalized to [-1, 1]."""
    return _bilinear_sample(data, grid)


# ---------------------------------------------------------------------------
# GridGenerator — src/operator/grid_generator-inl.h
# ---------------------------------------------------------------------------

def _grid_infer(attrs, in_shapes):
    (data,) = in_shapes[:1]
    tt = attrs.get("transform_type", "affine")
    if data is None:
        return list(in_shapes), [None], []
    if tt == "affine":
        th, tw = _pair(attrs["target_shape"])
        return [tuple(data)], [(data[0], 2, th, tw)], []
    return [tuple(data)], [tuple(data)], []


def _linspace(n, device):
    """``jnp.linspace(-1, 1, n)`` in float32, by JAX's formula
    (``start * (1 - step) + stop * step``, then the endpoint)."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    step = torch.arange(n - 1, dtype=torch.float32, device=device) \
        * _recip(n - 1)
    out = -1.0 * (1 - step) + 1.0 * step
    return torch.cat([out, torch.ones(1, device=device)])


@register("GridGenerator", infer_shape=_grid_infer)
def grid_generator(data, transform_type="affine", target_shape=None):
    """affine: data [N, 6] -> sampling grid [N, 2, H, W]; warp: data is an
    [N, 2, H, W] optical flow added to the identity grid."""
    if transform_type == "affine":
        th, tw = _pair(target_shape)
        dev = data.device
        ys, xs = torch.meshgrid(_linspace(th, dev), _linspace(tw, dev),
                                indexing="ij")
        base = torch.stack([xs.reshape(-1), ys.reshape(-1),
                            torch.ones(th * tw, device=dev)])   # [3, H*W]
        theta = data.reshape(-1, 2, 3)
        grid = torch.matmul(theta, base.to(theta.dtype))
        return grid.reshape(-1, 2, th, tw)
    if transform_type == "warp":
        n, _two, h, w = data.shape
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=data.dtype, device=data.device),
            torch.arange(w, dtype=data.dtype, device=data.device),
            indexing="ij")
        gx = (data[:, 0] + xs) * 2 * _recip(max(w - 1, 1)) - 1
        gy = (data[:, 1] + ys) * 2 * _recip(max(h - 1, 1)) - 1
        return torch.stack([gx, gy], dim=1)
    raise MXNetError("unknown transform_type %r" % (transform_type,))


# ---------------------------------------------------------------------------
# SpatialTransformer — src/operator/spatial_transformer-inl.h
# ---------------------------------------------------------------------------

def _st_infer(attrs, in_shapes):
    data, loc = in_shapes[:2]
    th, tw = _pair(attrs["target_shape"])
    if data is None:
        return list(in_shapes), [None], []
    return [tuple(data), (data[0], 6)], [(data[0], data[1], th, tw)], []


@register("SpatialTransformer", input_names=("data", "loc"),
          infer_shape=_st_infer)
def spatial_transformer(data, loc, target_shape=None,
                        transform_type="affine", sampler_type="bilinear"):
    """Affine spatial transformer: loc [N, 6] predicts an affine
    transform; the output is data sampled on the transformed grid."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports affine/bilinear only "
                         "(as the reference, spatial_transformer-inl.h)")
    grid = grid_generator(loc, transform_type="affine",
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


# ---------------------------------------------------------------------------
# Correlation — src/operator/correlation-inl.h (FlowNet cost volume)
# ---------------------------------------------------------------------------

def _corr_geometry(h, w, kernel_size, max_displacement, stride1, stride2,
                   pad_size):
    """(oh, ow, border, displacements, window low and high) of the JAX
    package's Correlation.  Output row i reads padded rows br + s1*i +
    [-low, high] of data1 and the same rows shifted by dy (|dy| <=
    (md // s2) * s2 = br - kr) of data2: all inside [0, ph), since
    br + s1*(oh-1) < ph - br, so ``jnp.roll``'s wraparound and the window's
    SAME padding are never read."""
    ks = int(kernel_size)
    md = int(max_displacement)
    s1, s2 = int(stride1), int(stride2)
    pad = int(pad_size)
    kr = ks // 2
    br = (md // s2) * s2 + kr
    ph, pw = h + 2 * pad, w + 2 * pad
    oh = int(np.ceil(float(ph - br * 2) / s1))
    ow = int(np.ceil(float(pw - br * 2) / s1))
    nd_half = md // s2
    disp = [i * s2 for i in range(-nd_half, nd_half + 1)]
    low = (ks - 1) // 2
    return oh, ow, br, disp, low, ks - 1 - low


def _corr_infer(attrs, in_shapes):
    d1 = in_shapes[0]
    if d1 is None:
        return list(in_shapes), [None], []
    n, c, h, w = d1
    oh, ow, _br, disp, _lo, _hi = _corr_geometry(
        h, w, attrs.get("kernel_size", 1), attrs.get("max_displacement", 1),
        attrs.get("stride1", 1), attrs.get("stride2", 1),
        attrs.get("pad_size", 0))
    return [tuple(d1), tuple(d1)], [(n, len(disp) ** 2, oh, ow)], []


class _CorrelationFn(torch.autograd.Function):
    """The cost volume over padded maps p1, p2 [N, C, ph, pw] -> [N, D,
    oh, ow]; the backward recomputes each displacement's window."""

    @staticmethod
    def _windows(p1, p2, geo, dy, dx):
        oh, ow, br, _disp, low, high, ks, s1 = geo
        if ks == 1:
            rows = slice(br, br + s1 * (oh - 1) + 1, s1)
            cols = slice(br, br + s1 * (ow - 1) + 1, s1)
            srows = slice(br + dy, br + dy + s1 * (oh - 1) + 1, s1)
            scols = slice(br + dx, br + dx + s1 * (ow - 1) + 1, s1)
        else:
            r0, r1 = br - low, br + s1 * (oh - 1) + high + 1
            c0, c1 = br - low, br + s1 * (ow - 1) + high + 1
            rows, cols = slice(r0, r1), slice(c0, c1)
            srows, scols = slice(r0 + dy, r1 + dy), slice(c0 + dx, c1 + dx)
        return (slice(None), slice(None), rows, cols), \
            (slice(None), slice(None), srows, scols)

    @staticmethod
    def forward(ctx, p1, p2, geo, is_multiply):
        oh, ow, _br, disp, _low, _high, ks, s1 = geo
        n, c = p1.shape[0], p1.shape[1]
        out = p1.new_empty((n, len(disp) ** 2, oh, ow))
        k = 0
        for dy in disp:
            for dx in disp:
                w1, w2 = _CorrelationFn._windows(p1, p2, geo, dy, dx)
                a, b = p1[w1], p2[w2]
                prod = a * b if is_multiply else (a - b).abs()
                m = prod.sum(1, keepdim=True) * _recip(c)
                if ks > 1:
                    m = F.avg_pool2d(m, ks, stride=s1, divisor_override=1) \
                        * _recip(ks * ks)
                out[:, k] = m[:, 0]
                k += 1
        ctx.save_for_backward(p1, p2)
        ctx.geo, ctx.is_multiply = geo, is_multiply
        return out

    @staticmethod
    def backward(ctx, grad):
        p1, p2 = ctx.saved_tensors
        geo, is_multiply = ctx.geo, ctx.is_multiply
        oh, ow, _br, disp, _low, _high, ks, s1 = geo
        c = p1.shape[1]
        g1 = torch.zeros_like(p1)
        g2 = torch.zeros_like(p2)
        if ks > 1:
            ones = p1.new_full((1, 1, ks, ks), _recip(ks * ks))
        k = 0
        for dy in disp:
            for dx in disp:
                w1, w2 = _CorrelationFn._windows(p1, p2, geo, dy, dx)
                a, b = p1[w1], p2[w2]
                gm = grad[:, k:k + 1]
                if ks > 1:
                    gm = F.conv_transpose2d(gm, ones, stride=s1)
                gm = gm * _recip(c)
                if is_multiply:
                    g1[w1] += gm * b
                    g2[w2] += gm * a
                else:
                    # JAX's abs gradient is select(x >= 0, g, -g): +1 at 0
                    gs = torch.where(a - b >= 0, gm, -gm)
                    g1[w1] += gs
                    g2[w2] -= gs
                k += 1
        return g1, g2, None, None


@register("Correlation", input_names=("data1", "data2"),
          infer_shape=_corr_infer)
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """Correlation cost volume between two feature maps: for each output
    position and displacement (dy, dx), the mean over channels and the
    kernel window of data1 * shift(data2) (or |data1 - shift(data2)| when
    is_multiply is false)."""
    n, c, h, w = data1.shape
    oh, ow, br, disp, low, high = _corr_geometry(
        h, w, kernel_size, max_displacement, stride1, stride2, pad_size)
    pad = int(pad_size)
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    if oh <= 0 or ow <= 0:
        return p1.new_zeros((n, len(disp) ** 2, max(oh, 0), max(ow, 0)))
    geo = (oh, ow, br, disp, low, high, int(kernel_size), int(stride1))
    return _CorrelationFn.apply(p1, p2, geo, bool(is_multiply))
