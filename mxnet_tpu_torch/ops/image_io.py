"""Image I/O ops (port of ``mxnet_tpu/ops/image_io.py``): the reference's
in-engine OpenCV NDArray ops (reference src/io/image_io.cc:269 registers
_cvimdecode/_cvimresize/_cvcopyMakeBorder).

``imdecode`` is a host op: JPEG payloads decode through the native libjpeg
decoder, others through ``cv2`` (imported where it runs).  ``imresize``
and ``copyMakeBorder`` are torch code that runs on the input's device.

``imresize`` computes what the JAX package's ``jax.image.resize`` computes,
not what ``F.interpolate`` does: per-axis weight matrices
(``jax.image.scale_and_translate``: half-pixel centers, the kernel widened
by the scale on a downsample, so it antialiases; ``cubic`` is Keys' kernel
with a = -0.5, ``lanczos3`` the windowed sinc of radius 3) applied to the
image as one product per resized axis.  ``F.interpolate``'s bicubic uses
a = -0.75 and its antialias differs.  ``nearest`` picks
``floor((i + 0.5) * in / out)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from .registry import register

# cv2 interp codes -> resize methods (2=bicubic like the reference's
# OpenCV default; 3=INTER_AREA has no analog, mapped to linear)
_INTERP = {0: "nearest", 1: "linear", 2: "cubic", 3: "linear", 4: "lanczos3"}


def _decode_host(buf, flag, to_rgb):
    """bytes -> HWC uint8 numpy (BGR when to_rgb=0, reference default)."""
    from .. import native as _native

    raw = bytes(buf)
    lib = _native.get_lib()
    # the native JPEG path always yields 3 channels; flags other than
    # 0 (gray) and 1 (color) (IMREAD_UNCHANGED=-1 must return 2-D for a
    # grayscale source, like the reference _cvimdecode) go to cv2
    if lib is not None and lib._has_imagedec and int(flag) in (0, 1):
        import ctypes as ct
        h = ct.c_int()
        w = ct.c_int()
        cbuf = ct.cast(ct.c_char_p(raw), ct.c_void_p)
        if lib.MXTImgDecodeDims(cbuf, len(raw), ct.byref(h),
                                ct.byref(w)) == 0:
            out = np.empty((h.value, w.value, 3), np.uint8)
            if lib.MXTImgDecode(cbuf, len(raw), out.ctypes.data_as(
                    ct.c_void_p), 1 if to_rgb else 0) == 0:
                if flag == 0:  # grayscale requested
                    coef = (np.array([0.299, 0.587, 0.114])
                            if to_rgb else np.array([0.114, 0.587, 0.299]))
                    g = (out.astype(np.float32) * coef).sum(-1)
                    return np.clip(g + 0.5, 0,
                                   255).astype(np.uint8)[:, :, None]
                return out
        # non-JPEG payloads (png, ...) fall through to cv2
    import cv2
    img = cv2.imdecode(np.frombuffer(raw, np.uint8), int(flag))
    if img is None:
        raise MXNetError("imdecode: cannot decode image")
    if img.ndim == 2:
        img = img[:, :, None]
    elif to_rgb:
        img = np.ascontiguousarray(img[..., ::-1])
    return img


@register("imdecode", input_names=("buf",), aliases=("_cvimdecode",))
def imdecode_op(buf, flag=1, to_rgb=1):
    """Decode an image byte buffer into an HWC uint8 array (reference
    src/io/image_io.cc Imdecode; _cvimdecode defaults: flag=1 color,
    to_rgb=1).  A host op: the output shape depends on the image, so it
    runs imperatively; the result lands on the buffer's device."""
    host = buf.detach().cpu().numpy()
    if host.dtype != np.uint8 or host.ndim != 1:
        raise MXNetError("imdecode expects a 1-D uint8 buffer NDArray")
    img = _decode_host(host.tobytes(), int(flag), int(to_rgb))
    return torch.from_numpy(np.ascontiguousarray(img)).to(buf.device)


# -- resize: jax.image.scale_and_translate's weights ------------------------

def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(x), out)


def _lanczos3(x, radius=3.):
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    denom = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / denom, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos3}


def resize_weights(in_size, out_size, method, antialias=True):
    """The (in_size, out_size) float32 weight matrix of one axis
    (``jax._src.image.scale.compute_weight_mat`` with translation 0)."""
    f32 = torch.float32
    scale = torch.tensor(out_size / in_size, dtype=f32)
    inv_scale = 1. / scale
    kernel_scale = torch.clamp(inv_scale, min=1.) if antialias else 1.
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]
         ).abs() / kernel_scale
    weights = _KERNELS[method](x)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000. * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _nearest_index(in_size, out_size):
    pos = (torch.arange(out_size, dtype=torch.float32) + 0.5) * in_size \
        / out_size
    return torch.floor(pos).to(torch.int64)


def resize(x, out_hw, method):
    """Resize the two leading axes of ``x`` (H, W, ...) to ``out_hw`` as
    ``jax.image.resize(x, out_hw + x.shape[2:], method)`` does (float32
    math; the caller casts)."""
    for axis, n in enumerate(out_hw):
        m = x.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            x = x.index_select(axis, _nearest_index(m, n).to(x.device))
            continue
        w = resize_weights(m, n, method).to(x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])),
                          -1, axis)
    return x


@register("imresize", input_names=("src",), aliases=("_cvimresize",))
def imresize_op(src, w=0, h=0, interp=1):
    """Resize an HWC image to (h, w) — reference _cvimresize, as torch code
    on the image's device (``jax.image.resize``'s arithmetic)."""
    method = _INTERP.get(int(interp), "linear")
    out = resize(src.to(torch.float32), (int(h), int(w)), method)
    if src.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255)
    return out.to(src.dtype)


@register("copyMakeBorder", input_names=("src",),
          aliases=("_cvcopyMakeBorder",))
def copy_make_border_op(src, top=0, bot=0, left=0, right=0, type=0,
                        value=0.0):
    """Pad an HWC image with a constant border — reference
    _cvcopyMakeBorder (only BORDER_CONSTANT, type=0, like the reference's
    default use in mx.image)."""
    if int(type) != 0:
        raise MXNetError("copyMakeBorder: only type=0 (constant) supported")
    top, bot, left, right = int(top), int(bot), int(left), int(right)
    H, W = src.shape[0], src.shape[1]
    out = torch.full((H + top + bot, W + left + right) + tuple(src.shape[2:]),
                     value, dtype=torch.float64, device=src.device
                     ).to(src.dtype)
    out[top:top + H, left:left + W] = src
    return out
