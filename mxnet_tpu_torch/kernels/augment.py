"""On-device image augmentation (port of ``mxnet_tpu/kernels/augment.py``),
as torch code on the batch's device.

The host pipelines augment on the CPU: random crop, mirror and normalize
per image, seeded per global batch.  With ``ImageRecordIter(...,
device_augment=...)`` the data service's workers decode each image to a
fixed uint8 CANVAS of ``(H + margin, W + margin)`` (center crop or
resize, no host augmentation), the uint8 batch crosses to the device (4x
fewer bytes than float32), and this module does the rest there: a random
``(H, W)`` window (offsets uniform in ``[0, margin]``, the center one when
``rand_crop`` is off), a mirror with probability 1/2 when ``rand_mirror``
is on, mean/std normalization, pad rows zeroed, and the cast.  A canvas of
another spatial size is first resized (``ops/image_io.resize``,
``jax.image.resize``'s ``linear`` weights, antialias included).

Crop and mirror are one batched gather: each image's rows ``oy +
arange(H)`` and columns ``ox + arange(W)`` (reversed where its mirror bit
is set) form a flat index into the canvas, and one ``gather`` takes every
image's window.  Then, in float32 and in the JAX package's order: subtract
the mean, divide by the std (a multiply by its float32 reciprocal: XLA
compiles the JAX package's division by a constant so), zero the rows past
``nvalid``, clip for uint8, cast.

Randomness: the port does not reproduce JAX's threefry stream.  Each
image's ``(oy, ox, flip)`` is drawn on the host by
``numpy.random.RandomState(chunk_seed(cseed, i))`` (:meth:`DeviceAugment.
draws`), ``cseed`` being the batch's ``common.chunk_seed(seed, global
batch, epoch)``, so the output is a pure function of (seed, epoch, batch)
for any worker or server count, and the card's output equals the CPU's
byte for byte when no resize is taken.  It is not the host-augmented
product (another crop geometry): ``MXTPU_FUSED_KERNELS`` without
``augment`` restores the exact host-augmented path.

The JAX package computes this under one ``jax.jit`` outside any Pallas
kernel; there is no hand-written kernel here (``PERF.md`` has its device
time and kernels a batch).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["DeviceAugment"]


class DeviceAugment(object):
    """A per-batch augmentation op: ``aug(images, cseed, nvalid)`` ->
    augmented batch on the images' device.

    ``data_shape`` is the canonical ``(3, H, W)`` output shape; ``margin``
    the extra pixels per spatial dim the input canvas carries for the
    random crop.  ``mean``/``std`` accept the host augmenters' forms (None,
    a scalar, 3 values, or ``True`` for the ImageNet constants)."""

    def __init__(self, data_shape, margin=16, rand_crop=False,
                 rand_mirror=False, mean=None, std=None, layout="NCHW",
                 dtype="float32"):
        shape = tuple(int(d) for d in data_shape)
        if len(shape) != 3 or shape[0] != 3:
            raise MXNetError(
                "device augment needs data_shape (3, H, W), got %s"
                % (shape,))
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("layout must be NCHW or NHWC")
        if int(margin) < 0:
            raise MXNetError("margin must be >= 0")
        self.out_shape = shape                 # canonical (c, h, w)
        self.margin = int(margin)
        self.rand_crop = bool(rand_crop)
        self.rand_mirror = bool(rand_mirror)
        self.layout = layout
        self.dtype = str(dtype)
        if self.dtype not in ("float32", "uint8", "bfloat16"):
            raise MXNetError(
                "device augment dtype must be float32/uint8/bfloat16, "
                "got %r" % (dtype,))
        self.mean = self._c3(mean, "mean")
        self.std = self._c3(std, "std")
        self.inv_std = None if self.std is None else \
            np.float32(1) / self.std
        if self.dtype == "uint8" and (self.mean is not None
                                      or self.std is not None):
            raise MXNetError(
                "uint8 device augmentation cannot normalize (mean/std "
                "produce fractional values); normalize on-device after "
                "the cast, or request a float dtype")
        c, h, w = shape
        self.canvas_shape = (c, h + self.margin, w + self.margin)
        self._consts = {}
        #: batches this instance augmented (one a call)
        self.calls = 0

    @staticmethod
    def _c3(v, what):
        if v is None or v is False:
            return None
        from ..data_service import common as dsc
        if v is True:
            v = dsc.IMAGENET_MEAN if what == "mean" else dsc.IMAGENET_STD
        a = np.asarray(v, np.float32).reshape(-1)
        if a.size == 1:
            a = np.repeat(a, 3)
        if a.size != 3:
            raise MXNetError("%s must be a scalar or 3 values" % what)
        return a

    def per_layout(self, canonical):
        c, h, w = canonical
        return (c, h, w) if self.layout == "NCHW" else (h, w, c)

    def draws(self, cseed, n):
        """``(n, 3)`` int64: each image's ``(oy, ox, flip)``, drawn from
        ``RandomState(chunk_seed(cseed, i))``: the offsets (``m // 2``
        without ``rand_crop``), then the mirror bit (0 without
        ``rand_mirror``)."""
        from ..data_service import common as dsc
        m = self.margin
        out = np.full((int(n), 3), m // 2, np.int64)
        out[:, 2] = 0
        if not (self.rand_crop and m > 0) and not self.rand_mirror:
            return out
        # one generator reseeded per image: constructing a RandomState
        # costs ten times its (legacy) reseed
        rs = np.random.RandomState(0)
        for i in range(int(n)):
            rs.seed(dsc.chunk_seed(int(cseed), i) % (2 ** 31))
            if self.rand_crop and m > 0:
                out[i, 0] = rs.randint(0, m + 1)
                out[i, 1] = rs.randint(0, m + 1)
            if self.rand_mirror:
                out[i, 2] = rs.randint(0, 2)
        return out

    def _const(self, name, device):
        key = (name, device)
        if key not in self._consts:
            shape = (3, 1, 1) if self.layout == "NCHW" else (3,)
            self._consts[key] = torch.as_tensor(
                getattr(self, name)).reshape(shape).to(device)
        return self._consts[key]

    def _resize(self, f, canvas):
        """``f`` (float32, batch first) resized to the canvas's (H, W)."""
        from ..ops.image_io import resize
        h_ax, w_ax = (2, 3) if self.layout == "NCHW" else (1, 2)
        x = torch.movedim(f, (h_ax, w_ax), (0, 1))
        ch, cw = canvas[1:] if self.layout == "NCHW" else canvas[:2]
        x = resize(x, (ch, cw), "linear")
        return torch.movedim(x, (0, 1), (h_ax, w_ax))

    def __call__(self, imgs, cseed, nvalid):
        self.calls += 1
        c, oh, ow = self.out_shape
        canvas = self.per_layout(self.canvas_shape)
        bs = imgs.shape[0]
        dev = imgs.device
        x = imgs
        if tuple(x.shape[1:]) != tuple(canvas):
            x = self._resize(x.to(torch.float32), canvas)
        ch, cw = (canvas[1], canvas[2]) if self.layout == "NCHW" \
            else (canvas[0], canvas[1])
        d = torch.as_tensor(self.draws(cseed, bs))
        if dev.type == "cuda":
            # pinned and non_blocking: a pageable copy would hold the host
            # until the stream's earlier work is done
            d = d.pin_memory().to(dev, non_blocking=True)
        rows = d[:, :1] + torch.arange(oh, device=dev)
        ar = torch.arange(ow, device=dev)
        cols = d[:, 1:2] + torch.where(d[:, 2:] > 0, ow - 1 - ar, ar)
        idx = (rows[:, :, None] * cw + cols[:, None, :]).reshape(bs, oh * ow)
        # one gather takes every image's (mirrored) window
        if self.layout == "NCHW":
            out = x.reshape(bs, c, ch * cw).gather(
                2, idx[:, None, :].expand(bs, c, oh * ow)).reshape(
                    bs, c, oh, ow)
        else:
            out = x.reshape(bs, ch * cw, c).gather(
                1, idx[:, :, None].expand(bs, oh * ow, c)).reshape(
                    bs, oh, ow, c)
        out = out.to(torch.float32)
        if self.mean is not None:
            out = out - self._const("mean", dev)
        if self.std is not None:
            out = out * self._const("inv_std", dev)
        nvalid = int(nvalid)
        if nvalid < bs:
            # pad rows are exact zeros, as the host decoders pad
            out[max(nvalid, 0):] = 0
        if self.dtype == "uint8":
            out = out.clamp(0, 255)
        return out.to({"float32": torch.float32, "uint8": torch.uint8,
                       "bfloat16": torch.bfloat16}[self.dtype])
