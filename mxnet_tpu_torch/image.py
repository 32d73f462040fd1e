"""Image loading + augmentation pipeline (port of ``mxnet_tpu/image.py``).

API parity with the reference's python/mxnet/image.py (imdecode,
resize_short, fixed/random/center/random_size crops, the *Aug factories,
CreateAugmenter, ImageIter) plus ImageRecordIter, the reference's C++
RecordIO image iterator (src/io/iter_image_recordio_2.cc).  Augmenters
work on numpy HWC uint8/float32 arrays on the host, with the same
``random``/``np.random`` draws as the JAX package from the same seeded
thread-local RNG, so both packages give the same bytes for the same seed.

``ImageRecordIter`` takes one of five routes, chosen as the JAX package
chooses them: the data service (``data_service=True`` or
``MXTPU_DATA_WORKERS``: decode worker processes over shared-memory rings;
``data_service='host:port,...'`` or ``MXTPU_DATA_SERVERS``: its network
tier), optionally with on-device augmentation (``device_augment=``,
``kernels/augment.py``); else the native libjpeg pipeline
(``native/imagedec.cc``, GIL released), decode worker processes
(``forkserver``; the workers import only this module's package on the host
and never touch CUDA), or the host dependency engine (custom ``aug_list``,
or ``MXNET_RECORDITER_PROCS=0``).  Its batches land on the context current
when it was built (``gpu(0)`` by default): the native pipe decodes
straight into a pinned host tensor, and every route copies through
``dataflow.Uploader`` (``non_blocking`` on one side stream; ``next()``
makes the caller's stream wait for the copy).  ``ImageIter`` yields host
arrays, as ``NDArrayIter`` does.

Divergences from the JAX package: bfloat16 host batches are
``torch.bfloat16`` tensors (no ``ml_dtypes``); one uploader thread and one
side stream replace its four uploader threads (``MXNET_UPLOAD_THREADS``),
since copies on one stream serialize and a ``non_blocking`` copy from
pinned memory returns at once; a native route that cannot run (no libjpeg)
raises instead of falling back to the process route.  ``cv2`` is
imported only where the JAX package imports it: ``imresize`` (a crop
resized to another size), ``PadAug`` with ``pad > 0`` and non-JPEG
payloads.
"""
from __future__ import annotations

import logging
import os
import random as pyrandom
import threading as _threading

import numpy as np
import torch

from . import io as mxio
from . import ndarray as nd
from . import recordio
from .base import MXNetError, get_env, register_env
from .context import cpu, current_context

ENV_JPEG_DECODE_FAST = register_env(
    "MXNET_JPEG_DECODE_FAST", default=1,
    doc="0 switches the native training decode from the fast SIMD IDCT "
        "to exact byte-parity with cv2")
ENV_RECORDITER_NATIVE = register_env(
    "MXNET_RECORDITER_NATIVE", default=1,
    doc="0 disables the native libjpeg decode pipeline in ImageRecordIter")
ENV_RECORDITER_PROCS = register_env(
    "MXNET_RECORDITER_PROCS", default=1,
    doc="0 disables the process-parallel decode pipeline in "
        "ImageRecordIter")
ENV_DATA_WORKERS = register_env(
    "MXTPU_DATA_WORKERS", default=0,
    doc="Route every env-routed ImageRecordIter through the data service "
        "with this many decode worker processes (0: off)")
ENV_DATA_SERVERS = register_env(
    "MXTPU_DATA_SERVERS", default="",
    doc="host:port list of data servers: routes every env-routed "
        "ImageRecordIter through the data service's network tier")

#: torch dtypes of the batch dtypes the pipelines emit
_TORCH_DTYPES = {"float32": torch.float32, "uint8": torch.uint8,
                 "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Augmentation RNG.  Augmenters draw from a THREAD-LOCAL rng when one has
# been installed (decode workers, the pipeline reader thread), falling back
# to the process-global modules otherwise (direct user calls keep reference
# semantics).  Pipelines reseed per CHUNK, keyed off a monotonically
# assigned chunk index — so a sample's augmentation is a pure function of
# (user seed, chunk index), independent of which worker the scheduler
# happens to hand the chunk to.
# ---------------------------------------------------------------------------


class _AugRngLocal(_threading.local):
    def __init__(self):
        self.py = None
        self.np = None


_AUG_RNG = _AugRngLocal()


def _rpy():
    return _AUG_RNG.py if _AUG_RNG.py is not None else pyrandom


def _rnp():
    return _AUG_RNG.np if _AUG_RNG.np is not None else np.random


def _seed_aug_rng(seed_val):
    _AUG_RNG.py = pyrandom.Random(int(seed_val))
    _AUG_RNG.np = np.random.RandomState(int(seed_val) % (2 ** 31))


# Deterministic per-(seed, chunk, epoch) augmentation seed and the
# default ImageNet normalization constants — ONE implementation shared
# with the out-of-process data service (its decode workers derive the
# identical seed for the identical global batch, which is what makes
# service output bit-identical to the in-process pipe).
from .data_service import common as _dsc  # noqa: E402
_chunk_seed = _dsc.chunk_seed

__all__ = [
    "imdecode", "imresize", "scale_down", "resize_short", "fixed_crop",
    "random_crop", "center_crop", "color_normalize", "random_size_crop",
    "ResizeAug", "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
    "RandomOrderAug", "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
    "HorizontalFlipAug", "CastAug", "PadAug", "CreateAugmenter", "ImageIter",
    "ImageRecordIter", "ImageRecordUInt8Iter",
]


def _cv2():
    import cv2
    return cv2


def imdecode(buf, flag=1, to_rgb=1, out=None):
    """Decode an image from bytes into an HWC uint8 array (reference
    image.py:imdecode; to_rgb=1 gives RGB, the reference's default).

    JPEG payloads decode through the native libjpeg path when available
    (shared with the mx.nd.imdecode op); everything else via cv2."""
    if isinstance(buf, nd.NDArray):
        buf = buf.asnumpy()
    from .ops.image_io import _decode_host
    img = _decode_host(bytes(buf), int(flag), int(to_rgb))
    return np.ascontiguousarray(img)


def imresize(src, w, h, interp=2):
    """Resize to exactly (w, h)."""
    cv2 = _cv2()
    out = cv2.resize(np.asarray(src), (int(w), int(h)), interpolation=interp)
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def scale_down(src_size, size):
    """Scale down crop size if bigger than image size (reference
    image.py:scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize the shorter edge to `size` keeping aspect ratio."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop at a fixed location, optionally resizing to `size` (w, h)."""
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp=interp)
    return out


def random_crop(src, size, interp=2):
    """Random crop of `size` (upsamples if src smaller). Returns
    (img, (x0, y0, w, h))."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _rpy().randint(0, w - new_w)
    y0 = _rpy().randint(0, h - new_h)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """Center crop of `size`. Returns (img, (x0, y0, w, h))."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = int((w - new_w) / 2)
    y0 = int((h - new_h) / 2)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32)
    if mean is not None:
        src = src - np.asarray(mean, dtype=np.float32)
    if std is not None:
        src /= np.asarray(std, dtype=np.float32)
    return src


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Random area + aspect-ratio crop (inception-style)."""
    h, w = src.shape[:2]
    new_ratio = _rpy().uniform(*ratio)
    if new_ratio * h > w:
        max_area = w * int(w / new_ratio)
    else:
        max_area = h * int(h * new_ratio)
    min_area = min_area * h * w
    if max_area < min_area:
        return random_crop(src, size, interp)
    new_area = _rpy().uniform(min_area, max_area)
    new_w = int(np.sqrt(new_area * new_ratio))
    new_h = int(np.sqrt(new_area / new_ratio))
    new_w, new_h = min(new_w, w), min(new_h, h)
    x0 = _rpy().randint(0, w - new_w)
    y0 = _rpy().randint(0, h - new_h)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def ResizeAug(size, interp=2):
    def aug(src):
        return [resize_short(src, size, interp)]
    return aug


def RandomCropAug(size, interp=2):
    def aug(src):
        return [random_crop(src, size, interp)[0]]
    return aug


def RandomSizedCropAug(size, min_area, ratio, interp=2):
    def aug(src):
        return [random_size_crop(src, size, min_area, ratio, interp)[0]]
    return aug


def CenterCropAug(size, interp=2):
    def aug(src):
        return [center_crop(src, size, interp)[0]]
    return aug


def RandomOrderAug(ts):
    def aug(src):
        src = [src]
        ts_ = list(ts)
        _rpy().shuffle(ts_)
        for t in ts_:
            src = [j for i in src for j in t(i)]
        return src
    return aug


def ColorJitterAug(brightness, contrast, saturation):
    """Random brightness/contrast/saturation jitter in random order."""
    ts = []
    coef = np.array([[[0.299, 0.587, 0.114]]], dtype=np.float32)
    if brightness > 0:
        def baug(src):
            alpha = 1.0 + _rpy().uniform(-brightness, brightness)
            return [src.astype(np.float32) * alpha]
        ts.append(baug)
    if contrast > 0:
        def caug(src):
            src = src.astype(np.float32)
            alpha = 1.0 + _rpy().uniform(-contrast, contrast)
            gray = (src * coef).sum(axis=2, keepdims=True)
            return [src * alpha + gray.mean() * (1.0 - alpha)]
        ts.append(caug)
    if saturation > 0:
        def saug(src):
            src = src.astype(np.float32)
            alpha = 1.0 + _rpy().uniform(-saturation, saturation)
            gray = (src * coef).sum(axis=2, keepdims=True)
            return [src * alpha + gray * (1.0 - alpha)]
        ts.append(saug)
    return RandomOrderAug(ts)


def LightingAug(alphastd, eigval, eigvec):
    """PCA-based lighting noise (AlexNet style)."""
    def aug(src):
        alpha = _rnp().normal(0, alphastd, size=(3,))
        rgb = np.dot(eigvec * alpha, eigval)
        return [src.astype(np.float32) + rgb.astype(np.float32)]
    return aug


def ColorNormalizeAug(mean, std):
    def aug(src):
        return [color_normalize(src, mean, std)]
    return aug


def HorizontalFlipAug(p):
    def aug(src):
        if _rpy().random() < p:
            src = src[:, ::-1]
        return [src]
    return aug


def CastAug():
    def aug(src):
        return [src.astype(np.float32)]
    return aug


class PadAug(object):
    """Pad every border by ``pad`` pixels with ``fill_value`` before
    cropping — the reference C++ augmenter's ``pad`` param
    (image_aug_default.cc; the CIFAR recipe is pad=4 + rand_crop 32)."""

    def __init__(self, pad, fill_value=0):
        self.pad = int(pad)
        self.fill = fill_value

    def __call__(self, src, rs=None):
        import cv2
        p = self.pad
        out = cv2.copyMakeBorder(src, p, p, p, p, cv2.BORDER_CONSTANT,
                                 value=[self.fill] * 3)
        return [out]


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2,
                    pad=0, fill_value=0):
    """Create the standard augmenter list (reference image.py:CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))

    if pad > 0:
        auglist.append(PadAug(pad, fill_value))

    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.3,
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))

    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))

    auglist.append(CastAug())

    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))

    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))

    if mean is True:
        mean = np.array(_dsc.IMAGENET_MEAN)
    if std is True:
        std = np.array(_dsc.IMAGENET_STD)
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(mxio.DataIter):
    """Image iterator with augmentation, reading .rec files or raw images
    listed in a .lst file (reference image.py:ImageIter).

    Supports path_imgrec (+ optional path_imgidx for shuffle/partition),
    or path_imglist + path_root, or an in-memory imglist.
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", seed=None, **kwargs):
        super(ImageIter, self).__init__()
        # seeded shuffle order is reproducible regardless of which thread
        # calls reset(); seed=None keeps reference semantics (global rng)
        self._shuffle_rng = pyrandom.Random(seed) if seed is not None \
            else pyrandom
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        self.imgrec = None
        self.imgidx = None
        if path_imgrec:
            logging.info("loading recordio %s...", path_imgrec)
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")

        self.imglist = None
        if path_imglist:
            logging.info("loading image list %s...", path_imglist)
            imglist_d = {}
            imgkeys = []
            with open(path_imglist) as fin:
                for line in fin:
                    line = [i.strip() for i in line.strip().split("\t")]
                    label = np.array(line[1:-1], dtype=np.float32)
                    key = int(line[0])
                    imglist_d[key] = (label, line[-1])
                    imgkeys.append(key)
            self.imglist = imglist_d
            self.seq = imgkeys
        elif isinstance(imglist, list):
            imglist_d = {}
            imgkeys = []
            for i, img in enumerate(imglist):
                key = i
                label = np.array(img[0], dtype=np.float32) \
                    if not isinstance(img[0], (int, float)) \
                    else np.array([img[0]], dtype=np.float32)
                imglist_d[key] = (label, img[1])
                imgkeys.append(key)
            self.imglist = imglist_d
            self.seq = imgkeys
        elif self.imgidx is not None:
            self.seq = self.imgidx
        else:
            self.seq = None

        self.path_root = path_root
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise MXNetError(
                "data_shape must be (3, height, width), got %s"
                % (data_shape,))
        self.data_name = data_name
        self.label_name = label_name
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        if self.seq is not None and num_parts > 1:
            chunk = len(self.seq) // num_parts
            self.seq = self.seq[part_index * chunk:(part_index + 1) * chunk]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        return [mxio.DataDesc(self.data_name,
                              (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [mxio.DataDesc(self.label_name,
                              (self.batch_size, self.label_width)
                              if self.label_width > 1
                              else (self.batch_size,))]

    def reset(self):
        if self.shuffle and self.seq is not None:
            self._shuffle_rng.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """Returns (label, decoded image) for the next sample."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                if self.imglist is None:
                    return header.label, img
                return self.imglist[idx][0], img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def next_raw(self):
        """(label, raw jpeg bytes or decoded array) — split out so threaded
        iterators can separate serial IO from parallel decode."""
        return self.next_sample()

    def decode_augment(self, s):
        """Decode (if raw bytes) + augment one sample into HWC float32."""
        data = self.imdecode(s) if isinstance(s, bytes) else s
        self.check_valid_image(data)
        return self.augmentation_transform(data)

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, h, w, c), dtype=np.float32)
        batch_label = np.zeros((batch_size, self.label_width),
                               dtype=np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                try:
                    batch_data[i] = self.decode_augment(s)
                except (RuntimeError, MXNetError) as e:
                    logging.debug("Invalid image, skipping: %s", str(e))
                    continue
                batch_label[i] = label
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = batch_size - i
        host = cpu()
        data = nd.array(batch_data.transpose(0, 3, 1, 2), ctx=host)
        label = nd.array(batch_label[:, 0] if self.label_width == 1
                         else batch_label, ctx=host)
        return mxio.DataBatch([data], [label], pad=pad,
                              provide_data=self.provide_data,
                              provide_label=self.provide_label)

    __next__ = next

    def check_data_shape(self, data_shape):
        if not len(data_shape) == 3:
            raise ValueError("data_shape should have length 3")
        if not data_shape[0] == 3:
            raise ValueError("This iterator expects the input (h, w, 3)")

    def check_valid_image(self, data):
        if len(data.shape) == 0:
            raise RuntimeError("Data shape is wrong")

    def imdecode(self, s):
        return imdecode(s)

    def read_image(self, fname):
        with open(os.path.join(self.path_root, fname), "rb") as fin:
            return imdecode(fin.read())

    def augmentation_transform(self, data):
        for aug in self.auglist:
            data = aug(data)[0]
        return data


# ---------------------------------------------------------------------------
# process-pool decode workers.  Python augmenters hold the GIL, so threads
# cannot scale decode+augment; worker PROCESSES are the analog of the
# reference's C++ decode thread pool (iter_image_recordio_2.cc's omp
# parallel chunk decode).  Workers come from a forkserver (not forked from
# a process that holds a CUDA context) and touch only numpy, the native
# decoder and cv2.
# ---------------------------------------------------------------------------

_PP_AUG = None


def _pp_init(data_shape, aug_kwargs, seed):
    """Worker initializer.  Installs a thread-local aug rng seeded from the
    user seed; _pp_work_chunk reseeds it per CHUNK so augmentation is a pure
    function of (seed, chunk index) — independent of pid and of which
    worker the scheduler hands a chunk to."""
    global _PP_AUG
    _seed_aug_rng(_chunk_seed(seed, 0))
    _PP_AUG = CreateAugmenter(tuple(data_shape), **aug_kwargs)


def _pp_work(raw, augs=None):
    """bytes -> augmented CHW float32 (or None for an unusable image —
    decode OR augmentation failures skip the sample, like the reference
    parser's per-image error tolerance)."""
    augs = _PP_AUG if augs is None else augs
    try:
        d = imdecode(raw)
        for a in augs:
            d = a(d)[0]
        return np.ascontiguousarray(np.asarray(d, dtype=np.float32)
                                    .transpose(2, 0, 1))
    except Exception:  # noqa: BLE001
        return None


def _pp_work_chunk(raws, chunk_seed=None):
    """Decode+augment a chunk of records in one IPC round trip (amortizes
    submit/pickle overhead, like the reference's per-chunk omp decode)."""
    if chunk_seed is not None:
        _seed_aug_rng(chunk_seed)
    return [_pp_work(r) for r in raws]


class _AsyncPipeline(object):
    """Reader thread + bounded batch queue: the prefetching decorator shared
    by the decode pipelines (the reference's dmlc ThreadedIter prefetcher,
    iter_prefetcher.h).  Subclasses implement _one_epoch()."""

    def __init__(self, it, batch_size, prefetch, seed=0):
        import queue
        import threading

        self._it = it
        self._bs = batch_size
        self._seed = int(seed)
        self._epoch_no = 0   # epoch ordinal: chunk seeds derive from
        # (seed, epoch, chunk-within-epoch), so an abandoned (mid-epoch
        # reset) epoch can't make later epochs timing-dependent
        self._queue = queue.Queue(maxsize=max(1, prefetch))
        self._cmd = queue.Queue()
        self._empty_exc = queue.Empty  # bound now: __del__ may run during
        self._full_exc = queue.Full    # interpreter shutdown (no imports)
        self._at_end = False
        self._stopping = False
        self._abandon = False
        self._failed = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._cmd.put("epoch")
        _register_pipeline(self)

    def _run(self):
        while True:
            cmd = self._cmd.get()
            if cmd == "stop":
                break
            try:
                self._one_epoch()
                self._put(None)  # epoch end marker
            except BaseException as e:  # noqa: BLE001 — surface in next()
                if not self._stopping:
                    self._failed = e
                    self._put(("error", e))
                break

    def _put(self, item):
        """Bounded put that stays interruptible for shutdown."""
        while not self._stopping:
            try:
                self._queue.put(item, timeout=0.2)
                return
            except self._full_exc:
                continue

    def _one_epoch(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _shutdown_extra(self):
        pass

    @staticmethod
    def _is_error(b):
        return isinstance(b, tuple) and len(b) == 2 and b[0] == "error"

    def next(self):
        if self._failed is not None:
            raise MXNetError("decode pipeline failed: %r" % (self._failed,))
        if self._at_end:
            raise StopIteration   # repeated next() after exhaustion
        b = self._queue.get()
        if b is None:
            self._at_end = True
            raise StopIteration
        if self._is_error(b):
            self._failed = b[1]
            self._at_end = True
            raise MXNetError("decode pipeline failed: %r" % (b[1],))
        return b

    def reset(self):
        if self._failed is not None:
            raise MXNetError(
                "decode pipeline failed earlier: %r" % (self._failed,))
        if not self._at_end:
            # abandon the in-flight epoch (reader checks the flag per
            # chunk) and drain to the end marker
            self._abandon = True
            while True:
                b = self._queue.get()
                if b is None:
                    break
                if self._is_error(b):
                    self._failed = b[1]
                    self._abandon = False
                    raise MXNetError(
                        "decode pipeline failed: %r" % (b[1],))
            self._abandon = False
        self._at_end = False
        self._it.reset()
        self._cmd.put("epoch")

    def shutdown(self):
        """Stop the reader thread before interpreter teardown: a daemon
        thread killed inside a native call aborts the process.  No imports
        here: __del__ can run while the interpreter shuts down."""
        if not hasattr(self, "_queue"):
            # a subclass __init__ failed before _AsyncPipeline.__init__
            # ran (it cleans its own resources on that path); there is
            # no thread/queue to stop and __del__ must not raise
            return
        self._stopping = True
        try:
            self._cmd.put_nowait("stop")
        except Exception:  # noqa: BLE001
            pass
        try:
            while True:
                self._queue.get_nowait()   # unblock a full-queue put
        except self._empty_exc:
            pass
        except Exception:  # noqa: BLE001
            pass
        try:
            self._thread.join(timeout=5)
        except Exception:  # noqa: BLE001
            pass
        try:
            self._shutdown_extra()
        except Exception:  # noqa: BLE001
            pass

    def __del__(self):
        self.shutdown()


class _ProcessPipeline(_AsyncPipeline):
    """Decode via worker processes (the Python augmenters hold the GIL, so
    threads cannot scale decode+augment).  Single-core hosts decode inline
    on the reader thread.  Batches go to the device through ``uploader``
    (a ``dataflow.Uploader``) on the reader thread."""

    def __init__(self, it, data_shape, batch_size, label_width, aug_kwargs,
                 num_workers, prefetch, dtype, allow_procs=True, seed=0,
                 ctx=None, uploader=None):
        import concurrent.futures as cf
        import multiprocessing as mp

        self._shape = data_shape
        self._lw = label_width
        self._dtype = np.dtype(dtype) if dtype != "bfloat16" else dtype
        self._ctx = ctx if ctx is not None else current_context()
        self._uploader = uploader
        self._workers = max(1, min(num_workers, _host_cores()))
        if not allow_procs:
            self._workers = 1
        if self._workers > 1:
            # forkserver: workers fork from a clean server process (no CUDA
            # context inherited, unlike fork) with no __main__
            # re-execution (unlike spawn)
            try:
                ctx = mp.get_context("forkserver")
            except ValueError:
                ctx = mp.get_context("spawn")
            self._pool = cf.ProcessPoolExecutor(
                max_workers=self._workers, mp_context=ctx,
                initializer=_pp_init,
                initargs=(tuple(data_shape), dict(aug_kwargs), seed))
            self._augs = None
        else:
            self._pool = None
            self._augs = CreateAugmenter(tuple(data_shape), **aug_kwargs)
        super(_ProcessPipeline, self).__init__(it, batch_size, prefetch,
                                              seed=seed)

    def _shutdown_extra(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)

    def _one_epoch(self):
        from collections import deque
        chunk = max(1, min(16, self._bs))
        max_inflight = self._workers * 4
        self._epoch_no += 1
        chunk_in_epoch = 0
        inflight = deque()
        ready = []          # decoded (img, label) awaiting batch assembly
        exhausted = False
        while (not exhausted or inflight or ready) \
                and not self._stopping and not self._abandon:
            while not exhausted and len(inflight) < max_inflight:
                raws, labs = [], []
                for _ in range(chunk):
                    try:
                        lab, raw = self._it.next_raw()
                    except StopIteration:
                        exhausted = True
                        break
                    raws.append(raw)
                    labs.append(np.asarray(lab, dtype=np.float32))
                if raws:
                    cseed = _chunk_seed(self._seed, chunk_in_epoch,
                                        epoch=self._epoch_no)
                    chunk_in_epoch += 1
                    if self._pool is None:
                        # inline path: same per-chunk derivation, installed
                        # on the reader thread's thread-local rng (user
                        # threads' global RNG state is untouched)
                        _seed_aug_rng(cseed)
                        inflight.append((_Done([_pp_work(r, self._augs)
                                                for r in raws]), labs))
                    else:
                        inflight.append(
                            (self._pool.submit(_pp_work_chunk, raws, cseed),
                             labs))
            if inflight:
                fut, labs = inflight.popleft()
                for img, lab in zip(fut.result(), labs):
                    if img is not None:
                        ready.append((img, lab))
                while len(ready) >= self._bs:
                    self._emit(ready[:self._bs])
                    del ready[:self._bs]
            elif ready:
                self._emit(ready)
                ready = []

    def _emit(self, items):
        c, h, w = self._shape
        data = np.zeros((self._bs, c, h, w), np.float32)
        lab = np.zeros((self._bs, self._lw), np.float32)
        n = 0
        for d, l in items:
            data[n] = d
            lab[n] = l
            n += 1
        if n == 0:
            return
        if self._dtype == "bfloat16":
            # halve the host->device bytes (torch rounds to nearest even,
            # as ml_dtypes does)
            data = torch.from_numpy(data).to(torch.bfloat16)
        elif np.dtype(self._dtype) == np.uint8:
            data = np.clip(data, 0, 255).astype(np.uint8)  # raw-pixel mode
        elif self._dtype != np.float32:
            data = data.astype(self._dtype)
        self._put(_upload_batch(self._ctx, self._uploader, data,
                                lab[:, 0] if self._lw == 1 else lab,
                                self._bs - n))


def _host_cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-linux
        return os.cpu_count() or 1


def _rec_looks_jpeg(path_imgrec):
    """Peek at the first record's image payload: JPEG magic FFD8?"""
    try:
        r = recordio.MXRecordIO(path_imgrec, "r")
        try:
            s = r.read()
            if s is None:
                return True  # empty file: either path handles it
            _, img = recordio.unpack(s)
            head = bytes(img[:2])
            return head == b"\xff\xd8"
        finally:
            r.close()
    except Exception:  # noqa: BLE001 — be permissive, decode errors surface later
        return True


# ---------------------------------------------------------------------------
# the native pipe's crop plan and pack arithmetic (imagedec.cc, resize=0),
# as torch code for the nvJPEG decode backend: decoded pixels in, the same
# crop offsets, mirror bit, resample, normalization and store as the
# libjpeg pipe's
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _mix_seed(chunk_seed, idx):
    """imagedec.cc:MixSeed."""
    z = (int(chunk_seed) * 0x9e3779b97f4a7c15
         + int(idx) * 0xbf58476d1ce4e5b9) & _M64
    z = ((z ^ (z >> 30)) * 0x94d049bb133111eb) & _M64
    return z ^ (z >> 31)


class _SplitMix(object):
    """imagedec.cc:Rng (splitmix64)."""

    def __init__(self, seed):
        self.state = int(seed) & _M64

    def next(self):
        self.state = (self.state + 0x9e3779b97f4a7c15) & _M64
        z = self.state
        z = ((z ^ (z >> 30)) * 0xbf58476d1ce4e5b9) & _M64
        z = ((z ^ (z >> 27)) * 0x94d049bb133111eb) & _M64
        return z ^ (z >> 31)

    def below(self, n):
        """Uniform integer in [0, n]."""
        return 0 if n == 0 else self.next() % (n + 1)


def _scale_down_f32(sw, sh, cw, ch):
    """imagedec.cc:ScaleDown (float32 arithmetic, then truncation)."""
    f = np.float32
    if sh < ch:
        cw = int(f(cw) * f(sh) / f(ch))
        ch = sh
    if sw < cw:
        ch = int(f(ch) * f(sw) / f(cw))
        cw = sw
    return max(cw, 1), max(ch, 1)


def crop_plan(h, w, out_h, out_w, rand_crop, rand_mirror, image_seed):
    """``(x0, y0, crop_w, crop_h, mirror)`` the native pipe picks for a
    decoded (h, w) source at ``resize=0``; ``image_seed`` is
    ``_mix_seed(chunk_seed, index in batch)``."""
    rng = _SplitMix(_mix_seed(image_seed, 0))
    cw, ch = _scale_down_f32(w, h, out_w, out_h)
    if rand_crop:
        x0 = rng.below(w - cw)
        y0 = rng.below(h - ch)
    else:
        x0 = (w - cw) // 2
        y0 = (h - ch) // 2
    mirror = bool(rand_mirror) and bool(rng.next() & 1)
    return x0, y0, cw, ch, mirror


def _taps(c0, step, n, size):
    """Bilinear taps of one axis (imagedec.cc's xmap/y taps): indices and
    float32 fractions, in float64 before the fraction's rounding."""
    vmax = size - 1
    idx = np.empty(n, np.int64)
    frac = np.empty(n, np.float32)
    for o in range(n):
        d = min(max(c0 + o * step, 0.0), float(vmax))
        i = int(d)
        if i > vmax - 1:
            i = vmax - 1 if vmax > 0 else 0
        idx[o] = i
        frac[o] = np.float32(d - i)
    return idx, frac


def pack_image(img, out, plan, norm, dtype, layout):
    """Write one augmented sample of the decoded (H, W, 3) uint8 tensor
    ``img`` into ``out`` (the batch slot, on ``img``'s device) as the
    native pipe's pack does: a 1:1 crop (``PackUnit``) or, when the image
    is smaller than the output, its bilinear resample
    (``PackBilinear``); then ``(v - mean) * std_inv`` in float32 where
    ``norm`` = ``(mean, std_inv)`` float32 tensors (None: no
    normalization) and the store (uint8: ``int(v + 0.5)`` clamped;
    bfloat16: round to nearest even)."""
    x0, y0, cw, ch, mirror = plan
    if layout == "NCHW":
        out_h, out_w = out.shape[1], out.shape[2]
    else:
        out_h, out_w = out.shape[0], out.shape[1]
    H, W = img.shape[0], img.shape[1]
    if cw == out_w and ch == out_h:
        v = img[y0:y0 + ch, x0:x0 + cw]
        if mirror:
            v = v.flip(1)
        v = v.to(torch.float32)
    else:
        gx, gy = float(cw) / out_w, float(ch) / out_h
        order = np.arange(out_w)[::-1] if mirror else np.arange(out_w)
        ix, fx = _taps(0.5 * gx + x0 * 1.0 - 0.5, gx, out_w, W)
        ix, fx = ix[order], fx[order]
        iy, fy = _taps(0.5 * gy + y0 * 1.0 - 0.5, gy, out_h, H)
        dev = img.device
        ix0 = torch.from_numpy(ix).to(dev)
        ix1 = torch.clamp(ix0 + 1, max=W - 1)
        iy0 = torch.from_numpy(iy).to(dev)
        iy1 = iy0 if H == 1 else iy0 + 1
        fxt = torch.from_numpy(fx).to(dev)[None, :, None]
        fyt = torch.from_numpy(fy).to(dev)[:, None, None]
        ofx, ofy = 1.0 - fxt, 1.0 - fyt
        f = img.to(torch.float32)
        r0, r1 = f[iy0], f[iy1]
        v = ((ofx * ofy) * r0[:, ix0] + (fxt * ofy) * r0[:, ix1]
             + (ofx * fyt) * r1[:, ix0] + (fxt * fyt) * r1[:, ix1])
    if norm is not None:
        v = (v - norm[0]) * norm[1]
    if dtype == torch.uint8:
        v = torch.clamp((v + 0.5).to(torch.int32), 0, 255)
    v = v.to(dtype)
    out.copy_(v.permute(2, 0, 1) if layout == "NCHW" else v)


def _fancy_h2(x):
    """libjpeg's fancy upsampling of rows by 2 (jdsample.c:
    h2v1_fancy_upsample): int32 (..., n) -> (..., 2n), a 3:1 triangle
    filter with the edge samples repeated."""
    prev = torch.cat([x[..., :1], x[..., :-1]], -1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], -1)
    return torch.stack([(3 * x + prev + 1) >> 2, (3 * x + nxt + 2) >> 2],
                       -1).flatten(-2)


def _fancy_h2v2(x):
    """libjpeg's fancy 2x2 upsampling (jdsample.c: h2v2_fancy_upsample):
    int32 (..., m, n) -> (..., 2m, 2n); each output row sums 3 x its
    nearest input row and 1 x the next nearest (the edge rows repeated),
    then the columns as 3:1 with libjpeg's rounding (+8 / +7, >> 4)."""
    up = torch.cat([x[..., :1, :], x[..., :-1, :]], -2)
    down = torch.cat([x[..., 1:, :], x[..., -1:, :]], -2)
    cols = torch.stack([3 * x + up, 3 * x + down], -2).flatten(-3, -2)
    prev = torch.cat([cols[..., :1], cols[..., :-1]], -1)
    nxt = torch.cat([cols[..., 1:], cols[..., -1:]], -1)
    return torch.stack([(3 * cols + prev + 8) >> 4,
                        (3 * cols + nxt + 7) >> 4], -1).flatten(-2)


def upsample_chroma(c, subsampling, h, w):
    """A coded chroma plane (uint8, its own size) at the image's (h, w) as
    libjpeg-turbo upsamples it with ``do_fancy_upsampling`` (its default):
    ``subsampling`` 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0.  Planes two samples
    wide or less are replicated, as libjpeg does.  Returns int32."""
    x = c.to(torch.int32)
    if subsampling == 1:
        x = _fancy_h2(x) if x.shape[1] > 2 else x.repeat_interleave(2, 1)
    elif subsampling == 2:
        x = _fancy_h2v2(x) if x.shape[1] > 2 else \
            x.repeat_interleave(2, 0).repeat_interleave(2, 1)
    return x[:h, :w]


def ycc_to_rgb(y, cb, cr):
    """libjpeg's YCbCr -> RGB (jdcolor.c: ycc_rgb_convert's fixed-point
    tables, SCALEBITS 16) on integer planes of one shape: (..., 3)
    uint8."""
    xb = cb.to(torch.int64) - 128
    xr = cr.to(torch.int64) - 128
    y = y.to(torch.int64)
    r = y + ((91881 * xr + 32768) >> 16)
    g = y + ((-22554 * xb + 32768 - 46802 * xr) >> 16)
    b = y + ((116130 * xb + 32768) >> 16)
    return torch.clamp(torch.stack([r, g, b], -1), 0, 255).to(torch.uint8)


def planes_to_rgb(sub, planes, h, w):
    """The (h, w, 3) uint8 image of a decoder's planes: ``sub`` 0/1/2 the
    coded Y, Cb, Cr planes of a 4:4:4/4:2:2/4:2:0 JPEG (upsampled and
    converted as libjpeg does), 3 a grayscale luma plane (repeated), 4 an
    interleaved RGB image (returned as it is)."""
    if sub == 3:
        return planes[0][:, :, None].expand(h, w, 3).contiguous()
    if sub == 4:
        return planes[0]
    return ycc_to_rgb(planes[0], upsample_chroma(planes[1], sub, h, w),
                      upsample_chroma(planes[2], sub, h, w))


def _batchable(sub, planes, plan, out_h, out_w):
    """Whether one decoded image takes ``pack_planes_batch``: a 1:1 crop
    of Y/Cb/Cr or grayscale planes, chroma fancy-upsampled (wider than 2
    samples)."""
    return (plan[2] == out_w and plan[3] == out_h and sub in (0, 1, 2, 3)
            and (sub in (0, 3) or planes[1].shape[1] > 2))


def pack_planes_batch(items, out, slots, norm, dtype, layout):
    """``pack_image(planes_to_rgb(...), ...)`` for many images at once:
    ``items`` are ``(sub, planes, plan)`` of one subsampling each with a
    1:1 crop (``_batchable``), written into ``out[slots]``.  Each image
    contributes its crop of Y and a window of its chroma with two samples
    of margin (edge samples repeated past the image, libjpeg's rule); the
    upsampling, color conversion, mirroring, normalization and store run
    once over the stack."""
    if layout == "NCHW":
        out_h, out_w = out.shape[2], out.shape[3]
    else:
        out_h, out_w = out.shape[1], out.shape[2]
    dev = out.device
    sub = items[0][0]
    ys = torch.stack([p[0][pl[1]:pl[1] + out_h, pl[0]:pl[0] + out_w]
                      for _, p, pl in items])
    if sub == 3:
        rgb = ys[..., None].expand(-1, -1, -1, 3)
    elif sub == 0:
        cc = torch.stack([torch.stack([p[1], p[2]])[
            :, pl[1]:pl[1] + out_h, pl[0]:pl[0] + out_w]
            for _, p, pl in items])
        rgb = ycc_to_rgb(ys, cc[:, 0], cc[:, 1])
    else:
        # chroma windows: columns (and for 4:2:0 rows) from x0 // 2 - 2
        wh = out_h + 8 if sub == 1 else out_h // 2 + 5
        ww = out_w // 2 + 5
        rows, cols = [], []
        for _, p, pl in items:
            hc, wc = p[1].shape
            r0 = pl[1] - 2 if sub == 1 else pl[1] // 2 - 2
            rows.append(np.clip(np.arange(wh) + r0, 0, hc - 1))
            cols.append(np.clip(np.arange(ww) + pl[0] // 2 - 2, 0, wc - 1))
        rows = torch.from_numpy(np.stack(rows)).to(dev)
        cols = torch.from_numpy(np.stack(cols)).to(dev)
        win = torch.stack([torch.stack([p[1], p[2]])[:, rows[k]][:, :, cols[k]]
                           for k, (_, p, _) in enumerate(items)]
                          ).to(torch.int32)
        if sub == 2:
            up = _fancy_h2v2(win)
            ry = np.stack([np.arange(out_h) + 4 + pl[1] % 2
                           for _, _, pl in items])
        else:
            up = _fancy_h2(win)
            ry = np.stack([np.arange(out_h) + 2 for _ in items])
        rx = np.stack([np.arange(out_w) + 4 + pl[0] % 2
                       for _, _, pl in items])
        kk = torch.arange(len(items), device=dev)[:, None, None]
        up = up.permute(0, 2, 3, 1)[kk, torch.from_numpy(ry).to(dev)[
            :, :, None], torch.from_numpy(rx).to(dev)[:, None, :]]
        rgb = ycc_to_rgb(ys, up[..., 0], up[..., 1])
    mirror = [pl[4] for _, _, pl in items]
    if any(mirror):
        flip = torch.from_numpy(np.stack([
            np.arange(out_w)[::-1] if m else np.arange(out_w)
            for m in mirror]).copy()).to(dev)
        kk = torch.arange(len(items), device=dev)[:, None, None]
        rgb = rgb[kk, torch.arange(out_h, device=dev)[None, :, None],
                  flip[:, None, :]]
    v = rgb.to(torch.float32)
    if norm is not None:
        v = (v - norm[0]) * norm[1]
    if dtype == torch.uint8:
        v = torch.clamp((v + 0.5).to(torch.int32), 0, 255)
    v = v.to(dtype)
    if layout == "NCHW":
        v = v.permute(0, 3, 1, 2)
    out.index_copy_(0, torch.as_tensor(slots, device=dev), v.contiguous())


class _NvjpegDecoder(object):
    """JPEG -> (H, W, 3) uint8 device tensor: nvJPEG (the native library's
    ``nvjpeg_dec.cc``) decodes the coded YCbCr planes on the caller's
    current stream; 4:4:4, 4:2:2 and 4:2:0 chroma is then upsampled and
    converted with libjpeg's arithmetic (``upsample_chroma``,
    ``ycc_to_rgb``), so pixels differ from libjpeg's only by the IDCT;
    grayscale repeats its luma; other subsamplings take nvJPEG's own
    RGB output."""

    def __init__(self, device):
        from . import native as _native
        self._lib = _native.nvjpeg_lib()
        self._device = device
        self._h = self._lib.MXTNvjpegCreate()
        if not self._h:
            raise MXNetError("nvJPEG decoder could not start")

    def decode_planes(self, raw):
        """``(subsampling, planes, h, w)`` of a JPEG (see
        :func:`planes_to_rgb`), or None when nvJPEG rejects it."""
        import ctypes as ct
        ncomp, sub = ct.c_int(), ct.c_int()
        hs, ws = (ct.c_int * 3)(), (ct.c_int * 3)()
        buf = ct.cast(ct.c_char_p(raw), ct.c_void_p)
        if self._lib.MXTNvjpegInfo(self._h, buf, len(raw), ct.byref(ncomp),
                                   ct.byref(sub), hs, ws) != 0:
            return None
        h, w = hs[0], ws[0]
        sub = sub.value if ncomp.value == 3 else (3 if ncomp.value == 1
                                                  else 4)
        if sub == 3:
            shapes, fmt = [(h, w)], 1
        elif sub == 4:
            shapes, fmt = [(h, w, 3)], 2
        else:
            shapes, fmt = [(hs[c], ws[c]) for c in range(3)], 0
        planes = [torch.empty(shape, dtype=torch.uint8, device=self._device)
                  for shape in shapes]
        args = []
        for i in range(3):
            if i < len(planes):
                args += [ct.c_void_p(planes[i].data_ptr()),
                         planes[i].stride(0)]
            else:
                args += [None, 0]
        stream = torch.cuda.current_stream(self._device).cuda_stream
        if self._lib.MXTNvjpegDecode(self._h, buf, len(raw), fmt, *args,
                                     ct.c_void_p(stream)) != 0:
            return None
        return sub, planes, h, w

    def decode(self, raw):
        """The decoded (H, W, 3) image, or None when nvJPEG rejects it."""
        got = self.decode_planes(raw)
        return None if got is None else planes_to_rgb(*got)

    def close(self):
        if self._h:
            self._lib.MXTNvjpegDestroy(self._h)
            self._h = None


def _upload_batch(ctx, uploader, data, label, pad, transform=None):
    """A DataBatch of one host batch (numpy or tensors) on ``ctx``: both
    arrays copied by ``uploader`` (a ``dataflow.Uploader``), then
    ``transform`` applied to the data on the uploader's stream.  The
    copies' event rides on the batch (``_upload_event``) until
    ``ImageRecordIter.next`` makes the caller's stream wait on it."""
    tensors = [t if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(t)) for t in (data, label)]
    (d, lab), event = uploader.upload(tensors)
    if transform is not None:
        if uploader.cuda:
            with torch.cuda.stream(uploader.stream):
                d = transform(d)
                event = torch.cuda.Event()
                event.record(uploader.stream)
        else:
            d = transform(d)
    batch = mxio.DataBatch([nd.NDArray._from_torch(d, ctx)],
                           [nd.NDArray._from_torch(lab, ctx)], pad=pad)
    batch._upload_event = event
    return batch


class _NativePipeline(_AsyncPipeline):
    """Decode via the native libjpeg pipeline (native/imagedec.cc), the
    rebuild of the reference's in-engine C++ decode threads (reference
    src/io/iter_image_recordio_2.cc:27-80).  The whole
    decode+augment+normalize+pack stage runs in C++ with the GIL released,
    straight into a host tensor (pinned when the batches go to a card),
    which one uploader thread copies to the device on a side stream while
    the reader thread decodes the next batch.

    ``backend`` is ``"libjpeg"``, or ``"nvjpeg"`` on a host whose native
    library has no libjpeg and whose batches go to a card: the reader
    thread then decodes each record on the card with nvJPEG and crops,
    mirrors, normalizes and packs it with torch ops on the uploader's
    stream (``crop_plan``/``pack_image``: the libjpeg pipe's arithmetic,
    ``resize=0`` only).  Pixels differ from libjpeg's by the two
    decoders' IDCT (``_NvjpegDecoder``)."""

    #: aug knobs the native path implements; anything else takes the
    #: process pipeline.
    SUPPORTED = frozenset(("resize", "rand_crop", "rand_mirror",
                           "mean", "std"))
    #: output dtypes the native pipe writes
    DTYPES = ("float32", "uint8", "bfloat16")

    #: one uploader thread: copies on one CUDA stream serialize, and a
    #: non_blocking copy from pinned memory returns at once, so more
    #: threads would only queue behind each other (the JAX package uses
    #: MXNET_UPLOAD_THREADS=4 because its transfers block)
    UPLOAD_THREADS = 1

    def __init__(self, it, data_shape, batch_size, label_width, aug_kwargs,
                 num_workers, prefetch, dtype, layout="NCHW", seed=0,
                 device_transform=None, host_batches=False, ctx=None,
                 uploader=None):
        import concurrent.futures as _cf

        from . import native as _native
        # host_batches: deliver the decode output as host-tensor
        # DataBatches with no device copy, the product the reference's C++
        # parser hands out; callers that feed their own consumer or
        # measure pure decode+augment throughput use this.
        self._host_batches = bool(host_batches)
        self._ctx = ctx if ctx is not None else current_context()
        self._uploader = uploader
        self._upload_pool = _cf.ThreadPoolExecutor(
            max_workers=self.UPLOAD_THREADS,
            thread_name_prefix="mxt-upload")
        # optional device-side per-batch map (a torch callable:
        # normalize/transpose/cast), run on the uploader's stream
        self._device_transform = device_transform
        self._pipe = None
        self._nvjpeg = None
        try:
            self._init_native(it, data_shape, batch_size, label_width,
                              aug_kwargs, num_workers, prefetch, dtype,
                              layout, seed)
        except BaseException:
            self._upload_pool.shutdown(wait=False)
            if self._pipe:
                _native.get_lib().MXTImgPipeDestroy(self._pipe)
                self._pipe = None
            if self._nvjpeg is not None:
                self._nvjpeg.close()
            raise

    def _init_native(self, it, data_shape, batch_size, label_width,
                     aug_kwargs, num_workers, prefetch, dtype, layout, seed):
        import ctypes

        from . import native as _native
        lib = _native.get_lib()
        if lib is None:
            raise MXNetError(
                "native image pipeline unavailable (MXNET_NO_NATIVE=1); "
                "set MXNET_RECORDITER_NATIVE=0 for the process route")
        self.backend = "libjpeg" if lib._has_imagedec else "nvjpeg"
        if self.backend == "nvjpeg" and (
                self._host_batches or self._ctx.device_type != "gpu"
                or aug_kwargs.get("resize")):
            raise MXNetError(
                "native image pipeline: the native library has no libjpeg "
                "(%s), and its nvJPEG backend decodes on a card, at "
                "resize=0, with no host_batches; set "
                "MXNET_RECORDITER_NATIVE=0 for the process route"
                % (_native.JPEG_BUILD_ERROR or "").strip()[-300:])
        unsupported = set(aug_kwargs) - self.SUPPORTED
        if unsupported:
            raise MXNetError("native image pipeline does not implement %s"
                             % sorted(unsupported))
        self._lib = lib
        self._ct = ctypes
        c, h, w = data_shape
        if c != 3:
            raise MXNetError("native image pipeline expects 3-channel data")
        self._shape = tuple(data_shape)
        self._lw = label_width
        self._layout = layout
        name = str(np.dtype(dtype)) if dtype != "bfloat16" else dtype
        if name not in self.DTYPES:
            raise MXNetError("native image pipeline: unsupported dtype %r"
                             % (dtype,))
        self._torch_dtype = _TORCH_DTYPES[name]
        self._dtype = dtype
        mean = aug_kwargs.get("mean")
        std = aug_kwargs.get("std")
        if mean is True:
            mean = np.array(_dsc.IMAGENET_MEAN)
        if std is True:
            std = np.array(_dsc.IMAGENET_STD)
        # honor the requested thread count (reference preprocess_threads)
        nthreads = max(1, int(num_workers))
        # the training profile defaults to the fast SIMD IDCT (within +-2
        # of the exact output); MXNET_JPEG_DECODE_FAST=0 restores byte
        # parity with cv2 (the mx.nd.imdecode op is always exact)
        fast_dct = get_env(ENV_JPEG_DECODE_FAST, "1") != "0"
        if self.backend == "nvjpeg":
            self._nvjpeg = _NvjpegDecoder(self._ctx.torch_device)
            self._crop = (bool(aug_kwargs.get("rand_crop")),
                          bool(aug_kwargs.get("rand_mirror")))
            self._norm = None
            if mean is not None or std is not None:
                m = np.zeros(3, np.float32) if mean is None else \
                    np.broadcast_to(np.asarray(mean, np.float32).reshape(-1),
                                    (3,))
                sd = np.ones(3, np.float32) if std is None else \
                    np.broadcast_to(np.asarray(std, np.float32).reshape(-1),
                                    (3,))
                inv = np.where(sd != 0, np.float32(1) / sd,
                               np.float32(1)).astype(np.float32)
                dev = self._ctx.torch_device
                self._norm = (torch.tensor(m, device=dev),
                              torch.tensor(inv, device=dev))
        else:
            self._pipe, self._pipe_keepalive = _dsc.open_native_pipe(
                lib, h, w, aug_kwargs.get("resize"),
                aug_kwargs.get("rand_crop"), aug_kwargs.get("rand_mirror"),
                _dsc.DTYPE_CODES[name], 0 if layout == "NCHW" else 1, mean,
                std, fast_dct, nthreads)
            if not self._pipe:
                raise MXNetError("native image pipeline: create failed")
        super(_NativePipeline, self).__init__(it, batch_size, prefetch,
                                              seed=seed)

    def _shutdown_extra(self):
        try:
            self._upload_pool.shutdown(wait=False, cancel_futures=True)
        except Exception:  # noqa: BLE001
            pass
        # free the C++ pipe only once the reader thread is provably out of
        # MXTImgPipeDecodeBatch: if the join timed out, leak the pipe
        # rather than delete an object a live thread is executing in
        if self._pipe and not self._thread.is_alive():
            self._lib.MXTImgPipeDestroy(self._pipe)
            self._pipe = None
        if self._nvjpeg is not None and not self._thread.is_alive():
            self._nvjpeg.close()

    def _upload(self, out, lab_arr, pad):
        """Host batch -> DataBatch on the device (runs on the uploader
        thread)."""
        label = torch.from_numpy(lab_arr[:, 0] if self._lw == 1
                                 else lab_arr)
        if self._host_batches:
            return mxio.DataBatch([out], [label], pad=pad)
        return _upload_batch(self._ctx, self._uploader, out, label, pad,
                             self._device_transform)

    def _one_epoch(self):
        from collections import deque
        ct = self._ct
        bs = self._bs
        c, h, w = self._shape
        bshape = (bs, c, h, w) if self._layout == "NCHW" else (bs, h, w, c)
        self._epoch_no += 1
        chunk_in_epoch = 0
        it = self._it
        u8p = ct.POINTER(ct.c_uint8)
        valid = np.empty(bs, np.uint8)
        exhausted = False
        inflight = deque()   # ordered upload futures

        def drain(block):
            while inflight and (block or inflight[0].done()):
                self._put(inflight.popleft().result())

        while not exhausted and not self._stopping and not self._abandon:
            raws, labs = [], []
            for _ in range(bs):
                try:
                    lab, raw = it.next_raw()
                except StopIteration:
                    exhausted = True
                    break
                raws.append(raw)
                labs.append(lab)
            n = len(raws)
            if n == 0:
                break
            cseed = _chunk_seed(self._seed, chunk_in_epoch,
                                epoch=self._epoch_no)
            chunk_in_epoch += 1
            if self._nvjpeg is not None:
                self._put(self._decode_nvjpeg(raws, labs, cseed, bshape))
                continue
            # a fresh host tensor per batch, decoded into in place: the
            # caching host allocator hands a pinned block out again only
            # after the copy that reads it has completed
            out = self._uploader.host_buffer(bshape, self._torch_dtype,
                                             zero=n < bs)
            bufs = (ct.c_void_p * n)(
                *[ct.cast(ct.c_char_p(r), ct.c_void_p) for r in raws])
            lens = (ct.c_uint64 * n)(*[len(r) for r in raws])
            valid[:] = 0
            nv = self._lib.MXTImgPipeDecodeBatch(
                self._pipe, bufs, lens, n, ct.c_void_p(out.data_ptr()),
                valid.ctypes.data_as(u8p), cseed)
            if nv == 0:
                # a whole batch of undecodable records is a dataset-level
                # problem (e.g. non-JPEG payloads), not per-image noise
                raise MXNetError(
                    "native image pipeline: every record in a batch failed "
                    "to decode — is this a non-JPEG .rec? Set "
                    "MXNET_RECORDITER_NATIVE=0 to use the cv2 pipeline")
            keep = np.flatnonzero(valid[:n])
            lab_arr = np.zeros((bs, self._lw), np.float32)
            lab_arr[:nv] = np.asarray(labs, np.float32).reshape(
                n, -1)[keep][:, :self._lw]
            if nv < n:   # compact valid samples to the front, zero the pad
                out[:nv] = out[torch.from_numpy(keep)]
                out[nv:] = 0
            inflight.append(
                self._upload_pool.submit(self._upload, out, lab_arr, bs - nv))
            drain(block=False)
            while len(inflight) > self.UPLOAD_THREADS + 2:  # backpressure
                self._put(inflight.popleft().result())
        drain(block=True)

    def _decode_nvjpeg(self, raws, labs, cseed, bshape):
        """One batch through the nvJPEG backend, on the uploader's stream:
        decode each record, plan its crop, pack (1:1 crops of one
        subsampling together, ``pack_planes_batch``; others one by one);
        valid samples compacted to the front."""
        bs = self._bs
        up = self._uploader
        _, oh, ow = self._shape
        with torch.cuda.stream(up.stream):
            out = torch.zeros(bshape, dtype=self._torch_dtype,
                              device=up.device)
            lab_arr = np.zeros((bs, self._lw), np.float32)
            groups = {}
            nv = 0
            for i, raw in enumerate(raws):
                got = self._nvjpeg.decode_planes(raw)
                if got is None:
                    continue
                sub, planes, h, w = got
                plan = crop_plan(h, w, oh, ow, self._crop[0], self._crop[1],
                                 _mix_seed(cseed, i))
                if _batchable(sub, planes, plan, oh, ow):
                    groups.setdefault(sub, []).append((nv, (sub, planes,
                                                            plan)))
                else:
                    pack_image(planes_to_rgb(sub, planes, h, w), out[nv],
                               plan, self._norm, self._torch_dtype,
                               self._layout)
                lab_arr[nv] = np.asarray(labs[i], np.float32).reshape(
                    -1)[:self._lw]
                nv += 1
            if nv == 0:
                raise MXNetError(
                    "native image pipeline (nvJPEG): every record in a "
                    "batch failed to decode — is this a non-JPEG .rec?")
            for members in groups.values():
                pack_planes_batch([m for _, m in members], out,
                                  [slot for slot, _ in members], self._norm,
                                  self._torch_dtype, self._layout)
            data = out
            if self._device_transform is not None:
                data = self._device_transform(data)
            (label,), _ = up.upload([torch.from_numpy(
                lab_arr[:, 0] if self._lw == 1 else lab_arr)])
            event = torch.cuda.Event()
            event.record(up.stream)
        # nvJPEG reads the record bytes while it decodes: hold them (and
        # the decoded planes) until the batch's work is done
        event.synchronize()
        batch = mxio.DataBatch([nd.NDArray._from_torch(data, self._ctx)],
                               [nd.NDArray._from_torch(label, self._ctx)],
                               pad=bs - nv)
        batch._upload_event = event
        return batch


_live_pipelines = None


def _register_pipeline(p):
    global _live_pipelines
    if _live_pipelines is None:
        import atexit
        import weakref
        _live_pipelines = weakref.WeakSet()

        def _stop_all():
            for pl in list(_live_pipelines):
                pl.shutdown()
        atexit.register(_stop_all)
    _live_pipelines.add(p)


class _Done(object):
    """Immediately-resolved future (inline decode path)."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


def _translate_cxx_aug_params(kwargs):
    """Map the reference C++ iterator's parameter names
    (src/io/image_aug_default.cc: mean_r/g/b, max_random_scale, ...) onto
    CreateAugmenter's kwargs, so reference training scripts run unmodified.
    Unsupported knobs are dropped with a log line rather than an error,
    matching the spirit of the reference's "best effort" augmentation
    defaults; exact-parity consumers should pass aug_list explicitly."""
    kw = dict(kwargs)
    out = {}
    mean = [kw.pop("mean_r", 0.0), kw.pop("mean_g", 0.0),
            kw.pop("mean_b", 0.0)]
    if any(mean):
        out["mean"] = np.asarray(mean, dtype=np.float32)
    std = [kw.pop("std_r", 0.0), kw.pop("std_g", 0.0), kw.pop("std_b", 0.0)]
    if any(std):
        out["std"] = np.asarray(std, dtype=np.float32)
    if "rand_crop" in kw:
        out["rand_crop"] = bool(kw.pop("rand_crop"))
    if "rand_mirror" in kw:
        out["rand_mirror"] = bool(kw.pop("rand_mirror"))
    if "resize" in kw:
        out["resize"] = kw.pop("resize")
    # random scale: the C++ pipeline rescales the source image before the
    # crop; the closest Python-side analog is the random-sized crop
    mx_scale = kw.pop("max_random_scale", 1.0)
    mn_scale = kw.pop("min_random_scale", 1.0)
    if (mx_scale != 1.0 or mn_scale != 1.0) and out.get("rand_crop"):
        out["rand_resize"] = True
    if "pad" in kw:
        out["pad"] = kw.pop("pad")
        # the reference C++ augmenter pads with 255 unless told otherwise
        # (image_aug_default.cc:109 fill_value default) — scripts passing
        # pad= alone must get white padding, not black
        out["fill_value"] = kw.pop("fill_value", 255)
    dropped = {}
    for name in ("max_rotate_angle", "max_random_rotate_angle",
                 "max_aspect_ratio", "max_random_aspect_ratio",
                 "max_shear_ratio", "max_random_shear_ratio",
                 "max_random_h", "max_random_s", "max_random_l",
                 "inter_method", "max_img_size",
                 "min_img_size", "mirror", "rand_gray", "scale", "max_crop_size",
                 "min_crop_size", "random_h", "random_s", "random_l",
                 "rotate", "verbose"):
        if name in kw:
            dropped[name] = kw.pop(name)
    if dropped:
        logging.info("ImageRecordIter: ignoring augmentation params with no "
                     "Python-pipeline analog yet: %s", sorted(dropped))
    out.update(kw)  # anything else goes through (and typos will raise)
    return out


class ImageRecordIter(mxio.DataIter):
    """Threaded RecordIO image iterator: the reference's C++
    ImageRecordIOParser2 pipeline (reference src/io/iter_image_recordio_2.cc:
    parser -> augmenter -> batch loader -> prefetcher).  ``route`` names the
    route it took: ``"service"`` (the local data service), ``"network"``
    (its network tier), ``"native"``, ``"process"`` or ``"engine"``.
    Batches land on the context current at construction (``ctx``
    overrides it).
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 shuffle_chunk_seed=0, seed=None, part_index=0, num_parts=1,
                 prefetch_buffer=4, preprocess_threads=4, round_batch=True,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NCHW", device_transform=None, host_batches=False,
                 data_service=None, device_augment=None, ctx=None,
                 **aug_kwargs):
        super(ImageRecordIter, self).__init__(batch_size)
        from . import random as _random
        from .dataflow import Uploader
        self._eff_seed = _random.get_seed() if seed is None else int(seed)
        aug_kwargs = _translate_cxx_aug_params(aug_kwargs)
        has_custom_augs = "aug_list" in aug_kwargs
        self._layout = layout
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("layout must be NCHW or NHWC")
        # incompatible-flag checks precede any resource acquisition (record
        # handles, the reader thread, the uploader, the C++ pipe)
        if host_batches and device_transform is not None:
            raise MXNetError(
                "host_batches yields raw host batches — a device_transform "
                "would be silently skipped; pass one or the other")
        self._ctx = ctx if ctx is not None else current_context()
        # The data service (data_service=True: preprocess_threads worker
        # processes; MXTPU_DATA_WORKERS=N turns it on for env-routed
        # iterators and sizes their fleet), or its network tier
        # (data_service='host:port,...' or MXTPU_DATA_SERVERS).
        # data_service=False forces the in-process pipelines even when
        # either variable is set.
        self._service = None
        self._service_iter = None
        self._dev_aug = None
        self._it = None
        if device_augment is False:
            device_augment = None   # explicit off == unset; 0 is a real
            # margin (center crop + mirror/normalize on the device)
        env_workers = int(get_env(ENV_DATA_WORKERS, 0) or 0)
        env_servers = str(get_env(ENV_DATA_SERVERS, "") or "").strip()
        # data_service forms: None (the variables decide), False/0/""
        # (opt out), True or another truthy value (local service),
        # 'host:p,host:p' or a list/tuple of addresses (network tier)
        explicit_servers = None
        explicit_local = False
        if isinstance(data_service, str):
            explicit_servers = data_service.strip() or None
        elif isinstance(data_service, (list, tuple)):
            explicit_servers = list(data_service) or None
        elif data_service is not None:
            explicit_local = bool(data_service)
        servers = explicit_servers
        if servers is None and data_service is None and env_servers:
            servers = env_servers
        env_routed = data_service is None
        use_local = explicit_local or (
            env_routed and not servers and env_workers > 0)
        if servers or use_local:
            # an explicit data_service=True sizes the fleet from the call's
            # preprocess_threads; the variable sizes only env-routed
            # iterators.  On the network tier preprocess_threads is the
            # per-server decode worker count.
            workers = env_workers if (use_local and env_routed) \
                else max(1, int(preprocess_threads))
            try:
                self._init_service(
                    path_imgrec, path_imgidx, data_shape, batch_size,
                    label_width, shuffle, part_index, num_parts, workers,
                    dtype, layout, aug_kwargs, has_custom_augs,
                    host_batches, data_name, label_name,
                    servers=servers, device_augment=device_augment)
            except MXNetError:
                if not env_routed:   # explicitly requested: surface it
                    raise
                if device_augment is not None:
                    # an explicit device-augment ask must not degrade to
                    # host augmentation on a routing fallback
                    raise
                logging.warning(
                    "ImageRecordIter: MXTPU_DATA_WORKERS/MXTPU_DATA_"
                    "SERVERS is set but this configuration cannot route "
                    "through the data service; using the in-process "
                    "pipeline", exc_info=True)
        elif device_augment is not None:
            raise MXNetError(
                "device_augment rides the data-service transports: pass "
                "data_service=True / a server list, or set "
                "MXTPU_DATA_WORKERS / MXTPU_DATA_SERVERS")
        self._uploader = Uploader(self._ctx.torch_device)
        if self._service is not None:
            self.route = "network" if servers else "service"
            self.batch_size = batch_size
            self.data_shape = tuple(data_shape)
            self.label_width = label_width
            self._dtype = dtype
            self._host_batches = bool(host_batches)
            self._device_transform = device_transform
            self._data_name = data_name
            self._label_name = label_name
            return
        self._it = ImageIter(
            batch_size, data_shape, label_width=label_width,
            path_imgrec=path_imgrec, path_imgidx=path_imgidx,
            shuffle=shuffle, part_index=part_index, num_parts=num_parts,
            data_name=data_name, label_name=label_name,
            seed=self._eff_seed, **aug_kwargs)
        self._pipeline = None
        # Fastest route: the native C++ decode pipeline (libjpeg,
        # GIL-released), when the augmentations and the dtype are native
        # and the first record looks like JPEG (PNG/BMP .rec files take the
        # cv2 routes).  Unlike the JAX package, a native route that cannot
        # run (no libjpeg) raises instead of taking the process route.
        dt_name = str(np.dtype(dtype)) if dtype != "bfloat16" else dtype
        if (not has_custom_augs
                and get_env(ENV_RECORDITER_NATIVE, "1") != "0"
                and set(aug_kwargs) <= _NativePipeline.SUPPORTED
                and data_shape[0] == 3
                and dt_name in _NativePipeline.DTYPES
                and _rec_looks_jpeg(path_imgrec)):
            self._pipeline = _NativePipeline(
                self._it, tuple(data_shape), batch_size, label_width,
                aug_kwargs, preprocess_threads, prefetch_buffer, dtype,
                layout=layout, seed=self._eff_seed,
                device_transform=device_transform,
                host_batches=host_batches, ctx=self._ctx,
                uploader=self._uploader)
        if device_transform is not None and self._pipeline is None:
            raise MXNetError(
                "device_transform needs the native image pipeline")
        if host_batches and not isinstance(self._pipeline, _NativePipeline):
            raise MXNetError(
                "host_batches needs the native image pipeline (libjpeg)")
        if self._pipeline is None and layout != "NCHW":
            raise MXNetError(
                "layout='NHWC' needs the native image pipeline (libjpeg); "
                "it is unavailable or the augmentations aren't native")
        # Next: decode-worker processes.  Custom aug_list closures aren't
        # picklable -> the engine route, also selectable with
        # MXNET_RECORDITER_PROCS=0.
        import sys as _sys
        main_file = getattr(_sys.modules.get("__main__"), "__file__", None)
        # worker processes re-import __main__ (the multiprocessing
        # contract: scripts guard with if __name__ == '__main__'); from a
        # REPL/stdin only the inline reader-thread mode is available
        spawnable_main = main_file is not None and os.path.exists(main_file)
        use_pipeline = (not has_custom_augs
                        and get_env(ENV_RECORDITER_PROCS, "1") != "0")
        if self._pipeline is None and use_pipeline:
            self._pipeline = _ProcessPipeline(
                self._it, tuple(data_shape), batch_size, label_width,
                aug_kwargs, preprocess_threads, prefetch_buffer, dtype,
                allow_procs=spawnable_main, seed=self._eff_seed,
                ctx=self._ctx, uploader=self._uploader)
        self.route = ("native" if isinstance(self._pipeline, _NativePipeline)
                      else "process" if self._pipeline is not None
                      else "engine")
        if self._pipeline is None:
            from . import engine as eng
            self._engine = eng.Engine(num_workers=max(2, preprocess_threads))
            self._img_base = 0   # global sample ordinal: engine-path
            # augmentation seeds derive per image from (seed, ordinal)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._dtype = dtype
        self._prefetch = max(1, prefetch_buffer)
        self._queue = []
        self._drained = False
        if self._pipeline is None:
            # Serializes raw record reads (the source is sequential).
            self._read_var = self._engine.new_variable()
            self._start_prefetch()

    def _init_service(self, path_imgrec, path_imgidx, data_shape,
                      batch_size, label_width, shuffle, part_index,
                      num_parts, workers, dtype, layout, aug_kwargs,
                      has_custom_augs, host_batches, data_name, label_name,
                      servers=None, device_augment=None):
        """Route through the data service, local
        (``data_service.DataService``, this host's cores) or the network
        tier (``data_service.NetDataService``); raises MXNetError for
        configurations neither can express."""
        from .data_service import (DataService, DataServiceIter,
                                   NetDataService)
        if path_imgidx is None:
            raise MXNetError(
                "data_service needs path_imgidx (sharded readers plan "
                "from the index)")
        if has_custom_augs:
            raise MXNetError(
                "data_service cannot ship a custom aug_list to worker "
                "processes")
        unsupported = set(aug_kwargs) - _NativePipeline.SUPPORTED
        if unsupported:
            raise MXNetError(
                "data_service does not implement augmentations %s"
                % sorted(unsupported))
        if not servers and not _rec_looks_jpeg(path_imgrec):
            # worker processes decode JPEG (libjpeg, or cv2/PIL where the
            # native library has none): fail eligibility here so env
            # routing falls back to the cv2 pipelines.  (Network tier: the
            # paths are the servers'; their handshake reports problems.)
            raise MXNetError(
                "data_service needs a JPEG-payload .rec (the worker "
                "decode pipes are libjpeg); this file's first record "
                "is not JPEG")
        svc_shape = tuple(data_shape)
        svc_aug = dict(aug_kwargs)
        svc_dtype = dtype
        if device_augment is not None:
            # on-device augmentation (kernels/augment.py, the `augment`
            # name of MXTPU_FUSED_KERNELS): the transport ships a decoded
            # uint8 canvas with a crop margin and the device crops,
            # mirrors and normalizes, seeded per global batch.  With the
            # name off, the exact host-augmented path below.
            from .kernels import fused_enabled
            if host_batches:
                raise MXNetError(
                    "device_augment produces device arrays: it cannot "
                    "combine with host_batches")
            if fused_enabled("augment"):
                from .kernels.augment import DeviceAugment
                margin = 16 if device_augment is True \
                    else int(device_augment)
                self._dev_aug = DeviceAugment(
                    svc_shape, margin=margin,
                    rand_crop=bool(aug_kwargs.get("rand_crop")),
                    rand_mirror=bool(aug_kwargs.get("rand_mirror")),
                    mean=aug_kwargs.get("mean"),
                    std=aug_kwargs.get("std"), layout=layout,
                    dtype=dtype)
                svc_shape = self._dev_aug.canvas_shape
                svc_aug = {k: v for k, v in aug_kwargs.items()
                           if k == "resize"}
                svc_dtype = "uint8"   # raw pixels cross: 4x fewer bytes
            else:
                logging.info(
                    "ImageRecordIter: MXTPU_FUSED_KERNELS disables the "
                    "augment kernel: using the exact host-augmented path")
        fast_dct = get_env(ENV_JPEG_DECODE_FAST, "1") != "0"
        if servers:
            self._service = NetDataService(
                servers, path_imgrec, path_imgidx, svc_shape,
                batch_size, label_width=label_width, shuffle=shuffle,
                seed=self._eff_seed, part_index=part_index,
                num_parts=num_parts, workers_per_server=workers,
                dtype=svc_dtype, layout=layout, aug=svc_aug,
                fast_dct=fast_dct)
        else:
            self._service = DataService(
                path_imgrec, path_imgidx, svc_shape, batch_size,
                label_width=label_width, shuffle=shuffle,
                seed=self._eff_seed, part_index=part_index,
                num_parts=num_parts, num_workers=workers,
                dtype=svc_dtype, layout=layout, aug=svc_aug,
                fast_dct=fast_dct)
        # copy=False: host_batches hands the views on (valid until the
        # next pull), and the device path copies them out of the slot
        # before it releases it (_next_service)
        self._service_iter = DataServiceIter(
            self._service, data_name=data_name, label_name=label_name,
            copy=False)

    @property
    def provide_data(self):
        dt = np.dtype("float32" if self._dtype == "bfloat16"
                      else self._dtype)
        if self._service is not None:
            if self._dev_aug is not None:
                # the transport carries the uint8 canvas; consumers see
                # the product of the device-side augmentation
                shape = (self.batch_size,) + self._dev_aug.per_layout(
                    self._dev_aug.out_shape)
                return [mxio.DataDesc(self._data_name, shape, dtype=dt)]
            return [mxio.DataDesc(d.name, d.shape, dtype=dt)
                    for d in self._service_iter.provide_data]
        descs = []
        for d in self._it.provide_data:
            shape = d.shape
            if self._layout == "NHWC":
                n, c, h, w = shape
                shape = (n, h, w, c)
            descs.append(mxio.DataDesc(d.name, shape, dtype=dt))
        return descs

    @property
    def provide_label(self):
        if self._service is not None:
            return self._service_iter.provide_label
        return self._it.provide_label

    def _produce_one(self):
        """Pipeline one batch: a serial read op pulls batch_size raw records,
        then per-image decode+augment ops fan out across engine workers, and
        an assemble op (depending on all decode vars) builds the DataBatch."""
        import threading

        it = self._it
        c, h, w = self.data_shape
        slot = {}
        done = threading.Event()
        raw = {}

        def read_raw():
            samples = []
            try:
                for _ in range(self.batch_size):
                    samples.append(it.next_raw())
            except StopIteration:
                pass
            raw["samples"] = samples

        decoded = np.zeros((self.batch_size, h, w, c), dtype=np.float32)
        valid = [False] * self.batch_size
        img_base = self._img_base
        self._img_base += self.batch_size

        def decode_i(i):
            samples = raw["samples"]
            if i >= len(samples):
                return
            try:
                # per-image deterministic stream: independent of which
                # engine worker thread runs this op
                _seed_aug_rng(_chunk_seed(self._eff_seed, img_base + i))
                decoded[i] = it.decode_augment(samples[i][1])
                valid[i] = True
            except (RuntimeError, MXNetError) as e:
                logging.debug("Invalid image, skipping: %s", str(e))

        def assemble():
            samples = raw["samples"]
            if not samples:
                slot["eof"] = True
                done.set()
                return
            keep = [i for i in range(len(samples)) if valid[i]]
            n = len(keep)
            data = np.zeros_like(decoded)
            label = np.zeros((self.batch_size, self.label_width), "f")
            for j, i in enumerate(keep):
                data[j] = decoded[i]
                lab = samples[i][0]
                label[j] = lab
            out = np.ascontiguousarray(data.transpose(0, 3, 1, 2))
            if np.dtype(self._dtype) == np.uint8:
                out = np.clip(out, 0, 255)  # clamp, don't wrap
            host = torch.from_numpy(out).to(nd._torch_dtype(self._dtype))
            batch = _upload_batch(
                self._ctx, self._uploader, host,
                label[:, 0] if self.label_width == 1 else label,
                self.batch_size - n)
            batch.provide_data = self.provide_data
            batch.provide_label = self.provide_label
            slot["batch"] = batch
            done.set()

        read_done = self._engine.new_variable()
        self._engine.push(read_raw, mutable_vars=(self._read_var, read_done),
                          name="imagerec_read")
        dec_vars = []
        for i in range(self.batch_size):
            dv = self._engine.new_variable()
            self._engine.push(lambda i=i: decode_i(i),
                              const_vars=(read_done,), mutable_vars=(dv,),
                              name="imagerec_decode")
            dec_vars.append(dv)
        self._engine.push(assemble, const_vars=tuple(dec_vars),
                          name="imagerec_assemble")
        # Dependency-ordered deletion: vars reclaim after their consumers.
        self._engine.delete_variable(read_done)
        for dv in dec_vars:
            self._engine.delete_variable(dv)
        self._queue.append((slot, done))

    def _start_prefetch(self):
        while len(self._queue) < self._prefetch and not self._drained:
            self._produce_one()

    def reset(self):
        if self._service is not None:
            self._service_iter.reset()
            return
        if self._pipeline is not None:
            self._pipeline.reset()
            return
        self._engine.wait_for_all()
        self._queue = []
        self._drained = False
        self._it.reset()
        self._start_prefetch()

    @staticmethod
    def _ready(batch):
        """Make the caller's stream wait for the batch's copies."""
        from .dataflow import wait
        event = batch.__dict__.pop("_upload_event", None)
        if event is not None:
            wait([a._data for a in list(batch.data) + list(batch.label)],
                 event)
        return batch

    def _next_service(self):
        """One batch off the service collector.  host_batches hands the
        zero-copy views on (valid until the next pull, the product the C++
        parser handed out).  The device path copies the slot through the
        uploader (into a pinned block, then ``non_blocking`` on the side
        stream; on the CPU a private clone, since the CPU "upload" would
        alias the slot) and only then releases the slot: a worker must not
        overwrite bytes still being read.  With device_augment the
        uploaded canvas is augmented on the uploader's stream, seeded by
        the batch's chunk seed."""
        batch = self._service_iter.next()
        if self._host_batches:
            return batch
        data = batch.data[0]
        if not self._uploader.cuda:
            data = data.clone()
        aug, dt = self._dev_aug, self._device_transform
        transform = dt
        if aug is not None:
            seed, nvalid = batch.aug_seed, self.batch_size - batch.pad
            transform = (lambda d: dt(aug(d, seed, nvalid))) if dt \
                else (lambda d: aug(d, seed, nvalid))
        out = _upload_batch(self._ctx, self._uploader, data,
                            batch.label[0], batch.pad, transform)
        batch.release()   # the bytes have left the slot: recycle it
        return out

    def next(self):
        if self._service is not None:
            batch = self._next_service()
            batch.provide_data = self.provide_data
            batch.provide_label = self.provide_label
            return self._ready(batch)
        if self._pipeline is not None:
            batch = self._pipeline.next()
            batch.provide_data = self.provide_data
            batch.provide_label = self.provide_label
            return self._ready(batch)
        if not self._queue:
            raise StopIteration
        slot, done = self._queue.pop(0)
        done.wait()
        if "eof" in slot:
            self._drained = True
            self._queue = []
            raise StopIteration
        self._start_prefetch()
        return self._ready(slot["batch"])

    def stats(self):
        """Per-stage data-service counters (``DataService.stats``); None
        for the in-process pipelines."""
        if self._service is not None:
            return self._service_iter.stats()
        return None

    def close(self):
        if self._service is not None:
            self._service_iter.close()
            return
        if self._pipeline is not None:
            self._pipeline.shutdown()
            return
        self._engine.wait_for_all()
        self._engine.shutdown()


def ImageRecordUInt8Iter(path_imgrec, data_shape, batch_size, **kwargs):
    """Raw uint8 record iterator (reference iter_image_recordio_2.cc:579
    ImageRecordUInt8Iter): decode+augment without normalization, batches
    emitted as uint8; callers cast/normalize on the device (4x fewer
    host->device bytes than float32)."""
    for bad in ("mean_r", "mean_g", "mean_b", "std_r", "std_g", "std_b"):
        if kwargs.get(bad):
            raise MXNetError(
                "ImageRecordUInt8Iter emits raw uint8; normalization "
                "params like %r belong on-device (or use ImageRecordIter)"
                % bad)
    return ImageRecordIter(path_imgrec, data_shape, batch_size,
                           dtype="uint8", **kwargs)
