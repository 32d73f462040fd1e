"""Shared pieces of the data service (port of the parts of
``mxnet_tpu/data_service/common.py`` that ``image.py`` needs: ``chunk_seed``,
``IMAGENET_MEAN``/``IMAGENET_STD``, ``np_dtype`` and ``open_native_pipe``),
stdlib and numpy only as in the JAX package.  ``chunk_seed`` is the
contract the in-process pipelines and the native decoder share: a
sample's augmentation is a pure function of (seed, chunk, epoch).
"""
from __future__ import annotations

#: the reference's default ImageNet channel normalization (image.py's
#: ``mean=True`` / ``std=True``)
IMAGENET_MEAN = (123.68, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)

__all__ = ["chunk_seed", "IMAGENET_MEAN", "IMAGENET_STD", "np_dtype",
           "open_native_pipe", "DTYPE_CODES"]

#: the native pipe's output dtype codes (imagedec.cc: kU8, kF32, kBf16)
DTYPE_CODES = {"uint8": 0, "float32": 1, "bfloat16": 2}


def chunk_seed(seed, chunk_idx, epoch=0):
    """Deterministic per-chunk seed (splitmix64-style mix keeps successive
    chunks decorrelated even for seed=0).  epoch and chunk mix through
    separate 64-bit odd multipliers.  The native decoder mixes the result
    further per image (imagedec.cc:MixSeed)."""
    m = (1 << 64) - 1
    x = (int(seed) * 0x9e3779b97f4a7c15
         + int(chunk_idx) * 0xbf58476d1ce4e5b9
         + int(epoch) * 0x2545f4914f6cdd1d) & m
    x ^= x >> 30
    x = (x * 0x94d049bb133111eb) & m
    x ^= x >> 31
    return x % (2 ** 31)


def np_dtype(name):
    """The numpy dtype for a dtype name.  numpy has no bfloat16 and the
    port does not use ``ml_dtypes``: a bfloat16 host buffer is held as its
    bits, ``uint16`` (``torch.bfloat16`` tensors view the same bytes)."""
    import numpy as _np
    if name == "bfloat16":
        return _np.dtype(_np.uint16)
    return _np.dtype(name)


def open_native_pipe(lib, out_h, out_w, resize, rand_crop, rand_mirror,
                     dtype_code, layout_code, mean, std, fast_dct,
                     nthreads):
    """Construct a native image pipe (``MXTImgPipeCreate``): the one place
    the ctypes argument marshaling lives.  ``mean``/``std`` are 1- or
    3-value float sequences or None (resolve ``True`` to the IMAGENET_*
    defaults before calling).  Returns ``(pipe_handle_or_None,
    keepalive)``: hold ``keepalive`` for the pipe's lifetime."""
    import ctypes
    import numpy as _np
    fp = ctypes.POINTER(ctypes.c_float)

    def _c3(v):
        if v is None:
            return None
        a = _np.asarray(v, dtype=_np.float32).reshape(-1)
        if a.size == 1:
            a = _np.repeat(a, 3)
        return (ctypes.c_float * 3)(*a[:3])

    mean_c, std_c = _c3(mean), _c3(std)
    pipe = lib.MXTImgPipeCreate(
        int(nthreads), int(out_h), int(out_w), int(resize or 0),
        1 if rand_crop else 0, 1 if rand_mirror else 0,
        int(dtype_code), int(layout_code),
        ctypes.cast(mean_c, fp) if mean_c else None,
        ctypes.cast(std_c, fp) if std_c else None,
        1 if fast_dct else 0)
    return pipe, (mean_c, std_c)
