"""The native host library (port of ``mxnet_tpu/native/__init__.py``).

The sources beside this file are the JAX package's ``native/`` sources
(the dependency engine, the RecordIO codec, the libjpeg decode pipeline
and the ``im2rec`` packer) with their C symbols prefixed ``MXT`` instead
of ``MXTPU``, so both packages' libraries load into one process.  It is
host code and builds with ``g++`` (not ``nvcc``) at first use, into
``mxnet_tpu_torch/_build/libmxt_native-<digest>.so``, the digest a hash of
the sources and the flags, as ``kernels/__init__.py`` keys the CUDA
kernels.  The library links with ``-Wl,-Bsymbolic`` so its calls into its
own symbols never resolve to another library's.

A failed build raises :class:`MXNetError` carrying the compiler's
message, where the JAX package falls back to pure Python in silence.
Without libjpeg the library is built without the image pipeline, the
libjpeg error is kept in :data:`JPEG_BUILD_ERROR`, and ``has_imagedec()``
is false.  ``MXNET_NO_NATIVE=1`` asks for the pure-Python paths:
:func:`get_lib` then returns None.

On a host without libjpeg but with the CUDA toolkit, :func:`nvjpeg_lib`
builds ``nvjpeg_dec.cc`` (nvJPEG, the toolkit's JPEG decoder) into a
library of its own, ``libmxt_nvjpeg-<digest>.so``: the native image route
then decodes on the card.  It is never built where libjpeg exists.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time

from ..base import MXNetError, get_env, register_env

__all__ = ["get_lib", "build", "library_path", "has_imagedec", "im2rec",
           "nvjpeg_lib", "cuda_home", "ENGINE_CB", "BUILD_SECONDS",
           "JPEG_BUILD_ERROR"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SRCS = ("engine.cc", "recordio.cc", "imagedec.cc", "im2rec.cc")
_JPEG_SRCS = ("imagedec.cc", "im2rec.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-Wl,-Bsymbolic")

ENV_NO_NATIVE = register_env(
    "MXNET_NO_NATIVE", default=0,
    doc="1 disables the native C runtime entirely (pure-Python fallbacks)")

ENGINE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

#: seconds the last build in this process took (None: none was needed)
BUILD_SECONDS = None
#: the compiler's message when the build with libjpeg failed (the library
#: then lacks the image pipeline), else None
JPEG_BUILD_ERROR = None

_lock = threading.Lock()
_lib = None
_nvjpeg = None


def library_path():
    """Where the library builds to, keyed by a hash of the sources, the
    header and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in _SRCS + ("mxt.h",):
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, "libmxt_native-%s.so" % h.hexdigest()[:16])


def _compile(srcs, out, extra=None):
    tmp = "%s.tmp%d" % (out, os.getpid())
    cmd = ["g++", *CXX_FLAGS, "-o", tmp] + \
        [os.path.join(_DIR, s) for s in srcs]
    if any(s in _JPEG_SRCS for s in srcs):
        cmd.append("-ljpeg")
    cmd += list(extra or ())
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return proc.stderr.decode(errors="replace")[-4000:]
    os.replace(tmp, out)
    return None


class _BuildLock(object):
    """One build at a time across processes: a lock file in ``_build/``."""

    def __enter__(self):
        os.makedirs(_BUILD, exist_ok=True)
        self._f = open(os.path.join(_BUILD, "native.lock"), "w")
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()


def build():
    """Compile the library if it does not exist yet.  Returns the seconds
    the build took, 0.0 when the library existed.  Raises MXNetError when
    neither the build with libjpeg nor the one without it succeeds (a
    library built without libjpeg leaves a ``.nojpeg`` file beside it
    holding the compiler's message)."""
    global BUILD_SECONDS, JPEG_BUILD_ERROR
    out = library_path()
    if os.path.exists(out):
        _read_jpeg_error(out)
        return 0.0
    with _BuildLock():
        if os.path.exists(out):
            _read_jpeg_error(out)
            return 0.0
        t0 = time.perf_counter()
        err = _compile(_SRCS, out)
        if err is not None:
            plain = [s for s in _SRCS if s not in _JPEG_SRCS]
            err2 = _compile(plain, out)
            if err2 is not None:
                raise MXNetError("native library build failed:\n%s\n%s"
                                 % (err, err2))
            with open(out + ".nojpeg", "w") as f:
                f.write(err)
            JPEG_BUILD_ERROR = err
        BUILD_SECONDS = time.perf_counter() - t0
        return BUILD_SECONDS


def _read_jpeg_error(out):
    global JPEG_BUILD_ERROR
    if os.path.exists(out + ".nojpeg"):
        with open(out + ".nojpeg") as f:
            JPEG_BUILD_ERROR = f.read()


def cuda_home():
    """The CUDA toolkit's root (``CUDA_HOME``, else /usr/local/cuda)."""
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def nvjpeg_lib():
    """The ctypes library of ``nvjpeg_dec.cc``, built on first use against
    the CUDA toolkit's ``nvjpeg.h``.  Raises MXNetError where libjpeg
    exists (the libjpeg pipeline decodes there) or when the build fails."""
    global _nvjpeg
    if _nvjpeg is not None:
        return _nvjpeg
    if has_imagedec():
        raise MXNetError("nvJPEG decode is for hosts without libjpeg; this "
                         "library has the libjpeg pipeline")
    cuda = cuda_home()
    extra = ["-I" + os.path.join(cuda, "include"),
             "-L" + os.path.join(cuda, "lib64"), "-lnvjpeg",
             "-Wl,-rpath," + os.path.join(cuda, "lib64")]
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(extra)).encode())
    with open(os.path.join(_DIR, "nvjpeg_dec.cc"), "rb") as f:
        h.update(f.read())
    out = os.path.join(_BUILD, "libmxt_nvjpeg-%s.so" % h.hexdigest()[:16])
    with _lock:
        if _nvjpeg is None:
            if not os.path.exists(out):
                with _BuildLock():
                    if not os.path.exists(out):
                        err = _compile(("nvjpeg_dec.cc",), out, extra)
                        if err is not None:
                            raise MXNetError("nvJPEG decoder build failed:\n"
                                             + err)
            lib = ctypes.CDLL(out)
            p = ctypes.c_void_p
            u64 = ctypes.c_uint64
            lib.MXTNvjpegCreate.restype = p
            lib.MXTNvjpegCreate.argtypes = []
            lib.MXTNvjpegDestroy.argtypes = [p]
            ip = ctypes.POINTER(ctypes.c_int)
            lib.MXTNvjpegInfo.restype = ctypes.c_int
            lib.MXTNvjpegInfo.argtypes = [p, p, u64, ip, ip, ip, ip]
            lib.MXTNvjpegDecode.restype = ctypes.c_int
            lib.MXTNvjpegDecode.argtypes = [p, p, u64, ctypes.c_int, p, u64,
                                            p, u64, p, u64, p]
            _nvjpeg = lib
    return _nvjpeg


def _configure(lib):
    u64 = ctypes.c_uint64
    p = ctypes.c_void_p
    lib.MXTEngineCreate.restype = p
    lib.MXTEngineCreate.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.MXTEngineShutdown.argtypes = [p]
    lib.MXTEngineNewVar.restype = u64
    lib.MXTEngineNewVar.argtypes = [p]
    lib.MXTEngineDeleteVar.argtypes = [p, u64]
    lib.MXTEnginePushAsync.restype = ctypes.c_int
    lib.MXTEnginePushAsync.argtypes = [
        p, ENGINE_CB, p, ctypes.POINTER(u64), ctypes.c_int,
        ctypes.POINTER(u64), ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
    lib.MXTEngineWaitForVar.argtypes = [p, u64]
    lib.MXTEngineWaitForAll.argtypes = [p]
    lib.MXTEngineNumPending.restype = ctypes.c_int
    lib.MXTEngineNumPending.argtypes = [p]
    lib.MXTEngineLastError.restype = ctypes.c_char_p
    lib.MXTEngineLastError.argtypes = [p]
    lib.MXTProfilerSetState.argtypes = [p, ctypes.c_int]
    lib.MXTProfilerDump.restype = p  # decoded, then freed with MXTFree
    lib.MXTProfilerDump.argtypes = [p]

    lib.MXTRecordIOWriterCreate.restype = p
    lib.MXTRecordIOWriterCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordIOWriterWrite.restype = ctypes.c_int
    lib.MXTRecordIOWriterWrite.argtypes = [p, ctypes.c_char_p, u64]
    lib.MXTRecordIOWriterTell.restype = u64
    lib.MXTRecordIOWriterTell.argtypes = [p]
    lib.MXTRecordIOWriterClose.argtypes = [p]
    lib.MXTRecordIOReaderCreate.restype = p
    lib.MXTRecordIOReaderCreate.argtypes = [ctypes.c_char_p]
    lib.MXTRecordIOReaderRead.restype = ctypes.c_int
    lib.MXTRecordIOReaderRead.argtypes = [
        p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(u64)]
    lib.MXTRecordIOReaderSeek.argtypes = [p, u64]
    lib.MXTRecordIOReaderTell.restype = u64
    lib.MXTRecordIOReaderTell.argtypes = [p]
    lib.MXTRecordIOReaderClose.argtypes = [p]
    lib.MXTFree.argtypes = [p]

    try:
        fp = ctypes.POINTER(ctypes.c_float)
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.MXTImgPipeCreate.restype = p
        lib.MXTImgPipeCreate.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, fp, fp,
            ctypes.c_int]
        lib.MXTImgPipeDecodeBatch.restype = ctypes.c_int
        lib.MXTImgPipeDecodeBatch.argtypes = [
            p, pp, ctypes.POINTER(u64), ctypes.c_int, p,
            ctypes.POINTER(ctypes.c_uint8), u64]
        lib.MXTImgPipeDestroy.argtypes = [p]
        lib.MXTImgDecodeDims.restype = ctypes.c_int
        lib.MXTImgDecodeDims.argtypes = [
            p, u64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.MXTImgDecode.restype = ctypes.c_int
        lib.MXTImgDecode.argtypes = [p, u64, p, ctypes.c_int]
        lib.MXTIm2Rec.restype = ctypes.c_int
        lib.MXTIm2Rec.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(u64), ctypes.POINTER(u64)]
        lib._has_imagedec = True
    except AttributeError:
        lib._has_imagedec = False
    return lib


def get_lib():
    """The configured ctypes library, built on first use; None under
    ``MXNET_NO_NATIVE=1``.  Raises MXNetError when the build fails."""
    global _lib
    if str(get_env(ENV_NO_NATIVE, "0")) == "1":
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            try:
                handle = ctypes.CDLL(library_path())
            except OSError:
                # a library built on another host (a copied _build/) whose
                # link dependencies this host lacks: build it here
                with _BuildLock():
                    for stale in (library_path(),
                                  library_path() + ".nojpeg"):
                        if os.path.exists(stale):
                            os.remove(stale)
                build()
                handle = ctypes.CDLL(library_path())
            _lib = _configure(handle)
    return _lib


def has_imagedec():
    """True when the library holds the libjpeg image pipeline."""
    lib = get_lib()
    return lib is not None and lib._has_imagedec


def im2rec(lst_path, root, rec_path, idx_path, resize=0, quality=95,
           nthreads=1, pass_through=False):
    """Pack the JPEGs a ``.lst`` names into ``.rec``/``.idx`` with the
    native packer (libjpeg decode, shorter-edge resize to ``resize``,
    libjpeg encode at ``quality``; ``pass_through`` copies the files'
    bytes), records in list order.  Returns ``(packed, skipped)``."""
    if not has_imagedec():
        raise MXNetError("native im2rec needs the libjpeg build: %s"
                         % (JPEG_BUILD_ERROR or "MXNET_NO_NATIVE=1"))
    packed = ctypes.c_uint64(0)
    skipped = ctypes.c_uint64(0)
    rc = get_lib().MXTIm2Rec(
        lst_path.encode(), (root or "").encode(), rec_path.encode(),
        idx_path.encode(), 0 if pass_through else int(resize), int(quality),
        max(1, int(nthreads)), 1 if pass_through else 0,
        ctypes.byref(packed), ctypes.byref(skipped))
    if rc != 0:
        raise MXNetError("native im2rec failed rc=%d" % rc)
    return int(packed.value), int(skipped.value)
