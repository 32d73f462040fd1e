"""Library locator (port of ``mxnet_tpu/libinfo.py``; reference
python/mxnet/libinfo.py find_lib_path): the native libraries this install
loads, built at first use under ``mxnet_tpu_torch/_build``."""
import os

__version__ = "0.1.0"


def find_lib_path():
    """Paths of the native libraries backing this install (the analog of
    locating libmxnet.so): the host library (``native/``: engine,
    RecordIO, JPEG decode; built with ``g++``) and, where ``nvcc``
    exists, the kernels' libraries (``csrc/<name>.cu``, one per source).
    Each is built on first use as :func:`kernels.load_library` and
    :func:`native.get_lib` do.  Raises ``RuntimeError`` when none can be
    built or found."""
    from . import kernels
    from . import native
    found = []
    errors = []
    try:
        native.get_lib()
        found.append(native.library_path())
    except Exception as e:  # noqa: BLE001 — reported below if nothing
        errors.append("native: %s" % (e,))
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
    names = sorted(n[:-len(".cu")] for n in os.listdir(csrc)
                   if n.endswith(".cu") and n != "rtc_elementwise.cu")
    try:
        kernels.build(names)
        found += [kernels.library_path(n) for n in names]
    except Exception as e:  # noqa: BLE001 — no nvcc on a CPU-only host
        errors.append("kernels: %s" % (e,))
    found = [p for p in found if os.path.exists(p)]
    if not found:
        raise RuntimeError("no native library could be built or found (%s)"
                           % "; ".join(errors))
    return found
