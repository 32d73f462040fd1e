"""Kernel routing and the CUDA kernel library loader.

**Routing** reads the JAX package's knob, ``MXTPU_FUSED_KERNELS``, with
its semantics: ``1`` (default) enables every kernel and plan pass, ``0``
restores the exact pre-fusion graphs, a comma list enables individual
names.  ``KNOWN_KERNELS`` is the JAX package's full catalog, so a
setting written for either package is understood (and no name warns)
in both, and one setting toggles the same plan passes in both
(``concat_fuse``, ``pool_act``, ``bn_act``/``bn_fold``,
``eltwise_chain``, ``infer_trace``: :mod:`mxnet_tpu_torch.mxfuse`;
the bodies of ``concat_fuse``, ``pool_act`` and ``eltwise_chain`` are
:mod:`.concat_fuse`, :mod:`.pool_act` and :mod:`.eltwise_chain` here).
``augment`` routes ``ImageRecordIter(device_augment=...)`` to
:mod:`.augment` (torch code, no hand-written kernel, as in the JAX
package).

**Building.** Every hand-written kernel lives in ``csrc/<name>.cu`` with
a plain C interface.  :func:`build` compiles the sources at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``mxnet_tpu_torch/_build/lib<name>-<hash>.so``, one ``nvcc`` process per
source, all started together.  The hash covers the source bytes and the
flags, so an edited ``.cu`` is never served from a stale library.
:func:`load_library` opens the result with ``ctypes``.  A missing
``nvcc`` or a failed build raises, with ``nvcc``'s message; nothing falls
back.  Both also take a GENERATED source (``sources=`` / ``source=``: the
rtc escape hatch renders a user's body into the template
``csrc/rtc_elementwise.cu``): it is written to
``_build/rtc/<name>-<hash>.cu`` and built to ``_build/rtc/lib<name>-<hash>.so``,
the hash over the rendered text and the flags.

**Flash block.** ``MXTPU_FLASH_BLOCK`` (registered here, eagerly, as the
JAX package does) is the routing threshold of ``full_attention`` and the
key-block length of the plain flash attention and its backward; the CUDA
kernel's own tiles do not depend on it.

**Registered ops.** Every forward kernel that inference reaches is an op
of the one ``mxt`` library (:func:`define_op`): ``bn_act_fwd``,
``lstm_seq_fwd``, ``lstm_cell_fwd``, ``flash_attention_fwd`` and
``rtc_elementwise`` (``rtc.py``).  The eager plan calls the op, so a
``torch.export`` program of the plan holds it, and a loaded program
launches the kernel as the plan does.  Launch counters and
:func:`note_launch` are fed inside the CUDA kernels only: a trace counts
nothing.  The backward kernels stay direct launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time

from ..base import ENV_FUSED_KERNELS, MXNetError, get_env, register_env

__all__ = ["KNOWN_KERNELS", "enabled_kernels", "fused_enabled", "build",
           "load_library", "library_path", "BUILD_SECONDS", "ENV_FLASH_BLOCK",
           "LAUNCH_HOOKS", "note_launch", "portable_trace", "portable",
           "define_op",
           "bn_act", "lstm_cell", "flash_attention", "roofline",
           "concat_fuse", "pool_act", "eltwise_chain", "augment"]

_LOG = logging.getLogger(__name__)

#: every kernel name the router understands (the JAX package's catalog)
KNOWN_KERNELS = ("bn_act", "bn_fold", "lstm_cell", "flash_attention",
                 "augment", "concat_fuse", "pool_act", "eltwise_chain",
                 "infer_trace")

# registered eagerly at package import, as in the JAX package
ENV_FLASH_BLOCK = register_env(
    "MXTPU_FLASH_BLOCK", default=128,
    doc="Tile size (query and key block length) for the flash-attention "
        "kernel; sequences at or below one block use plain attention")

_ON = frozenset(("1", "on", "true", "yes", "all"))
_OFF = frozenset(("", "0", "off", "false", "no", "none"))

_warned_unknown = set()


def enabled_kernels():
    """The set of fused kernels the env currently enables.  Read per call:
    callers consult it at bind time, so the cost is paid once per graph
    build."""
    raw = str(get_env(ENV_FUSED_KERNELS, "1")).strip().lower()
    if raw in _ON:
        return frozenset(KNOWN_KERNELS)
    if raw in _OFF:
        return frozenset()
    names = set()
    for part in raw.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        if part in KNOWN_KERNELS:
            names.add(part)
        elif part not in _warned_unknown:
            _warned_unknown.add(part)
            _LOG.warning(
                "MXTPU_FUSED_KERNELS names unknown kernel %r "
                "(known: %s) — ignored", part, ", ".join(KNOWN_KERNELS))
    return frozenset(names)


def fused_enabled(name):
    """Whether the named fused kernel is used for graphs bound now."""
    return name in enabled_kernels()


#: ``hook(kernel, grad_enabled, requires_grad)`` callables told of every
#: hand-written kernel launch.  The kernels launch through ctypes, so no
#: dispatch mode sees them: the graph lint's recorder
#: (``analysis/graph_lint.record_step``) listens here
LAUNCH_HOOKS = []

#: held while a wrapper adds to its launch counter: the positions of an
#: in-process mesh launch from threads of their own
COUNT_LOCK = threading.Lock()


def note_launch(kernel, *tensors):
    """Report one launch of ``kernel`` on ``tensors`` to the hooks: grad
    mode, and whether any input requires grad.  Costs one list test when
    nothing listens."""
    if not LAUNCH_HOOKS:
        return
    import torch
    grad = torch.is_grad_enabled()
    req = any(getattr(t, "requires_grad", False) for t in tensors)
    for hook in list(LAUNCH_HOOKS):
        hook(kernel, grad, req)


_PORTABLE = threading.local()


@contextlib.contextmanager
def portable_trace():
    """Scope in which every kernel wrapper takes its plain version, on
    any device: ``predict.export_compiled`` traces inside it, so the
    portable program holds only aten ops and loads in a process that
    imports torch alone.  Serving never enters it."""
    prev = getattr(_PORTABLE, "on", False)
    _PORTABLE.on = True
    try:
        yield
    finally:
        _PORTABLE.on = prev


def portable():
    """Whether this thread is inside :func:`portable_trace`."""
    return getattr(_PORTABLE, "on", False)


_MXT = []


def define_op(schema, plain, cuda, fake):
    """Define ``torch.ops.mxt.<name>`` from ``schema`` on the one ``mxt``
    library (torch allows one definition library a namespace): ``plain``
    is its CompositeExplicitAutograd kernel (every device but CUDA),
    ``cuda`` its CUDA kernel (the hand-written kernel's launch), ``fake``
    its shape function under ``FakeTensorMode`` and on ``meta`` tensors.
    An exported program (``serving/aot.py``) holds the op and calls the
    kernel where the eager plan does.  Registered through
    ``torch.library.Library`` (a definition, two kernels and a fake), not
    the ``custom_op`` decorator, whose Python autograd layers cost several
    times as much host time a call (``tools/bn_act_dispatch.py``; PERF.md
    §6).  Returns the op's overload packet."""
    import torch
    if not _MXT:
        _MXT.append(torch.library.Library("mxt", "DEF"))
    lib = _MXT[0]
    name = schema.split("(", 1)[0]
    lib.define(schema)
    lib.impl(name, plain, "CompositeExplicitAutograd")
    lib.impl(name, cuda, "CUDA")
    torch.library.register_fake("mxt::" + name, fake, lib=lib)
    return getattr(torch.ops.mxt, name)


# ---------------------------------------------------------------------------
# nvcc build + ctypes load
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_GENERATED = os.path.join(_BUILD, "rtc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: seconds each library's build took in this process (0.0: already built)
BUILD_SECONDS = {}

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise MXNetError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                     "the CUDA kernels cannot be built")


def _digest(text_bytes):
    return hashlib.sha256(text_bytes + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:16]


def library_path(name, source=None):
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of its bytes
    and the flags; with ``source`` (generated text), where that text
    builds to under ``_build/rtc/``, keyed by a hash of the text and the
    flags."""
    if source is not None:
        return os.path.join(_GENERATED, "lib%s-%s.so" % (
            name, _digest(source.encode())))
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = _digest(f.read())
    return os.path.join(_BUILD, "lib%s-%s.so" % (name, digest))


def _source_file(name, out, source):
    """The ``.cu`` nvcc compiles for ``name``: ``csrc/<name>.cu``, or the
    generated text written beside its library (temp name, then renamed,
    so concurrent builders never read a torn file)."""
    if source is None:
        return os.path.join(_CSRC, name + ".cu")
    path = out[:-len(".so")] + ".cu"
    tmp = "%s.tmp%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        f.write(source)
    os.replace(tmp, path)
    return path


def build(names, sources=None):
    """Compile every named source that has no current library: one
    ``nvcc`` per source, all started together, each written to a
    temporary name and renamed into place once it succeeded.  ``sources``
    maps a name to its generated text; other names are ``csrc/<name>.cu``.
    The compiler's report (``-Xptxas -v``: registers, spills) is kept
    beside the library as ``<lib>.log``.  Returns ``{name: seconds}`` for
    the sources it compiled (empty when every library existed).  Raises
    :class:`MXNetError` carrying nvcc's message when a build fails."""
    sources = sources or {}
    todo = {}
    for name in names:
        out = library_path(name, sources.get(name))
        if os.path.exists(out):
            BUILD_SECONDS.setdefault(name, 0.0)
        else:
            todo[name] = out
    if not todo:
        return {}
    os.makedirs(_BUILD, exist_ok=True)
    if any(name in sources for name in todo):
        os.makedirs(_GENERATED, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name, out in todo.items():
        tmp = "%s.tmp%d" % (out, os.getpid())
        src = _source_file(name, out, sources.get(name))
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        report, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - start
        with open(out + ".log", "wb") as f:
            f.write(report)
        if proc.returncode != 0:
            failed.append("%s (nvcc rc %d):\n%s" % (
                name, proc.returncode, report.decode(errors="replace")[-4000:]))
            continue
        os.replace(tmp, out)
    if failed:
        raise MXNetError("CUDA kernel build failed: " + "\n".join(failed))
    return {name: BUILD_SECONDS[name] for name in todo}


def load_library(name, source=None):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu`` (or of the generated
    ``source``), built on first use; a library already loaded in this
    process is returned as it is."""
    path = library_path(name, source)
    with _LOCK:
        lib = _LIBS.get(path)
        if lib is None:
            build([name], None if source is None else {name: source})
            lib = _LIBS[path] = ctypes.CDLL(path)
        return lib


from . import bn_act  # noqa: E402
from . import lstm_cell  # noqa: E402
from . import flash_attention  # noqa: E402
from . import roofline  # noqa: E402
from . import concat_fuse  # noqa: E402
from . import pool_act  # noqa: E402
from . import eltwise_chain  # noqa: E402
from . import augment  # noqa: E402
