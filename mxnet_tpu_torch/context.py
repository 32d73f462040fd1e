"""Device context: ``cpu()`` and ``gpu(i)`` over explicit ``torch.device``s.

Port of ``mxnet_tpu/context.py``.  Two deliberate differences:

- **No silent CPU fallback.**  ``current_context()`` is ``gpu(0)``.  A gpu
  context on a host without CUDA raises when it is resolved to a device;
  it never runs on the CPU instead.  Callers that want the CPU say
  ``cpu()``.
- **f32 means f32.**  The JAX reference has no TF32 mode, so before the
  first CUDA tensor is made through a context, :func:`pin_f32_numerics`
  turns TF32 off for cuDNN convolutions
  (``torch.backends.cudnn.allow_tf32``, True by default) and for cuBLAS
  matmuls (``torch.backends.cuda.matmul.allow_tf32``).
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "pin_f32_numerics", "tpu", "num_tpus"]


def pin_f32_numerics():
    """Run float32 convolutions and matmuls in full float32 (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Context(object):
    """A device context; devtype ids follow the reference
    (include/mxnet/base.h Context::kCPU=1, kGPU=2)."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    @property
    def torch_device(self):
        """The ``torch.device`` this context denotes.  A gpu context
        raises when CUDA is absent or the id is out of range."""
        if self.device_typeid == 1:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but CUDA is not available; pass mx.cpu() "
                "to run on the host" % self)
        count = torch.cuda.device_count()
        if self.device_id >= count:
            raise MXNetError("%s: device_id out of range (%d CUDA devices)"
                             % (self, count))
        pin_f32_numerics()
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    """The host."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """The i-th CUDA device."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """The JAX package's accelerator context, here the i-th CUDA device:
    a script written for ``mx.tpu()`` runs on the card."""
    return gpu(device_id)


def num_gpus():
    """The number of CUDA devices (0 on a host without CUDA)."""
    return torch.cuda.device_count()


def num_tpus():
    """:func:`num_gpus` under the JAX package's name."""
    return num_gpus()


#: the process's default device when a process group set one (each rank
#: of ``distributed.initialize`` owns one device), else None
_PROCESS_DEFAULT = None


def set_process_default(ctx):
    """Make ``ctx`` the default context of every thread that has not
    entered a ``with ctx:`` scope (``distributed.initialize`` sets each
    rank's device)."""
    global _PROCESS_DEFAULT
    _PROCESS_DEFAULT = None if ctx is None else Context(ctx)
    Context._default_ctx.value = _PROCESS_DEFAULT or Context("gpu", 0)


def current_context():
    """The default context: ``gpu(0)`` (or this rank's device under a
    process group) unless a ``with ctx:`` scope says otherwise."""
    if not hasattr(Context._default_ctx, "value"):
        Context._default_ctx.value = _PROCESS_DEFAULT or Context("gpu", 0)
    return Context._default_ctx.value
