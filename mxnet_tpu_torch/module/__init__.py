"""Module API (port of ``mxnet_tpu/module``; reference
python/mxnet/module/).  ``BucketingModule``, ``SequentialModule`` and
``PythonModule`` come with the next slice."""
from .base_module import BaseModule
from .module import Module
from .executor_group import DataParallelExecutorGroup

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup"]
