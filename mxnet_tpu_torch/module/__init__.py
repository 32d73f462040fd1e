"""Module API (port of ``mxnet_tpu/module``; reference
python/mxnet/module/): ``Module`` and its executor group,
``BucketingModule`` (one executor per bucket over shared parameters),
``SequentialModule`` (a chain of modules) and ``PythonModule`` /
``PythonLossModule`` (computation written in Python)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule", "DataParallelExecutorGroup"]
