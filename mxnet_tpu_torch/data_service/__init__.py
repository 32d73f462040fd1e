"""The input-data service (port of ``mxnet_tpu/data_service/``).

So far it holds :mod:`.common`, the pieces ``image.py`` shares with the
service: the per-chunk augmentation seed, the ImageNet normalization
constants and the native pipe's constructor.  The service itself
(decode worker processes over a shared-memory ring, the network tier,
``DataServiceIter``) comes with the next slice of the port, together with
on-device augmentation (``DeviceAugment``).
"""
from . import common  # noqa: F401
