"""mxserve on the port: inference serving on the predict/resilience stack
(port of ``mxnet_tpu/serving/``).

- :mod:`.batcher` — continuous request batching into padded power-of-two
  **bucket** shapes, one cached executor per bucket.
- :mod:`.pool` — warm multi-model pool, device-resident weights,
  optional bfloat16 or int8 weights, checkpoint-directory loading.
- :mod:`.frontend` — HTTP admission control: bounded queues, SLO-aware
  load shedding (429), ``/healthz`` + ``/stats``, graceful SIGTERM
  drain, StepWatchdog coverage of wedged forwards (exit 87 ->
  ``tools/supervise.py`` relaunch), weighted-fair tenant queueing.
- :mod:`.sequence` — bucketed SEQUENCE serving (``/predict_seq``).
- :mod:`.deploy` — hot swap of verified new checkpoint epochs.
- :mod:`.aot` — the AOT store: one weight-free ``torch.export`` program
  per (model, bucket), its meta check and its fallback.

``python mxnet_tpu_torch/serving/serve_main.py`` is the daemon (the JAX
package's ``tools/serve.py`` with a ``--context`` flag).
"""
from .batcher import (BucketBatcher, DeadlineExpired, Draining, QueueFull,
                      TenantQuotaExceeded, parse_buckets, pick_bucket,
                      pad_to_bucket, parse_tenant_weights)
from .pool import ModelPool, PooledModel
from .frontend import ServeClient, ServingFrontend, Stats
# deploy's MXTPU_SWAP_* knobs register EAGERLY here, and sequence's
# MXTPU_SERVE_SEQ_BUCKETS rides the same rule
from .deploy import CheckpointWatcher
from .sequence import (SequenceEntry, parse_seq_buckets, pick_seq_bucket,
                       seq_batcher_name)

__all__ = ["BucketBatcher", "DeadlineExpired", "Draining", "QueueFull",
           "TenantQuotaExceeded", "parse_buckets", "pick_bucket",
           "pad_to_bucket", "parse_tenant_weights", "ModelPool",
           "PooledModel", "ServeClient", "ServingFrontend", "Stats",
           "CheckpointWatcher", "SequenceEntry", "parse_seq_buckets",
           "pick_seq_bucket", "seq_batcher_name"]
