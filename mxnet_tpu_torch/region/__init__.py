"""The region drill on the port: data servers, a supervised elastic zero3
trainer, the serving fleet under ``--watch`` and closed-loop clients under
one supervision tree (the counterpart of the JAX package's
``tools/region.py`` and ``tools/supervise.py``'s ``Supervisor``).

- :mod:`.supervisor` — :class:`~.supervisor.Supervisor`, one non-blocking
  monitor a role, and the exit-code policy :func:`~.supervisor.
  relaunch_decision` (0 done, 85 preempt and 87 watchdog relaunch with
  ``MXTPU_RESUME=1``);
- :mod:`.region_main` — the orchestrator and its CLI
  (``python mxnet_tpu_torch/region/region_main.py smoke|storm|run``);
- :mod:`.trainer_main` — the elastic trainer process (imports torch);
- :mod:`.dataset_main` — the region's seeded JPEG ``.rec`` builder.

Only the trainer imports torch.  The orchestrator, the supervisor and
the dataset builder import neither torch nor jax: run as scripts, they
load the package through a stub ``mxnet_tpu_torch`` package
(``region_main.bootstrap``), as the fleet's CLI does, so
``mxnet_tpu_torch/__init__.py`` never runs in them.
"""
