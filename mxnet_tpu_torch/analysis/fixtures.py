"""The ONE definition of the "standard MLP fused step" fixture (port of
``mxnet_tpu/analysis/fixtures.py``), and the shared source fixtures of
the level-3 passes.

Two consumers assert the same claim — "the standard MLP step lints
clean" — and must lint the same step: ``mxlint_main.py --graph`` (the CLI
gate) and ``tests/test_torch_analysis.py``.  The JAX package builds its
trainer on a dp mesh of 8 virtual CPUs; the port's runs on one device,
``ctx`` (``gpu(0)`` unless the caller passes ``cpu()``).

Imports are function-local: the analysis package stays stdlib-only at
import time (the CLI's AST level must run without torch).
"""
from __future__ import annotations

__all__ = ["standard_mlp_sym", "standard_mlp_trainer",
           "standard_mlp_batch",
           "RACE_UNGUARDED_SRC", "RACE_GUARDED_SRC",
           "RACE_CHECK_THEN_ACT_SRC", "RACE_SUPPRESSED_SRC",
           "CONTRACT_DRIFT_SRC", "CONTRACT_CLEAN_SRC",
           "contract_fixture_surface", "PR18_SUPERVISION_KEYS",
           "pr18_broken_router_source"]

#: the canonical dimensions/seed of the fixture — change them HERE only
BATCH, IN_DIM, HIDDEN, NUM_CLASSES, SEED = 64, 32, 64, 10, 7


def standard_mlp_sym(num_classes=NUM_CLASSES, nh=HIDDEN):
    """fc(64) -> relu -> fc(10) -> softmax, the tier-1 pinned model."""
    import mxnet_tpu_torch as mx
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=nh, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def standard_mlp_batch():
    """The deterministic example batch every consumer lints against."""
    import numpy as np
    rs = np.random.RandomState(0)
    return (rs.randn(BATCH, IN_DIM).astype("f"),
            rs.randint(0, NUM_CLASSES, BATCH).astype("f"))


def standard_mlp_trainer(cls=None, ctx=None, **kwargs):
    """A bound + initialized SPMDTrainer of the standard MLP on one
    device, ``ctx``.  ``cls`` lets tests substitute violation-seeding
    fixture subclasses; extra kwargs (compute_dtype, input_transforms,
    optimizer_params, ...) pass through to the trainer."""
    import mxnet_tpu_torch as mx
    from ..parallel import SPMDTrainer
    cls = cls or SPMDTrainer
    opt_params = kwargs.pop("optimizer_params", {"learning_rate": 0.1})
    trainer = cls(standard_mlp_sym(), "sgd", opt_params, ctx=ctx, **kwargs)
    trainer.bind([("data", (BATCH, IN_DIM))],
                 [("softmax_label", (BATCH,))])
    mx.random.seed(SEED)
    trainer.init_params(mx.initializer.Xavier())
    return trainer


# ---------------------------------------------------------------------------
# Level 3 (cross-module lint) fixtures: one synthetic snippet per rule
# behavior, shared by tests and by anyone reproducing a finding by hand.
# Plain strings + a revert helper — stdlib-only, like the whole module.
# ---------------------------------------------------------------------------

#: two threads mutate ``self.counter`` read-modify-write with no lock —
#: the canonical ``repo-shared-mutation`` finding
RACE_UNGUARDED_SRC = """
import threading

class Worker(object):
    def __init__(self):
        self.counter = 0
        self._thread = threading.Thread(target=self._loop)

    def _loop(self):
        self.counter += 1

    def tick(self):
        self.counter += 1
"""

#: the same shape with both mutations under the class lock — clean
RACE_GUARDED_SRC = """
import threading

class Worker(object):
    def __init__(self):
        self.counter = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop)

    def _loop(self):
        with self._lock:
            self.counter += 1

    def tick(self):
        with self._lock:
            self.counter += 1
"""

#: ``if k in d: ... d[k]`` on a thread-shared dict outside any lock —
#: the canonical ``repo-check-then-act`` finding
RACE_CHECK_THEN_ACT_SRC = """
import threading

class Registry(object):
    def __init__(self):
        self.entries = {}
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop)

    def _loop(self):
        with self._lock:
            self.entries["x"] = 1

    def lookup(self):
        if "x" in self.entries:
            return self.entries["x"]
        return None
"""

#: an unguarded mutation carrying a justified inline suppression — the
#: escape hatch must keep working or every justified carve-out breaks
RACE_SUPPRESSED_SRC = """
import threading

class Worker(object):
    def __init__(self):
        self.counter = 0
        self._thread = threading.Thread(target=self._loop)

    def _loop(self):
        # benign: test-only counter, torn reads acceptable
        self.counter += 1  # mxlint: disable=repo-shared-mutation

    def tick(self):
        self.counter += 1  # mxlint: disable=repo-shared-mutation
"""

#: producer/consumer pair for ``wire-contract-drift``: the producer
#: emits {a, b}; the consumer reads a and c.  Declared as one surface,
#: this yields BOTH drift directions — ``c`` consumer-read-never-
#: produced (error) and ``b`` producer-key-never-read (warning)
CONTRACT_DRIFT_SRC = """
def produce():
    return {"a": 1, "b": 2}

def consume(doc):
    return doc["a"] + doc.get("c", 0)
"""

#: the aligned version of the same surface — clean
CONTRACT_CLEAN_SRC = """
def produce():
    return {"a": 1, "b": 2}

def consume(doc):
    return doc["a"] + doc.get("b", 0)
"""


def contract_fixture_surface(contract_lint, relpath):
    """The declared surface for the snippet above (producer ``produce``
    and consumer ``consume`` in the same file)."""
    return contract_lint.Surface(
        "fixture-doc", "synthetic fixture surface",
        producers=[(relpath, "produce")],
        consumers=[(relpath, "consume")])


#: the supervision fields ``view_export`` must carry — the exact keys
#: the regression fixture rips back out
PR18_SUPERVISION_KEYS = ("state", "pid", "restarts", "last_rc")


def pr18_broken_router_source():
    """Re-create the ``view_export`` wire-contract bug: return the
    port's ``fleet/router.py``'s
    source with ``view_export``'s supervision fields reverted (the
    sharded front end again silently dropping ``state/pid/restarts/
    last_rc`` from the published view).  Feed the result to
    ``contract_lint.lint_paths(..., overrides=...)`` — the lint must go
    red with one consumer-read-never-produced error per key.  Raises if
    the source has drifted so far the revert no longer applies (then
    the fixture — not the lint — needs updating)."""
    import os
    import re
    here = os.path.dirname(os.path.abspath(__file__))
    relpath = os.path.join("mxnet_tpu_torch", "fleet", "router.py")
    path = os.path.join(os.path.dirname(os.path.dirname(here)),
                        "mxnet_tpu_torch", "fleet", "router.py")
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    broken = src.replace('"state": sup.get("state"),', "")
    broken = re.sub(
        r'\n *# supervision fields travel with the view'
        r'[\s\S]*?"last_rc": sup\.get\("last_rc"\)\}',
        "}", broken)
    if broken == src or any('"%s": sup.get' % k in broken
                            for k in PR18_SUPERVISION_KEYS):
        raise RuntimeError(
            "pr18_broken_router_source: view_export no longer matches "
            "the revert pattern — update the regression fixture")
    return {relpath: broken}
