"""The port's linter (``mxnet_tpu_torch/analysis/``) against the JAX
package's (``mxnet_tpu/analysis/``) on the CPU.

- Source levels: the AST, race and contract passes of both packages give
  identical ``(rule, line, message)`` lists on the same source fixtures
  written to ``tmp_path``, and the same report JSON, byte for byte, for
  the same findings.
- The port's tree lints clean: ``mxlint_main.py`` exits 0 over its
  default paths with poisoned ``torch`` and ``jax`` on ``PYTHONPATH``
  (the AST and whole-repo levels need no runtime), and ``tools/mxlint.py
  mxnet_tpu_torch`` exits 0.
- Graph level: the standard MLP step is clean in float32, with a metric
  and momentum, and under ``compute_dtype="bfloat16"``; the seeded
  violations flag with the JAX package's rule ids (a rebound carry,
  ``.item()`` in an input transform, a float32 transform under bfloat16,
  a kernel launched outside an ``autograd.Function``).  The JAX graph
  lint itself is not called here: its ``jax.core`` walk needs the jax
  version the JAX package pins.
- ``MXTPU_ANALYZE``: ``strict`` refuses (sticky per signature), ``1``
  warns and trains.
- ``PooledModel.analyze`` is clean for an MLP and a narrow ResNet,
  float32, bfloat16 and int8.
- Data parallel (two gloo ranks, ``tests/test_torch_zero3.py``'s
  analysis worker): a zero3 step's collective schedule is clean (one
  bucketed all-gather a group forward and backward, reduce-scatter
  gradients, no param-scale all-reduce), a parameter left out of the
  sharding is flagged ``graph-collective-schedule``, an allreduce step
  shows no all-gather and a zero step gathers by design; ``analyze``
  trains nothing.
- The step writes its carries in place: every carry keeps its
  ``data_ptr`` across steps, the values are bit-equal to the
  out-of-place step (a test-local subclass that rebinds every carry), and
  within ``tests/test_torch_trainer.py``'s tolerance of the JAX trainer;
  with the divergence abort off (``max_consecutive_bad_steps=0``) too.
"""
import json
import logging
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.analysis import ast_lint as j_ast
from mxnet_tpu.analysis import contract_lint as j_contract
from mxnet_tpu.analysis import fixtures as j_fix
from mxnet_tpu.analysis import race_lint as j_race
from mxnet_tpu.analysis import report as j_report
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.analysis import ast_lint as t_ast
from mxnet_tpu_torch.analysis import contract_lint as t_contract
from mxnet_tpu_torch.analysis import fixtures as t_fix
from mxnet_tpu_torch.analysis import graph_lint
from mxnet_tpu_torch.analysis import race_lint as t_race
from mxnet_tpu_torch.analysis import report as t_report
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(REPO, "mxnet_tpu_torch", "analysis", "mxlint_main.py")
CPU = tmx.cpu()


def rules_of(report):
    return sorted({f.rule for f in report.findings})


def _triples(report):
    return sorted((f.rule, f.line, f.message, os.path.basename(f.file or ""))
                  for f in report.findings)


def _write(tmp_path, name, src):
    path = tmp_path / name
    path.write_text(textwrap.dedent(src))
    return str(path)


# ---------------------------------------------------------------------------
# source levels: identical findings on shared fixtures
# ---------------------------------------------------------------------------

AST_FIXTURES = {
    "traced": """
        import time
        import jax

        def build():
            def step(x):
                return x * 2
            return jax.jit(step, donate_argnums=(0,))

        def leaky(x):
            t = time.time()
            return float(x) + x.item() + t

        fast = jax.jit(leaky)

        class Trainer(object):
            def step(self, x):
                t0 = time.monotonic()
                return x, t0

            @jax.jit
            def fused(self, x):
                return bool(x)
        """,
    "locks": """
        import threading

        class A(object):
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
        """,
    "excepts_env": """
        import os
        from mxnet_tpu.base import get_env, register_env

        ENV_X = register_env("MXTPU_FIXTURE_X")

        def f():
            try:
                pass
            except:
                pass
            a = os.environ.get("MXTPU_FIXTURE_X")
            b = os.environ["MXNET_FIXTURE_Y"]
            c = get_env(ENV_X)
            d = get_env("MXTPU_FIXTURE_TYPO")
            e = os.environ.get("MXTPU_FIXTURE_X")  # mxlint: disable=env-direct-read
            return a, b, c, d, e
        """,
}


@pytest.mark.parametrize("name", sorted(AST_FIXTURES))
def test_ast_level_matches_jax(tmp_path, name):
    path = _write(tmp_path, name + ".py", AST_FIXTURES[name])
    j = j_ast.lint_paths([path])
    t = t_ast.lint_paths([path])
    assert j.findings, "fixture %s flags nothing" % name
    assert _triples(t) == _triples(j)


RACE_FIXTURES = ("RACE_UNGUARDED_SRC", "RACE_GUARDED_SRC",
                 "RACE_CHECK_THEN_ACT_SRC", "RACE_SUPPRESSED_SRC")


@pytest.mark.parametrize("name", RACE_FIXTURES)
def test_race_level_matches_jax(tmp_path, name):
    assert getattr(t_fix, name) == getattr(j_fix, name)
    path = _write(tmp_path, "race.py", getattr(t_fix, name))
    j = j_race.lint_paths([path])
    t = t_race.lint_paths([path])
    assert _triples(t) == _triples(j)
    expect = {"RACE_UNGUARDED_SRC": ["repo-shared-mutation"],
              "RACE_CHECK_THEN_ACT_SRC": ["repo-check-then-act"]}
    assert rules_of(t) == expect.get(name, [])


@pytest.mark.parametrize("name", ("CONTRACT_DRIFT_SRC", "CONTRACT_CLEAN_SRC"))
def test_contract_level_matches_jax(tmp_path, name):
    assert getattr(t_fix, name) == getattr(j_fix, name)
    path = _write(tmp_path, "contract.py", getattr(t_fix, name))
    reports = []
    for lint, fix in ((j_contract, j_fix), (t_contract, t_fix)):
        surface = fix.contract_fixture_surface(lint, path)
        mods, _ = lint.load_modules([path])
        reports.append(lint.lint_modules(mods, surfaces=[surface]))
    # the port's message drops the JAX package's changelog reference
    # ("the PR 18 view_export bug shape"); the text is otherwise equal
    want = [(r, ln, m.replace("the PR 18 view_export", "the view_export"),
             f) for r, ln, m, f in _triples(reports[0])]
    assert _triples(reports[1]) == want
    if name == "CONTRACT_DRIFT_SRC":
        sev = sorted(f.severity for f in reports[1].findings)
        assert sev == ["error", "warning"]
    else:
        assert reports[1].ok


def test_report_json_is_byte_identical():
    out = []
    for mod in (j_report, t_report):
        rep = mod.Report(tool="mxlint.ast")
        rep.files_scanned = 3
        rep.add("bare-except", "m1", file="a.py", line=4)
        rep.add("wire-contract-drift", "m2", file="b.py", line=1,
                severity="warning", data={"k": 1})
        rep.add("graph-callback", "m3")
        rep.stats["collectives"] = {"all-reduce": {"count": 0, "bytes": 0}}
        out.append((rep.to_json(), rep.format_text()))
    assert out[0] == out[1]
    assert t_report.REPORT_VERSION == j_report.REPORT_VERSION == 1


def test_ast_level_sees_the_torch_capture_forms(tmp_path):
    """traced-host-call also covers functions handed to torch.compile,
    torch.cuda.make_graphed_callables or called inside a CUDA graph
    capture; the JAX package's pass does not know these forms."""
    path = _write(tmp_path, "capture.py", """
        import time
        import torch

        def step(x):
            return x * x.sum().item()

        compiled = torch.compile(step)

        @torch.compile(mode="max-autotune")
        def fused(x):
            return float(x.sum())

        def body(x):
            return x + time.perf_counter()

        def run(g, x):
            with torch.cuda.graph(g):
                body(x)

        def host_only(x):
            return x.item()
        """)
    t = t_ast.lint_paths([path])
    got = sorted((f.line, f.message.split(":")[0]) for f in t.findings)
    assert got == [(6, "inside 'step' (passed to torch.compile)"),
                   (12, "inside 'fused' (passed to torch.compile)"),
                   (15, "inside 'body' (run under torch.cuda.graph)")], got
    assert not j_ast.lint_paths([path]).findings


def test_contract_registry_names_the_ports_files():
    refs = set()
    for s in t_contract.repo_registry():
        for rel, _q in tuple(s.producers) + tuple(s.consumers):
            refs.add(rel)
    assert refs, "empty registry"
    assert all(r.startswith(("mxnet_tpu_torch/", "tests/test_torch_",
                             "chip_smoke.py", "tools/ckpt_fsck.py"))
               for r in refs), sorted(refs)
    assert all(os.path.isfile(os.path.join(REPO, r)) for r in refs)


#: the region drill's surfaces and its reads of the router's /stats
REGION_SURFACES = ("trainer-status", "region-spec", "region-stats",
                   "router-stats")
REGION_FILES = {j_contract: ["tools/region.py"],
                t_contract: ["mxnet_tpu_torch/region/region_main.py",
                             "mxnet_tpu_torch/region/trainer_main.py"]}


def _region_findings(lint, drift=None, files=None):
    surfaces = [s for s in lint.repo_registry() if s.name in REGION_SURFACES]
    assert sorted(s.name for s in surfaces) == sorted(REGION_SURFACES)
    paths = [os.path.join(REPO, f) for f in (files or REGION_FILES[lint])]
    overrides = None
    if drift is not None:
        with open(paths[0]) as f:
            src = f.read()
        assert drift[0] in src
        overrides = {paths[0]: src.replace(*drift)}
    rep = lint.lint_paths(paths, surfaces=surfaces, overrides=overrides)
    return [(f.rule, f.severity, f.message) for f in rep.findings]


@pytest.mark.parametrize("drift", [
    None,
    ('"served_epochs": epochs,', '"served": epochs,'),
    ("        self.clients = 4\n", "        self.client_count = 4\n")])
def test_region_surfaces_match_jax(drift):
    """trainer-status, region-spec, region-stats and the region's reads
    of router-stats: the port's level over region_main.py and
    trainer_main.py reports what the JAX level reports over
    tools/region.py, clean and with the same drift in each."""
    got = _region_findings(t_contract, drift)
    want = _region_findings(j_contract, drift)
    assert got == want
    assert bool(got) == (drift is not None)


def test_trainer_status_is_a_real_producer():
    """The port's trainer writes the status file in a module the lint
    reads (the JAX package's is a generated script): a renamed key is an
    error at the region's reader."""
    got = _region_findings(
        t_contract, ('"reconnects": reconnects(it),',
                     '"reconnect": reconnects(it),'),
        files=["mxnet_tpu_torch/region/trainer_main.py",
               "mxnet_tpu_torch/region/region_main.py"])
    errors = [m for _r, sev, m in got if sev == "error"]
    assert len(errors) == 1 and "Region._reconnect_total reads " \
        "'reconnects'" in errors[0], got


def test_view_export_regression_fixture_flags_every_supervision_key():
    overrides = t_fix.pr18_broken_router_source()
    rel, = overrides
    assert rel == os.path.join("mxnet_tpu_torch", "fleet", "router.py")
    full = {os.path.join(REPO, rel): overrides[rel]}
    rep = t_contract.lint_paths([os.path.join(REPO, rel)], overrides=full)
    errors = [f for f in rep.findings if f.severity == "error"]
    for key in t_fix.PR18_SUPERVISION_KEYS:
        assert any("%r" % key in f.message for f in errors), \
            rep.format_text()
    clean = t_contract.lint_paths([os.path.join(REPO, rel)])
    assert not clean.errors, clean.format_text()


def test_fault_points_resolve_the_ports_sites():
    points = t_ast.collect_fault_points([os.path.join(REPO,
                                                      "mxnet_tpu_torch")])
    for name in ("poison_grad", "hang_step", "checkpoint_write",
                 "stage_batch", "preempt", "iter_next"):
        assert name in points, sorted(points)


# ---------------------------------------------------------------------------
# the port's tree lints clean, without a runtime
# ---------------------------------------------------------------------------

def _poisoned_env(tmp_path):
    for mod in ("torch", "jax"):
        d = tmp_path / "poison" / mod
        d.mkdir(parents=True)
        (d / "__init__.py").write_text("raise ImportError('%s poisoned')\n"
                                       % mod)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tmp_path / "poison")
    env.pop("MXTPU_ANALYZE_REPORT", None)
    return env


def test_port_tree_lints_clean_without_torch_or_jax(tmp_path):
    env = _poisoned_env(tmp_path)
    out = tmp_path / "r.json"
    proc = subprocess.run([sys.executable, CLI, "-q", "--json", str(out)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["summary"]["findings"] == 0
    assert doc["files_scanned"] > 150
    # the graph level is the one mode that needs torch
    proc = subprocess.run([sys.executable, CLI, "-q", "--graph",
                           os.path.join(REPO, "mxnet_tpu_torch", "analysis")],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "graph level failed" in proc.stderr


def test_jax_cli_lints_the_port_clean():
    proc = subprocess.run([sys.executable, "tools/mxlint.py", "-q",
                           "mxnet_tpu_torch"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_flags(tmp_path):
    bad = _write(tmp_path, "bad.py", """
        def f():
            try:
                pass
            except:
                pass
        """)
    run = [sys.executable, CLI]
    proc = subprocess.run(run + [bad], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1 and "bare-except" in proc.stdout
    proc = subprocess.run(run + ["--select", "lock-order", bad],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout
    proc = subprocess.run(run + ["--select", "nope", bad],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    proc = subprocess.run(run + ["--list-faults"], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "poison_grad" in proc.stdout
    proc = subprocess.run(run + ["--graph", "--context", "cpu", "-q",
                                 bad.replace("bad.py", "none.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# graph level: the shipped step is clean
# ---------------------------------------------------------------------------

def _mlp(**kw):
    return t_fix.standard_mlp_trainer(ctx=CPU, **kw)


def test_standard_mlp_constants_match_jax():
    assert (t_fix.BATCH, t_fix.IN_DIM, t_fix.HIDDEN, t_fix.NUM_CLASSES,
            t_fix.SEED) == (j_fix.BATCH, j_fix.IN_DIM, j_fix.HIDDEN,
                            j_fix.NUM_CLASSES, j_fix.SEED) == \
        (64, 32, 64, 10, 7)
    for a, b in zip(t_fix.standard_mlp_batch(), j_fix.standard_mlp_batch()):
        np.testing.assert_array_equal(a, b)
    # auto-names count per process: compare from fresh name managers
    with tmx.name.NameManager():
        tsym = t_fix.standard_mlp_sym()
    with jmx.name.NameManager():
        jsym = j_fix.standard_mlp_sym()
    assert tsym.tojson() == jsym.tojson()


def test_mlp_step_clean():
    tr = _mlp()
    before = {k: v.clone() for k, v in tr.params.items()}
    rep = tr.analyze(*t_fix.standard_mlp_batch())
    assert rep.ok, rep.format_text()
    assert rep.stats["host_syncs"] == 0
    assert all(s["count"] == 0 for s in rep.stats["collectives"].values())
    assert set(rep.stats["collectives"]) == set(graph_lint.COLLECTIVE_OPS)
    assert rep.stats["plan_fusion"]["entries"] > 0
    # analysing a step trains nothing
    assert tr._num_update == 0
    for k, v in tr.params.items():
        assert torch.equal(v, before[k]), k


def test_mlp_step_with_metric_and_momentum_clean():
    tr = _mlp(optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    metric = tmx.metric.Accuracy()
    fn = metric.graph_update(["softmax_label"])
    assert fn is not None
    tr.install_metric(fn, key="acc-test")
    rep = tr.analyze(*t_fix.standard_mlp_batch())
    assert rep.ok, rep.format_text()


def test_bf16_step_clean():
    tr = _mlp(compute_dtype="bfloat16")
    rep = tr.analyze(*t_fix.standard_mlp_batch())
    assert rep.ok, rep.format_text()
    tally = rep.stats["compute_eqn_dtypes"]
    assert tally and all(set(d) == {"bfloat16"} for d in tally.values()), \
        tally


def test_resnet_step_and_plan_fusion_clean():
    sym = tmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                image_shape=(3, 8, 8))
    tr = tmx.parallel.SPMDTrainer(sym, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9}, ctx=CPU)
    tr.bind([("data", (2, 3, 8, 8))], [("softmax_label", (2,))])
    tr.init_params(tmx.initializer.Xavier())
    rs = np.random.RandomState(0)
    rep = tr.analyze(rs.rand(2, 3, 8, 8).astype("f"),
                     np.array([0, 3], "f"))
    assert rep.ok, rep.format_text()
    assert rep.stats["plan_fusion"]["overrides"] > 0


# ---------------------------------------------------------------------------
# graph level: seeded violations flag with the JAX package's rule ids
# ---------------------------------------------------------------------------

class _Rebound(tmx.parallel.SPMDTrainer):
    """The out-of-place step: every carry's new value in new storage."""

    def _carry(self, old, new, finite):
        return new if finite is None else torch.where(finite, new, old)

    def _step_tail(self, *args):
        outs = super()._step_tail(*args)
        if self._guard_acc is not None:
            self._guard_acc = self._guard_acc.clone()
        return outs


def test_fixture_trainer_donation_violation_flagged():
    """A trainer that rebinds its carries (the out-of-place step) is
    caught: the four params and the guard counters, each named."""
    tr = t_fix.standard_mlp_trainer(cls=_Rebound, ctx=CPU)
    rep = tr.analyze(*t_fix.standard_mlp_batch())
    missing = [f for f in rep.findings
               if f.rule == "graph-donation-missing"]
    assert len(missing) == 5, rep.format_text()
    text = "\n".join(f.message for f in missing)
    for name in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
                 "guard"):
        assert name in text, text


def test_fixture_trainer_callback_violation_flagged():
    def leaky(x):
        return x * (x.sum().item() > -1e30)

    tr = _mlp(input_transforms={"data": leaky})
    rep = tr.analyze(*t_fix.standard_mlp_batch())
    assert rules_of(rep) == ["graph-callback"], rep.format_text()
    f, = rep.findings
    assert f.file == __file__ and f.line is not None


def test_fixture_trainer_dtype_violation_flagged():
    """An input transform that widens to float32 inside a bf16 step."""
    tr = _mlp(compute_dtype="bfloat16",
              input_transforms={"data": lambda x: x.float()})
    rep = tr.analyze(*t_fix.standard_mlp_batch())
    assert "graph-dtype-drift" in rules_of(rep), rep.format_text()


def _fake_launch(x):
    """A stand-in for a hand-written kernel's wrapper: it reports its
    launch as the real wrappers do (on the CPU they take the plain
    version and launch nothing)."""
    tmx.kernels.note_launch("fake_kernel", x)
    return x * 2.0


class _Protected(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fake_launch(x)

    @staticmethod
    def backward(ctx, g):
        return _fake_launch(g)


def test_unprotected_kernel_launch_flagged_and_protected_clean():
    w = torch.ones(8, 4)
    d = torch.ones(2, 8)

    def bad_step(params, data):
        with torch.enable_grad():
            leaf = params["w"].detach().requires_grad_(True)
            out = _fake_launch(data @ leaf)
            out.sum().backward()
        params["w"].sub_(0.1 * leaf.grad)
        return out.detach()

    def good_step(params, data):
        with torch.enable_grad():
            leaf = params["w"].detach().requires_grad_(True)
            out = _Protected.apply(data @ leaf)
            out.sum().backward()
        params["w"].sub_(0.1 * leaf.grad)
        return out.detach()

    params = {"w": w.clone()}
    bad = graph_lint.lint_step(bad_step, params, d, carries=params,
                               expect_allgather=False, min_donate_bytes=0)
    assert rules_of(bad) == ["graph-pallas-no-vjp"], bad.format_text()
    good = graph_lint.lint_step(good_step, params, d, carries=params,
                                expect_allgather=False, min_donate_bytes=0)
    assert good.ok, good.format_text()
    # forward and backward launches were both seen, neither flagged
    assert good.stats["kernel_launches"] == {"fake_kernel": 2}


def _carry_step_rebind(params, data):
    params["w"] = params["w"] - 0.01 * (data @ params["w"]).sum()
    return data @ params["w"]


def _carry_step_inplace(params, data):
    params["w"].sub_(0.01 * (data @ params["w"]).sum())
    return data @ params["w"]


def test_lint_step_donation_rules():
    d = torch.ones(8, 64)
    params = {"w": torch.ones(64, 32)}
    bad = graph_lint.lint_step(_carry_step_rebind, params, d,
                               carries=params, min_donate_bytes=0)
    assert rules_of(bad) == ["graph-donation-missing"], bad.format_text()
    params = {"w": torch.ones(64, 32)}
    small = graph_lint.lint_step(_carry_step_rebind, params, d,
                                 carries=params, min_donate_bytes=1 << 20)
    assert small.ok, small.format_text()
    params = {"w": torch.ones(64, 32)}
    good = graph_lint.lint_step(_carry_step_inplace, params, d,
                                carries=params, min_donate_bytes=0)
    assert good.ok, good.format_text()

    def writes_batch(params, data):
        data.mul_(2.0)
        return _carry_step_inplace(params, data)

    unused = graph_lint.lint_step(writes_batch, params, d, carries=params,
                                  min_donate_bytes=0)
    assert rules_of(unused) == ["graph-donation-unused"], \
        unused.format_text()


def test_collectives_recorded_and_allgather_flagged():
    import torch.distributed as dist
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                            world_size=1, rank=0)
    try:
        def step(x):
            dist.all_reduce(x)
            out = [torch.empty_like(x)]
            dist.all_gather(out, x)
            return out[0]

        x = torch.ones(4, 4)
        rep = graph_lint.lint_step(step, x, inputs=[],
                                   expect_allgather=False)
        coll = rep.stats["collectives"]
        assert coll["all-reduce"] == {"count": 1, "bytes": 64}
        assert coll["all-gather"] == {"count": 1, "bytes": 64}
        assert rules_of(rep) == ["graph-collective-allgather"]
        ok = graph_lint.lint_step(step, x, inputs=[], expect_allgather=True)
        assert ok.ok, ok.format_text()
    finally:
        dist.destroy_process_group()


def test_collective_schedule_waits_for_multi_gpu():
    """The zero3 schedule rule (ported with the data-parallel slice):
    no declared schedule, no findings; a declared one is held to its
    gathered bytes, its reduce-scatters and the absence of a
    param-scale all-reduce (the JAX package's rule on the same
    stats)."""
    from mxnet_tpu.analysis import graph_lint as jlint
    assert graph_lint.audit_collective_schedule({}, None) == []

    def stats(ag, rs, ar, agn=2, rsn=1):
        return {"all-gather": {"count": agn, "bytes": ag},
                "reduce-scatter": {"count": rsn, "bytes": rs},
                "all-reduce": {"count": 1, "bytes": ar}}

    expect = 1 << 20
    for st, clean in ((stats(2 * expect, expect // 2, 64), True),
                      (stats(expect // 4, expect // 2, 64), False),
                      (stats(2 * expect, 0, 64, rsn=0), False),
                      (stats(2 * expect, expect // 2, expect), False)):
        got = graph_lint.audit_collective_schedule(st, "zero3-manual",
                                                   expect)
        want = jlint.audit_collective_schedule(st, "zero3-manual", expect)
        assert (not got) == clean == (not want), (st, got, want)
        assert all(f.rule == "graph-collective-schedule" for f in got)
    # group counts: one gather a group forward, at most one more backward
    assert graph_lint.audit_collective_schedule(
        stats(2 * expect, expect // 2, 64, agn=2, rsn=1), "zero3-manual",
        expect, expect_groups=1) == []
    assert graph_lint.audit_collective_schedule(
        stats(2 * expect, expect // 2, 64, agn=5, rsn=1), "zero3-manual",
        expect, expect_groups=2)
    # the gspmd tier with an all-reduce the plan owes by design (ruled
    # and indivisible params on an in-process mesh): the port's rule
    # subtracts it before the half-expected bound, and owes a
    # reduce-scatter on every platform; the JAX rule (gpu: bound and
    # reduce-scatter owed; cpu: neither) departs exactly there
    owed = 3 * expect // 4
    for st, platform, port_clean, jax_clean in (
            (stats(2 * expect, expect // 2, 64), "gpu", True, True),
            (stats(2 * expect, expect // 2, owed + 64), "gpu", True, False),
            (stats(2 * expect, expect // 2, owed + expect // 2), "gpu",
             False, False),
            (stats(expect // 4, expect // 2, owed), "gpu", False, False),
            (stats(2 * expect, 0, owed, rsn=0), "cpu", False, True)):
        got = graph_lint.audit_collective_schedule(
            st, "zero3-gspmd", expect, platform=platform,
            allreduce_bytes=owed)
        want = jlint.audit_collective_schedule(st, "zero3-gspmd", expect,
                                               platform=platform)
        assert (not got, not want) == (port_clean, jax_clean), \
            (st, platform, got, want)
        if platform == "gpu":
            # with nothing owed the two rules agree
            plain = graph_lint.audit_collective_schedule(
                st, "zero3-gspmd", expect, platform=platform)
            assert (not plain) == jax_clean, (st, plain, want)


# ---------------------------------------------------------------------------
# MXTPU_ANALYZE at the first step
# ---------------------------------------------------------------------------

def _leaky(x):
    return x * (x.sum().item() > -1e30)


def test_env_analyze_strict_refuses_and_stays_refused(monkeypatch):
    monkeypatch.setenv("MXTPU_ANALYZE", "strict")
    tr = _mlp(input_transforms={"data": _leaky})
    before = {k: v.clone() for k, v in tr.params.items()}
    for _ in range(2):
        with pytest.raises(MXNetError, match="graph-callback"):
            tr.step(*t_fix.standard_mlp_batch())
    assert tr._num_update == 0
    for k, v in tr.params.items():
        assert torch.equal(v, before[k]), k


def test_env_analyze_strict_covers_new_signatures(monkeypatch):
    monkeypatch.setenv("MXTPU_ANALYZE", "strict")

    def leaky_half(x):
        if x.shape[0] == 32:
            return _leaky(x)
        return x

    tr = _mlp(input_transforms={"data": leaky_half})
    X, y = t_fix.standard_mlp_batch()
    tr.step(X, y)
    with pytest.raises(MXNetError, match="graph-callback"):
        tr.step(X[:32], y[:32])


def test_env_analyze_strict_trains_a_clean_step(monkeypatch):
    """A clean step passes the strict gate and trains exactly as an
    ungated step: the analysis run left no trace in the carries."""
    batch = t_fix.standard_mlp_batch()
    monkeypatch.setenv("MXTPU_ANALYZE", "0")
    ref = _mlp()
    want = ref.step(*batch)[0]
    monkeypatch.setenv("MXTPU_ANALYZE", "strict")
    tr = _mlp()
    out = tr.step(*batch)[0]
    assert tr._analyzed_keys and not ref._analyzed_keys
    assert torch.equal(out, want)
    for k in tr.params:
        assert torch.equal(tr.params[k], ref.params[k]), k


def test_env_analyze_warn_mode_still_trains(monkeypatch, caplog):
    monkeypatch.setenv("MXTPU_ANALYZE", "1")
    tr = _mlp(input_transforms={"data": _leaky})
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.parallel.trainer"):
        outs = tr.step(*t_fix.standard_mlp_batch())
    assert tuple(outs[0].shape) == (64, 10)
    assert tr._num_update == 1
    assert any("MXTPU_ANALYZE" in r.message and "graph-callback" in r.message
               for r in caplog.records)


# ---------------------------------------------------------------------------
# the serving pool
# ---------------------------------------------------------------------------

def _pool_model(sym, shapes, dtype):
    arg_shapes, _, aux_shapes = sym.infer_shape(
        **{k: (1,) + v for k, v in shapes.items()})
    rs = np.random.RandomState(3)
    args = {n: (0.1 * rs.standard_normal(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes and not n.endswith("label")}
    aux = {n: (np.ones(s, np.float32) if n.endswith("var")
               else np.zeros(s, np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    pool = tmx.serving.ModelPool(ctx=CPU, dtype=dtype)
    pool.add("m", sym, args, aux, sample_shapes=shapes)
    return pool.get("m")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_pooled_model_analyze_clean(model, dtype):
    if model == "mlp":
        sym, shapes = t_fix.standard_mlp_sym(), {"data": (32,)}
    else:
        sym = tmx.models.get_symbol("resnet", num_layers=8, num_classes=4,
                                    image_shape=(3, 8, 8))
        shapes = {"data": (3, 8, 8)}
    entry = _pool_model(sym, shapes, dtype)
    rep = entry.analyze(bucket=4)
    assert rep.ok, rep.format_text()
    assert rep.stats["host_syncs"] == 0
    assert rep.stats["dispatched_ops"] > 0


def test_pool_strict_gate_serves_clean_and_refuses_sticky(monkeypatch):
    monkeypatch.setenv("MXTPU_ANALYZE", "strict")
    entry = _pool_model(t_fix.standard_mlp_sym(), {"data": (32,)},
                        "float32")
    x = np.zeros((2, 32), "f")
    assert entry.forward({"data": x})[0].shape == (2, 10)
    assert (("data", (2, 32)),) in entry._analyzed

    def seeded(bucket=1):
        rep = tmx.analysis.Report()
        rep.add("graph-callback", "seeded")
        return rep

    entry.analyze = seeded
    x4 = np.zeros((4, 32), "f")
    for _ in range(2):
        with pytest.raises(MXNetError, match="strict"):
            entry.forward({"data": x4})
    # the clean signature keeps serving
    assert entry.forward({"data": x})[0].shape == (2, 10)


# ---------------------------------------------------------------------------
# carries in place: same storage, same values
# ---------------------------------------------------------------------------

def _resnet_trainers(cls, steps, metric=False):
    """The ResNet-8 of ``tests/test_torch_trainer.py`` from its seeded
    weights, ``steps`` steps on its seeded batches."""
    from test_torch_trainer import (BATCH, IMAGE, SGD, _batches, _symbol,
                                    _weights)
    args, aux = _weights()
    tr = (cls or tmx.parallel.SPMDTrainer)(_symbol(tmx), SGD[0],
                                           dict(SGD[1]), ctx=CPU)
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    tr.init_params(None, arg_params=args, aux_params=aux)
    if metric:
        tr.install_metric(tmx.metric.Accuracy().graph_update(
            ["softmax_label"]), flush_interval=100)
    outs = [tr.step(x, y)[0].clone() for x, y in _batches(steps)]
    return tr, outs


def _flat(tr):
    return graph_lint._flatten(tr._carries())


def test_carries_keep_storage_and_values_bit_equal():
    tr, _ = _resnet_trainers(None, 1, metric=True)
    ptrs = [(p, t.data_ptr()) for p, t in _flat(tr)]
    assert any("guard" in p for p, _ in ptrs)
    assert any("metric" in p for p, _ in ptrs)
    assert any("moving_var" in p for p, _ in ptrs)
    assert any("opt_state" in p for p, _ in ptrs)
    from test_torch_trainer import _batches
    for x, y in _batches(3, seed=52):
        tr.step(x, y)
    assert [(p, t.data_ptr()) for p, t in _flat(tr)] == ptrs

    a, outs_a = _resnet_trainers(None, 4, metric=True)
    b, outs_b = _resnet_trainers(_Rebound, 4, metric=True)
    for oa, ob in zip(outs_a, outs_b):
        assert torch.equal(oa, ob)
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.fetch_metric() == b.fetch_metric()


def test_in_place_step_matches_jax_trainer():
    from test_torch_trainer import _assert_params_close, _run_both
    (j, t), outs = _run_both(3)
    for jo, to in outs:
        np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)
    _assert_params_close(j, t)


def test_carries_in_place_with_the_abort_off():
    """``max_consecutive_bad_steps=0`` turns the divergence abort off: the
    trips counter passes through, and the guard counters still keep
    their storage and count a skipped step."""
    tr = t_fix.standard_mlp_trainer(ctx=CPU, max_consecutive_bad_steps=0)
    x, y = t_fix.standard_mlp_batch()
    tr.step(x, y)
    acc = tr._guard_acc
    ptrs = [(p, t.data_ptr()) for p, t in _flat(tr)]
    tr.step(np.full_like(x, np.nan), y)
    assert tr.skipped_steps == 1 and tr.consecutive_bad_steps == 1
    tr.step(x, y)
    tr.flush_step_guard()
    assert tr.skipped_steps == 1 and tr.consecutive_bad_steps == 0
    assert tr._guard_acc is acc
    assert acc.tolist() == [1, 0, 0]
    assert [(p, t.data_ptr()) for p, t in _flat(tr)] == ptrs
    assert tr._num_update == 2


# ---------------------------------------------------------------------------
# data parallel: the zero3 schedule proof across two ranks
# ---------------------------------------------------------------------------

_DP = {}


@pytest.fixture(scope="module")
def dp_reports(tmp_path_factory):
    if "r" not in _DP:
        sys.path.insert(0, os.path.join(REPO, "tests"))
        from test_torch_parallel import launch_workers
        ranks = launch_workers(
            os.path.join(REPO, "tests", "test_torch_zero3.py"), 2,
            tmp_path_factory.mktemp("analysis_dp"), extra=["analysis"])
        _DP["r"] = [{k: json.loads(str(v)) for k, v in r.items()}
                    for r in ranks]
    return _DP["r"]


def test_zero3_schedule_is_clean(dp_reports):
    for r in dp_reports:
        rep = r["zero3"]
        assert rep["ok"], rep["text"]
        assert rep["unchanged"]
        c = rep["collectives"]
        assert c["reduce-scatter"]["count"] == rep["groups"]
        assert rep["groups"] <= c["all-gather"]["count"] <= 2 * rep["groups"]
        # forward gather and backward re-gather of every sharded byte
        assert c["all-gather"]["bytes"] == 2 * rep["expect"]
        assert c["all-reduce"]["bytes"] < 0.5 * rep["expect"]


def test_zero3_param_left_out_of_sharding_is_flagged(dp_reports):
    for r in dp_reports:
        rep = r["left_out"]
        assert not rep["ok"]
        assert rep["rules"] == ["graph-collective-schedule"], rep["text"]


def test_allreduce_step_shows_no_allgather(dp_reports):
    for r in dp_reports:
        rep = r["allreduce"]
        assert rep["ok"], rep["text"]
        c = rep["collectives"]
        assert c["all-gather"]["count"] == 0
        assert c["reduce-scatter"]["count"] == 0
        assert c["all-reduce"]["count"] >= 1
        zero = r["zero"]
        assert zero["ok"], zero["text"]
        assert zero["collectives"]["all-gather"]["count"] >= 1
        assert zero["collectives"]["reduce-scatter"]["count"] >= 1
