"""The compiled forward of the port (``serving/aot.py``, the pool's AOT
store, the daemon's ``--export-aot``, the fleet's warm store and
``predict.export_compiled``/``load_compiled``) on the CPU, at small
sizes: an MLP and a conv + BatchNorm + relu net with one ``bn_fold``
site (conv -> BN -> relu) and one ``bn_act`` site (pool -> BN -> relu).

- the store's programs loaded in a fresh pool answer bit for bit as the
  port's ``Predictor`` at every bucket; a non-bucket shape falls back;
- they agree with the JAX package's in-process ``aot.build_forward``
  program and its ``Predictor`` within rtol 1e-5 / atol 1e-6 (not a
  JAX store loaded from disk: XLA:CPU can refuse a stored executable on
  a machine-feature mismatch);
- the ``.exec`` files hold no weights, and a ``swap_params`` reaches the
  loaded programs;
- the exported graph calls ``torch.ops.mxt.bn_act_fwd`` once a
  ``fused_bn_act`` site;
- int8 pools refuse, bfloat16 pools match their ``Predictor`` path;
- ``Custom`` ops refuse export and nothing is written (rtc graphs
  export: ``tests/test_torch_aot_kernels.py``);
- the daemon and the fleet warm from the store, with JAX unimportable;
- the portable archive agrees with the JAX package's ``export_compiled``
  and runs in a process where ``mxnet_tpu_torch`` cannot be imported.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import ModelPool, ServeClient
from mxnet_tpu_torch.serving import aot

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "serving", "serve_main.py")
FLEET_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "fleet", "fleet_main.py")
CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)
BUCKETS = [1, 2, 4]


def mlp_sym(mx, nh=256):
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=nh, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def conv_sym(mx):
    """conv -> BN -> relu (a bn_fold site), pool -> BN -> relu (a bn_act
    site), then a classifier."""
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3),
                                 pad=(1, 1), name="c1")
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                             pool_type="max")
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn2")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.Flatten(net)
        net = mx.sym.FullyConnected(net, num_hidden=6, name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")


MODELS = {"mlp": (mlp_sym, (512,)), "conv": (conv_sym, (3, 8, 8))}


def np_params(sym, sample, seed=0):
    """Random args and BN moving stats (mean near 0, var near 1)."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + sample)
    args = {n: rs.uniform(-0.3, 0.3, s).astype("f")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: (rs.uniform(0.5, 1.5, s) if n.endswith("var")
                else rs.uniform(-0.2, 0.2, s)).astype("f")
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def t_nd(d):
    return {k: tmx.nd.array(v, ctx=CPU) for k, v in d.items()}


def j_nd(d):
    return {k: jmx.nd.array(v) for k, v in d.items()}


def model(kind, seed=0):
    """(port symbol, numpy args, numpy auxs, sample shape) — the symbol
    built by the JAX package and carried over as JSON."""
    fn, sample = MODELS[kind]
    jsym = fn(jmx)
    args, auxs = np_params(jsym, sample, seed)
    return tmx.sym.load_json(jsym.tojson()), args, auxs, sample


def pool_of(kind, dtype="float32", seed=0):
    sym, args, auxs, sample = model(kind, seed)
    pool = ModelPool(ctx=CPU, dtype=dtype)
    pool.add("m", sym, t_nd(args), t_nd(auxs),
             sample_shapes={"data": sample})
    return pool, sym, args, auxs, sample


def predictor(sym, args, auxs, batch, sample):
    blob = {"arg:%s" % k: tmx.nd.array(v, ctx=CPU) for k, v in args.items()}
    blob.update({"aux:%s" % k: tmx.nd.array(v, ctx=CPU)
                 for k, v in auxs.items()})
    return tmx.predict.Predictor(sym, blob, {"data": (batch,) + sample},
                                 ctx=CPU)


def batch_of(b, sample, seed):
    return np.random.RandomState(seed).rand(b, *sample).astype("f")


def exported(kind, tmp_path, dtype="float32", seed=0):
    """A pool whose store holds BUCKETS, and a fresh pool that loaded it."""
    pool, sym, args, auxs, sample = pool_of(kind, dtype, seed)
    store = str(tmp_path / "aot")
    pool.get("m").export_aot(BUCKETS, store)
    fresh, _, _, _, _ = pool_of(kind, dtype, seed)
    assert fresh.get("m").load_aot(store, BUCKETS) == len(BUCKETS)
    return fresh.get("m"), sym, args, auxs, sample, store


# ---------------------------------------------------------------------------
# (a) store parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_store_programs_bit_equal_to_predictor(tmp_path, kind):
    entry, sym, args, auxs, sample, store = exported(kind, tmp_path)
    assert sorted(entry._aot) == BUCKETS
    for b in BUCKETS:
        x = batch_of(b, sample, b)
        got = entry.forward({"data": x})[0]
        ref = predictor(sym, args, auxs, b, sample).forward(
            data=x).get_output(0)
        assert got.shape == ref.shape and np.array_equal(got, ref), b
    # 3 rows is no bucket: the Predictor path, shape kept
    x = batch_of(3, sample, 3)
    got = entry.forward({"data": x})[0]
    ref = predictor(sym, args, auxs, 3, sample).forward(data=x).get_output(0)
    assert got.shape == (3, ref.shape[1]) and np.array_equal(got, ref)
    assert entry._pred is not None
    doc = json.load(open(os.path.join(store, "m.json")))
    assert doc["buckets"] == BUCKETS and doc["runtime"] == aot.RUNTIME
    assert doc["platform"] == "cpu"
    tree = json.load(open(os.path.join(store, "m-b2.tree")))
    assert tree["inputs"] == ["data"] and tree["params"] == sorted(args)
    # one batch-dynamic program, written for each bucket, loaded once
    assert tree["dynamic_batch"] is True
    blobs = {open(os.path.join(store, "m-b%d.exec" % b), "rb").read()
             for b in BUCKETS}
    assert len(blobs) == 1 and len({id(f) for f in entry._aot.values()}) == 1


def test_plan_with_a_fixed_batch_gets_one_program_a_bucket(tmp_path):
    """A graph that fixes the batch (``Reshape`` to (2, -1)) cannot be
    batch-dynamic: the export falls back to one program a bucket."""
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = tmx.sym.Reshape(data, shape=(2, -1))
        net = tmx.sym.FullyConnected(net, num_hidden=4, name="fc")
        sym = tmx.sym.SoftmaxOutput(net, name="softmax")
    rs = np.random.RandomState(0)
    args = {"fc_weight": rs.rand(4, 6).astype("f"),
            "fc_bias": rs.rand(4).astype("f")}
    pool = ModelPool(ctx=CPU)
    entry = pool.add("m", sym, t_nd(args), {}, sample_shapes={"data": (6,)})
    store = str(tmp_path / "aot")
    entry.export_aot([2], store)
    tree = json.load(open(os.path.join(store, "m-b2.tree")))
    assert tree["dynamic_batch"] is False
    fresh = ModelPool(ctx=CPU).add("m", sym, t_nd(args), {},
                                   sample_shapes={"data": (6,)})
    assert fresh.load_aot(store) == 1
    x = rs.rand(2, 6).astype("f")
    ref = tmx.predict.Predictor(sym, {"arg:%s" % k: v for k, v in
                                      t_nd(args).items()},
                                {"data": (2, 6)}, ctx=CPU).forward(
        data=x).get_output(0)
    assert np.array_equal(fresh.forward({"data": x})[0], ref)


# ---------------------------------------------------------------------------
# (b) against the JAX package's in-process program and Predictor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_store_programs_match_jax_build_forward(tmp_path, kind):
    from mxnet_tpu.serving import aot as jaot
    entry, _, args, auxs, sample, _ = exported(kind, tmp_path)
    jsym = MODELS[kind][0](jmx)
    for b in (1, 4):
        x = batch_of(b, sample, 10 + b)
        compiled, (pv, av) = jaot.build_forward(
            jsym, j_nd(args), j_nd(auxs), {"data": sample}, b)
        want = np.asarray(compiled(pv, av, x)[0])
        got = entry.forward({"data": x})[0]
        np.testing.assert_allclose(got, want, **TOL)
        jblob = {"arg:%s" % k: v for k, v in j_nd(args).items()}
        jblob.update({"aux:%s" % k: v for k, v in j_nd(auxs).items()})
        jpred = jmx.predict.Predictor(jsym, jblob, {"data": (b,) + sample})
        jpred.forward(data=x)
        np.testing.assert_allclose(got, np.asarray(jpred.get_output(0)),
                                   **TOL)


# ---------------------------------------------------------------------------
# (c) no weights in the artifact; swaps reach the loaded programs
# ---------------------------------------------------------------------------

def test_exec_is_weight_free_and_swaps_reach_programs(tmp_path):
    pool0, sym, _, _, sample = pool_of("mlp", seed=0)
    pool1, _, args1, auxs1, _ = pool_of("mlp", seed=1)
    pool0.get("m").export_aot([2], str(tmp_path / "s0"))
    pool1.get("m").export_aot([2], str(tmp_path / "s1"))
    b0 = open(str(tmp_path / "s0" / "m-b2.exec"), "rb").read()
    b1 = open(str(tmp_path / "s1" / "m-b2.exec"), "rb").read()
    assert b0 == b1
    param_bytes = sum(v.nbytes for v in args1.values())
    assert len(b0) < 0.1 * param_bytes, (len(b0), param_bytes)
    fresh, _, _, _, _ = pool_of("mlp", seed=0)
    entry = fresh.get("m")
    assert entry.load_aot(str(tmp_path / "s0")) == 1
    x = batch_of(2, sample, 7)
    entry.swap_params(t_nd(args1), t_nd(auxs1))
    assert 2 in entry._aot and entry._pred is None
    got = entry.forward({"data": x})[0]
    ref = predictor(sym, args1, auxs1, 2, sample).forward(
        data=x).get_output(0)
    assert np.array_equal(got, ref)


# ---------------------------------------------------------------------------
# (d) the kernel's op is in the graph, once a fused_bn_act site
# ---------------------------------------------------------------------------

def test_graph_holds_bn_act_op_once_a_site():
    from mxnet_tpu_torch import mxfuse
    from mxnet_tpu_torch.executor import _build_eval
    sym, args, auxs, sample = model("conv")
    program, _, _ = aot.build_forward(sym, t_nd(args), t_nd(auxs),
                                      {"data": sample}, 2, CPU.torch_device)
    calls = [n for n in program.graph.nodes
             if n.op == "call_function"
             and n.target is torch.ops.mxt.bn_act_fwd.default]
    eval_fn = _build_eval(sym)
    report = mxfuse.plan_report(eval_fn.plan, eval_fn.out_refs,
                                mxfuse.output_shapes(sym, data=(2,) + sample))
    assert report["bn_act"] == 1 and report["bn_fold"] == 1
    assert len(calls) == report["bn_act_calls_infer"] == 1
    assert calls[0].args[3] == "relu"


# ---------------------------------------------------------------------------
# (e) pool dtypes
# ---------------------------------------------------------------------------

def test_int8_pool_refuses_export_and_load(tmp_path, caplog):
    pool, _, _, _, _ = pool_of("mlp", dtype="int8")
    store = str(tmp_path / "aot")
    with pytest.raises(MXNetError, match="int8"):
        pool.get("m").export_aot([1], store)
    assert not os.path.exists(store)
    fp, _, _, _, _ = pool_of("mlp")
    fp.get("m").export_aot([1], store)
    assert pool.get("m").load_aot(store, [1]) == 0
    assert not pool.get("m")._aot


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_bfloat16_pool_program_equals_its_predictor_path(tmp_path, kind):
    entry, _, _, _, sample, _ = exported(kind, tmp_path, dtype="bfloat16")
    plain, _, _, _, _ = pool_of(kind, dtype="bfloat16")
    for b in BUCKETS:
        x = batch_of(b, sample, 20 + b)
        got = entry.forward({"data": x})[0]
        ref = plain.get("m").forward({"data": x})[0]
        assert np.array_equal(got, ref), b
    assert plain.get("m")._lowp is not None and not plain.get("m")._aot


# ---------------------------------------------------------------------------
# (f) unexportable ops: Custom (a host callback, as in the JAX store)
# ---------------------------------------------------------------------------

def _custom_sym():
    if "aot_test_double" not in tmx.operator._PROP_REGISTRY:
        @tmx.operator.register("aot_test_double")
        class DoubleProp(tmx.operator.CustomOpProp):
            def list_arguments(self):
                return ["data"]

            def infer_shape(self, in_shape):
                return in_shape, [in_shape[0]], []

            def create_operator(self, ctx, shapes, dtypes):
                return Double()

        class Double(tmx.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.assign(out_data[0], req[0], in_data[0] * 2)

    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=4, name="fc")
        net = tmx.sym.Custom(net, op_type="aot_test_double", name="dbl")
        return tmx.sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("which", ["custom"])
def test_unexportable_ops_refuse_and_write_nothing(tmp_path, which):
    sym = _custom_sym()
    want = "dbl (Custom)"
    rs = np.random.RandomState(0)
    args = {"fc_weight": rs.rand(4, 5).astype("f"),
            "fc_bias": np.zeros(4, "f")}
    pool = ModelPool(ctx=CPU)
    entry = pool.add("m", sym, t_nd(args), {}, sample_shapes={"data": (5,)})
    assert entry.forward({"data": rs.rand(2, 5).astype("f")})[0].shape == \
        (2, 4)
    store = str(tmp_path / "aot")
    with pytest.raises(MXNetError, match=want.replace("(", r"\(")
                       .replace(")", r"\)")):
        entry.export_aot([1], store)
    assert not os.path.exists(store)
    fname = str(tmp_path / "portable.pt2")
    with pytest.raises(MXNetError, match="cannot be exported"):
        tmx.predict.export_compiled(sym, t_nd(args), {}, {"data": (2, 5)},
                                    fname=fname)
    assert not os.path.exists(fname)


# ---------------------------------------------------------------------------
# (g) the daemon end to end
# ---------------------------------------------------------------------------

#: runs a script with JAX and the JAX package unimportable
WRAPPER = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["mxnet_tpu"] = None
sys.argv = [%(main)r] + sys.argv[1:]
runpy.run_path(%(main)r, run_name="__main__")
"""


def _save_conv(tmp_path):
    sym, args, auxs, sample = model("conv", seed=3)
    prefix = str(tmp_path / "net")
    tmx.model.save_checkpoint(prefix, 1, sym, t_nd(args), t_nd(auxs),
                              blocking=True)
    return sym, args, auxs, sample, prefix


def _daemon_env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for k in ("MXTPU_COMPILE_CACHE", "MXTPU_FAULTS", "MXTPU_RESUME"):
        env.pop(k, None)
    env.update(extra)
    return env


def _serve_answers(tmp_path, wrapper, base, env, name, xs):
    """Start a daemon, ask each batch of ``xs`` at once, drain it;
    returns (answers, stderr)."""
    port_file = str(tmp_path / ("%s.port" % name))
    err_path = str(tmp_path / ("%s.err" % name))
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, wrapper, "--port-file", port_file] + base,
            env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(port_file):
            assert proc.poll() is None, open(err_path).read()[-3000:]
            assert time.monotonic() < deadline, "daemon never listened"
            time.sleep(0.05)
        host, port = open(port_file).read().split(":")
        cli = ServeClient(host, int(port), timeout=60)
        outs = []
        for x in xs:
            st, payload = cli.predict("net", x)
            assert st == 200, payload
            outs.append(np.asarray(payload["outputs"][0], "f"))
        cli.close()
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return outs, open(err_path).read()


def test_daemon_exports_then_warms_from_the_store(tmp_path):
    _, _, _, sample, prefix = _save_conv(tmp_path)
    wrapper = str(tmp_path / "w.py")
    with open(wrapper, "w") as f:
        f.write(WRAPPER % {"main": SERVE_MAIN})
    base = ["--model", "net=%s:1" % prefix, "--input-shape",
            "data=%s" % ",".join(map(str, sample)), "--port", "0",
            "--buckets", "1,2", "--context", "cpu", "--max-wait-ms", "1"]
    cache = str(tmp_path / "cache")
    res = subprocess.run([sys.executable, wrapper] + base
                         + ["--warmup-only", "--export-aot"],
                         env=_daemon_env(MXTPU_COMPILE_CACHE=cache),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "exported AOT programs for 'net' over buckets [1, 2]" in \
        res.stderr and "warmup_s=" in res.stderr
    assert sorted(os.listdir(os.path.join(cache, "aot"))) == [
        "net-b1.exec", "net-b1.tree", "net-b2.exec", "net-b2.tree",
        "net.json"]
    xs = [batch_of(1, sample, 5)[0]]
    warm, err = _serve_answers(tmp_path, wrapper, base + ["--warmup"],
                               _daemon_env(MXTPU_COMPILE_CACHE=cache),
                               "warm", xs)
    assert "warmed 'net' from the AOT store (2/2 buckets)" in err, err
    assert "warmed 'net' over buckets" not in err and "warmup_s=" in err
    cold, err = _serve_answers(tmp_path, wrapper, base + ["--warmup"],
                               _daemon_env(), "cold", xs)
    assert "warmed 'net' over buckets [1, 2]" in err
    assert all(np.array_equal(a, b) for a, b in zip(warm, cold))


# ---------------------------------------------------------------------------
# (h) the fleet's warm store on the CPU
# ---------------------------------------------------------------------------

def _poisoned(tmp_path):
    poison = tmp_path / "poison" / "jax"
    poison.mkdir(parents=True)
    (poison / "__init__.py").write_text(
        "raise ImportError('a fleet process imported jax')\n")
    env = _daemon_env()
    env["PYTHONPATH"] = str(tmp_path / "poison")
    return env


def test_build_warm_store_writes_store_and_marker(tmp_path):
    from mxnet_tpu_torch import fleet
    _, _, _, sample, prefix = _save_conv(tmp_path)
    man = fleet.FleetManifest.from_flags(
        ["net=%s:1" % prefix], ["net:data=%s" % ",".join(map(str, sample))],
        replicas=2, buckets="1,2", device_sets="cpu")
    store = str(tmp_path / "store")
    doc = fleet.build_warm_store(man, store, extra_env=_poisoned(tmp_path))
    assert doc["models"] == ["net"] and doc["warmup_s"] > 0
    assert fleet.warm_store_manifest(store) == doc
    assert aot.AotStore(os.path.join(store, "aot")).buckets("net") == [1, 2]
    again = fleet.build_warm_store(man, store)      # idempotent: no run
    assert again == doc
    # a failed build raises with the daemon's stderr and keeps no marker
    bad = fleet.FleetManifest.from_flags(
        ["net=%s:7" % prefix], ["net:data=%s" % ",".join(map(str, sample))],
        replicas=1, buckets="1", device_sets="cpu")
    with pytest.raises(MXNetError, match="warm-store build failed"):
        fleet.build_warm_store(bad, str(tmp_path / "bad"), force=True)
    assert fleet.warm_store_manifest(str(tmp_path / "bad")) is None


def test_fleet_main_warmup_and_serve_from_the_store(tmp_path):
    """``warmup`` builds a store (and finds it built the second time);
    ``serve --warm-store`` on an absent store builds it first, and both
    replicas warm from it."""
    sym, args, auxs, sample, prefix = _save_conv(tmp_path)
    env = _poisoned(tmp_path)
    flags = ["--model", "net=%s:1" % prefix, "--input-shape",
             "net:data=%s" % ",".join(map(str, sample)), "--buckets", "1,2",
             "--device-sets", "cpu"]
    store = str(tmp_path / "store")
    for run in ("build", "again"):
        res = subprocess.run([sys.executable, FLEET_MAIN, "warmup"] + flags
                             + ["--warm-store", store], env=env,
                             capture_output=True, text=True, timeout=180)
        assert res.returncode == 0, res.stderr[-3000:]
        assert json.loads(res.stdout)["models"] == ["net"]
        assert ("already built" in res.stderr) == (run == "again")
    port_file = str(tmp_path / "fleet.port")
    run_dir = str(tmp_path / "run")
    err_path = str(tmp_path / "fleet.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, FLEET_MAIN, "serve"] + flags
            + ["--replicas", "2", "--warm-store", str(tmp_path / "store2"),
               "--port", "0", "--port-file", port_file, "--run-dir",
               run_dir],
            env=dict(env, MXTPU_SERVE_MAX_WAIT_MS="1"),
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + 150
        while not os.path.exists(port_file):
            assert proc.poll() is None, open(err_path).read()[-3000:]
            assert time.monotonic() < deadline, "the fleet never listened"
            time.sleep(0.1)
        host, port = open(port_file).read().split(":")
        cli = ServeClient(host, int(port), timeout=60)
        x = batch_of(1, sample, 9)[0]
        st, payload = cli.predict("net", x)
        cli.close()
        assert st == 200
        ref = predictor(sym, args, auxs, 1, sample).forward(
            data=x[None]).get_output(0)[0]
        np.testing.assert_allclose(np.asarray(payload["outputs"][0], "f"),
                                   ref, **TOL)
        proc.terminate()
        assert proc.wait(timeout=90) == 0, open(err_path).read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "building warm store" in open(err_path).read()
    assert os.path.exists(str(tmp_path / "store2" / "FLEET_WARM.json"))
    for rid in (0, 1):
        log = open(os.path.join(run_dir, "replica-%d.log" % rid)).read()
        assert "warmed 'net' from the AOT store (2/2 buckets)" in log, log
        assert "warmed 'net' over buckets" not in log


# ---------------------------------------------------------------------------
# (i) the portable archive
# ---------------------------------------------------------------------------

def _jax_export(jsym, args, auxs, shapes):
    blob = jmx.predict.export_compiled(jsym, j_nd(args), j_nd(auxs), shapes,
                                       platforms=("cpu",))
    return jmx.predict.load_compiled(blob)


@pytest.mark.parametrize("kind,aux", [("mlp", "no_aux"),
                                      ("conv", "with_aux"),
                                      ("conv", "zero_filled_aux")])
def test_export_compiled_matches_jax(tmp_path, kind, aux):
    sym, args, auxs, sample = model(kind)
    if aux == "zero_filled_aux":
        auxs = {}
    shapes = {"data": (3,) + sample}
    fname = str(tmp_path / "model.pt2")
    blob = tmx.predict.export_compiled(sym, t_nd(args), t_nd(auxs), shapes,
                                       fname=fname)
    assert open(fname, "rb").read() == blob
    fn = tmx.predict.load_compiled(fname)
    x = batch_of(3, sample, 31)
    got = fn(x)[0].numpy()
    want = np.asarray(_jax_export(MODELS[kind][0](jmx), args, auxs,
                                  shapes)(x)[0])
    np.testing.assert_allclose(got, want, **TOL)
    assert fn.info["inputs"] == ["data"]
    graph = torch.export.load(fname).graph
    assert not [n for n in graph.nodes if "mxt" in str(n.target)
                or "device" in n.kwargs]


def test_export_compiled_builds_factories_from_the_input():
    """A node without tensor inputs (``ones``) is a factory call in the
    trace; the archive rebuilds it from the first input (``new_ones``),
    so it names no device, and answers as the ``Predictor``."""
    import io
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = data + tmx.sym.ones(shape=(2, 5))
        net = tmx.sym.FullyConnected(net, num_hidden=4, name="fc")
        sym = tmx.sym.SoftmaxOutput(net, name="softmax")
    rs = np.random.RandomState(0)
    args = {"fc_weight": rs.rand(4, 5).astype("f"),
            "fc_bias": rs.rand(4).astype("f")}
    blob = tmx.predict.export_compiled(sym, t_nd(args), {}, {"data": (2, 5)})
    graph = torch.export.load(io.BytesIO(blob)).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert "aten.new_ones.default" in targets
    assert not [n for n in graph.nodes if "device" in n.kwargs]
    x = rs.rand(2, 5).astype("f")
    ref = tmx.predict.Predictor(sym, {"arg:%s" % k: v for k, v in
                                      t_nd(args).items()},
                                {"data": (2, 5)}, ctx=CPU).forward(
        data=x).get_output(0)
    assert np.array_equal(tmx.predict.load_compiled(blob)(x)[0].numpy(), ref)


PORTABLE_CHILD = r"""
import sys
for name in ("mxnet_tpu_torch", "mxnet_tpu", "jax"):
    sys.modules[name] = None
import numpy as np, torch
try:
    import mxnet_tpu_torch
    raise SystemExit("mxnet_tpu_torch imported")
except ImportError:
    pass
m = torch.export.load(sys.argv[1]).module().to("cpu")
out = m(torch.from_numpy(np.load(sys.argv[2])))[0]
np.save(sys.argv[3], out.numpy())
"""


def test_portable_archive_runs_without_the_port(tmp_path):
    sym, args, auxs, sample = model("conv", seed=5)
    shapes = {"data": (2,) + sample}
    fname = str(tmp_path / "model.pt2")
    tmx.predict.export_compiled(sym, t_nd(args), t_nd(auxs), shapes,
                                fname=fname)
    x = batch_of(2, sample, 3)
    np.save(str(tmp_path / "x.npy"), x)
    child = tmp_path / "child.py"
    child.write_text(PORTABLE_CHILD)
    res = subprocess.run([sys.executable, str(child), fname,
                          str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = predictor(sym, args, auxs, 2, sample).forward(data=x).get_output(0)
    np.testing.assert_allclose(np.load(str(tmp_path / "y.npy")), ref, **TOL)
