"""The LSTM, flash-attention and rtc forward kernels as registered ops
(``torch.ops.mxt.{lstm_seq_fwd, lstm_cell_fwd, flash_attention_fwd,
rtc_elementwise}``), and the AOT store over the graphs that reach them,
on the CPU at small sizes:

- (a) each op is bit-equal to its plain version on CPU tensors and
  gives the stated shapes and dtypes under ``FakeTensorMode``;
- (b) a 2-layer LM (vocab 50, width 8, seq 8; ``data`` and
  ``softmax_label`` declared): each bucket's program holds 2
  ``lstm_seq_fwd`` calls (4 with a bidirectional ``RNN``), a fresh pool
  loads 3 of 3 buckets, every bucket answers bit-equal to the port's
  ``Predictor`` and within rtol 1e-5 / atol 1e-6 of the JAX package's
  in-process ``aot.build_forward`` program;
- (c) the unrolled cells (``rnn.LSTMCell`` with fusion on: the
  ``_FusedLSTMCell`` op) hold 2·T ``lstm_cell_fwd`` calls and load
  bit-equal;
- (d) ``contrib.Attention`` above one flash block holds one
  ``flash_attention_fwd`` call, loads bit-equal and agrees with the JAX
  program;
- (e) the load check compares the validation outputs with the graph's
  shapes at the bucket: the LM's time-major (T·b, V) output loads, a
  program of the wrong shape is refused with a warning;
- (f) an rtc graph exports with ``rtc_elementwise`` and its body's key;
  a process that registered the same body loads it and answers
  bit-equal, one that did not loads nothing and warns naming the key;
- (g) the portable archive (``predict.export_compiled``) of these graphs
  holds no ``mxt`` op;
- (h) the daemon (``serve_main.py``, JAX unimportable) exports the LM's
  programs and a ``--warmup`` daemon answers ``/predict_seq`` through
  them bit-equal to the ``Predictor``; a fleet's replicas get both input
  shapes and ``MXTPU_SERVE_SEQ_BUCKETS``.
"""
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kernels import flash_attention as TFA
from mxnet_tpu_torch.kernels import lstm_cell as TLC
from mxnet_tpu_torch.ops.registry import OP_REGISTRY
from mxnet_tpu_torch.serving import ModelPool, ServeClient, aot

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)
BUCKETS = [1, 2, 4]
VOCAB, WIDTH, SEQ, LAYERS = 50, 8, 8, 2
LM_SHAPES = {"data": (SEQ,), "softmax_label": (SEQ,)}
#: the attention graph: heads, model width, sequence; the flash block
#: below the sequence, so the flash route is taken
HEADS, DMODEL, ATT_T, FLASH_BLOCK = 2, 16, 16, "8"
ATT_SHAPES = {n: (ATT_T, DMODEL) for n in ("key", "query", "value")}

AFFINE = "out = 3.0f * in - 1.0f;"
TWICE = "out = 2.0f * in;"


def _affine(x):
    return (3.0 * x.float() - 1.0).to(x.dtype)


RTC_AFFINE = tmx.rtc.elementwise_cuda_kernel(AFFINE, plain=_affine)


def t_nd(d):
    return {k: tmx.nd.array(v, ctx=CPU) for k, v in d.items()}


def j_nd(d):
    return {k: jmx.nd.array(v) for k, v in d.items()}


def mxt_calls(graph, name):
    op = getattr(torch.ops.mxt, name).default
    return sum(1 for n in graph.nodes
               if n.op == "call_function" and n.target is op)


def program_graph(store, model, bucket):
    with open(os.path.join(store, "%s-b%d.exec" % (model, bucket)),
              "rb") as f:
        return aot.load_program(f.read()).graph


def weights(sym, shapes, seed=0, skip=()):
    rs = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**{k: (1,) + s
                                          for k, s in shapes.items()})
    return {n: rs.uniform(-0.3, 0.3, s).astype("f")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes and n not in skip}


def pooled(sym, args, shapes, name="m"):
    return ModelPool(ctx=CPU).add(name, sym, t_nd(args), {},
                                  sample_shapes=shapes)


def predictor(sym, args, feed):
    blob = {"arg:%s" % k: v for k, v in t_nd(args).items()}
    return tmx.predict.Predictor(sym, blob, {k: v.shape
                                             for k, v in feed.items()},
                                 ctx=CPU).forward(**feed).get_output(0)


# ---------------------------------------------------------------------------
# (a) the ops
# ---------------------------------------------------------------------------

OPS = ("lstm_seq_fwd", "lstm_cell_fwd", "flash_attention_fwd",
       "rtc_elementwise")


def _op_case(name, dtype):
    """(op arguments, the plain version's outputs) on CPU tensors."""
    rs = np.random.RandomState(OPS.index(name))

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            rs.uniform(-scale, scale, shape).astype("f")).to(dtype)

    if name == "lstm_seq_fwd":
        args = (t(5, 3, 16, scale=2), t(16, 4, scale=0.5), t(3, 4),
                t(3, 4), "")
        out = TLC.lstm_seq_plain(*args[:4])
        return args, (out.hs, out.hT, out.cT)
    if name == "lstm_cell_fwd":
        args = (t(3, 16, scale=2), t(3, 4))
        return args, TLC.lstm_cell_plain(*args)
    if name == "flash_attention_fwd":
        q, k, v = t(2, 9, 2, 4), t(2, 9, 2, 4), t(2, 9, 2, 4)
        return (q, k, v, True, 0.5, 4), (TFA.flash_attention_plain(
            q, k, v, causal=True, scale=0.5, block_k=4),)
    x = t(3, 7, scale=3)
    return (x, RTC_AFFINE.key), (_affine(x),)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", OPS)
def test_op_equals_plain_on_cpu_and_fake_shapes(name, dtype):
    op = getattr(torch.ops.mxt, name)
    args, want = _op_case(name, dtype)
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(f.shape), f.dtype) for f in fake] == \
        [(tuple(w.shape), w.dtype) for w in want]


def test_rtc_op_raises_naming_an_unregistered_key():
    key = tmx.rtc.body_key("out = in * 7.5f;")
    assert key not in tmx.rtc.KERNELS
    with pytest.raises(tmx.MXNetError, match=key):
        torch.ops.mxt.rtc_elementwise(torch.ones(3), key)


# ---------------------------------------------------------------------------
# (b) the LM's store
# ---------------------------------------------------------------------------

def bi_lm_sym(mx):
    """The LM's graph with a bidirectional 2-layer ``RNN``."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data=data, input_dim=VOCAB, output_dim=WIDTH,
                             name="embed")
    tnc = mx.sym.SwapAxis(embed, dim1=0, dim2=1, name="tnc")
    rnn = mx.sym.RNN(data=tnc, parameters=mx.sym.Variable("lstm_parameters"),
                     state=mx.sym.Variable("lstm_init_h"),
                     state_cell=mx.sym.Variable("lstm_init_c"),
                     state_size=WIDTH, num_layers=LAYERS, mode="lstm",
                     bidirectional=True, name="lstm")
    hidden = mx.sym.Reshape(rnn, shape=(-1, 2 * WIDTH), name="reshape_h")
    pred = mx.sym.FullyConnected(data=hidden, num_hidden=VOCAB, name="pred")
    lab = mx.sym.Reshape(mx.sym.SwapAxis(label, dim1=0, dim2=1),
                         shape=(-1,), name="reshape_l")
    return mx.sym.SoftmaxOutput(data=pred, label=lab, name="softmax")


def lm(bidirectional=False, seed=0):
    """(port symbol, JAX symbol, numpy args): built by the JAX package
    and carried over as JSON; the init states are left to the fills."""
    with jmx.name.NameManager():
        jsym = bi_lm_sym(jmx) if bidirectional else \
            jmx.models.lstm_lm.lstm_lm_sym(SEQ, VOCAB, WIDTH, WIDTH,
                                           LAYERS)[0]
    args = weights(jsym, LM_SHAPES, seed, ("lstm_init_h", "lstm_init_c"))
    return tmx.sym.load_json(jsym.tojson()), jsym, args


def tokens(b, seed):
    rs = np.random.RandomState(seed)
    return {"data": rs.randint(0, VOCAB, (b, SEQ)).astype("f"),
            "softmax_label": np.zeros((b, SEQ), "f")}


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lm_store_loads_every_bucket_bit_equal(tmp_path, bidirectional):
    from mxnet_tpu.serving import aot as jaot
    sym, jsym, args = lm(bidirectional)
    store = str(tmp_path / "aot")
    pooled(sym, args, LM_SHAPES, "lm").export_aot(BUCKETS, store)
    for b in BUCKETS:
        assert mxt_calls(program_graph(store, "lm", b), "lstm_seq_fwd") == \
            (4 if bidirectional else 2)
        with open(os.path.join(store, "lm-b%d.tree" % b)) as f:
            tree = json.load(f)
        # the init-state fills carry the batch: one program a bucket
        assert tree["inputs"] == ["data", "softmax_label"]
        assert tree["dynamic_batch"] is False
    entry = pooled(sym, args, LM_SHAPES, "lm")
    assert entry.load_aot(store, BUCKETS) == len(BUCKETS)
    for b in BUCKETS:
        feed = tokens(b, 10 + b)
        got = entry.forward(feed)[0]
        assert got.shape == (SEQ * b, VOCAB)
        assert np.array_equal(got, predictor(sym, args, feed)), b
        compiled, (pv, av) = jaot.build_forward(jsym, j_nd(args), {},
                                                LM_SHAPES, b)
        want = np.asarray(compiled(pv, av, feed["data"],
                                   feed["softmax_label"])[0])
        np.testing.assert_allclose(got, want, **TOL)
    assert entry._pred is None      # every answer came from the programs


# ---------------------------------------------------------------------------
# (c) the unrolled cells
# ---------------------------------------------------------------------------

def cells_sym():
    """Embedding -> two ``rnn.LSTMCell`` unrolled over SEQ steps (the
    ``_FusedLSTMCell`` op a step and layer) -> FullyConnected ->
    SoftmaxOutput."""
    with tmx.name.NameManager():
        stack = tmx.rnn.SequentialRNNCell()
        for i in range(LAYERS):
            stack.add(tmx.rnn.LSTMCell(num_hidden=WIDTH,
                                       prefix="lstm_l%d_" % i))
        data = tmx.sym.Variable("data")
        embed = tmx.sym.Embedding(data=data, input_dim=VOCAB,
                                  output_dim=WIDTH, name="embed")
        outputs, _ = stack.unroll(SEQ, inputs=embed, merge_outputs=True)
        pred = tmx.sym.Reshape(outputs, shape=(-1, WIDTH))
        pred = tmx.sym.FullyConnected(data=pred, num_hidden=VOCAB,
                                      name="pred")
        label = tmx.sym.Reshape(tmx.sym.Variable("softmax_label"),
                                shape=(-1,))
        return tmx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def test_unrolled_cells_store_holds_the_cell_op_and_loads_bit_equal(
        tmp_path):
    sym = cells_sym()
    assert sum(1 for n in sym._nodes() if n.op is not None
               and n.op.name == "_FusedLSTMCell") == LAYERS * SEQ
    args = weights(sym, LM_SHAPES, seed=3)
    store = str(tmp_path / "aot")
    pooled(sym, args, LM_SHAPES, "cells").export_aot(BUCKETS, store)
    for b in BUCKETS:
        assert mxt_calls(program_graph(store, "cells", b),
                         "lstm_cell_fwd") == LAYERS * SEQ
    entry = pooled(sym, args, LM_SHAPES, "cells")
    assert entry.load_aot(store, BUCKETS) == len(BUCKETS)
    for b in BUCKETS:
        feed = tokens(b, 20 + b)
        assert np.array_equal(entry.forward(feed)[0],
                              predictor(sym, args, feed)), b
    assert entry._pred is None


# ---------------------------------------------------------------------------
# (d) attention above one flash block
# ---------------------------------------------------------------------------

def att_sym(mx):
    return mx.sym.contrib.Attention(
        *(mx.sym.Variable(n) for n in ("query", "key", "value")),
        num_heads=HEADS, causal=True, name="att")


def att_feed(b, seed):
    rs = np.random.RandomState(seed)
    return {n: rs.standard_normal((b,) + s).astype("f")
            for n, s in ATT_SHAPES.items()}


def test_attention_store_holds_one_flash_call_and_matches(tmp_path,
                                                          monkeypatch):
    from mxnet_tpu.serving import aot as jaot
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", FLASH_BLOCK)
    sym = att_sym(tmx)
    store = str(tmp_path / "aot")
    pooled(sym, {}, ATT_SHAPES).export_aot([1, 2], store)
    for b in (1, 2):
        graph = program_graph(store, "m", b)
        assert mxt_calls(graph, "flash_attention_fwd") == 1
        call = [n for n in graph.nodes if n.op == "call_function"
                and "flash" in str(n.target)][0]
        assert call.args[3] is True and call.args[5] == int(FLASH_BLOCK)
    entry = pooled(sym, {}, ATT_SHAPES)
    assert entry.load_aot(store) == 2
    for b in (1, 2):
        feed = att_feed(b, 30 + b)
        got = entry.forward(feed)[0]
        assert np.array_equal(got, predictor(sym, {}, feed)), b
        compiled, (pv, av) = jaot.build_forward(att_sym(jmx), {}, {},
                                                ATT_SHAPES, b)
        want = np.asarray(compiled(pv, av, *(feed[n] for n in
                                             sorted(feed)))[0])
        np.testing.assert_allclose(got, want, **TOL)
    assert entry._pred is None


# ---------------------------------------------------------------------------
# (e) the load check
# ---------------------------------------------------------------------------

def test_load_check_takes_time_major_outputs_and_refuses_wrong_shapes(
        tmp_path, caplog):
    # the LM's bucket-2 program answers (SEQ * 2, VOCAB) rows: the graph's
    # shape, not the bucket's leading dim
    sym, _, args = lm()
    store = str(tmp_path / "lm")
    pooled(sym, args, LM_SHAPES, "lm").export_aot([2], store)
    entry = pooled(sym, args, LM_SHAPES, "lm")
    with caplog.at_level(logging.WARNING):
        assert entry.load_aot(store) == 1
    assert "validation call failed" not in caplog.text
    assert entry.forward(tokens(2, 5))[0].shape == (SEQ * 2, VOCAB)
    # a program of the same parameters whose output has twice the rows
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        fc = tmx.sym.FullyConnected(data, num_hidden=4, name="fc")
        doubled = tmx.sym.Concat(fc, fc, dim=0, name="twice")
        with tmx.name.NameManager():
            right = tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                           num_hidden=4, name="fc")
    args = weights(right, {"data": (5,)}, seed=4)
    store = str(tmp_path / "wrong")
    pooled(doubled, args, {"data": (5,)}).export_aot([2], store)
    entry = pooled(right, args, {"data": (5,)})
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert entry.load_aot(store) == 0
    assert "wrong validation output shape" in caplog.text
    assert not entry._aot and entry._aot_args is None
    x = np.random.RandomState(6).rand(2, 5).astype("f")
    assert np.array_equal(entry.forward({"data": x})[0],
                          predictor(right, args, {"data": x}))


# ---------------------------------------------------------------------------
# (f) rtc across processes
# ---------------------------------------------------------------------------

def _rtc_sym():
    if "aot_test_twice" not in OP_REGISTRY:
        twice = tmx.rtc.elementwise_cuda_kernel(TWICE, plain=lambda x: 2 * x)
        tmx.rtc.register_kernel("aot_test_twice")(lambda data: twice(data))
    with tmx.name.NameManager():
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=4, name="fc")
        net = tmx.sym.aot_test_twice(net, name="twice")
        return tmx.sym.SoftmaxOutput(net, name="softmax")


#: a fresh process (JAX unimportable) that registers the op with the same
#: rtc body, or as plain torch code without one, then loads the store
RTC_CHILD = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["mxnet_tpu"] = None
import numpy as np
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.serving import ModelPool
mode, sym_path, args_path, store, x_path, y_path = sys.argv[1:]
if mode == "register":
    twice = tmx.rtc.elementwise_cuda_kernel(%(body)r, plain=lambda x: 2 * x)
    tmx.rtc.register_kernel("aot_test_twice")(lambda data: twice(data))
else:
    tmx.rtc.register_kernel("aot_test_twice")(lambda data: 2 * data)
with open(sym_path) as f:
    sym = tmx.sym.load_json(f.read())
args = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in np.load(args_path).items()}
entry = ModelPool(ctx=tmx.cpu()).add("m", sym, args, {},
                                     sample_shapes={"data": (5,)})
loaded = entry.load_aot(store, [1, 2])
np.save(y_path, entry.forward({"data": np.load(x_path)})[0])
print(json.dumps({"loaded": loaded, "aot": sorted(entry._aot)}))
"""


def test_rtc_store_loads_where_the_body_is_registered(tmp_path):
    sym = _rtc_sym()
    rs = np.random.RandomState(0)
    args = {"fc_weight": rs.rand(4, 5).astype("f"),
            "fc_bias": np.zeros(4, "f")}
    store = str(tmp_path / "aot")
    pooled(sym, args, {"data": (5,)}).export_aot([1, 2], store)
    key = tmx.rtc.body_key(TWICE)
    for b in (1, 2):
        graph = program_graph(store, "m", b)
        calls = [n for n in graph.nodes if n.op == "call_function"
                 and "rtc_elementwise" in str(n.target)]
        assert len(calls) == 1 and calls[0].args[1] == key
    paths = {k: str(tmp_path / k) for k in ("sym.json", "args.npz", "x.npy",
                                           "child.py")}
    with open(paths["sym.json"], "w") as f:
        f.write(sym.tojson())
    np.savez(paths["args.npz"], **args)
    x = rs.rand(2, 5).astype("f")
    np.save(paths["x.npy"], x)
    with open(paths["child.py"], "w") as f:
        f.write(RTC_CHILD % {"body": TWICE})
    ref = predictor(sym, args, {"data": x})
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    for mode, loaded in (("register", 2), ("absent", 0)):
        y = str(tmp_path / ("%s.npy" % mode))
        res = subprocess.run(
            [sys.executable, paths["child.py"], mode, paths["sym.json"],
             paths["args.npz"], store, paths["x.npy"], y],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=180)
        assert res.returncode == 0, res.stderr[-3000:]
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["loaded"] == loaded, (mode, res.stderr[-3000:])
        assert np.array_equal(np.load(y), ref), mode
        if mode == "absent":
            assert out["aot"] == [] and key in res.stderr
            assert "falling back to the bucket warmup" in res.stderr
        else:
            assert out["aot"] == [1, 2] and key not in res.stderr


# ---------------------------------------------------------------------------
# (g) the portable archive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lm", "attention", "rtc"])
def test_portable_archive_holds_no_mxt_op(tmp_path, monkeypatch, kind):
    monkeypatch.setenv("MXTPU_FLASH_BLOCK", FLASH_BLOCK)
    if kind == "lm":
        sym, _, args = lm(seed=7)
        feed = tokens(2, 8)
    elif kind == "attention":
        sym, args, feed = att_sym(tmx), {}, att_feed(2, 9)
    else:
        sym = _rtc_sym()
        args = weights(sym, {"data": (5,)}, seed=10, skip=("softmax_label",))
        feed = {"data": np.random.RandomState(11).rand(2, 5).astype("f")}
    fname = str(tmp_path / "model.pt2")
    tmx.predict.export_compiled(sym, t_nd(args), {},
                                {k: v.shape for k, v in feed.items()},
                                fname=fname)
    graph = torch.export.load(fname).graph
    assert not [n for n in graph.nodes if "mxt" in str(n.target)]
    got = tmx.predict.load_compiled(fname)(
        *(feed[n] for n in sorted(feed)))[0].numpy()
    np.testing.assert_allclose(got, predictor(sym, args, feed), **TOL)


# ---------------------------------------------------------------------------
# (h) the daemon answers /predict_seq through the LM's stored programs
# ---------------------------------------------------------------------------

SERVE_MAIN = os.path.join(REPO, "mxnet_tpu_torch", "serving", "serve_main.py")

#: runs a script with JAX and the JAX package unimportable
WRAPPER = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["mxnet_tpu"] = None
sys.argv = [%(main)r] + sys.argv[1:]
runpy.run_path(%(main)r, run_name="__main__")
"""


def _lm_flags(prefix):
    return ["--model", "lm=%s:1" % prefix,
            "--input-shape", "lm:data=%d" % SEQ,
            "--input-shape", "lm:softmax_label=%d" % SEQ]


def test_daemon_serves_predict_seq_from_the_lm_store(tmp_path, monkeypatch):
    from mxnet_tpu_torch import fleet
    sym, _, args = lm(seed=12)
    prefix = str(tmp_path / "lm")
    tmx.model.save_checkpoint(prefix, 1, sym, t_nd(args), {}, blocking=True)
    wrapper = str(tmp_path / "w.py")
    with open(wrapper, "w") as f:
        f.write(WRAPPER % {"main": SERVE_MAIN})
    base = _lm_flags(prefix) + ["--port", "0", "--buckets", "1,2",
                                "--context", "cpu", "--max-wait-ms", "1"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO,
               MXTPU_COMPILE_CACHE=str(tmp_path / "cache"),
               MXTPU_SERVE_SEQ_BUCKETS="4,%d" % SEQ)
    for k in ("MXTPU_FAULTS", "MXTPU_RESUME"):
        env.pop(k, None)
    res = subprocess.run([sys.executable, wrapper] + base
                         + ["--warmup-only", "--export-aot"], env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "exported AOT programs for 'lm' over buckets [1, 2]" in res.stderr
    port_file = str(tmp_path / "lm.port")
    err_path = str(tmp_path / "lm.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, wrapper] + base + [
            "--warmup", "--port-file", port_file], env=env,
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(port_file):
            assert proc.poll() is None, open(err_path).read()[-3000:]
            assert time.monotonic() < deadline, "daemon never listened"
            time.sleep(0.05)
        host, port = open(port_file).read().split(":")
        cli = ServeClient(host, int(port), timeout=60)
        toks = np.random.RandomState(13).randint(0, VOCAB, SEQ - 1)
        status, payload = cli.predict_seq("lm", toks.tolist())
        cli.close()
        assert status == 200 and payload["bucket"] == SEQ, payload
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = open(err_path).read()
    assert "warmed 'lm' from the AOT store (2/2 buckets)" in err, err
    assert "warmed 'lm' over buckets" not in err
    padded = np.concatenate([toks, toks[-1:]]).astype("f")[None]
    ref = predictor(sym, args, {"data": padded,
                                "softmax_label": np.zeros_like(padded)})
    assert np.array_equal(np.asarray(payload["outputs"][0], "f"),
                          ref[:SEQ - 1])
    # a fleet's replicas get the manifest's shapes and the sequence buckets
    monkeypatch.setenv("MXTPU_SERVE_SEQ_BUCKETS", "4,%d" % SEQ)
    man = fleet.FleetManifest.from_flags(
        ["lm=%s:1" % prefix], ["lm:data=%d" % SEQ,
                               "lm:softmax_label=%d" % SEQ],
        replicas=2, buckets="1,2", device_sets="cpu")
    ctl = fleet.ReplicaController(man, str(tmp_path / "run"))
    for rep in ctl.replicas:
        assert rep.env["MXTPU_SERVE_SEQ_BUCKETS"] == "4,%d" % SEQ
        flags = " ".join(rep.argv)
        assert "lm:data=%d" % SEQ in flags and \
            "lm:softmax_label=%d" % SEQ in flags
