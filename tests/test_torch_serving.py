"""The port's serving slice (``mxnet_tpu_torch/serving/``) on the CPU,
against the JAX package's ``mxnet_tpu/serving/``.

The same numpy inputs and weights go through both packages:

- parsers and pickers: equal results and equal errors over a grid of
  specs; ``quantize_int8``: ``q`` and ``s`` bit for bit;
- pool forwards: float32 and int8 at rtol 1e-5 / atol 1e-6 against the
  JAX pool; bfloat16 at rtol 1e-5 against the JAX pool on the MLP, and on
  the conv net against the JAX float32 pool given the bfloat16-rounded
  weights (the JAX bfloat16 pool cannot run a convolution:
  ``lax.conv_general_dilated`` refuses float32 data with bfloat16
  weights), which is the arithmetic JAX's promotion gives;
- sequence serving: ``/predict_seq`` answers at rtol 1e-5 / atol 1e-6;
- the AOT store's ``entry_meta``: equal dicts;
- the batcher's dispatch order for one trace of submits: equal.

Inside the port, bit for bit: a batched row against the same row served
alone in the same bucket, a full bucket against the hand-batched
``Predictor``, int8 against float32 on the dequantized weights, a hot
swap against a fresh ``Predictor`` on the new epoch, and a rollback
against the old outputs.
"""
import json
import logging
import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.serving as jsrv
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.serving as tsrv
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import CheckpointManager, TransientError, faults
from mxnet_tpu_torch.serving import (BucketBatcher, Draining, ModelPool,
                                     QueueFull, ServeClient, ServingFrontend,
                                     TenantQuotaExceeded, pad_to_bucket)
from mxnet_tpu_torch.serving.deploy import CheckpointWatcher

pytestmark = pytest.mark.serve

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def port_faults():
    """Disarm the port's fault points around the test."""
    faults.disarm()
    yield faults
    faults.disarm()


# ---------------------------------------------------------------------------
# the models of tests/test_serving.py, built once in the JAX package and
# carried to the port as JSON + numpy
# ---------------------------------------------------------------------------

def mlp_sym(nh=64, num_classes=10):
    with jmx.name.NameManager():
        data = jmx.sym.Variable("data")
        net = jmx.sym.FullyConnected(data, num_hidden=nh, name="fc1")
        net = jmx.sym.Activation(net, act_type="relu")
        net = jmx.sym.FullyConnected(net, num_hidden=num_classes,
                                     name="fc2")
        return jmx.sym.SoftmaxOutput(net, name="softmax")


def conv_sym():
    with jmx.name.NameManager():
        data = jmx.sym.Variable("data")
        net = jmx.sym.Convolution(data, num_filter=8, kernel=(3, 3),
                                  pad=(1, 1), name="c1")
        net = jmx.sym.BatchNorm(net, name="bn1")
        net = jmx.sym.Activation(net, act_type="relu")
        net = jmx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                              pool_type="max")
        net = jmx.sym.Flatten(net)
        net = jmx.sym.FullyConnected(net, num_hidden=4, name="fc")
        return jmx.sym.SoftmaxOutput(net, name="softmax")


MODELS = {"mlp": (mlp_sym, (32,)), "conv": (conv_sym, (3, 8, 8))}


def np_params(sym, data_shape, seed=0):
    """Random args (+ BN aux: mean 0 / var 1) as numpy."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    args = {n: rs.uniform(-0.3, 0.3, s).astype("f")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: (np.ones(s) if n.endswith("var") else np.zeros(s))
            .astype("f")
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def t_nd(d):
    return {k: tmx.nd.array(v, ctx=CPU) for k, v in d.items()}


def j_nd(d):
    return {k: jmx.nd.array(v) for k, v in d.items()}


def t_sym(sym):
    return tmx.sym.load_json(sym.tojson())


def both_pools(kind, dtype="float32", seed=0):
    """(jax pool, port pool, jax sym, numpy args, numpy auxs, sample)."""
    fn, sample = MODELS[kind]
    sym = fn()
    args, auxs = np_params(sym, (1,) + sample, seed)
    jp = jsrv.ModelPool(dtype=dtype)
    jp.add("m", sym, j_nd(args), j_nd(auxs), sample_shapes={"data": sample})
    tp = ModelPool(ctx=CPU, dtype=dtype)
    tp.add("m", t_sym(sym), t_nd(args), t_nd(auxs),
           sample_shapes={"data": sample})
    return jp, tp, sym, args, auxs, sample


def port_pool(kind="mlp", dtype="float32", seed=0, **kw):
    fn, sample = MODELS[kind]
    sym = fn()
    args, auxs = np_params(sym, (1,) + sample, seed)
    pool = ModelPool(ctx=CPU, dtype=dtype)
    pool.add("m", t_sym(sym), t_nd(args), t_nd(auxs),
             sample_shapes={"data": sample}, **kw)
    return pool, t_sym(sym), args, auxs, sample


def ref_predictor(sym, args, auxs, shape):
    blob = {"arg:%s" % k: tmx.nd.array(v, ctx=CPU) for k, v in args.items()}
    blob.update({"aux:%s" % k: tmx.nd.array(v, ctx=CPU)
                 for k, v in auxs.items()})
    return tmx.predict.Predictor(sym, blob, {"data": shape}, ctx=CPU)


def same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# parsers and pickers against the JAX package
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return ("error", type(e).__name__)


@pytest.mark.parametrize("spec", ["1,2,4,8", " 2, 4,16", (3, 5), [1],
                                  "8,4", "0,1", "1,1,2", "", "a,b", (),
                                  "1,2,,4", (-1, 2)])
def test_parse_buckets_matches_jax(spec):
    assert _outcome(tsrv.parse_buckets, spec) == \
        _outcome(jsrv.parse_buckets, spec)


def test_parse_buckets_env_default_matches_jax(monkeypatch):
    assert tsrv.parse_buckets() == jsrv.parse_buckets() == \
        (1, 2, 4, 8, 16, 32)
    monkeypatch.setenv("MXTPU_SERVE_BUCKETS", "2, 4,16")
    assert tsrv.parse_buckets() == jsrv.parse_buckets() == (2, 4, 16)


@pytest.mark.parametrize("buckets", [(1, 2, 4, 8), (3, 5), (32,)])
def test_pick_and_pad_match_jax(buckets):
    for n in range(1, buckets[-1] + 3):
        assert _outcome(tsrv.pick_bucket, n, buckets) == \
            _outcome(jsrv.pick_bucket, n, buckets)
    rs = np.random.RandomState(0)
    for n in (1, 3, buckets[-1]):
        rows = list(rs.randn(n, 3, 2).astype("f"))
        b = tsrv.pick_bucket(n, buckets)
        got = tsrv.pad_to_bucket(rows, b)
        assert got.shape == (b, 3, 2)
        assert np.array_equal(got, jsrv.pad_to_bucket(rows, b))


@pytest.mark.parametrize("spec", ["gold:4,free:1", "", " ", "a:2, b:0.5,",
                                  {"a": 2}, "gold:0", "gold", "x:-1",
                                  "x:abc", "ns:team:3"])
def test_parse_tenant_weights_matches_jax(spec):
    assert _outcome(tsrv.parse_tenant_weights, spec) == \
        _outcome(jsrv.parse_tenant_weights, spec)


@pytest.mark.parametrize("spec", ["8,16,32", "32;8,16", [16, 8, 8], "4",
                                  "8,-1", "0", "", "a", None])
def test_parse_seq_buckets_and_pick_match_jax(spec):
    got = _outcome(tsrv.parse_seq_buckets, spec)
    assert got == _outcome(jsrv.parse_seq_buckets, spec)
    if got[0] == "ok":
        for n in range(0, got[1][-1] + 2):
            assert _outcome(tsrv.pick_seq_bucket, n, got[1]) == \
                _outcome(jsrv.pick_seq_bucket, n, got[1])
        assert tsrv.seq_batcher_name("lm", got[1][0]) == \
            jsrv.seq_batcher_name("lm", got[1][0])


@pytest.mark.parametrize("shape", [(8, 16), (4, 3, 3, 3), (10, 1), (7,)])
def test_quantize_int8_bit_equal_jax(shape):
    from mxnet_tpu.serving.pool import quantize_int8 as jq
    from mxnet_tpu_torch.serving.pool import quantize_int8 as tq
    rs = np.random.RandomState(0)
    w = rs.uniform(-2.0, 2.0, shape).astype("f")
    w[min(3, shape[0] - 1)] *= 0.01
    w[0] = 0.0                          # an all-zero channel
    for arg in (w, tmx.nd.array(w, ctx=CPU)):
        q, s = tq(arg)
        jq_, js = jq(w)
        assert q.dtype == np.int8 and s.dtype == np.float32
        assert np.array_equal(q, jq_) and np.array_equal(s, js)


# ---------------------------------------------------------------------------
# the pool against the JAX pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [("mlp", "float32"),
                                        ("conv", "float32"),
                                        ("mlp", "bfloat16"),
                                        ("mlp", "int8"),
                                        ("conv", "int8")])
def test_pool_forward_matches_jax(kind, dtype):
    """Tolerance: rtol 1e-5, atol 1e-6 — both compute in float32 on the
    same (rounded or dequantized) weights."""
    jp, tp, _, _, _, sample = both_pools(kind, dtype)
    x = np.random.RandomState(5).rand(4, *sample).astype("f")
    got = tp.get("m").forward({"data": x})
    ref = jp.get("m").forward({"data": x})
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    if dtype == "int8":
        assert sorted(tp.get("m")._wt_scales) == \
            sorted(jp.get("m")._wt_scales)


def test_pool_bf16_conv_matches_jax_promotion():
    """bfloat16 weights, float32 inputs: JAX's arithmetic is float32 on
    the rounded weights (``conv(f32, bf16)`` promotes).  The JAX pool's
    own convolution refuses the mixed dtypes, so the reference is the
    JAX float32 pool given the bfloat16-rounded weights.  Tolerance:
    rtol 1e-5, atol 1e-6.  The weights are stored as bfloat16."""
    import ml_dtypes
    sym = conv_sym()
    sample = (3, 8, 8)
    args, auxs = np_params(sym, (1,) + sample)
    pool = ModelPool(ctx=CPU, dtype="bfloat16")
    entry = pool.add("m", t_sym(sym), t_nd(args), t_nd(auxs),
                     sample_shapes={"data": sample})
    assert all(v.dtype == "bfloat16" for v in entry.arg_params.values())
    assert all(v.dtype == "bfloat16" for v in entry.aux_params.values())

    def rounded(d):
        return {k: jmx.nd.array(v.astype(ml_dtypes.bfloat16)
                                .astype(np.float32)) for k, v in d.items()}

    jp = jsrv.ModelPool()
    jp.add("m", sym, rounded(args), rounded(auxs),
           sample_shapes={"data": sample})
    x = np.random.RandomState(6).rand(4, *sample).astype("f")
    np.testing.assert_allclose(entry.forward({"data": x})[0],
                               jp.get("m").forward({"data": x})[0], **TOL)
    assert entry.resident_weight_bytes() == \
        sum(v.size * 2 for d in (args, auxs) for v in d.values())


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_pool_int8_equals_float32_on_dequantized_weights(kind):
    """int8 serving is float32 arithmetic on ``q * s``: bit for bit equal
    to a float32 pool given the dequantized weights (numpy's multiply),
    and not equal to the unquantized float32 pool."""
    pool8, sym, args, auxs, sample = port_pool(kind, "int8")
    e8 = pool8.get("m")
    deq = dict(args)
    for k, s in e8._wt_scales.items():
        deq[k] = e8.arg_params[k].astype(np.float32) * s
    p32 = ModelPool(ctx=CPU)
    p32.add("m", sym, t_nd(deq), t_nd(auxs), sample_shapes={"data": sample})
    x = np.random.RandomState(5).rand(8, *sample).astype("f")
    o8 = e8.forward({"data": x})
    assert same(o8, p32.get("m").forward({"data": x}))
    plain = port_pool(kind)[0].get("m").forward({"data": x})
    assert not np.array_equal(o8[0], plain[0])
    np.testing.assert_allclose(o8[0], plain[0], atol=2e-2, rtol=5e-2)


def test_pool_int8_resident_bytes_under_03_f32():
    """int8 + float32 per-channel scales stay under 0.3x the float32
    bytes of the quantized weights, and the float32 values live only
    during a forward (the bound arrays hold a zero-stride view)."""
    pool, _, _, _, _ = port_pool("mlp", "int8")
    entry = pool.get("m")
    entry.forward({"data": np.zeros((1, 32), "f")})
    f32 = sum(int(np.prod(np.shape(entry.arg_params[k]))) * 4
              for k in entry._wt_scales)
    assert entry.resident_weight_bytes() < 0.3 * f32
    bound = entry._lowp._pred._arg_params
    for k in entry._wt_scales:
        assert bound[k]._data.stride() == (0, 0)


def test_pool_bn_fold_default_matches_unfolded(monkeypatch):
    """bn_fold is on by default; the folded forward equals the unfolded
    graph within rtol 1e-5 / atol 1e-6 (float reassociation)."""
    monkeypatch.delenv("MXTPU_FUSED_KERNELS", raising=False)
    assert "bn_fold" in tmx.kernels.enabled_kernels()
    pool_on, sym, args, auxs, sample = port_pool("conv")
    x = np.random.RandomState(3).randn(4, *sample).astype("f")
    folded = pool_on.get("m").forward({"data": x})[0]
    monkeypatch.setenv("MXTPU_FUSED_KERNELS",
                       ",".join(k for k in tmx.kernels.KNOWN_KERNELS
                                if k != "bn_fold"))
    assert "bn_fold" not in tmx.kernels.enabled_kernels()
    pool_off = ModelPool(ctx=CPU)
    pool_off.add("m", sym, t_nd(args), t_nd(auxs),
                 sample_shapes={"data": sample})
    unfolded = pool_off.get("m").forward({"data": x})[0]
    np.testing.assert_allclose(folded, unfolded, **TOL)


def test_pool_loads_what_the_jax_package_wrote(tmp_path):
    """A ``save_checkpoint`` pair and a ``CheckpointManager`` directory
    written by the JAX package serve in the port with no converter,
    within rtol 1e-5 / atol 1e-6 of the JAX pool; the directory load
    walks back past a rotted newest epoch."""
    from mxnet_tpu.model import save_checkpoint
    from mxnet_tpu.resilience import CheckpointManager as JMan
    sym = conv_sym()
    args, auxs = np_params(sym, (1, 3, 8, 8), seed=1)
    prefix = str(tmp_path / "conv")
    save_checkpoint(prefix, 3, sym, j_nd(args), j_nd(auxs), blocking=True)
    man = JMan(str(tmp_path / "dir"))
    man.save(1, symbol=sym, arg_params=j_nd(args), aux_params=j_nd(auxs))
    args2, auxs2 = np_params(sym, (1, 3, 8, 8), seed=2)
    man.save(2, symbol=sym, arg_params=j_nd(args2), aux_params=j_nd(auxs2))
    p2 = man.params_path(2)
    blob = bytearray(open(p2, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p2, "wb").write(bytes(blob))
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype("f")
    shapes = {"data": (3, 8, 8)}
    pool = ModelPool(ctx=CPU)
    a = pool.load("a", prefix, 3, sample_shapes=shapes)
    d = pool.load_dir("d", str(tmp_path / "dir"), sample_shapes=shapes)
    assert (a.loaded_epoch, d.loaded_epoch) == (3, 1)
    assert d.source_dir == str(tmp_path / "dir")
    jp = jsrv.ModelPool()
    jp.load("a", prefix, 3, sample_shapes=shapes)
    ref = jp.get("a").forward({"data": x})[0]
    for entry in (a, d):
        np.testing.assert_allclose(entry.forward({"data": x})[0], ref, **TOL)


def test_pool_unknown_model_dtype_and_context():
    pool, _, _, _, _ = port_pool()
    assert pool.names() == ["m"] and "m" in pool and "nope" not in pool
    with pytest.raises(MXNetError, match="no model"):
        pool.get("nope")
    assert pool.get("m").ctx == CPU
    with pytest.raises(MXNetError, match="serving dtype"):
        port_pool(dtype="float64")
    # the default context is the card's, fixed when the pool is made
    assert ModelPool().ctx == tmx.gpu(0)
    with tmx.cpu():
        assert ModelPool().ctx == CPU


def test_analyze_and_env_gate_refuse_without_a_linter(monkeypatch):
    """The port has its graph linter now: ``analyze`` returns a clean
    report and the ``MXTPU_ANALYZE`` gate lints, then serves (it refused
    while the linter was missing)."""
    pool, _, _, _, _ = port_pool()
    entry = pool.get("m")
    rep = entry.analyze(bucket=2)
    assert rep.ok, rep.format_text()
    monkeypatch.setenv("MXTPU_ANALYZE", "1")
    assert entry.forward({"data": np.zeros((1, 32), "f")})[0].shape == \
        (1, 10)
    monkeypatch.delenv("MXTPU_ANALYZE")
    assert entry.forward({"data": np.zeros((1, 32), "f")})[0].shape == \
        (1, 10)


# ---------------------------------------------------------------------------
# the bucket bit-identity contract, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [("mlp", "float32"),
                                        ("conv", "float32"),
                                        ("conv", "bfloat16"),
                                        ("mlp", "int8")])
def test_batched_rows_bit_identical_to_unbatched(kind, dtype):
    """5 rows in a bucket of 8 equal each row served alone, padded to 8,
    bit for bit (the partial fill's padding included)."""
    pool, _, _, _, sample = port_pool(kind, dtype)
    entry = pool.get("m")
    X = np.random.RandomState(1).randn(5, *sample).astype("f")
    batched = entry.forward({"data": pad_to_bucket(list(X), 8)})[0]
    for i in range(5):
        alone = entry.forward({"data": pad_to_bucket([X[i]], 8)})[0]
        assert np.array_equal(batched[i], alone[0]), i


def test_full_bucket_is_the_hand_batched_predictor():
    pool, sym, args, auxs, _ = port_pool("conv")
    X = np.random.RandomState(2).randn(8, 3, 8, 8).astype("f")
    batched = pool.get("m").forward({"data": X.copy()})[0]
    hand = ref_predictor(sym, args, auxs, (8, 3, 8, 8)).forward(
        data=X).get_output(0)
    assert np.array_equal(batched, hand)


def test_batcher_end_to_end_bit_identity_with_partial_final_batch():
    """11 concurrent requests (largest bucket 8): every result equals
    its solo forward at some bucket, bit for bit; none is lost."""
    pool, sym, args, auxs, _ = port_pool()
    b = BucketBatcher(pool.get("m").forward, buckets=(1, 2, 4, 8),
                      max_wait_ms=50.0, name="m")
    X = np.random.RandomState(4).randn(11, 32).astype("f")
    try:
        results = [f.result(timeout=60) for f in
                   [b.submit({"data": X[i]}) for i in range(11)]]
    finally:
        b.close()
    refs = {k: ref_predictor(sym, args, auxs, (k, 32)) for k in (1, 2, 4, 8)}
    for i in range(11):
        assert results[i][0].shape == (10,)
        assert any(np.array_equal(results[i][0], refs[k].forward(
            data=pad_to_bucket([X[i]], k)).get_output(0)[0]) for k in refs)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_priority_traffic_keeps_bit_exactness(dtype):
    """Mixed priorities change WHEN a request runs, never WHAT it
    returns (bucket 1): each answer equals the unbatched forward."""
    pool, _, _, _, _ = port_pool(dtype=dtype)
    entry = pool.get("m")
    rs = np.random.RandomState(3)
    xs = [rs.rand(32).astype("f") for _ in range(6)]
    expect = [entry.forward({"data": x[None]})[0][0] for x in xs]
    b = BucketBatcher(entry.forward, buckets=(1,), max_wait_ms=1)
    try:
        futs = [b.submit({"data": x}, priority=i % 3)
                for i, x in enumerate(xs)]
        for f, e in zip(futs, expect):
            assert np.array_equal(f.result(timeout=30)[0], e)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------

TRACES = {
    "priority": [(1.0, 0, None), (2.0, 5, None), (3.0, 1, None),
                 (4.0, 5, None), (5.0, 0, None), (6.0, 2, None),
                 (7.0, 5, None), (8.0, 0, None)],
    "tenants": [(100.0 + i, 0, "flood") for i in range(9)]
    + [(1.0, 0, "quiet"), (2.0, 3, "quiet"), (3.0, 0, "quiet")]
    + [(50.0, 1, None), (51.0, 0, None), (52.0, 0, "gold"),
       (53.0, 0, "gold")],
    "weighted": [(100.0 + i, i % 2, "gold") for i in range(8)]
    + [(200.0 + i, 0, "free") for i in range(8)],
}


def _dispatch_order(pkg, trace):
    """The dispatch order of ``trace`` (tag, priority, tenant) through
    ``pkg``'s batcher, every submit made while ``run_exclusive`` holds
    the dispatcher, so timing cannot decide the order."""
    order = []

    def runner(inputs, n):
        vals = np.asarray(inputs["data"])
        order.append(vals[:n, 0].tolist())
        return [vals]

    b = pkg.BucketBatcher(runner, buckets=(1, 2, 4), max_wait_ms=1000.0,
                          tenant_weights="gold:3,free:1")
    gate, held = threading.Event(), threading.Event()

    def hold():
        held.set()
        assert gate.wait(30)

    t = threading.Thread(target=b.run_exclusive, args=(hold,))
    t.start()
    try:
        assert held.wait(10)
        futs = [b.submit({"data": np.full((2,), tag, "f")},
                         priority=pri, tenant=ten)
                for tag, pri, ten in trace]
        gate.set()
        t.join(30)
        for f in futs:
            f.result(timeout=30)
    finally:
        gate.set()
        b.close()
    return order


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_dispatch_order_matches_jax(trace):
    order = _dispatch_order(tsrv, TRACES[trace])
    assert order == _dispatch_order(jsrv, TRACES[trace])
    assert sum(len(batch) for batch in order) == len(TRACES[trace])
    assert all(len(batch) == 4 for batch in order)


def test_batcher_never_truncates_above_max_bucket():
    calls = []

    def runner(inputs, n):
        calls.append((inputs["data"].shape[0], n))
        return [inputs["data"] * 2.0]

    b = BucketBatcher(runner, buckets=(1, 2, 4), max_wait_ms=30.0)
    try:
        outs = [f.result(timeout=30) for f in
                [b.submit({"data": np.full((2,), i, "f")})
                 for i in range(11)]]
    finally:
        b.close()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o[0], np.full((2,), 2.0 * i))
    assert sum(n for _, n in calls) == 11
    assert all(shape <= 4 and n <= shape for shape, n in calls)


def test_batcher_queue_bound_and_draining():
    release = threading.Event()

    def runner(inputs, n):
        release.wait(30)
        return [inputs["data"]]

    b = BucketBatcher(runner, buckets=(1,), max_wait_ms=0.0, max_queue=2)
    try:
        futures = [b.submit({"data": np.zeros((1,), "f")})]
        deadline = time.monotonic() + 10
        while b._qtotal_locked() and time.monotonic() < deadline:
            time.sleep(0.005)
        futures += [b.submit({"data": np.zeros((1,), "f")})
                    for _ in range(2)]
        with pytest.raises(QueueFull):
            b.submit({"data": np.zeros((1,), "f")})
        release.set()
        for f in futures:
            f.result(timeout=30)
    finally:
        release.set()
        b.close()
    with pytest.raises(Draining):
        b.submit({"data": np.zeros((1,), "f")})


def test_batcher_deadlines_shed_queued_and_spent():
    order = []
    stats = tsrv.Stats()
    gate, first = threading.Event(), threading.Event()

    def runner(inputs, n):
        vals = np.asarray(inputs["data"])
        if not first.is_set():
            first.set()
            assert gate.wait(10)
        order.extend(vals[:n, 0].tolist())
        return [vals]

    b = BucketBatcher(runner, buckets=(1,), max_wait_ms=0, stats=stats)
    try:
        f0 = b.submit({"data": np.full((2,), 0.0, "f")})
        assert first.wait(10)
        doomed = b.submit({"data": np.full((2,), 1.0, "f")}, deadline_ms=30)
        kept = b.submit({"data": np.full((2,), 2.0, "f")})
        with pytest.raises(tsrv.DeadlineExpired):
            b.submit({"data": np.full((2,), 3.0, "f")}, deadline_ms=0)
        time.sleep(0.15)
        gate.set()
        f0.result(timeout=10)
        kept.result(timeout=10)
        with pytest.raises(tsrv.DeadlineExpired):
            doomed.result(timeout=10)
        assert order == [0.0, 2.0]
        assert stats.snapshot()["counters"]["shed_deadline"] == 2
    finally:
        gate.set()
        b.close()


def test_batcher_model_error_reaches_every_waiter():
    def runner(inputs, n):
        raise RuntimeError("model exploded")

    b = BucketBatcher(runner, buckets=(1, 2), max_wait_ms=20.0)
    try:
        futures = [b.submit({"data": np.zeros((1,), "f")})
                   for _ in range(2)]
        for f in futures:
            with pytest.raises(RuntimeError, match="model exploded"):
                f.result(timeout=30)
    finally:
        b.close()


def test_wfq_fairness_and_quota():
    """A flooding tenant cannot starve an equal one (the quiet tenant's
    3 requests within the first 7 slots), and a tenant at its queued
    quota is shed while the other still queues."""
    order = []
    gate, first = threading.Event(), threading.Event()

    def runner(inputs, n):
        vals = np.asarray(inputs["data"])
        if not first.is_set():
            first.set()
            assert gate.wait(10)
        order.extend(vals[:n, 0].tolist())
        return [vals]

    stats = tsrv.Stats()
    b = BucketBatcher(runner, buckets=(1,), max_wait_ms=0, tenant_quota=12,
                      stats=stats)
    try:
        futs = [b.submit({"data": np.full((2,), 0.0, "f")})]
        assert first.wait(10)
        futs += [b.submit({"data": np.full((2,), 100.0 + i, "f")},
                          tenant="flood") for i in range(12)]
        with pytest.raises(TenantQuotaExceeded):
            b.submit({"data": np.full((2,), 199.0, "f")}, tenant="flood")
        futs += [b.submit({"data": np.full((2,), 1.0 + i, "f")},
                          tenant="quiet") for i in range(3)]
        gate.set()
        for f in futs:
            f.result(timeout=10)
    finally:
        gate.set()
        b.close()
    served = order[1:]
    quiet = [i for i, tag in enumerate(served) if tag < 100.0]
    assert max(quiet) <= 6 and [served[i] for i in quiet] == [1.0, 2.0, 3.0]
    assert 199.0 not in order
    assert stats.snapshot()["counters"]["shed_tenant"] == 1


def test_serve_forward_fault_points(port_faults):
    """``serve_forward`` fails the batch it strikes (every waiter gets
    the error, the next batch serves); ``hang_serve_forward`` stalls the
    dispatch for its armed time and loses nothing."""
    def runner(inputs, n):
        return [inputs["data"] + 1.0]

    b = BucketBatcher(runner, buckets=(1, 2), max_wait_ms=20.0)
    try:
        port_faults.arm("serve_forward")
        futs = [b.submit({"data": np.zeros((1,), "f")}) for _ in range(2)]
        for f in futs:
            with pytest.raises(TransientError, match="serve_forward"):
                f.result(timeout=30)
        assert b.submit({"data": np.zeros((1,), "f")}).result(30)[0] == 1.0
        port_faults.arm_hang("hang_serve_forward", seconds=0.3)
        t0 = time.monotonic()
        out = b.submit({"data": np.ones((1,), "f")}).result(timeout=30)
        assert time.monotonic() - t0 >= 0.3 and out[0] == 2.0
    finally:
        b.close()


def test_sustained_high_priority_cannot_starve_low():
    state = {"refills": 0, "low_seen_at": None, "b": None}

    def runner(inputs, n):
        vals = np.asarray(inputs["data"])
        if 1.0 in vals[:n, 0]:
            state["low_seen_at"] = state["refills"]
        elif state["refills"] < 200 and state["low_seen_at"] is None:
            state["refills"] += 1
            state["b"].submit({"data": np.full((2,), 9.0, "f")},
                              priority=9)
        time.sleep(0.02)
        return [vals]

    b = state["b"] = BucketBatcher(runner, buckets=(1,), max_wait_ms=0)
    try:
        b.submit({"data": np.full((2,), 9.0, "f")}, priority=9)
        b.submit({"data": np.full((2,), 1.0, "f")},
                 priority=0).result(timeout=30)
        assert state["low_seen_at"] is not None
        assert 3 <= state["low_seen_at"] < 150, state
    finally:
        b.close()


# ---------------------------------------------------------------------------
# sequence serving: the LSTM LM (vocab 50, width 8, 2 layers)
# ---------------------------------------------------------------------------

VOCAB = 50


def _lm_pools():
    """The LM in both packages from one numpy parameter set, registered
    WITHOUT init states (zero-filled per batch bucket)."""
    from mxnet_tpu.models import lstm_lm
    with jmx.name.NameManager():
        sym, _, _ = lstm_lm.lstm_lm_sym(8, VOCAB, num_embed=8, num_hidden=8,
                                        num_layers=2)
    arg_shapes, _, _ = sym.infer_shape(data=(2, 8), softmax_label=(2, 8))
    skip = ("data", "softmax_label", "lstm_init_h", "lstm_init_c")
    rs = np.random.RandomState(0)
    args = {n: ((rs.rand(*s) - 0.5) * 0.4).astype("f")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in skip}
    jp = jsrv.ModelPool()
    jp.add("lm", sym, j_nd(args))
    tp = ModelPool(ctx=CPU)
    tp.add("lm", t_sym(sym), t_nd(args))
    return jp, tp


@pytest.fixture(scope="module")
def lm_pools():
    return _lm_pools()


TOKENS = [3, 7, 11, 19, 2, 23, 29, 31, 5, 13, 44, 1, 9]


def test_predict_seq_matches_jax(lm_pools):
    """Answers trimmed to their true length equal the JAX pool's at
    rtol 1e-5 / atol 1e-6, across three length buckets."""
    jp, tp = lm_pools
    jfe = jsrv.ServingFrontend(jp, buckets="1,2,4", max_wait_ms=1,
                               seq_buckets="4,8,16")
    tfe = ServingFrontend(tp, buckets="1,2,4", max_wait_ms=1,
                          seq_buckets="4,8,16")
    try:
        for n in (3, 5, 13):
            st, got = tfe.handle_predict_seq("lm", TOKENS[:n])
            jst, ref = jfe.handle_predict_seq("lm", TOKENS[:n])
            assert st == jst == 200, got
            assert (got["bucket"], got["len"]) == (ref["bucket"], ref["len"])
            o = np.asarray(got["outputs"][0])
            assert o.shape == (n, VOCAB)
            np.testing.assert_allclose(o, np.asarray(ref["outputs"][0]),
                                       **TOL)
    finally:
        tfe.drain_and_stop(timeout=10)
        jfe.drain_and_stop(timeout=10)


def test_predict_seq_bit_stable_across_bucket_boundaries(lm_pools):
    _, tp = lm_pools
    fe = ServingFrontend(tp, buckets="1,2,4", max_wait_ms=1,
                         seq_buckets="4,8,16")
    try:
        st, out = fe.handle_predict_seq("lm", TOKENS[:5])
        assert st == 200 and out["bucket"] == 8 and out["len"] == 5
        o = np.asarray(out["outputs"][0])
        assert np.allclose(o.sum(axis=1), 1.0, atol=1e-5)
        st2, out2 = fe.handle_predict_seq("lm", TOKENS[:10])
        assert st2 == 200 and out2["bucket"] == 16
        assert np.array_equal(o, np.asarray(out2["outputs"][0])[:5])
        st3, out3 = fe.handle_predict_seq("lm", TOKENS[:5])
        assert np.array_equal(np.asarray(out3["outputs"][0]), o)
        st4, out4 = fe.handle_predict_seq("lm", list(range(99)))
        assert st4 == 400 and "exceeds" in out4["error"]
    finally:
        fe.drain_and_stop(timeout=10)


def test_predict_seq_equals_predictor_at_the_bucket_shape(lm_pools):
    """A ``/predict_seq`` answer over HTTP equals a ``Predictor`` forward
    at the bucket shape (batch 1, length 8) on the padded tokens, bit
    for bit; each length bucket has its own batcher."""
    _, tp = lm_pools
    entry = tp.get("lm")
    fe = ServingFrontend(tp, port=0, buckets="1,2,4", max_wait_ms=1,
                         seq_buckets="4,8")
    fe.serve_in_background()
    try:
        cli = ServeClient("127.0.0.1", fe.port, timeout=30)
        st, out = cli.predict_seq("lm", TOKENS[:6], tenant="gold")
        assert st == 200 and out["bucket"] == 8
        padded = np.asarray(TOKENS[:6] + [TOKENS[5]] * 2, "f")[None]
        pred = tmx.predict.Predictor(
            entry.symbol, {"arg:%s" % k: v for k, v in
                           entry.arg_params.items()},
            {"data": (1, 8), "softmax_label": (1, 8)}, ctx=CPU)
        ref = pred.forward(data=padded,
                           softmax_label=np.zeros((1, 8), "f")).get_output(0)
        assert np.array_equal(np.asarray(out["outputs"][0], "f"), ref[:6])
        st2, _ = cli.predict_seq("lm", TOKENS[:3])
        assert st2 == 200
        wait = fe.stats_payload()["est_wait_ms"]
        assert "lm@seq4" in wait and "lm@seq8" in wait
        assert cli.predict_seq("nope", [1, 2])[0] == 404
        cli.close()
    finally:
        fe.drain_and_stop(timeout=10)


# ---------------------------------------------------------------------------
# the AOT store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [("mlp", "float32"),
                                        ("conv", "float32"),
                                        ("mlp", "int8"),
                                        ("mlp", "bfloat16")])
def test_entry_meta_matches_jax(kind, dtype):
    from mxnet_tpu.serving import aot as jaot
    from mxnet_tpu_torch.serving import aot as taot
    jp, tp, _, _, _, _ = both_pools(kind, dtype)
    assert taot.entry_meta(tp.get("m")) == jaot.entry_meta(jp.get("m"))


def _port_meta(entry, store_dir, **over):
    """A meta doc that verifies against ``entry`` on the CPU."""
    from mxnet_tpu_torch.serving import aot
    doc = dict(aot.entry_meta(entry), platform="cpu", runtime=aot.RUNTIME,
               meta_version=1, buckets=[1])
    doc.update(over)
    os.makedirs(store_dir, exist_ok=True)
    with open(os.path.join(store_dir, "m.json"), "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("case", ["meta_mismatch", "jax_built",
                                  "corrupt_artifact", "absent"])
def test_aot_store_falls_back_with_a_warning(tmp_path, caplog, case):
    """Every store the port cannot use warns and loads 0 buckets, and
    the model serves through the bucket warmup."""
    pool, _, _, _, _ = port_pool()
    entry = pool.get("m")
    store = str(tmp_path / "aot")
    if case == "meta_mismatch":
        _port_meta(entry, store, sample_shapes={"data": [16]})
    elif case == "jax_built":
        # what the JAX package's --export-aot writes on the CPU
        jp, _, _, _, _, _ = both_pools("mlp")
        from mxnet_tpu.serving import aot as jaot
        doc = dict(jaot.entry_meta(jp.get("m")), platform="cpu",
                   meta_version=1, buckets=[1])
        os.makedirs(store)
        with open(os.path.join(store, "m.json"), "w") as f:
            json.dump(doc, f)
        open(os.path.join(store, "m-b1.exec"), "wb").write(b"\0" * 64)
    elif case == "corrupt_artifact":
        _port_meta(entry, store)
        open(os.path.join(store, "m-b1.exec"), "wb").write(b"\x13" * 64)
    with caplog.at_level(logging.WARNING):
        assert entry.load_aot(store, [1, 2]) == 0
    want = {"meta_mismatch": "meta mismatch", "jax_built": "meta mismatch",
            "corrupt_artifact": "cannot load", "absent": None}[case]
    if want:
        assert want in caplog.text
    assert not entry._aot
    entry.warmup([1, 2])
    assert entry.forward({"data": np.zeros((2, 32), "f")})[0].shape == \
        (2, 10)


# ---------------------------------------------------------------------------
# hot swap (serving/deploy.py)
# ---------------------------------------------------------------------------

def _stream(tmp_path, writer="port", dtype="float32"):
    """A CheckpointManager directory written by ``writer``'s package,
    epoch 1 saved, plus a pool and watcher on it in the port."""
    sym = mlp_sym()

    def save(epoch, args=None):
        if args is None:
            args, _ = np_params(sym, (1, 32), seed=10 + epoch)
        if writer == "jax":
            from mxnet_tpu.resilience import CheckpointManager as JMan
            JMan(str(tmp_path / "stream")).save(
                epoch, symbol=sym, arg_params=j_nd(args), aux_params={})
        else:
            CheckpointManager(str(tmp_path / "stream")).save(
                epoch, symbol=t_sym(sym), arg_params=t_nd(args),
                aux_params={}, blocking=True)
        return args

    save(1)
    pool = ModelPool(ctx=CPU, dtype=dtype)
    entry = pool.load_dir("m", str(tmp_path / "stream"),
                          sample_shapes={"data": (32,)})
    return sym, save, pool, entry, CheckpointWatcher(pool, "m")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hot_swap_serves_the_new_epoch_bit_exact(tmp_path, writer):
    """The promoted epoch serves bit-equal to a fresh ``Predictor`` on
    its params; a bystander model's bytes do not move."""
    sym, save, pool, entry, watcher = _stream(tmp_path, writer)
    bargs, bauxs = np_params(mlp_sym(nh=24), (1, 32), seed=77)
    pool.add("by", t_sym(mlp_sym(nh=24)), t_nd(bargs), t_nd(bauxs),
             sample_shapes={"data": (32,)})
    x = {"data": np.random.RandomState(3).rand(4, 32).astype("f")}
    before_b = pool.get("by").forward(dict(x))
    entry.forward(dict(x))
    assert watcher.check_once()["action"] == "current"
    args2 = save(2)
    out = watcher.check_once()
    assert out["ok"] and out["action"] == "promoted", out
    assert entry.loaded_epoch == 2 and watcher.last_swap_ms is not None
    ref = ref_predictor(t_sym(sym), args2, {}, (4, 32)).forward(
        data=x["data"]).get_output(0)
    assert np.array_equal(entry.forward(dict(x))[0], ref)
    assert same(before_b, pool.get("by").forward(dict(x)))


@pytest.mark.parametrize("damage", ["rot_checkpoint", "truncate_checkpoint"])
def test_hot_swap_rejects_damaged_epochs(tmp_path, port_faults, damage):
    sym, save, pool, entry, watcher = _stream(tmp_path)
    x = {"data": np.random.RandomState(5).rand(2, 32).astype("f")}
    before = entry.forward(dict(x))
    port_faults.arm(damage)
    save(2)
    out = watcher.check_once()
    assert not out["ok"] and out["action"] == "rejected", out
    assert watcher.counters["rejected"] == 1 and entry.loaded_epoch == 1
    assert same(before, entry.forward(dict(x)))
    out = watcher.check_once()
    assert out["action"] == "rejected" and out.get("already_counted")
    save(3)
    out = watcher.check_once()
    assert out["ok"] and out["epoch"] == 3, out


def test_hot_swap_rejects_nan_and_a_changed_graph(tmp_path):
    sym, save, pool, entry, watcher = _stream(tmp_path)
    args, _ = np_params(sym, (1, 32), seed=9)
    args["fc1_weight"][:] = np.nan
    save(2, args=args)
    out = watcher.check_once()
    assert not out["ok"] and out["action"] == "validation_failed", out
    assert watcher.check_once()["action"] == "held"
    other = mlp_sym(nh=48)
    oargs, _ = np_params(other, (1, 32), seed=10)
    CheckpointManager(str(tmp_path / "stream")).save(
        3, symbol=t_sym(other), arg_params=t_nd(oargs), aux_params={},
        blocking=True)
    out = watcher.check_once()
    assert not out["ok"] and out["action"] == "validation_failed", out
    assert watcher.counters["validation_failures"] == 2
    assert entry.loaded_epoch == 1
    with pytest.raises(MXNetError, match="does not match"):
        entry.swap_params(t_nd(oargs), {})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_hot_swap_probe_failure_rolls_back_bitwise(tmp_path, port_faults,
                                                   dtype):
    """A ``swap_probe`` failure restores the previous weights bit for
    bit (the snapshot is a copy, not a reference); the retried swap
    then equals a fresh pool on the new epoch, bit for bit."""
    sym, save, pool, entry, watcher = _stream(tmp_path, dtype=dtype)
    x = {"data": np.random.RandomState(7).rand(2, 32).astype("f")}
    before = entry.forward(dict(x))
    port_faults.arm("swap_probe")
    save(2)
    out = watcher.check_once()
    assert not out["ok"] and out["action"] == "rolled_back", out
    assert entry.loaded_epoch == 1
    assert same(before, entry.forward(dict(x)))
    assert watcher.check_once()["action"] == "held"
    out = watcher.check_once(force=True)
    assert out["ok"] and out["action"] == "promoted", out
    fresh = ModelPool(ctx=CPU, dtype=dtype).load_dir(
        "m", str(tmp_path / "stream"), sample_shapes={"data": (32,)})
    assert same(entry.forward(dict(x)), fresh.forward(dict(x)))


def test_hot_swap_at_the_dispatch_boundary(tmp_path):
    """The batch in flight finishes on the old weights, the next runs
    on the new ones."""
    sym = t_sym(mlp_sym())
    args1, _ = np_params(mlp_sym(), (1, 32), seed=1)
    args2, _ = np_params(mlp_sym(), (1, 32), seed=2)
    pool = ModelPool(ctx=CPU)
    entry = pool.add("m", sym, t_nd(args1), sample_shapes={"data": (32,)})
    entered, release = threading.Event(), threading.Event()

    def runner(inputs, n):
        entered.set()
        assert release.wait(30)
        entered.clear()
        release.clear()
        return entry.forward(inputs, n)

    b = BucketBatcher(runner, buckets=(1, 2), max_wait_ms=0, name="m")
    try:
        x = np.random.RandomState(0).rand(32).astype("f")
        ref1 = ref_predictor(sym, args1, {}, (1, 32)).forward(
            data=x[None]).get_output(0)[0]
        ref2 = ref_predictor(sym, args2, {}, (1, 32)).forward(
            data=x[None]).get_output(0)[0]
        fut1 = b.submit({"data": x})
        assert entered.wait(10)
        swapped = threading.Event()

        def do_swap():
            b.run_exclusive(lambda: entry.swap_params(t_nd(args2)))
            swapped.set()

        t = threading.Thread(target=do_swap)
        t.start()
        fut2 = b.submit({"data": x})
        time.sleep(0.2)
        assert not swapped.is_set()
        release.set()
        t.join(timeout=30)
        assert swapped.is_set()
        out1 = fut1.result(timeout=30)[0]
        assert entered.wait(10)
        release.set()
        assert np.array_equal(out1, ref1)
        assert np.array_equal(fut2.result(timeout=30)[0], ref2)
    finally:
        release.set()
        b.close(drain=False, timeout=5)


def test_hot_swap_under_traffic_drops_no_request(tmp_path):
    """Four clients keep requesting while the front end's watcher
    promotes epochs 2 and 3: every answer is a 200, and afterwards the
    model serves epoch 3 bit-equal to a fresh ``Predictor``."""
    sym, save, pool, entry, _ = _stream(tmp_path)
    fe = ServingFrontend(pool, buckets=(1, 2, 4), max_wait_ms=1)
    watcher = fe.watcher("m")
    stop = threading.Event()
    codes = []
    lock = threading.Lock()
    x = np.random.RandomState(2).rand(32).astype("f")

    def client():
        while not stop.is_set():
            st, _ = fe.handle_predict("m", {"data": x})
            with lock:
                codes.append(st)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.2)
        for epoch in (2, 3):
            args = save(epoch)
            out = watcher.check_once()
            assert out["ok"] and out["action"] == "promoted", out
            time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert codes and set(codes) == {200}, sorted(set(codes))
    st, payload = fe.handle_predict("m", {"data": x})
    ref = ref_predictor(t_sym(mlp_sym()), args, {}, (1, 32)).forward(
        data=x[None]).get_output(0)[0]
    assert np.array_equal(np.asarray(payload["outputs"][0], "f"), ref)
    stats = fe.stats_payload()
    assert stats["epochs"]["m"] == 3 and stats["deploy"]["m"]["promoted"] == 2
    fe.drain_and_stop(timeout=10)


def test_swap_endpoint_and_watcher_thread(tmp_path):
    sym, save, pool, entry, _ = _stream(tmp_path)
    args, auxs = np_params(mlp_sym(), (1, 32), seed=50)
    pool.add("inmem", t_sym(mlp_sym()), t_nd(args), sample_shapes={
        "data": (32,)})
    fe = ServingFrontend(pool, port=0, buckets=(1, 2))
    fe.serve_in_background()
    try:
        cli = ServeClient("127.0.0.1", fe.port, timeout=30)
        assert cli.swap("nope")[0] == 404
        assert cli.swap("inmem")[0] == 409
        st, out = cli.swap("m")
        assert st == 200 and out["action"] == "current"
        save(2)
        st, out = cli.swap("m")
        assert st == 200 and out["action"] == "promoted", out
        w = fe.watcher("m")
        w.poll_s = 0.05
        w.start()
        save(3)
        deadline = time.monotonic() + 20
        while entry.loaded_epoch != 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert entry.loaded_epoch == 3, w.stats()
        st, health = cli.healthz()
        assert st == 200 and health["epochs"]["m"] == 3
        cli.close()
    finally:
        fe.drain_and_stop(timeout=10)
    assert not fe.watcher("m").watching()


# ---------------------------------------------------------------------------
# the front end, in process and over HTTP on port 0
# ---------------------------------------------------------------------------

def test_frontend_predict_stats_and_400():
    pool, sym, args, auxs, _ = port_pool()
    fe = ServingFrontend(pool, buckets=(1, 2, 4), max_wait_ms=1)
    x = np.random.RandomState(0).randn(32).astype("f")
    st, payload = fe.handle_predict("m", {"data": x})
    assert st == 200
    ref = ref_predictor(sym, args, auxs, (1, 32)).forward(
        data=x[None]).get_output(0)[0]
    assert np.array_equal(np.asarray(payload["outputs"][0], "f"), ref)
    st, payload = fe.handle_predict("m", {"data": np.zeros(16, "f")})
    assert st == 400 and "shapes" in payload["error"]
    stats = fe.stats_payload()
    assert stats["counters"]["accepted"] == stats["counters"]["completed"] == 1
    assert stats["batches"]["count"] == 1
    assert stats["batches"]["fill_ratio"] == 1.0
    assert stats["latency_ms"]["p50"] is not None
    assert stats["models"] == ["m"] and stats["buckets"] == [1, 2, 4]
    fe.drain_and_stop(timeout=10)


def test_frontend_sheds_at_the_queue_bound_and_the_slo():
    release = threading.Event()
    pool, _, _, _, _ = port_pool()
    entry = pool.get("m")
    real = entry.forward

    def slow(inputs, n=None):
        release.wait(30)
        return real(inputs, n)

    entry.forward = slow
    fe = ServingFrontend(pool, buckets=(1,), max_wait_ms=0, max_queue=1)
    codes = []
    threads = [threading.Thread(target=lambda: codes.append(
        fe.handle_predict("m", {"data": np.zeros(32, "f")})[0]))
        for _ in range(4)]
    for t in threads:
        t.start()
        time.sleep(0.05)
    release.set()
    for t in threads:
        t.join(timeout=30)
    assert codes.count(429) >= 1
    assert codes.count(200) == 4 - codes.count(429)
    assert fe.stats.snapshot()["counters"]["shed_queue"] >= 1
    fe.drain_and_stop(timeout=10)

    fe = ServingFrontend(pool, buckets=(1,), slo_ms=5.0, max_queue=100)
    b = fe.batcher("m")
    b._ema_batch_s = 1.0
    with b._cv:
        b._inflight = 1
    ok, status, reason = fe.admit("m")
    assert not ok and status == 429 and "SLO" in reason
    assert fe.stats.snapshot()["counters"]["shed_slo"] == 1
    with b._cv:
        b._inflight = 0
    assert fe.admit("m")[0]
    fe.drain_and_stop(timeout=10)


def test_frontend_draining_answers_503():
    pool, _, _, _, _ = port_pool()
    fe = ServingFrontend(pool, buckets=(1,))
    fe.draining = True
    st, payload = fe.handle_predict("m", {"data": np.zeros(32, "f")})
    assert st == 503 and "draining" in payload["error"]
    assert fe.handle_swap("m")[0] == 503


def test_http_qos_tenants_dedup_and_client():
    """Over HTTP: priority/deadline/tenant headers and body fields, a
    spent deadline's 429, a tenant's latency ledger, a request-id
    replay that does not execute twice, JSON and x-npy bodies equal,
    404 and 400."""
    pool, _, _, _, _ = port_pool()
    fe = ServingFrontend(pool, port=0, buckets=(1, 2), max_wait_ms=1,
                         tenant_quota=64)
    fe.serve_in_background()
    try:
        cli = ServeClient("127.0.0.1", fe.port, timeout=30)
        x = np.random.RandomState(0).rand(32).astype("f")
        st, j = cli.predict("m", x, priority=2, deadline_ms=8000,
                            tenant="gold")
        assert st == 200
        st, n = cli.predict("m", x, npy=True)
        assert st == 200 and n["outputs"] == j["outputs"]
        st, p = cli.predict("m", x, deadline_ms=-5)
        assert st == 429 and p["reason"] == "shed_deadline"
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        conn.request("POST", "/predict/m", body=json.dumps(
            {"inputs": {"data": [0.0] * 32}, "deadline_ms": -1}).encode(),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 429
        assert json.loads(resp.read())["reason"] == "shed_deadline"
        conn.close()
        accepted = fe.stats.snapshot()["counters"]["accepted"]
        st1, p1 = cli.predict("m", x, request_id="r1")
        st2, p2 = cli.predict("m", x, request_id="r1")
        assert st1 == st2 == 200 and p1 == p2
        counters = fe.stats.snapshot()["counters"]
        assert counters["accepted"] == accepted + 1
        assert counters["dedup_hits"] == 1
        payload = cli.stats()[1]
        assert "gold" in payload["tenant_latency_ms"]
        assert payload["dedup"]["entries"] == 3   # every 200 has an id
        assert cli.predict("nope", x)[0] == 404
        assert cli._request("POST", "/predict/m", body=b"{}")[0] == 400
        assert cli._request("GET", "/nowhere")[0] == 404
        cli.close()
    finally:
        fe.drain_and_stop(timeout=10)


def test_handler_sends_without_nagle():
    """A reply is a header write then a body write; with Nagle's delay
    on, the body waits for the client's delayed ACK (about 40 ms a
    keep-alive request), so the port's handler sets TCP_NODELAY."""
    from mxnet_tpu_torch.serving.frontend import _Handler
    assert _Handler.disable_nagle_algorithm is True


def test_each_model_batcher_gets_its_own_watchdog():
    from mxnet_tpu_torch.resilience import StepWatchdog
    sym = t_sym(mlp_sym())
    args, _ = np_params(mlp_sym(), (1, 32))
    pool = ModelPool(ctx=CPU)
    for name in ("a", "b"):
        pool.add(name, sym, t_nd(args), sample_shapes={"data": (32,)})
    fe = ServingFrontend(pool, buckets=(1,), max_wait_ms=0,
                         watchdog=StepWatchdog(timeout=30))
    ba, bb = fe.batcher("a"), fe.batcher("b")
    assert ba.watchdog is not None and ba.watchdog is not bb.watchdog
    assert fe.handle_predict("a", {"data": np.zeros(32, "f")})[0] == 200
    fe.drain_and_stop(timeout=5)
    assert fe._watchdogs == []
    assert ba.watchdog._thread is None and bb.watchdog._thread is None


def test_stats_merge_and_percentiles_match_jax():
    ts, js = tsrv.Stats(), jsrv.Stats()
    for v in range(1, 101):
        ts.record_latency(float(v), tenant="t" if v % 2 else None)
        js.record_latency(float(v), tenant="t" if v % 2 else None)
    ts.record_batch(3, 4, 0.01)
    js.record_batch(3, 4, 0.01)
    assert ts.snapshot() == js.snapshot()
    assert tsrv.Stats.merged_snapshot([ts.export(), ts.export()]) == \
        jsrv.Stats.merged_snapshot([js.export(), js.export()])
