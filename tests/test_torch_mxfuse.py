"""The PyTorch port's plan optimizer (``mxnet_tpu_torch.mxfuse``) against
the JAX package's, on the CPU: the cases of ``tests/test_mxfuse.py`` that
apply to the port, and the port's own liveness and merged-body contracts.

Parity, fused against ``MXTPU_FUSED_KERNELS=0`` and the port's fused
plan against the JAX package's, forward AND backward AND moving stats:

- ``pool_act``'s reorder and ``eltwise_chain`` run the same ops on the
  same values: forward bit for bit, gradients within 2e-6 relative;
- ``concat_fuse`` and ``bn_fold`` reassociate the conv reduction (a
  merged or folded conv sums in another order): rtol 1e-5 / atol 1e-6 on
  outputs, rtol 5e-4 / atol 5e-6 on gradients and moving stats — the JAX
  package's tolerances for the same nets;
- the slice pooling is bitwise for max, within 1e-6 for avg/sum.

The port has no XLA: a dead entry it interprets is work it does.  So the
convolutions one forward runs are counted (``aten.convolution`` through a
dispatch mode) and held to the plan's live convolutions, and each merged
``concat_fuse`` group runs its conv once per forward on both paths."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import executor as jex, mxfuse as jfuse
from mxnet_tpu_torch import executor as tex, mxfuse as tfuse
from mxnet_tpu_torch.kernels import (bn_act as BA, concat_fuse as CF,
                                     eltwise_chain as EC, pool_act as PA)

PRE = "bn_act,bn_fold,lstm_cell,flash_attention,augment"


class ConvCount(TorchDispatchMode):
    """Counts ``aten.convolution`` calls made inside the mode."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.convolution:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _inception_net(mx):
    """Stem + one A tower + one B tower: every pattern the pipeline
    matches (merge trio, grouped 3x3 siblings, act→max-pool stem,
    avg-pool branch, concat)."""
    ib = mx.models.inception_bn
    data = mx.sym.Variable("data")
    c1 = ib.ConvFactory(data, 16, (3, 3), pad=(1, 1), name="c1")
    p1 = mx.sym.Pooling(c1, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="max", name="p1")
    a = ib.InceptionFactoryA(p1, 8, 8, 12, 8, 12, "avg", 8, "3a")
    b = ib.InceptionFactoryB(a, 8, 12, 8, 12, "3c")
    flat = mx.sym.Flatten(mx.sym.Pooling(
        b, global_pool=True, kernel=(1, 1), pool_type="avg"))
    fc = mx.sym.FullyConnected(flat, num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _resnet_block_net(mx):
    """conv→bn→relu stacks + a shortcut add + relu tail and a scalar
    chain."""
    ib = mx.models.inception_bn
    data = mx.sym.Variable("data")
    body = ib.ConvFactory(data, 8, (3, 3), pad=(1, 1), name="rb1")
    body = mx.sym.Convolution(body, num_filter=8, kernel=(3, 3),
                              pad=(1, 1), name="rb2")
    body = mx.sym.BatchNorm(body, fix_gamma=False, name="rb2_bn")
    short = mx.sym.Convolution(data, num_filter=8, kernel=(1, 1), name="sc")
    fused = mx.sym.Activation(body + short, act_type="relu",
                              name="sum_relu")
    tail = mx.sym.tanh(fused * 0.5 + 1.0)
    fc = mx.sym.FullyConnected(mx.sym.Flatten(tail), num_hidden=10,
                               name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _mlp_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _run(mx, sym_fn, shape, train, env, monkeypatch):
    """One forward (and backward when ``train``) of ``sym_fn(mx)`` with the
    JAX test's seeded values; returns (output, grads, aux)."""
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", env)
    rs = np.random.RandomState(0)
    with mx.name.NameManager():
        sym = sym_fn(mx)
    ex = sym.simple_bind(mx.cpu(), data=shape)
    for name in sorted(ex.arg_dict):
        if name in ("data", "softmax_label"):
            continue
        r = np.random.RandomState(sum(map(ord, name)))
        ex.arg_dict[name][:] = \
            (r.rand(*ex.arg_dict[name].shape).astype("f") - 0.5) * 0.4
    for name in ex.aux_dict:
        ex.aux_dict[name][:] = 1.0 if name.endswith("var") else 0.0
    ex.arg_dict["data"][:] = rs.rand(*shape).astype("f")
    ex.arg_dict["softmax_label"][:] = rs.randint(0, 10, shape[0]).astype("f")
    out = ex.forward(is_train=train)[0].asnumpy()
    grads, aux = {}, {}
    if train:
        ex.backward()
        grads = {k: v.asnumpy() for k, v in ex.grad_dict.items()
                 if v is not None}
        aux = {k: v.asnumpy() for k, v in ex.aux_dict.items()}
    return out, grads, aux


def _close(got, want, rtol, atol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


NETS = {"mlp": (_mlp_net, (4, 12)),
        "resnet_block": (_resnet_block_net, (2, 3, 8, 8)),
        "inception": (_inception_net, (2, 3, 16, 16))}


# ---------------------------------------------------------------------------
# parity: fused against unfused and against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_parity_all_passes(net, train, monkeypatch):
    sym_fn, shape = NETS[net]
    o1, g1, a1 = _run(tmx, sym_fn, shape, train, "1", monkeypatch)
    o0, g0, a0 = _run(tmx, sym_fn, shape, train, "0", monkeypatch)
    oj, gj, aj = _run(jmx, sym_fn, shape, train, "1", monkeypatch)
    for want in (o0, oj):
        np.testing.assert_allclose(o1, want, rtol=1e-5, atol=1e-6)
    for gw, aw in ((g0, a0), (gj, aj)):
        assert sorted(g1) == sorted(gw)
        _close(g1, gw, 5e-4, 5e-6)
        _close(a1, aw, 5e-4, 5e-6)


def test_inception_eval_stays_in_bn_fold_contract(monkeypatch):
    """Every pass on against the pre-mxfuse set (bn_act, bn_fold): the
    serving output moves within the bn_fold tolerance (rtol 1e-5)."""
    shape = NETS["inception"][1]
    o_all, _, _ = _run(tmx, _inception_net, shape, False, "1", monkeypatch)
    o_pre, _, _ = _run(tmx, _inception_net, shape, False, PRE, monkeypatch)
    np.testing.assert_allclose(o_all, o_pre, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# plan structure
# ---------------------------------------------------------------------------

def _plans(mx, ex_mod, fuse_mod, sym_fn, env, monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", env)
    with mx.name.NameManager():
        sym = sym_fn(mx)
    plan = ex_mod._node_plan(sym)
    refs = [(id(n), i) for n, i in sym._outputs]
    return sym, plan, refs, fuse_mod.optimize_plan(plan, refs)


def _overrides(plan):
    return {e[0].name: len(e[5][1]) for e in plan if e[5] is not None}


@pytest.mark.parametrize("env", ["1", "concat_fuse", "pool_act",
                                 "bn_act,bn_fold", "bn_fold",
                                 "eltwise_chain", "infer_trace", "0"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_one_knob_toggles_the_same_passes_in_both(net, env, monkeypatch):
    """The same ``MXTPU_FUSED_KERNELS`` value rewrites the same nodes, with
    the same number of extra refs, in both packages."""
    sym_fn = NETS[net][0]
    _, _, _, tplan = _plans(tmx, tex, tfuse, sym_fn, env, monkeypatch)
    _, _, _, jplan = _plans(jmx, jex, jfuse, sym_fn, env, monkeypatch)
    assert _overrides(tplan) == _overrides(jplan)
    assert [e[0].name for e in tplan] == [e[0].name for e in jplan]


def test_off_restores_exact_plain_plan(monkeypatch):
    _, plan, refs, fused = _plans(tmx, tex, tfuse, _inception_net, "0",
                                  monkeypatch)
    assert fused is plan
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", "1")
    fused = tfuse.optimize_plan(plan, refs)
    assert fused is not plan
    assert all(e[5] is None for e in plan)


def test_concat_fuse_plan_structure(monkeypatch):
    """The A-tower's three 1x1 stacks merge into one shared-input group (1
    shared input + 3 members x (w, b, gamma, beta, mm, mv) extra refs), and
    the fused plan is a PERMUTATION of the plain entries with slots 0-4
    intact."""
    _, plan, _, fused = _plans(tmx, tex, tfuse, _inception_net,
                               "concat_fuse", monkeypatch)
    by_name = {e[0].name: e for e in fused}
    trio = ["bn_3a_1x1", "bn_3a_3x3_reduce", "bn_3a_double_3x3_reduce"]
    keys = set()
    for name in trio:
        ov = by_name[name][5]
        assert ov is not None, name
        assert len(ov[1]) == 1 + 3 * 6
        assert ov[2] == ov[3] == frozenset(range(5))   # dead on both paths
        keys.add(ov[0].group)
    assert len(keys) == 1
    assert {id(e[0]) for e in fused} == {id(e[0]) for e in plan}
    plain_of = {id(e[0]): e for e in plan}
    for e in fused:
        assert e[:5] == plain_of[id(e[0])][:5]


def test_concat_fuse_grouped_siblings(monkeypatch):
    """Equal-width sibling 3x3 convs over DIFFERENT inputs merge as one
    grouped conv: member BNs carry one x ref PER member."""
    def net(mx):
        ib = mx.models.inception_bn
        data = mx.sym.Variable("data")
        l = ib.ConvFactory(data, 8, (1, 1), name="la")
        r = ib.ConvFactory(data, 8, (1, 1), name="ra")
        lb = ib.ConvFactory(l, 12, (3, 3), pad=(1, 1), name="lb")
        rb = ib.ConvFactory(r, 12, (3, 3), pad=(1, 1), name="rb")
        return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Flatten(
            mx.sym.Concat(lb, rb)), num_hidden=4), name="softmax")
    _, _, _, fused = _plans(tmx, tex, tfuse, net, "concat_fuse",
                            monkeypatch)
    by_name = {e[0].name: e for e in fused}
    for name in ("bn_lb", "bn_rb"):
        ov = by_name[name][5]
        assert len(ov[1]) == 2 + 2 * 6
        assert ov[0].grouped
    assert len(by_name["bn_la"][5][1]) == 1 + 2 * 6
    assert not by_name["bn_la"][5][0].grouped


def test_concat_fuse_dependent_siblings_not_merged(monkeypatch):
    def net(mx):
        ib = mx.models.inception_bn
        data = mx.sym.Variable("data")
        a = ib.ConvFactory(data, 8, (3, 3), pad=(1, 1), name="s1")
        b = ib.ConvFactory(a, 8, (3, 3), pad=(1, 1), name="s2")
        return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.Flatten(b), num_hidden=4), name="softmax")
    _, plan, _, fused = _plans(tmx, tex, tfuse, net, "concat_fuse",
                               monkeypatch)
    assert fused is plan


def test_topo_sort_raises_on_cycle():
    class N(object):
        def __init__(self, name):
            self.name = name
            self.op = object()
            self.inputs = []

    a, b = N("a"), N("b")
    ea = (a, {}, 1, [], 0, (lambda *x, **k: x[0], [(b, 0)], frozenset()))
    eb = (b, {}, 1, [], 1, (lambda *x, **k: x[0], [(a, 0)], frozenset()))
    with pytest.raises(tmx.base.MXNetError):
        tfuse._topo_sort([ea, eb])


# ---------------------------------------------------------------------------
# pool_act and eltwise_chain
# ---------------------------------------------------------------------------

def _conv_relu_pool(mx):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           name="c")
    r = mx.sym.Activation(c, act_type="relu", name="r")
    p = mx.sym.Pooling(r, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max", name="p")
    fc = mx.sym.FullyConnected(mx.sym.Flatten(p), num_hidden=4, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def test_pool_act_reorder_is_bitwise(monkeypatch):
    shape = (2, 3, 10, 10)
    o1, g1, _ = _run(tmx, _conv_relu_pool, shape, True, "pool_act",
                     monkeypatch)
    o0, g0, _ = _run(tmx, _conv_relu_pool, shape, True, "0", monkeypatch)
    np.testing.assert_array_equal(o1, o0)
    _close(g1, g0, 2e-6, 1e-7)
    _, _, _, fused = _plans(tmx, tex, tfuse, _conv_relu_pool, "pool_act",
                            monkeypatch)
    assert sorted(e[0].name for e in fused if e[5] is not None) == \
        ["p", "r"]


def test_pool_slice_lowering_matches_pooling():
    """The shifted-slice lowering against the registered op, and against
    the JAX package's lowering: max bit for bit, avg/sum within 1e-6; max
    in training keeps the op; maps above the CPU gate (the JAX package's)
    take the op, unless a caller's ``limit`` admits them."""
    import jax.numpy as jnp
    from mxnet_tpu.kernels import pool_act as JPA
    from mxnet_tpu_torch.ops import nn as NN
    rs = np.random.RandomState(0)
    xn = rs.randn(2, 6, 10, 10).astype("f")
    x = torch.from_numpy(xn)
    for pool_type in ("max", "avg", "sum"):
        attrs = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type=pool_type)
        assert PA.slice_pool_eligible(x, attrs)
        ref = NN.pooling(x, **attrs).numpy()
        got = PA.pooling_opt(x, attrs, is_train=False).numpy()
        jgot = np.asarray(JPA.pooling_opt(jnp.asarray(xn), attrs))
        if pool_type == "max":
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, jgot)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)
    attrs = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max")
    assert not PA.slice_pool_eligible(x, attrs, is_train=True)
    assert PA.slice_pool_eligible(x, dict(attrs, pool_type="avg"),
                                  is_train=True)
    big = torch.from_numpy(rs.randn(1, 2, 80, 80).astype("f"))
    assert not PA.slice_pool_eligible(big, attrs)
    np.testing.assert_array_equal(PA.pooling_opt(big, attrs).numpy(),
                                  NN.pooling(big, **attrs).numpy())
    assert PA.slice_pool_eligible(big, attrs, limit=80 * 80)
    assert PA.POOL_SLICE_MAX_SPATIAL == JPA.POOL_SLICE_MAX_SPATIAL


def _chain_net(mx):
    data = mx.sym.Variable("data")
    side = mx.sym.Variable("side")
    v = mx.sym.Activation(data, act_type="relu", name="n1")
    v = v * 0.5
    v = mx.sym.broadcast_add(v, side, name="n3")
    v = mx.sym.tanh(v, name="n4")
    fc = mx.sym.FullyConnected(mx.sym.Flatten(v), num_hidden=4, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def test_eltwise_chain_plan_and_parity(monkeypatch):
    """relu→scale→add→tanh becomes ONE override at the tail (3
    passthroughs, the side operand as an extra ref) and computes the plain
    plan's values and gradients."""
    _, _, _, fused = _plans(tmx, tex, tfuse, _chain_net, "eltwise_chain",
                            monkeypatch)
    overridden = {e[0].name: e[5] for e in fused if e[5] is not None}
    assert len(overridden["n4"][1]) == 1
    assert overridden["n4"][0].n_stages == 4
    assert len(overridden) == 4

    def run(env):
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", env)
        with tmx.name.NameManager():
            s = _chain_net(tmx)
        ex = s.simple_bind(tmx.cpu(), data=(2, 3, 4, 4), side=(2, 3, 4, 4))
        for name in sorted(ex.arg_dict):
            r = np.random.RandomState(sum(map(ord, name)))
            ex.arg_dict[name][:] = r.rand(
                *ex.arg_dict[name].shape).astype("f")
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return out, {k: v.asnumpy() for k, v in ex.grad_dict.items()}

    o1, g1 = run("eltwise_chain")
    o0, g0 = run("0")
    np.testing.assert_array_equal(o1, o0)
    _close(g1, g0, 2e-6, 1e-7)


def test_passes_provably_engaged(monkeypatch):
    """Each pass's body factory is invoked for the inception net and its
    bodies run in the forward (patched counters)."""
    calls = {"concat": 0, "pool": 0, "chain": 0}
    real_group, real_pool = CF.make_group_member, PA.pooling_opt
    real_chain = EC.make_chain_fn

    def count(key, real):
        def wrapped(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        return wrapped

    monkeypatch.setattr(CF, "make_group_member", count("concat", real_group))
    monkeypatch.setattr(PA, "pooling_opt", count("pool", real_pool))
    monkeypatch.setattr(EC, "make_chain_fn", count("chain", real_chain))
    _run(tmx, _inception_net, (2, 3, 16, 16), False, "1", monkeypatch)
    assert calls["concat"] >= 3
    assert calls["pool"] >= 1
    _run(tmx, _resnet_block_net, (2, 3, 8, 8), False, "1", monkeypatch)
    assert calls["chain"] >= 1


# ---------------------------------------------------------------------------
# liveness, infer_trace, the merged body once per forward
# ---------------------------------------------------------------------------

def test_infer_trace_prunes_dead_convs(monkeypatch):
    """With the folds and merges installed, the inference plan skips the
    original per-branch convs (their weights stay reachable through the
    overrides' extra refs), the JAX package's live_entries drops the same
    entries, and the pruned plan computes the unpruned fused plan's
    outputs bit for bit (infer_trace on against off)."""
    _, _, refs, fused = _plans(tmx, tex, tfuse, _inception_net, "1",
                               monkeypatch)
    live = tfuse.live_entries(fused, refs)
    dropped = {e[0].name for e in fused} - {e[0].name for e in live}
    assert any(name.startswith("conv_") for name in dropped)
    live_ids = {id(e[0]) for e in live}
    for e in live:
        if e[5] is not None:
            for src, _idx in e[5][1]:
                assert src.op is None or id(src) in live_ids
    _, _, jrefs, jfused = _plans(jmx, jex, jfuse, _inception_net, "1",
                                 monkeypatch)
    jdropped = {e[0].name for e in jfused} - \
        {e[0].name for e in jfuse.live_entries(jfused, jrefs)}
    assert dropped == jdropped
    shape = NETS["inception"][1]
    o_on, _, _ = _run(tmx, _inception_net, shape, False, "1", monkeypatch)
    no_fold = ",".join(k for k in tmx.kernels.KNOWN_KERNELS
                       if k != "infer_trace")
    o_off, _, _ = _run(tmx, _inception_net, shape, False, no_fold,
                       monkeypatch)
    np.testing.assert_array_equal(o_on, o_off)


def test_fold_constants_unit():
    """A zero-input generator op folds, its consumer folds transitively,
    and anything touching runtime args stays."""
    class FakeOp(object):
        def __init__(self, fn, n_in):
            self.fn = fn
            self.name = fn.__name__
            self.needs_rng = False
            self.needs_is_train = False
            self.variable_inputs = False
            self._n_in = n_in

        def get_input_names(self, attrs):
            return tuple("in%d" % i for i in range(self._n_in))

    class FakeNode(object):
        def __init__(self, name, op, inputs):
            self.name = name
            self.op = op
            self.inputs = inputs

    def three(ctx=None):
        return torch.full((), 3.0, device=ctx)

    def double(x):
        return x * 2

    var = FakeNode("w", None, [])
    gen = FakeNode("gen", FakeOp(three, 0), [])
    dbl = FakeNode("dbl", FakeOp(double, 1), [(gen, 0)])
    dep = FakeNode("dep", FakeOp(double, 1), [(var, 0)])
    entries = [(var, None, None, None, 0, None), (gen, {}, 1, [], 1, None),
               (dbl, {}, 1, [], 2, None), (dep, {}, 1, [], 3, None)]
    const_env, remaining = tfuse.fold_constants(entries, torch.device("cpu"))
    assert float(const_env[id(gen)][0]) == 3.0
    assert float(const_env[id(dbl)][0]) == 6.0
    assert [e[0].name for e in remaining] == ["w", "dep"]


def test_fold_constants_in_the_executor(monkeypatch):
    """A graph with a constant branch (``_ones`` -> ``*2``) serves from
    the folded constants: the branch's entries are not in the interpreted
    inference plan, and outputs equal the plain plan's."""
    def net(mx):
        data = mx.sym.Variable("data")
        const = mx.sym.ones(shape=(2, 3)) * 2.0
        return mx.sym.broadcast_add(data, const, name="out")
    outs = []
    for env in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", env)
        with tmx.name.NameManager():
            sym = net(tmx)
        ex = sym.simple_bind(tmx.cpu(), data=(2, 3))
        ex.arg_dict["data"][:] = np.arange(6, dtype="f").reshape(2, 3)
        outs.append(ex.forward()[0].asnumpy())
        if env == "1":
            const_env, chunk = tfuse.fold_constants(ex._eval.infer_plan,
                                                    torch.device("cpu"))
            assert len(const_env) == 2
            assert [e[0].name for e in chunk] == ["data", "out"]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0],
                                  np.arange(6, dtype="f").reshape(2, 3) + 2)


def _convs_per_forward(mx, sym, shape, train, monkeypatch, env="1"):
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", env)
    ex = sym.simple_bind(mx.cpu(), data=shape)
    rs = np.random.RandomState(1)
    for k in sorted(ex.arg_dict):
        if k not in ("data", "softmax_label"):
            ex.arg_dict[k][:] = (rs.rand(*ex.arg_dict[k].shape)
                                 .astype("f") - 0.5) * 0.2
    ex.arg_dict["data"][:] = rs.rand(*shape).astype("f")
    count = ConvCount()
    with count:
        ex.forward(is_train=train)
    report = tfuse.plan_report(ex._eval.plan, ex._eval.out_refs,
                               tfuse.output_shapes(sym, data=shape))
    return count.n, report


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,layers,shape,fused,before", [
    ("resnet20", 20, (2, 3, 28, 28), 22, 32),
    ("resnet50", 50, (1, 3, 64, 64), 53, 86),
])
def test_conv_count_equals_live_convs(name, layers, shape, fused, before,
                                      train, monkeypatch):
    """The repair: a fused forward runs only live convolutions.  At
    inference ResNet-20 at 28x28 runs 22 and ResNet-50 at 64x64 runs 53,
    as unfused — not the ``before`` (32, 86) of interpreting every entry,
    which ran each fold site's original conv beside its folded one.
    Training runs as many (every fold site's conv is live there)."""
    with tmx.name.NameManager():
        sym = tmx.models.resnet.get_symbol(
            10, layers, image_shape=",".join(map(str, shape[1:])))
    n, report = _convs_per_forward(tmx, sym, shape, train, monkeypatch)
    n0, _ = _convs_per_forward(tmx, sym, shape, train, monkeypatch, "0")
    assert n == n0 == fused
    assert n == report["conv_calls_train" if train else "conv_calls_infer"]
    if train:
        assert report["dropped_train"] == 0
    else:
        assert report["dropped_infer"] == report["bn_fold"]
        assert fused + report["bn_fold"] == before


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_merged_group_runs_once_per_forward(train, monkeypatch):
    """Inception-BN: each concat_fuse group computes its merged body once
    per forward (not once per member) on both paths, the member convs
    never run, every convolution the forward runs is one the plan counts,
    and in training ``fused_bn_act`` runs once per merged group (one
    ``bn_act`` launch over the merged channels on the card)."""
    calls = {"bn_act": 0}
    real = BA.fused_bn_act

    def counted(*a, **kw):
        calls["bn_act"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(BA, "fused_bn_act", counted)
    with tmx.name.NameManager():
        sym = tmx.models.get_symbol("inception-bn", num_classes=10)
    shape = (2, 3, 32, 32)
    before = CF.MERGED_BODIES
    n, report = _convs_per_forward(tmx, sym, shape, train, monkeypatch)
    merged = CF.MERGED_BODIES - before
    assert report["concat_groups"] == 14
    assert report["concat_members"] == 36
    assert report["concat_grouped"] == 4
    # one grouped pair (4d's 3x3 towers: 128 against 160 input channels)
    # is shape-ineligible and runs its members' own math
    assert merged == report["concat_groups"] - 1
    assert n == report["conv_calls_train" if train else "conv_calls_infer"]
    n0, _ = _convs_per_forward(tmx, sym, shape, train, monkeypatch, "0")
    assert (n, n0) == (48, 69)
    assert calls["bn_act"] == (report["bn_act_calls_train"] if train
                               else report["bn_act_calls_infer"])
    assert calls["bn_act"] == (48 if train else 0)


def test_train_plan_drops_only_merged_member_convs(monkeypatch):
    """Training keeps every fold site's conv (the fold is an inference
    rewrite) and drops exactly the merged members' own convs."""
    _, _, refs, fused = _plans(tmx, tex, tfuse, _inception_net, "1",
                               monkeypatch)
    train = tfuse.live_entries(fused, refs, is_train=True)
    dropped = {e[0].name for e in fused} - {e[0].name for e in train}
    members = [e[0] for e in fused if e[5] is not None
               and getattr(e[5][0], "group", None) is not None]
    assert dropped == {bn.inputs[0][0].name for bn in members}


def test_inception_v3_grouped_merges_skip_a_cycle(monkeypatch):
    """Inception-v3's factorized towers give grouped merges that feed each
    other: the JAX package's pass merges them all and its topological sort
    raises; the port skips the merge that would close the cycle, so the
    plan is interpretable (every ref produced before its reader) and
    serves what the plain plan serves."""
    monkeypatch.setenv("MXTPU_FUSED_KERNELS", "1")
    with jmx.name.NameManager():
        jsym = jmx.models.get_symbol("inception-v3", num_classes=10)
    with pytest.raises(jmx.base.MXNetError, match="cycle"):
        jfuse.optimize_plan(jex._node_plan(jsym),
                            [(id(n), i) for n, i in jsym._outputs])
    shape = (1, 3, 75, 75)
    with tmx.name.NameManager():
        sym = tmx.models.get_symbol("inception-v3", num_classes=10)
    plan = tex._node_plan(sym)
    refs = [(id(n), i) for n, i in sym._outputs]
    fused = tfuse.optimize_plan(plan, refs)
    seen = set()
    for e in fused:
        deps = list(e[0].inputs or ()) + (list(e[5][1]) if e[5] else [])
        assert all(id(src) in seen for src, _ in deps), e[0].name
        seen.add(id(e[0]))
    report = tfuse.plan_report(fused, refs, tfuse.output_shapes(
        sym, data=shape))
    assert report["concat_grouped"] > 0
    outs = []
    for env in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_KERNELS", env)
        ex = sym.simple_bind(tmx.cpu(), data=shape)
        rs = np.random.RandomState(2)
        for k in sorted(ex.arg_dict):
            if k not in ("data", "softmax_label"):
                ex.arg_dict[k][:] = (rs.rand(*ex.arg_dict[k].shape)
                                     .astype("f") - 0.5) * 0.2
        ex.arg_dict["data"][:] = rs.rand(*shape).astype("f")
        outs.append(ex.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
