"""Every op that ``mxnet_tpu/ops/tensor.py`` registers, in the PyTorch
port against the JAX package, on the CPU, from the same seeded numpy
inputs.

``test_registry_covers_the_tensor_ops`` holds the port's registry to the
reference's: every name (aliases included) ``mxnet_tpu/ops/tensor.py``
registers, with the same canonical op, aliases, input names, attributes,
output count and ``needs_rng``/``hidden``/``variable_inputs`` flags.
The cases (inputs, domains with deliberate ties, attributes, dtypes) are
``chip_smoke.tensor_op_cases``, which the card's sweep runs at (64, 257);
here they run at (3, 7).  ``test_forward`` runs each op's function on
both sides, per dtype
(float32 always, float16 and bfloat16 where the op takes floats, int32
where the reference takes it) and compares result dtype and values:

- exact for integer results and for comparison, logic, indexing and
  ordering ops (their inputs hold deliberate ties);
- float32: rtol 1e-5 / atol 1e-6 (both sides compute in float32, in
  other orders); transcendental ops rtol 1e-4 / atol 1e-6 (the two
  libraries' float32 ``exp``/``log``/``erf``/... differ by a few ulp);
- float16 and bfloat16: rtol 1e-2 / atol 1e-2 (a few ulp of 2^-8 on
  O(1) values; both round the same float32 inputs).

``test_gradient`` binds the differentiable ops through ``simple_bind``
in both packages, runs ``forward(is_train=True)`` and ``backward`` with
a seeded head gradient, and holds every input gradient within 1e-4
relative L2 (1e-5 elementwise of the largest magnitude).  The samplers
have no cross-package stream to match: ``test_sampler_moments`` checks
seed determinism and the mean and variance within 5 standard errors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import OP_REGISTRY as JREG
from mxnet_tpu_torch.ops.registry import OP_REGISTRY as TREG

from chip_smoke import (HALF_TYPES, case_attrs, draw_tensor_inputs,
                        input_dtypes, tensor_case_id, tensor_op_cases)

#: the sweep's cases at a small shape (the smoke runs them at (64, 257))
CASES = tensor_op_cases(3, 7)


def _cast(x, dtype):
    """(jax array, torch tensor) of float32/int32 numpy ``x`` in dtype —
    both round the same float32 values."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(x)).to(
        tmx.ops.tensor.torch_dtype(dtype))
    return j, t


def _params():
    for case in CASES:
        for dtype in case["dtypes"]:
            yield pytest.param(case, dtype, id=tensor_case_id(case, dtype))


def _as_np(x):
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy(), name
    x = np.asarray(x)
    name = x.dtype.name
    return x.astype(np.float32) if name == "bfloat16" else x, name


def _tolerance(case, dtype, out_dtype):
    if case["kind"] == "exact" or not out_dtype.startswith(("float",
                                                            "bfloat")):
        return 0.0, 0.0
    if dtype in HALF_TYPES or out_dtype in HALF_TYPES:
        return 1e-2, 1e-2
    if case["kind"] == "trans":
        return 1e-4, 1e-6
    return 1e-5, 1e-6


def _run_both(case, dtype, arrays):
    """(jax outputs, torch outputs) of the op's function."""
    jins, tins = [], []
    for a, d in zip(arrays, input_dtypes(case, dtype)):
        j, t = _cast(a, d)
        jins.append(j)
        tins.append(t)
    attrs = case_attrs(case, dtype)
    jout = JREG[case["op"]].fn(*jins, **attrs)
    tout = TREG[case["op"]].fn(*tins, **attrs)
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    return jout, tout


@pytest.mark.parametrize("case, dtype", list(_params()))
def test_forward(case, dtype):
    arrays = draw_tensor_inputs(case, dtype, seed=len(case["op"]))
    jout, tout = _run_both(case, dtype, arrays)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        jv, jname = _as_np(j)
        tv, tname = _as_np(t)
        assert tname == jname, (tname, jname)
        assert tv.shape == jv.shape, (tv.shape, jv.shape)
        rtol, atol = _tolerance(case, dtype, jname)
        if rtol == 0.0:
            np.testing.assert_array_equal(tv, jv)
        else:
            np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)


def _grad_params():
    for case in CASES:
        if case["grad"] and "float32" in case["dtypes"] and case["inputs"]:
            yield pytest.param(case, id=tensor_case_id(case))


def _bound_grads(mx, case, arrays, head):
    """Input gradients of the op through simple_bind -> forward(is_train)
    -> backward(head) on the CPU, and its forward output."""
    names = ["in%d" % i for i in range(len(arrays))]
    diff = [n for n, (domain, _) in zip(names, case["inputs"])
            if domain not in ("index", "bool")]
    op = getattr(mx.sym, case["op"])
    net = op(*[mx.sym.Variable(n) for n in names], **case["attrs"])
    ex = net.simple_bind(mx.cpu(), grad_req={n: "write" if n in diff
                                             else "null" for n in names},
                         **{n: a.shape for n, a in zip(names, arrays)})
    for n, a in zip(names, arrays):
        ex.arg_dict[n][:] = a
    ex.forward(is_train=True)
    ex.backward(out_grads=[mx.nd.array(head, ctx=mx.cpu(),
                                       dtype=head.dtype)])
    return ([ex.grad_dict[n].asnumpy() for n in diff],
            ex.outputs[0].asnumpy())


@pytest.mark.parametrize("case", list(_grad_params()))
def test_gradient(case):
    arrays = draw_tensor_inputs(case, "float32", seed=len(case["op"]) + 1)
    jout, _ = _run_both(case, "float32", arrays)
    # the head gradient in the output's dtype (Cast to float16 gives one)
    out = np.asarray(jout[0])
    head = np.random.RandomState(7).standard_normal(out.shape).astype(
        out.dtype)
    jg, jo = _bound_grads(jmx, case, arrays, head)
    tg, to = _bound_grads(tmx, case, arrays, head)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-6)
    assert len(jg) == len(tg)
    for j, t in zip(jg, tg):
        scale = max(float(np.abs(j).max()), 1e-30)
        num = float(np.sqrt(np.sum((t.astype(np.float64) - j) ** 2)))
        den = float(np.sqrt(np.sum(j.astype(np.float64) ** 2)))
        assert num <= 1e-4 * max(den, 1e-30) or num == 0.0, (num, den)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * scale + 1e-7)


def _tensor_names():
    return sorted(n for n, op in JREG.items()
                  if op.fn.__module__ == "mxnet_tpu.ops.tensor")


def _public(accepted):
    return None if accepted is None else \
        {a for a in accepted if not a.startswith("_")}


def test_registry_covers_the_tensor_ops():
    names = _tensor_names()
    canonical = {JREG[n].name for n in names}
    assert len(canonical) == 152 and len(names) == 228
    missing = [n for n in names if n not in TREG]
    assert not missing, missing
    for n in names:
        j, t = JREG[n], TREG[n]
        assert t.name == j.name, n
        assert t.aliases == j.aliases, n
        for attrs in ({}, {"num_args": 3, "ret_typ": "both"}):
            assert t.get_input_names(attrs) == j.get_input_names(attrs), n
            assert t.get_aux_names(attrs) == j.get_aux_names(attrs), n
            assert t.get_num_outputs(attrs) == j.get_num_outputs(attrs), n
        assert (t.needs_rng, t.needs_is_train, t.hidden,
                t.variable_inputs) == (j.needs_rng, j.needs_is_train,
                                       j.hidden, j.variable_inputs), n
        assert _public(t.accepted_attrs()) == _public(j.accepted_attrs()), n
    ported = {n for n in canonical if n in tmx.ops.registry.list_ops()}
    assert ported == canonical


def test_every_tensor_op_has_a_sweep_case():
    from chip_smoke import SAMPLERS
    covered = {c["op"] for c in CASES} | {s[0] for s in SAMPLERS}
    assert covered == {JREG[n].name for n in _tensor_names()}


def test_list_ops_lists_canonical_names_with_hidden_ones():
    ops = tmx.ops.registry.list_ops()
    jops = jmx.ops.registry.list_ops()
    assert ops == sorted(set(ops))
    assert "_CrossDeviceCopy" in ops and "_slice_assign" in ops
    assert "broadcast_plus" not in ops and "broadcast_add" in ops
    # every canonical name the port registers is one of the reference's
    # (rtc ops that tests register at run time aside)
    assert {n for n in ops if TREG[n].fn.__module__.startswith(
        "mxnet_tpu_torch.ops")} <= set(jops)


@pytest.mark.parametrize("op, attrs, mean, var", [
    ("_sample_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
    ("_sample_normal", {"loc": 0.5, "scale": 2.0}, 0.5, 4.0),
    ("_sample_gamma", {"alpha": 2.0, "beta": 1.5}, 3.0, 4.5),
], ids=["uniform", "normal", "gamma"])
def test_sampler_moments(op, attrs, mean, var):
    n = 200000
    host = tmx.cpu()
    draws = []
    for _ in range(2):
        tmx.random.seed(3)
        draws.append(getattr(tmx.nd, op)(shape=(n,), ctx=host, **attrs)
                     .asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    x = draws[0].astype(np.float64)
    assert x.dtype == np.float64 and draws[0].dtype == np.float32
    assert abs(x.mean() - mean) <= 5 * np.sqrt(var / n)
    # the sample variance's standard error, from the 4th central moment
    m4 = np.mean((x - x.mean()) ** 4)
    assert abs(x.var() - var) <= 5 * np.sqrt((m4 - var ** 2) / n)
    jx = np.asarray(getattr(jmx.nd, op)(shape=(n,), **attrs).asnumpy(),
                    np.float64)
    assert abs(jx.mean() - mean) <= 5 * np.sqrt(var / n)
    tmx.random.seed(4)
    assert not np.array_equal(
        getattr(tmx.nd, op)(shape=(n,), ctx=host, **attrs).asnumpy(),
        draws[0])


def test_prod_gradient_with_zeros_matches_jax():
    """The port's prod backward (exclusive cumulative products, no host
    check for zeros) at inputs with one and with two zeros in a row."""
    import jax
    x = np.array([[2.0, 0.0, 3.0, -1.5], [0.0, 4.0, 0.0, 2.0],
                  [1.5, -2.0, 0.5, 3.0]], np.float32)
    for axis in (0, 1):
        jg = np.asarray(jax.grad(lambda v: jnp.sum(
            JREG["prod"].fn(v, axis=axis) * jnp.arange(1.0, 5 - axis)))(
                jnp.asarray(x)))
        t = torch.from_numpy(x.copy()).requires_grad_(True)
        out = TREG["prod"].fn(t, axis=axis)
        (out * torch.arange(1.0, 5 - axis)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", list(HALF_TYPES))
@pytest.mark.parametrize("op", ["sum", "mean", "nansum", "norm"])
def test_long_half_reductions_accumulate_in_float32(op, dtype):
    """Over 82245 elements (the card sweep's size), where a sum kept in
    the half type drifts by several of its ulps (torch's CPU sum did:
    -6.69 against the reference's -6.93 in float16)."""
    cases = tensor_op_cases(64, 257)
    k, case = next((k, c) for k, c in enumerate(cases)
                   if c["op"] == "sum" and c["tag"] == "all")
    x, = draw_tensor_inputs(case, "float32", k)   # the card sweep's input
    j, t = _cast(x, dtype)
    jv, _ = _as_np(JREG[op].fn(j))
    tv, _ = _as_np(TREG[op].fn(t))
    exact = {"sum": np.sum, "mean": np.mean, "nansum": np.sum,
             "norm": lambda v: np.sqrt(np.sum(v * v))}[op](
        np.asarray(j.astype(jnp.float32), np.float64))
    ulp = 2.0 ** (-10 if dtype == "float16" else -7) * abs(exact)
    if np.isfinite(jv):
        assert abs(float(jv) - exact) <= ulp
    np.testing.assert_array_equal(tv, jv)
