"""Testing utilities (port of ``mxnet_tpu/test_utils.py``; reference
python/mxnet/test_utils.py).

Provides the reference's three numeric oracles:
- ``check_numeric_gradient``: finite differences vs symbolic backward
- ``check_symbolic_forward`` / ``check_symbolic_backward``: vs numpy refs
- ``check_consistency``: same graph on two device types — here
  ``check_consistency(sym, [cpu(), gpu(0)], shapes=...)``, the
  reference's cpu-against-accelerator check (``is_train=True`` runs the
  training forward and backward and compares the gradients too)
"""
from __future__ import annotations

import numpy as np

from .base import get_env, register_env
from .context import Context, current_context
from .ndarray import NDArray, array as nd_array

ENV_TEST_DEVICE = register_env(
    "MXNET_TEST_DEVICE", scope="test",
    doc="Overrides test_utils.default_context() (e.g. cpu:0)")

__all__ = [
    "default_context", "assert_almost_equal", "rand_ndarray", "rand_shape_nd",
    "check_numeric_gradient", "check_symbolic_forward", "check_symbolic_backward",
    "check_consistency", "simple_forward",
]


def default_context():
    """Context under test — switchable via MXNET_TEST_DEVICE (reference
    test_utils.py default_context via env); ``gpu(0)`` otherwise, the
    port's default."""
    dev = get_env(ENV_TEST_DEVICE)
    if dev:
        name, _, idx = dev.partition(":")
        return Context(name, int(idx or 0))
    return current_context()


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    if isinstance(a, NDArray):
        a = a.asnumpy()
    if isinstance(b, NDArray):
        b = b.asnumpy()
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               err_msg="%s vs %s" % names)


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, ctx=None, dtype=np.float32):
    return nd_array(np.random.uniform(-1, 1, size=shape).astype(dtype), ctx=ctx)


def _as_numpy_dict(location, arg_names):
    if isinstance(location, dict):
        return {k: (v.asnumpy() if isinstance(v, NDArray) else np.asarray(v, dtype=np.float32))
                for k, v in location.items()}
    return {name: (v.asnumpy() if isinstance(v, NDArray) else np.asarray(v, dtype=np.float32))
            for name, v in zip(arg_names, location)}


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    ctx = ctx or default_context()
    ex = sym.bind(ctx, {k: nd_array(v, ctx=ctx) for k, v in inputs.items()})
    outputs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    return outputs[0] if len(outputs) == 1 else outputs


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-5,
                           aux_states=None, ctx=None):
    ctx = ctx or default_context()
    loc = _as_numpy_dict(location, sym.list_arguments())
    args = {k: nd_array(v, ctx=ctx) for k, v in loc.items()}
    aux = {k: nd_array(v, ctx=ctx) for k, v in (aux_states or {}).items()} or None
    ex = sym.bind(ctx, args, aux_states=aux)
    outputs = ex.forward()
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out.asnumpy(), exp, rtol=rtol, atol=atol)
    return [o.asnumpy() for o in outputs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-5, aux_states=None, grad_req="write",
                            ctx=None):
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    loc = _as_numpy_dict(location, arg_names)
    args = {k: nd_array(v, ctx=ctx) for k, v in loc.items()}
    grads = {k: nd_array(np.zeros_like(v), ctx=ctx) for k, v in loc.items()}
    aux = {k: nd_array(v, ctx=ctx) for k, v in (aux_states or {}).items()} or None
    ex = sym.bind(ctx, args, args_grad=grads, grad_req=grad_req,
                  aux_states=aux)
    ex.forward(is_train=True)
    ex.backward([nd_array(g, ctx=ctx) for g in out_grads])
    expected = expected if isinstance(expected, dict) else \
        dict(zip(arg_names, expected))
    for name, exp in expected.items():
        assert_almost_equal(grads[name].asnumpy(), exp, rtol=rtol, atol=atol,
                            names=("grad(%s)" % name, "expected"))
    return {k: v.asnumpy() for k, v in grads.items()}


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=1e-4, grad_nodes=None, ctx=None):
    """Finite-difference gradient check (reference test_utils.py
    check_numeric_gradient): perturb each input element, compare the numeric
    d(sum(outputs*proj))/dx against the symbolic backward."""
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    loc = _as_numpy_dict(location, arg_names)
    grad_nodes = grad_nodes or [n for n in arg_names if n in loc]

    # random fixed projection so a vector output reduces to a scalar
    _, out_shapes, _ = sym.infer_shape(**{k: v.shape for k, v in loc.items()})
    proj = [np.random.normal(0, 1.0, size=s).astype(np.float32)
            for s in out_shapes]

    args = {k: nd_array(v, ctx=ctx) for k, v in loc.items()}
    grads = {k: nd_array(np.zeros_like(v), ctx=ctx) for k, v in loc.items()}
    aux = {k: nd_array(v, ctx=ctx) for k, v in (aux_states or {}).items()} or None
    ex = sym.bind(ctx, args, args_grad=grads, grad_req="write", aux_states=aux)
    ex.forward(is_train=True)
    ex.backward([nd_array(p, ctx=ctx) for p in proj])
    sym_grads = {k: grads[k].asnumpy().copy() for k in grad_nodes}

    def fwd_scalar():
        # is_train=True so the finite-difference probes the same function the
        # symbolic backward differentiated (BatchNorm batch-stats path etc.)
        outs = ex.forward(is_train=True)
        return sum(float((o.asnumpy() * p).sum()) for o, p in zip(outs, proj))

    for name in grad_nodes:
        base = loc[name].copy()
        numeric = np.zeros_like(base)
        flat = base.reshape(-1)
        num_flat = numeric.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + numeric_eps
            args[name][:] = base
            fp = fwd_scalar()
            flat[i] = orig - numeric_eps
            args[name][:] = base
            fm = fwd_scalar()
            flat[i] = orig
            args[name][:] = base
            num_flat[i] = (fp - fm) / (2 * numeric_eps)
        np.testing.assert_allclose(
            sym_grads[name], numeric, rtol=rtol, atol=atol,
            err_msg="numeric vs symbolic gradient mismatch for %s" % name)


def check_consistency(sym, ctx_list, scale=1.0, rtol=1e-3, atol=1e-4,
                      shapes=None, is_train=False):
    """Run the same symbol on several contexts and compare outputs
    (reference test_utils.py check_consistency, used by
    tests/python/gpu/test_operator_gpu.py for cpu-vs-gpu).

    ``ctx_list`` holds contexts, or ``{"ctx": ctx, "shapes": {...}}``
    dicts as in the JAX package; ``shapes`` is the input shapes for
    entries that carry none.  With ``is_train`` each context runs the
    training forward and a backward of ones, and the argument gradients
    are compared too.  Returns the per-context output lists."""
    if not ctx_list:
        return
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    specs = [c if isinstance(c, dict) else {"ctx": c} for c in ctx_list]
    shapes = specs[0].get("shapes", shapes)
    outputs = []
    grads = []
    arg_vals = None
    aux_vals = None
    for spec in specs:
        ctx = spec["ctx"]
        shapes = spec.get("shapes", shapes)
        arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**shapes)
        if arg_vals is None:
            arg_vals = {n: (np.random.normal(0, scale, size=s).astype(np.float32))
                        for n, s in zip(arg_names, arg_shapes)}
            # aux convention: running means 0, running variances 1
            aux_vals = {n: (np.ones(s, np.float32) if "var" in n
                            else np.zeros(s, np.float32))
                        for n, s in zip(aux_names, aux_shapes)}
        args = {k: nd_array(v, ctx=ctx) for k, v in arg_vals.items()}
        aux = {k: nd_array(v, ctx=ctx) for k, v in aux_vals.items()} or None
        if is_train:
            gbufs = {k: nd_array(np.zeros_like(v), ctx=ctx)
                     for k, v in arg_vals.items()}
            ex = sym.bind(ctx, args, args_grad=gbufs, grad_req="write",
                          aux_states=aux)
            outs = ex.forward(is_train=True)
            ex.backward([nd_array(np.ones(s, np.float32), ctx=ctx)
                         for s in out_shapes])
            grads.append({k: v.asnumpy() for k, v in gbufs.items()})
        else:
            ex = sym.bind(ctx, args, aux_states=aux)
            outs = ex.forward()
        outputs.append([o.asnumpy() for o in outs])
    for other in outputs[1:]:
        for a, b in zip(outputs[0], other):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    for other in grads[1:]:
        for k, g in other.items():
            np.testing.assert_allclose(grads[0][k], g, rtol=rtol, atol=atol,
                                       err_msg="grad(%s)" % k)
    return outputs
