"""``mx.contrib.autograd`` in the PyTorch port against the JAX package, on
the CPU: the 17 cases of ``tests/test_autograd.py``, each run in both
packages on the same numpy inputs.

Every case returns the arrays it computed (outputs and gradients); the
port's must equal the JAX package's within rtol 1e-5 / atol 1e-6 (the
same float32 arithmetic; the bfloat16 case at 1e-2, as in the JAX test),
and each case also holds its own expected values as the JAX test does.
The random cases (Dropout) draw different masks in the two packages, so
they compare what does not depend on the draw: the gradient's support
equals the observed output's.

Further cases hold what the port's design must keep: a leaf does not
stay requiring grad after its section, an executor run inside a section
keeps its own gradients, a write into a tensor the graph saved is taken
functionally, and the imperative ``is_train`` default follows the
section.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _run(case, mx):
    if mx is tmx:
        with tmx.cpu():
            return case(mx)
    return case(mx)


def _ag(mx):
    return mx.contrib.autograd


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def case_unary_func(mx):
    ag = _ag(mx)
    x = mx.nd.array(np.random.RandomState(0).uniform(1, 2, (4, 5))
                    .astype(np.float32))
    res = {}
    for name, f in (("add", lambda x: x + 1), ("double", lambda x: x + x),
                    ("triple", lambda x: x * 3)):
        g, out = ag.grad_and_loss(f)(x)
        res[name + "_out"] = _np(out)
        res[name + "_grad"] = _np(g[0])
    np.testing.assert_allclose(res["double_grad"], 2 * np.ones((4, 5)))
    return res


def case_binary_func(mx):
    ag = _ag(mx)
    rs = np.random.RandomState(1)
    x = mx.nd.array(rs.uniform(1, 2, (3, 4)).astype(np.float32))
    y = mx.nd.array(rs.uniform(1, 2, (3, 4)).astype(np.float32))
    gm, om = ag.grad_and_loss(lambda a, b: a * b)(x, y)
    gd, od = ag.grad_and_loss(lambda a, b: a / b)(x, y)
    np.testing.assert_allclose(_np(gd[1]), -_np(x) / _np(y) ** 2,
                               rtol=1e-5)
    return {"mul": _np(om), "mul_dx": _np(gm[0]), "mul_dy": _np(gm[1]),
            "div": _np(od), "div_dx": _np(gd[0]), "div_dy": _np(gd[1])}


def case_operator_with_state(mx):
    ag = _ag(mx)
    rs = np.random.RandomState(2)
    a, b = (mx.nd.array(rs.uniform(size=(10, 64)).astype(np.float32))
            for _ in range(2))
    w = mx.nd.array(rs.uniform(size=(32, 64)).astype(np.float32))
    bias = mx.nd.array(rs.uniform(size=(32,)).astype(np.float32))

    def f(a, b, w, bias):
        return mx.nd.FullyConnected(a * b, w, bias, num_hidden=32)

    g, out = ag.grad_and_loss(f)(a, b, w, bias)
    expect = (np.ones((10, 32), np.float32) @ _np(w)) * _np(b)
    np.testing.assert_allclose(_np(g[0]), expect, rtol=1e-4, atol=1e-4)
    return {"out": _np(out), **{"g%d" % i: _np(v) for i, v in enumerate(g)}}


def case_argnum(mx):
    ag = _ag(mx)
    rs = np.random.RandomState(3)
    a = mx.nd.array(rs.uniform(size=(3, 2)).astype(np.float32))
    b = mx.nd.array(rs.uniform(size=(3, 2)).astype(np.float32))
    g, out = ag.grad_and_loss(lambda a, b, mode: a + b if mode else a * b,
                              argnum=0)(a, b, True)
    assert len(g) == 1
    np.testing.assert_allclose(_np(g[0]), np.ones((3, 2)))
    return {"out": _np(out), "g": _np(g[0])}


def case_training_dropout(mx):
    ag = _ag(mx)
    x = mx.nd.ones((10, 10))
    with ag.train_section():
        y = mx.nd.Dropout(x, p=0.5)
        dropped = not np.array_equal(_np(y), _np(x))
        with ag.test_section():
            y2 = mx.nd.Dropout(x, p=0.5)
            kept = np.array_equal(_np(y2), _np(x))
    assert dropped and kept
    return {"kept": np.array(kept), "dropped": np.array(dropped)}


def case_out_grads(mx):
    ag = _ag(mx)
    x = mx.nd.ones((3, 5))
    dx = mx.nd.zeros_like(x)
    ag.mark_variables([x], [dx])
    db = mx.nd.array(np.array([1, 2, 3, 4, 5], np.float32))
    dc = mx.nd.array(np.array([5, 4, 3, 2, 1], np.float32))
    with ag.train_section():
        parts = mx.nd.SliceChannel(x, num_outputs=3, axis=0,
                                   squeeze_axis=True)
        ag.backward(list(parts), out_grads=[mx.nd.ones((5,)), db, dc])
    ag.unmark_variables([x])
    expect = np.stack([np.ones(5, np.float32), _np(db), _np(dc)])
    np.testing.assert_allclose(_np(dx), expect)
    return {"dx": _np(dx)}


def case_detach_updated_grad(mx):
    ag = _ag(mx)
    x = mx.nd.ones((2, 2))
    dx = mx.nd.zeros_like(x)
    ag.mark_variables([x], [dx])
    with ag.train_section():
        ag.compute_gradient([x * x])
    x2 = mx.nd.ones((2, 2))
    dx2 = mx.nd.zeros_like(x2)
    ag.mark_variables([x2], [dx2], grad_reqs="add")
    with ag.train_section():
        ag.compute_gradient([x2 * 3])
        ag.compute_gradient([x2 * 5])
    ag.unmark_variables([x, x2])
    np.testing.assert_allclose(_np(dx), 2 * np.ones((2, 2)))
    np.testing.assert_allclose(_np(dx2), 8 * np.ones((2, 2)))
    return {"dx": _np(dx), "dx2": _np(dx2)}


def case_retain_graph(mx):
    ag = _ag(mx)
    x = mx.nd.ones((2, 2))
    dx = mx.nd.zeros_like(x)
    ag.mark_variables([x], [dx])
    with ag.train_section():
        y = x * x
        ag.backward([y], retain_graph=True)
        first = _np(dx).copy()
        ag.backward([y])
    ag.unmark_variables([x])
    np.testing.assert_allclose(first, _np(dx))
    return {"first": first, "second": _np(dx)}


def case_grad_decorator(mx):
    ag = _ag(mx)
    x = mx.nd.array(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
    g = ag.grad(lambda x: mx.nd.sum(x * x))(x)[0]
    np.testing.assert_allclose(_np(g), 2 * _np(x))
    return {"g": _np(g)}


def case_rng_replay_deterministic(mx):
    ag = _ag(mx)
    x = mx.nd.ones((50, 50))
    dx = mx.nd.zeros_like(x)
    ag.mark_variables([x], [dx])
    with ag.train_section():
        y = mx.nd.Dropout(x, p=0.5)
        y_np = _np(y)
        ag.compute_gradient([y])
    ag.unmark_variables([x])
    # the gradient's support is the observed output's, whatever was drawn
    np.testing.assert_array_equal(_np(dx) > 0, y_np > 0)
    np.testing.assert_allclose(_np(dx)[y_np > 0], 2.0)
    return {"support_equal": np.array(True)}


def case_is_recording(mx):
    ag = _ag(mx)
    states = [ag.is_recording()]
    with ag.train_section():
        states.append(ag.is_recording())
    states.append(ag.is_recording())
    assert states == [False, True, False]
    return {"states": np.array(states)}


def case_grads_through_views_and_inplace(mx):
    ag = _ag(mx)
    res = {}
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    dx = mx.nd.zeros_like(x)
    ag.mark_variables([x], [dx])
    with ag.train_section():
        y = (x * 2).reshape((6,))
        ag.backward([mx.nd.sum(y * y)])
    ag.unmark_variables([x])
    res["view"] = _np(dx)
    np.testing.assert_allclose(res["view"], 8 * _np(x))
    # an in-place operator on a leaf: linearized at the leaf's value
    x2 = mx.nd.ones((2, 2))
    dx2 = mx.nd.zeros_like(x2)
    ag.mark_variables([x2], [dx2])
    with ag.train_section():
        x2 += 1
        ag.backward([mx.nd.sum(x2 * x2)])
    ag.unmark_variables([x2])
    res["inplace"] = _np(dx2)
    res["inplace_value"] = _np(x2)
    np.testing.assert_allclose(res["inplace"], 4 * np.ones((2, 2)))
    # __setitem__ with a recorded value
    a = mx.nd.ones((3,))
    da = mx.nd.zeros_like(a)
    ag.mark_variables([a], [da])
    with ag.train_section():
        b = mx.nd.zeros((3,))
        b[1] = mx.nd.sum(a * 3)
        ag.backward([mx.nd.sum(b)])
    ag.unmark_variables([a])
    res["setitem"] = _np(da)
    np.testing.assert_allclose(res["setitem"], 3 * np.ones(3))
    return res


def case_stale_marks_not_clobbered(mx):
    ag = _ag(mx)
    f = lambda v: mx.nd.sum(v * v)  # noqa: E731
    g1 = ag.grad_and_loss(f)(mx.nd.ones((2,)))[0][0]
    first = _np(g1).copy()
    g2 = ag.grad_and_loss(f)(mx.nd.ones((2,)) * 2)[0][0]
    np.testing.assert_allclose(_np(g1), first)
    return {"g1": _np(g1), "g2": _np(g2)}


def case_single_ndarray_out_grads(mx):
    ag = _ag(mx)
    x = mx.nd.ones((3, 4))
    dx = mx.nd.zeros_like(x)
    ag.mark_variables([x], [dx])
    with ag.train_section():
        ag.backward(x * 2, out_grads=mx.nd.ones((3, 4)) * 5)
    ag.unmark_variables([x])
    np.testing.assert_allclose(_np(dx), 10 * np.ones((3, 4)))
    return {"dx": _np(dx)}


def case_nested_train_in_test_preserves_tape(mx):
    ag = _ag(mx)
    x = mx.nd.ones((2,))
    dx = mx.nd.zeros_like(x)
    ag.mark_variables([x], [dx])
    with ag.train_section():
        y = x * 3
        with ag.test_section():
            with ag.train_section():
                pass
        ag.compute_gradient([y])
    ag.unmark_variables([x])
    np.testing.assert_allclose(_np(dx), 3 * np.ones(2))
    return {"dx": _np(dx)}


def case_test_section_clears_training_flag(mx):
    ag = _ag(mx)
    flags = []
    with ag.train_section():
        flags.append(ag.is_training())
        with ag.test_section():
            flags += [ag.is_training(), ag.is_recording()]
        flags.append(ag.is_training())
    assert flags == [True, False, False, True]
    return {"flags": np.array(flags)}


def case_backward_casts_head_grads(mx):
    ag = _ag(mx)
    x = mx.nd.array(np.ones((2, 3), np.float32)).astype("bfloat16")
    gx = mx.nd.zeros((2, 3))
    with ag.train_section():
        ag.mark_variables([x], [gx])
        y = x * 2.0
        ag.backward([y], out_grads=[mx.nd.ones((2, 3)) * 3.0])
    ag.unmark_variables([x])
    np.testing.assert_allclose(_np(gx), np.full((2, 3), 6.0), rtol=1e-2,
                               atol=1e-2)
    return {"gx": _np(gx)}


CASES = [case_unary_func, case_binary_func, case_operator_with_state,
         case_argnum, case_training_dropout, case_out_grads,
         case_detach_updated_grad, case_retain_graph, case_grad_decorator,
         case_rng_replay_deterministic, case_is_recording,
         case_grads_through_views_and_inplace,
         case_stale_marks_not_clobbered, case_single_ndarray_out_grads,
         case_nested_train_in_test_preserves_tape,
         case_test_section_clears_training_flag,
         case_backward_casts_head_grads]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_autograd_case_matches_jax(case):
    ref = _run(case, jmx)
    got = _run(case, tmx)
    assert sorted(ref) == sorted(got)
    tol = 1e-2 if case is case_backward_casts_head_grads else RTOL
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=ATOL,
                                   err_msg=k)
    assert not tmx.contrib.autograd.is_recording()


def test_module_aliases():
    assert tmx.contrib.autograd.grad is tmx.autograd.grad
    assert sorted(tmx.autograd.__all__) == sorted(jmx.autograd.__all__)


def test_leaf_does_not_keep_requiring_grad():
    """After a section, neither the marked array nor a later op on it
    builds a graph."""
    ag = tmx.autograd
    with tmx.cpu():
        x = tmx.nd.ones((3,))
        g, loss = ag.grad_and_loss(lambda v: tmx.nd.sum(v * v))(x)
        assert not x._data.requires_grad
        assert not loss._data.requires_grad
        dx = tmx.nd.zeros((3,))
        ag.mark_variables([x], [dx])
        with ag.train_section():
            y = x * 2
        assert not x._data.requires_grad
        assert y._data.requires_grad        # the section's result
        z = y * 3                           # outside: no graph
        assert not z._data.requires_grad
        y[:] = 1.0                          # writes into the storage
        np.testing.assert_allclose(y.asnumpy(), np.ones(3))
        ag.unmark_variables([x])
        np.testing.assert_allclose(g[0].asnumpy(), 2 * np.ones(3))


def test_setitem_into_saved_tensor_while_recording():
    """``b`` is saved by ``b * b``'s graph; writing into it afterwards
    must not change the gradient (torch's version counter would raise on
    an in-place write)."""
    ag = tmx.autograd
    with tmx.cpu():
        a = tmx.nd.array(np.array([1.0, 2.0, 3.0], np.float32))
        da = tmx.nd.zeros((3,))
        ag.mark_variables([a], [da])
        with ag.train_section():
            b = a * 1.0
            loss = tmx.nd.sum(b * b)
            b[:] = 0.0
            b.copyto(a)
            ag.backward([loss])
        ag.unmark_variables([a])
        np.testing.assert_allclose(da.asnumpy(), [2.0, 4.0, 6.0])
        np.testing.assert_allclose(a.asnumpy(), [0.0, 0.0, 0.0])


def test_executor_inside_section_keeps_its_gradients():
    """An executor run inside a train section uses its own leaves: its
    gradients equal the same run outside any section."""
    rs = np.random.RandomState(4)
    with tmx.cpu():
        data = tmx.sym.Variable("data")
        net = tmx.sym.FullyConnected(data, num_hidden=3, name="fc")
        net = tmx.sym.MakeLoss(tmx.sym.sum(tmx.sym.tanh(net)))
        vals = {"data": rs.randn(4, 5).astype(np.float32),
                "fc_weight": rs.randn(3, 5).astype(np.float32),
                "fc_bias": rs.randn(3).astype(np.float32)}

        def run():
            args = {k: tmx.nd.array(v) for k, v in vals.items()}
            grads = {k: tmx.nd.zeros(v.shape) for k, v in vals.items()}
            ex = net.bind(tmx.cpu(), args, args_grad=grads)
            ex.forward(is_train=True)
            ex.backward()
            return {k: g.asnumpy() for k, g in grads.items()}

        plain = run()
        x = tmx.nd.ones((2,))
        ag = tmx.autograd
        with ag.train_section():
            ag.mark_variables([x], [tmx.nd.zeros((2,))])
            inside = run()
        ag.unmark_variables([x])
    for k in plain:
        np.testing.assert_array_equal(inside[k], plain[k])


def test_imperative_is_train_follows_section():
    """``mx.nd`` ops take ``is_train`` from the section, as the JAX
    package's ``_TRAIN_MODE`` gives them: BatchNorm normalizes with batch
    statistics inside a train section and with the moving ones in a test
    section."""
    rs = np.random.RandomState(5)
    x_np = rs.randn(8, 3).astype(np.float32) * 2 + 1
    res = {}
    for mx in (jmx, tmx):
        def body():
            x = mx.nd.array(x_np)
            g, b = mx.nd.ones((3,)), mx.nd.zeros((3,))
            mm, mv = mx.nd.zeros((3,)), mx.nd.ones((3,))
            ag = mx.contrib.autograd
            with ag.train_section():
                tr = mx.nd.BatchNorm(x, g, b, mm, mv, fix_gamma=False)
                with ag.test_section():
                    te = mx.nd.BatchNorm(x, g, b, mm, mv, fix_gamma=False)
            # the JAX package also returns the aux updates
            first = [o[0] if isinstance(o, list) else o for o in (tr, te)]
            return tuple(o.asnumpy() for o in first)
        res[mx] = _run(lambda _m: body(), mx)
    for a, b in zip(res[jmx], res[tmx]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    assert abs(res[tmx][0].mean()) < 1e-5       # batch statistics
    np.testing.assert_allclose(res[tmx][1], x_np / np.sqrt(1 + 1e-3),
                               rtol=1e-5)
