"""The port's ``SPMDTrainer`` against the JAX package's on the CPU: a
ResNet-8 (3x16x16, 10 classes) at batch 4 with bench.py's sgd settings
(lr 0.1, momentum 0.9, wd 1e-4, rescale_grad 1/batch), both started from
identical numpy weights and fed the same seeded batches.

Tolerance: rtol 1e-4, atol 1e-5 on outputs each step and on params and
aux after the last step — float32 on both sides, the convolutions, their
backwards and the BatchNorm sums taken in other orders, carried through
several updates."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
import mxnet_tpu_torch as tmx

BATCH = 4
IMAGE = (3, 16, 16)
RTOL, ATOL = 1e-4, 1e-5
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
               "rescale_grad": 1.0 / BATCH})


def _symbol(mx):
    return mx.models.get_symbol("resnet", num_layers=8, num_classes=10,
                                image_shape=IMAGE)


def _trainer(mx, optimizer=SGD, **kw):
    if mx is tmx:
        kw.setdefault("ctx", tmx.cpu())
        cls = tmx.parallel.SPMDTrainer
    else:
        cls = JaxTrainer
    tr = cls(_symbol(mx), optimizer[0], dict(optimizer[1]), mesh=None, **kw)
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    return tr


def _weights(seed=50):
    """Seeded numpy weights: He-normal convs and FC, non-trivial gamma,
    beta and moving statistics."""
    rs = np.random.RandomState(seed)
    sym = _symbol(tmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH,) + IMAGE)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            std = np.sqrt(2.0 / np.prod(s[1:]))
            args[n] = (std * rs.standard_normal(s)).astype(np.float32)
        elif n.endswith("_gamma"):
            args[n] = rs.uniform(0.8, 1.2, s).astype(np.float32)
        else:
            args[n] = (0.1 * rs.standard_normal(s)).astype(np.float32)
    aux = {n: (rs.uniform(0.8, 1.2, s) if n.endswith("_var")
               else 0.1 * rs.standard_normal(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _batches(n, seed=51):
    rs = np.random.RandomState(seed)
    return [(rs.standard_normal((BATCH,) + IMAGE).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.float32)) for _ in range(n)]


def _run_both(steps, optimizer=SGD, **kw):
    args, aux = _weights()
    trainers = []
    for mx in (jmx, tmx):
        tr = _trainer(mx, optimizer, **kw)
        tr.init_params(None, arg_params=args, aux_params=aux)
        trainers.append(tr)
    outs = []
    for x, y in _batches(steps):
        outs.append([np.asarray(trainers[0].step(x, y)[0], np.float32),
                     trainers[1].step(x, y)[0].float().numpy()])
    return trainers, outs


def _params_numpy(tr):
    args, aux = tr.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _assert_params_close(j, t, rtol=RTOL, atol=ATOL):
    for jd, td in zip(_params_numpy(j), _params_numpy(t)):
        assert set(jd) == set(td)
        for k in jd:
            np.testing.assert_allclose(td[k], jd[k], rtol=rtol, atol=atol,
                                       err_msg=k)


def test_sgd_five_steps_match_jax():
    (j, t), outs = _run_both(5)
    for step, (jo, to) in enumerate(outs):
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL,
                                   err_msg="step %d" % step)
    _assert_params_close(j, t)
    start_args, start_aux = _weights()
    t_args, t_aux = _params_numpy(t)
    assert not np.allclose(t_args["conv0_weight"], start_args["conv0_weight"])
    assert not np.allclose(t_aux["bn1_moving_var"], start_aux["bn1_moving_var"])
    # the gammas kept their weight decay under momentum: both packages
    # moved them the same way (checked above), and the optimizer says so
    assert "bn1_gamma" not in t.optimizer.wd_mult
    assert t.skipped_steps == 0 and t._num_update == 5
    assert all(not v.requires_grad for v in t.params.values())


def test_adam_three_steps_match_jax():
    """Adam with its bias correction from the update count.  epsilon is
    1e-4: Adam's first steps move each weight by about lr whatever the
    size of its gradient, so with the default 1e-8 a gradient at float32
    noise level (a sum that should be 0) decides a whole step by its
    sign, and the two packages' noise differs; 1e-4 keeps such gradients
    from deciding, and the test compares the rule."""
    adam = ("adam", {"learning_rate": 0.01, "wd": 1e-4, "epsilon": 1e-4,
                     "rescale_grad": 1.0 / BATCH})
    (j, t), outs = _run_both(3, adam)
    for jo, to in outs:
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    _assert_params_close(j, t)
    assert t._num_update == 3


def test_nan_batch_is_skipped_in_both():
    """A NaN batch makes the gradients non-finite: the guard leaves
    params, aux and optimizer state as they were, and the skip shows one
    step late, at the next flush, rolling the update count back."""
    args, aux = _weights()
    x, y = _batches(1)[0]
    bad = np.full_like(x, np.nan)
    for mx in (jmx, tmx):
        tr = _trainer(mx)
        tr.init_params(None, arg_params=args, aux_params=aux)
        tr.step(x, y)
        before = _params_numpy(tr)
        tr.step(bad, y)
        assert tr.skipped_steps == 1 and tr.consecutive_bad_steps == 1
        assert tr._num_update == 1
        after = _params_numpy(tr)
        for b, a in zip(before, after):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        tr.step(x, y)
        assert tr.consecutive_bad_steps == 0 and tr.skipped_steps == 1


def test_bfloat16_compute_step_matches_jax():
    """compute_dtype='bfloat16': a bfloat16 copy of the float32 master
    per step, batches cast on the way in, the update in float32.  One
    step: the outputs (probabilities) agree within 2e-2 absolute.  The
    parameter step comes from bfloat16 gradients whose batch sums carry
    errors up to about half the step here (in both packages, in
    different places), so each parameter tensor must land within one
    float32 step size of the JAX package's bfloat16 result and of the
    port's own float32 step."""
    (j, t), outs = _run_both(1, compute_dtype="bfloat16")
    np.testing.assert_allclose(outs[0][1], outs[0][0], rtol=0, atol=2e-2)
    start, _ = _weights()
    ref = _trainer(tmx)
    ref.init_params(None, arg_params=start, aux_params=_weights()[1])
    ref.step(*_batches(1)[0])
    (j_args, _), (t_args, _) = _params_numpy(j), _params_numpy(t)
    r_args, _ = _params_numpy(ref)
    for k in start:
        assert t.params[k].dtype == torch.float32
        step = np.abs(r_args[k] - start[k]).max()
        assert step > 0, k
        assert np.abs(t_args[k] - j_args[k]).max() <= step, k
        assert np.abs(t_args[k] - r_args[k]).max() <= step, k


def test_later_slice_arguments_raise(monkeypatch):
    sym = _symbol(tmx)
    for kw in (dict(mesh=object()), dict(grad_sync="zero"),
               dict(plan={}), dict(remat=True),
               dict(param_shardings={".*": ("tp",)})):
        with pytest.raises(tmx.MXNetError, match="not ported yet"):
            tmx.parallel.SPMDTrainer(sym, ctx=tmx.cpu(), **kw)
    tr = _trainer(tmx)
    with pytest.raises(tmx.MXNetError, match="not ported yet"):
        tr.install_metric(lambda outs, data: (0.0, 0.0))
    with pytest.raises(tmx.MXNetError, match="not ported yet"):
        tr.install_watchdog(object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="CUDA is not available"):
        tmx.parallel.SPMDTrainer(sym)      # default context: gpu(0)


def test_eval_forward_only_and_set_params():
    args, aux = _weights()
    x, y = _batches(1)[0]
    outs = {}
    for mx in (jmx, tmx):
        tr = _trainer(mx)
        tr.init_params(None, arg_params=args, aux_params=aux)
        outs[mx] = ([np.asarray(tr.eval_step(x, y)[0], np.float32)
                     for _ in range(1)] +
                    [np.asarray(tr.forward_only(x, y)[0], np.float32)])
    for jo, to in zip(outs[jmx], outs[tmx]):
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=ATOL)
    tr = _trainer(tmx)
    tr.init_params(tmx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    assert tr.aux["bn1_moving_var"].eq(1).all()
    tr.set_params(args, aux)
    got_args, got_aux = tmx.convert.params_to_numpy(*tr.get_params())
    np.testing.assert_array_equal(got_args["fc1_weight"], args["fc1_weight"])
    np.testing.assert_array_equal(got_aux["bn1_moving_mean"],
                                  aux["bn1_moving_mean"])
    # the trainer's own tensors convert the same way
    np.testing.assert_array_equal(
        tmx.convert.params_to_numpy(tr.params)["fc1_weight"],
        args["fc1_weight"])
    tr.close()
    assert tr.params is None
