"""The contrib ops of ``mxnet_tpu_torch/ops/contrib.py`` (MultiBoxPrior,
MultiBoxTarget, MultiBoxDetection, Proposal, fft, ifft, count_sketch)
against the JAX package's on the CPU, on the same numpy inputs from a
seed, float32.  The JAX ops run under ``jax.jit``, as the JAX package's
executor and imperative calls run them (XLA compiles a division by a
constant as a multiply by its reciprocal there).

Tolerances:
- MultiBoxPrior: within 1 ulp of the op run op by op (Python's float64
  ``sqrt(ratio)`` is rounded where it meets float32 centres; both do so),
  and within 1 ulp of 1.0 (2**-23) of the jitted op, where XLA contracts
  some centres' products and corner offsets into fused multiply-adds.
- MultiBoxTarget: ``cls_target`` and ``loc_mask`` exact (the matching,
  the ties and the mining ranks are the JAX package's); ``loc_target``
  within 1e-6 absolute (one ``log`` of each side's math library).
- MultiBoxDetection and Proposal: class ids, scores and the row order
  exact; coordinates within 2 ulp of 1.0 (2.4e-7) in MultiBoxDetection's
  normalized units and of 64 (1.6e-5) in Proposal's pixels: one ``exp``
  of each side's library, and XLA contracts the decode's multiply and add
  into one fused multiply-add (a corner near 0 is a difference of two
  values near the centre, so the bound is absolute).
- fft/ifft: 1e-5 relative to the largest magnitude (pocketfft against
  XLA's FFT, sums in other orders); count_sketch exact (each output sums
  the same terms in the same order), its gradients within 1e-6 relative,
  1e-7 absolute (s's gradient sums over the batch in XLA's order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import contrib as jc
from mxnet_tpu_torch.ops import contrib as tc


COORD_ATOL = 2.4e-7
PIXEL_ATOL = 1.6e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(a)


def _jit(fn, **kw):
    """The JAX op with its attributes bound, jitted."""
    return jax.jit(lambda *a: fn(*a, **kw))


def _anchors(h=6, w=6, sizes=(0.3, 0.5), ratios=(1, 2, 0.5)):
    return np.asarray(jc.multibox_prior(jnp.zeros((1, 3, h, w)),
                                        sizes=sizes, ratios=ratios))


PRIOR_CASES = {
    "ssd_toy": dict(sizes=(0.2, 0.35), ratios=(1, 2, 0.5)),
    "ssd512_ratio3": dict(sizes=(0.1, 0.141), ratios=(1, 2, .5, 3, 1 / 3.)),
    "clip_steps_offsets": dict(sizes=(0.5, 0.9), ratios=(1, 3), clip=True,
                               steps=(0.1, 0.2), offsets=(0.3, 0.6)),
    "one_size": dict(sizes=0.75, ratios=1),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_multibox_prior(case):
    kw = PRIOR_CASES[case]
    d = np.zeros((2, 3, 5, 7), np.float32)
    want = np.asarray(_jit(jc.multibox_prior, **kw)(_j(d)))
    got = tc.multibox_prior(_t(d), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
    np.testing.assert_array_max_ulp(
        got, np.asarray(jc.multibox_prior(_j(d), **kw)), maxulp=1)


def test_multibox_prior_through_contrib_namespaces():
    d = np.zeros((1, 3, 4, 4), np.float32)
    got = tmx.nd.contrib.MultiBoxPrior(tmx.nd.array(d, ctx=tmx.cpu()),
                                       sizes=[0.5, 0.25], ratios=[1, 2])
    want = jmx.contrib.nd.MultiBoxPrior(jmx.nd.array(d), sizes=[0.5, 0.25],
                                        ratios=[1, 2])
    np.testing.assert_array_max_ulp(got.asnumpy(), want.asnumpy(), maxulp=1)
    s = tmx.sym.contrib.MultiBoxPrior(tmx.sym.Variable("data"),
                                      sizes=[0.5], ratios=[1])
    assert s.infer_shape(data=(1, 3, 4, 4))[1] == [(1, 16, 4)]


def _det_labels(rs, n, o, classes):
    """(n, o, 5) rows (cls, x1, y1, x2, y2), padded with rows of -1; two
    identical boxes in sample 1 (tied IoUs)."""
    lab = -np.ones((n, o, 5), np.float32)
    for i in range(n):
        for k in range(rs.randint(1, o)):
            x0, y0 = rs.uniform(0, 0.6, 2)
            lab[i, k] = [rs.randint(0, classes), x0, y0,
                         x0 + rs.uniform(0.1, 0.4), y0 + rs.uniform(0.1, 0.4)]
    lab[1, 1] = lab[1, 0]
    lab[1, 1, 0] = (lab[1, 0, 0] + 1) % classes
    return lab


def _target_inputs(seed=0, n=4, o=5, classes=3):
    rs = np.random.RandomState(seed)
    anchors = _anchors()
    lab = _det_labels(rs, n, o, classes)
    # a gt box equal to an anchor, matched by two identical anchors
    # (sizes repeated) in sample 2
    twin = _anchors(sizes=(0.3, 0.3), ratios=(1,))
    lab[2, 0, 1:] = twin[0, 40]
    pred = rs.standard_normal((n, classes + 1, anchors.shape[1])) \
        .astype(np.float32)
    pred[:, :, 10:20] = pred[:, :, 30:31]      # tied mining scores
    return anchors, twin, lab, pred


#: (attrs, twin anchors): the twins are every anchor doubled, so a gt
#: box equal to one of them has two anchors of tied IoU
TARGET_CASES = {
    "match_only_twins": (dict(), True),
    "mining": (dict(negative_mining_ratio=3.0), False),
    "mining_min_negatives_twins": (dict(
        negative_mining_ratio=0.5, minimum_negative_samples=40,
        negative_mining_thresh=0.4, overlap_threshold=0.4), True),
    "ignore_label": (dict(negative_mining_ratio=2.0, ignore_label=-7.0,
                          variances=(0.2, 0.2, 0.1, 0.1)), False),
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target(case):
    kw, twin = TARGET_CASES[case]
    anchors, twins, lab, pred = _target_inputs()
    if twin:
        anchors = twins
        pred = pred[:, :, :anchors.shape[1]]
    want = [np.asarray(x) for x in _jit(jc.multibox_target, **kw)(
        _j(anchors), _j(lab), _j(pred))]
    got = [x.numpy() for x in tc.multibox_target(
        _t(anchors), _t(lab), _t(pred), **kw)]
    loc_t, loc_m, cls_t = got
    np.testing.assert_array_equal(cls_t, want[2])
    np.testing.assert_array_equal(loc_m, want[1])
    np.testing.assert_allclose(loc_t, want[0], rtol=0, atol=1e-6)
    assert (cls_t > 0).any()
    if kw.get("negative_mining_ratio", -1) > 0:
        ignore = kw.get("ignore_label", -1.0)
        assert (cls_t == ignore).any() and (cls_t == 0).any()


def test_multibox_target_detaches_cls_pred():
    anchors, _, lab, pred = _target_inputs()
    p = _t(pred).requires_grad_()
    outs = tc.multibox_target(_t(anchors), _t(lab), p,
                              negative_mining_ratio=3.0)
    assert not any(o.requires_grad for o in outs)


def _det_inputs(seed=1, n=3, classes=4):
    rs = np.random.RandomState(seed)
    anchors = _anchors()
    a = anchors.shape[1]
    logits = 2 * rs.standard_normal((n, classes + 1, a)).astype(np.float32)
    logits[:, :, 7] = logits[:, :, 8]            # tied scores
    prob = np.asarray(jax.nn.softmax(_j(logits), axis=1))
    loc = (0.5 * rs.standard_normal((n, a * 4))).astype(np.float32)
    return prob, loc, anchors


DETECTION_CASES = {
    "per_class": dict(threshold=0.2, nms_threshold=0.3),
    "force_suppress": dict(threshold=0.2, nms_threshold=0.3,
                           force_suppress=True),
    "topk_below": dict(threshold=0.1, nms_threshold=0.4, nms_topk=10),
    "topk_above": dict(threshold=0.1, nms_threshold=0.4, nms_topk=5000),
    "force_topk_below": dict(threshold=0.05, nms_threshold=0.5,
                             force_suppress=True, nms_topk=7),
    "background_2_no_clip": dict(threshold=0.15, background_id=2,
                                 clip=False, nms_threshold=0.45),
}


@pytest.mark.parametrize("case", sorted(DETECTION_CASES))
def test_multibox_detection(case):
    kw = DETECTION_CASES[case]
    prob, loc, anchors = _det_inputs()
    want = np.asarray(_jit(jc.multibox_detection, **kw)(
        _j(prob), _j(loc), _j(anchors)))
    got = tc.multibox_detection(_t(prob), _t(loc), _t(anchors),
                                **kw).numpy()
    assert got.shape == want.shape == (prob.shape[0], anchors.shape[1], 6)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=COORD_ATOL)
    kept = (got[..., 0] >= 0).sum()
    candidates = (np.delete(prob, kw.get("background_id", 0), 1).max(1)
                  > kw["threshold"]).sum()
    assert 0 < kept < candidates            # NMS suppressed some


def _proposal_inputs(seed=2, n=2, a0=6, h=6, w=7):
    rs = np.random.RandomState(seed)
    cp = rs.uniform(0, 1, (n, 2 * a0, h, w)).astype(np.float32)
    cp[:, a0 + 1, 2, 3] = cp[:, a0 + 2, 2, 3]    # tied scores
    cp[:, a0:, 4, :] = 0.5
    bp = (0.3 * rs.standard_normal((n, 4 * a0, h, w))).astype(np.float32)
    info = np.array([[48, 56, 1.0], [40, 44, 1.5]], np.float32)[:n]
    return cp, bp, info


PROPOSAL_CASES = {
    "scores": dict(output_score=True),
    "min_size": dict(rpn_min_size=12, output_score=True),
    "rois_only": dict(threshold=0.3),
    "pre_cut": dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=20,
                    output_score=True),
}


@pytest.mark.parametrize("case", sorted(PROPOSAL_CASES))
def test_proposal(case):
    kw = dict(rpn_pre_nms_top_n=150, rpn_post_nms_top_n=40, threshold=0.5,
              rpn_min_size=4, scales=(2, 4), ratios=(0.5, 1, 2),
              feature_stride=8)
    kw.update(PROPOSAL_CASES[case])
    cp, bp, info = _proposal_inputs()
    want = _jit(jc.proposal, **kw)(_j(cp), _j(bp), _j(info))
    got = tc.proposal(_t(cp), _t(bp), _t(info), **kw)
    if not kw.get("output_score"):
        want, got = (want,), (got,)
    assert len(got) == len(want) == tc._proposal_num_outputs(kw)
    rois, want_rois = got[0].numpy(), np.asarray(want[0])
    assert rois.shape == want_rois.shape
    np.testing.assert_array_equal(rois[:, 0], want_rois[:, 0])
    np.testing.assert_allclose(rois[:, 1:], want_rois[:, 1:], rtol=0,
                               atol=PIXEL_ATOL)
    if kw.get("output_score"):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # some boxes were suppressed or padded
    assert (rois[:, 1:] == 0).all(axis=1).any() or \
        kw["rpn_post_nms_top_n"] < kw["rpn_pre_nms_top_n"]


def test_gen_base_anchors_rounds_half_to_even():
    # base 16, ratio 0.5: sqrt(512) = 22.6 -> 23, 23 * 0.5 = 11.5 -> 12
    for args in ((16, (8, 16, 32), (0.5, 1, 2)), (4, (2, 4), (0.5, 1, 2)),
                 (10, (1.5,), (0.25, 3.0))):
        np.testing.assert_array_equal(tc._gen_base_anchors(*args),
                                      jc._gen_base_anchors(*args))


def test_proposal_num_outputs_and_shapes():
    op_t = tmx.ops.get_op("_contrib_Proposal")
    op_j = jmx.ops.get_op("_contrib_Proposal")
    for attrs in ({}, {"output_score": True}, {"output_score": False}):
        assert op_t.get_num_outputs(attrs) == op_j.get_num_outputs(attrs)
        shapes = [(2, 12, 6, 7), (2, 24, 6, 7), (2, 3)]
        assert op_t.infer_shape(attrs, shapes) == \
            op_j.infer_shape(attrs, shapes)


def _grads_against_jax(jfn, tfn, arrays, diff, seed, **kw):
    ja = [_j(a) for a in arrays]

    def f(*d):
        full = list(ja)
        for i, v in zip(diff, d):
            full[i] = v
        return jfn(*full, **kw)

    jout, vjp = jax.vjp(jax.jit(f), *[ja[i] for i in diff])
    cot = np.random.RandomState(seed).standard_normal(jout.shape) \
        .astype(np.float32)
    jg = vjp(_j(cot))
    ta = [_t(a) for a in arrays]
    for i in diff:
        ta[i].requires_grad_(True)
    tout = tfn(*ta, **kw)
    tg = torch.autograd.grad(tout, [ta[i] for i in diff], _t(cot))
    return (tout.detach().numpy(), np.asarray(jout),
            [g.numpy() for g in tg], [np.asarray(g) for g in jg])


@pytest.mark.parametrize("shape", [(3, 8), (2, 3, 16), (4, 5)])
def test_fft_and_ifft(shape):
    rs = np.random.RandomState(3)
    x = rs.standard_normal(shape).astype(np.float32)
    got, want, tg, jg = _grads_against_jax(jc.fft, tc.fft, [x], (0,), 4)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(tg[0], jg[0], rtol=0,
                               atol=1e-5 * np.abs(jg[0]).max())
    z = rs.standard_normal(shape[:-1] + (2 * shape[-1],)).astype(np.float32)
    got, want, tg, jg = _grads_against_jax(jc.ifft, tc.ifft, [z], (0,), 5)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(tg[0], jg[0], rtol=0,
                               atol=1e-5 * np.abs(jg[0]).max())
    # ifft(fft(x)) = d * x
    back = tc.ifft(tc.fft(_t(x))).numpy()
    np.testing.assert_allclose(back, shape[-1] * x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_dim", [5, 16])
def test_count_sketch_and_gradient(out_dim):
    rs = np.random.RandomState(6)
    x = rs.standard_normal((4, 12)).astype(np.float32)
    h = rs.randint(0, out_dim, (1, 12)).astype(np.float32)
    s = rs.choice([-1.0, 1.0], (1, 12)).astype(np.float32)
    got, want, tg, jg = _grads_against_jax(
        jc.count_sketch, tc.count_sketch, [x, h, s], (0, 2), 7,
        out_dim=out_dim)
    np.testing.assert_array_equal(got, want)
    for g, j in zip(tg, jg):
        np.testing.assert_allclose(g, j, rtol=1e-6, atol=1e-7)
    sym = tmx.sym.contrib.count_sketch(
        tmx.sym.Variable("data"), tmx.sym.Variable("h"),
        tmx.sym.Variable("s"), out_dim=out_dim)
    assert sym.list_arguments() == ["data", "h", "s"]
    assert sym.infer_shape(data=(4, 12), h=(1, 12), s=(1, 12))[1] == \
        [(4, out_dim)]
