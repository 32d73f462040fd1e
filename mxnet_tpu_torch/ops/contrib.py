"""Contrib ops (port of ``mxnet_tpu/ops/contrib.py``): the SSD MultiBox
family, Faster R-CNN's ``Proposal``, ``fft``/``ifft``, ``count_sketch``
and ``Attention``.

Anchor generation, target matching and NMS stay dense fixed-shape
computations, as in the JAX package, and run on the whole batch at once:

- ``MultiBoxTarget``'s greedy matching is one loop of ``n_gt`` rounds,
  each batched over the samples (the JAX package ``vmap``s one sample's
  ``fori_loop``);
- the NMS sweep (``_nms_sweep``) runs over boxes already in score order,
  batched over every leading axis: ``MultiBoxDetection`` sweeps all
  (sample, class) rows in one loop of ``nms_topk`` steps, where the JAX
  package runs one ``fori_loop`` a class inside a ``vmap``; ``Proposal``
  sweeps its pre-NMS top-N.

Ties decide the results, so every order is the JAX package's: argmax
takes the first maximum (``_argmax_first``), sorts are stable, and a
``lax.top_k`` is a stable descending sort and a slice (the lower index
first among equal scores).  Detection outputs carry no gradient (the
JAX package's ``stop_gradient``), and their inputs are detached.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register
from .vision import _recip
from ..base import MXNetError


def _flist(v, default):
    if v is None:
        return tuple(default)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _argmax_first(x, dim):
    """(max, index of its first occurrence) along ``dim`` — ``jnp.argmax``
    semantics on every device."""
    best = x.amax(dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    idx = torch.where(x == best, pos, n).amin(dim)
    return best.squeeze(dim), idx


def _sort_desc(x, dim=-1):
    """Stable descending sort (``lax.top_k``'s order, or ``argsort(-x)``'s
    with stable ties): (values, indices)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


# ---------------------------------------------------------------------------
# MultiBoxPrior — contrib/multibox_prior-inl.h
# ---------------------------------------------------------------------------

def _mbp_infer(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return list(in_shapes), [None], []
    sizes = _flist(attrs.get("sizes"), (1.0,))
    ratios = _flist(attrs.get("ratios"), (1.0,))
    na = len(sizes) + len(ratios) - 1
    h, w = data[2], data[3]
    return [tuple(data)], [(1, h * w * na, 4)], []


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
          infer_shape=_mbp_infer)
def multibox_prior(data, sizes=None, ratios=None, clip=False, steps=None,
                   offsets=None):
    """SSD prior (anchor) boxes for each feature-map cell: (1, H*W*A, 4)
    corners (x1, y1, x2, y2) normalized to [0, 1]; square boxes for every
    size, then sizes[0] stretched by sqrt(ratio) for ratios[1:]."""
    sizes = _flist(sizes, (1.0,))
    ratios = _flist(ratios, (1.0,))
    offsets = _flist(offsets, (0.5, 0.5))
    h, w = data.shape[2], data.shape[3]
    steps = _flist(steps, (-1.0, -1.0))
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    # the half-extents are Python floats (float64 sqrt), rounded to float32
    # where they meet the centres, as in the JAX package
    whs = [(s, s) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    boxes = [torch.stack([cxg - float(bw) / 2, cyg - float(bh) / 2,
                          cxg + float(bw) / 2, cyg + float(bh) / 2], dim=-1)
             for bw, bh in whs]
    out = torch.stack(boxes, dim=2).reshape(1, -1, 4)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# box utilities, over any leading axes
# ---------------------------------------------------------------------------

def _iou(a, b):
    """IoU of corner boxes ``a`` [..., P, 4] against ``b`` [..., Q, 4] ->
    [..., P, Q], in the JAX package's order of operations."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    return inter / (area_a + area_b - inter).clamp(min=1e-12)


def _encode(anchors, gt, variances):
    """Corner gt against corner anchors -> centre-form regression targets
    (multibox_target-inl.h encoding)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    r = [_recip(v) for v in variances]     # ``/ v`` as XLA compiles it
    tx = (gcx - acx) / aw.clamp(min=1e-12) * r[0]
    ty = (gcy - acy) / ah.clamp(min=1e-12) * r[1]
    tw = torch.log((gw / aw.clamp(min=1e-12)).clamp(min=1e-12)) * r[2]
    th = torch.log((gh / ah.clamp(min=1e-12)).clamp(min=1e-12)) * r[3]
    return torch.stack([tx, ty, tw, th], dim=-1)


def _decode(anchors, deltas, variances):
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[1] * ah + acy
    w = torch.exp(deltas[..., 2] * variances[2]) * aw
    h = torch.exp(deltas[..., 3] * variances[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _nms_sweep(boxes, keep, threshold, steps):
    """Greedy NMS over boxes already in score order, batched over every
    leading axis: ``boxes`` [..., K, 4], ``keep`` [..., K] the candidates.
    Step i lets the box at position i, if still kept, suppress every later
    box whose IoU with it exceeds ``threshold`` (the JAX package's
    ``_nms_mask`` body with ``rank > rank[idx]`` as "later"); boxes past
    ``steps`` suppress nothing but are suppressed.  Returns the keep mask
    in the same order."""
    keep = keep.clone()
    k = boxes.shape[-2]
    for i in range(min(int(steps), k - 1)):
        alive = keep[..., i:i + 1]
        later = boxes[..., i + 1:, :]
        ious = _iou(boxes[..., i:i + 1, :], later)[..., 0, :]
        keep[..., i + 1:] &= ~(alive & (ious > threshold))
    return keep


# ---------------------------------------------------------------------------
# MultiBoxTarget — contrib/multibox_target-inl.h
# ---------------------------------------------------------------------------

def _mbt_infer(attrs, in_shapes):
    anchor, label, cls_pred = in_shapes[:3]
    if anchor is None or label is None or cls_pred is None:
        return list(in_shapes), [None, None, None], []
    a = anchor[1]
    n = label[0]
    return ([tuple(anchor), tuple(label), tuple(cls_pred)],
            [(n, a * 4), (n, a * 4), (n, a)], [])


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          input_names=("anchor", "label", "cls_pred"), num_outputs=3,
          output_names=("loc_target", "loc_mask", "cls_target"),
          infer_shape=_mbt_infer)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets for the whole batch: each anchor matched to
    ground truth (one distinct anchor per valid gt by greedy rounds, plus
    IoU >= threshold), localization targets and masks, class targets, and
    hard negative mining by background cross-entropy."""
    variances = _flist(variances, (0.1, 0.1, 0.2, 0.2))
    anchors = anchor[0].detach()                        # [A, 4]
    label = label.detach()
    cls_pred = cls_pred.detach()
    a = anchors.shape[0]
    n, n_gt = label.shape[0], label.shape[1]
    dev = anchors.device
    valid = label[:, :, 0] >= 0                         # [N, O]
    gt = label[:, :, 1:5]                               # [N, O, 4]
    iou = _iou(anchors.expand(n, a, 4), gt)             # [N, A, O]
    iou = torch.where(valid[:, None, :], iou, -1.0)
    best_iou, best_gt = _argmax_first(iou, 2)           # [N, A]
    # greedy matching: each round takes every sample's globally best
    # remaining (anchor, gt) pair, then masks that anchor row and gt column
    rows = torch.arange(n, device=dev)
    iou_m = iou.clone()
    forced = torch.zeros((n, a), dtype=torch.bool, device=dev)
    forced_gt = torch.zeros((n, a), dtype=torch.int64, device=dev)
    for _ in range(n_gt):
        best, idx = _argmax_first(iou_m.reshape(n, -1), 1)
        ai = idx // n_gt
        gi = idx % n_gt
        ok = best >= 0.0                # invalid/exhausted entries < 0
        forced[rows, ai] |= ok
        forced_gt[rows, ai] = torch.where(ok, gi, forced_gt[rows, ai])
        iou_m[rows, ai, :] = -2.0
        iou_m[rows, :, gi] = -2.0
    pos = forced | (best_iou >= overlap_threshold)
    match = torch.where(forced, forced_gt, best_gt)     # [N, A]
    matched_gt = torch.gather(gt, 1, match[..., None].expand(n, a, 4))
    loc_t = _encode(anchors, matched_gt, variances)
    loc_t = torch.where(pos[..., None], loc_t, 0.0).reshape(n, -1)
    loc_m = pos[..., None].expand(n, a, 4).to(torch.float32).reshape(n, -1)
    cls_t = torch.where(pos, torch.gather(label[:, :, 0], 1, match) + 1, 0.0)
    if float(negative_mining_ratio) > 0:
        p = torch.softmax(cls_pred, dim=1)               # [N, cls, A]
        neg_score = -torch.log(p[:, 0].clamp(min=1e-12))
        cand = (~pos) & (best_iou < negative_mining_thresh)
        num_pos = pos.sum(1)
        num_neg = (num_pos * float(negative_mining_ratio)).to(
            torch.int32).clamp(min=int(minimum_negative_samples))
        score = torch.where(cand, neg_score, -torch.inf)
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(a, device=dev).expand(n, a))
        selected = cand & (rank < num_neg[:, None])
        cls_t = torch.where(pos, cls_t, torch.where(
            selected, 0.0, float(ignore_label)))
    return loc_t, loc_m, cls_t


# ---------------------------------------------------------------------------
# MultiBoxDetection — contrib/multibox_detection-inl.h
# ---------------------------------------------------------------------------

def _mbd_infer(attrs, in_shapes):
    cls_prob, loc_pred, anchor = in_shapes[:3]
    if cls_prob is None or anchor is None:
        return list(in_shapes), [None], []
    return ([tuple(cls_prob), tuple(loc_pred), tuple(anchor)],
            [(cls_prob[0], anchor[1], 6)], [])


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          input_names=("cls_prob", "loc_pred", "anchor"),
          infer_shape=_mbd_infer)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """SSD detection output: loc predictions decoded against the anchors,
    each anchor's best non-background class, a score threshold and greedy
    NMS per class (or across classes with ``force_suppress``).  Output
    [N, A, 6] rows (class_id, score, x1, y1, x2, y2), kept rows first by
    descending score; suppressed rows have class_id -1."""
    variances = _flist(variances, (0.1, 0.1, 0.2, 0.2))
    n, _n_cls, a = cls_prob.shape
    topk = a if nms_topk is None or int(nms_topk) <= 0 else \
        min(int(nms_topk), a)
    bg = int(background_id)
    boxes, score, cls_id, valid, sel = _mbd_candidates(
        cls_prob, loc_pred, anchor, clip, threshold, bg, variances,
        force_suppress)
    order, sorted_boxes, keep_sorted = _score_rows(boxes, score, sel)
    keep_sorted = _nms_sweep(sorted_boxes, keep_sorted, nms_threshold, topk)
    keep = torch.zeros_like(sel).scatter_(2, order, keep_sorted).any(1)
    if not force_suppress:
        # an anchor whose best class is the background belongs to no row
        keep = torch.where(cls_id == bg, valid, keep)
    fg_id = torch.where(cls_id > bg, cls_id - 1, cls_id)
    out_id = torch.where(keep, fg_id.to(torch.float32), -1.0)
    rows = torch.cat([out_id[..., None], score[..., None], boxes], dim=2)
    _, row_order = _sort_desc(torch.where(keep, score, -torch.inf), 1)
    return torch.gather(rows, 1, row_order[..., None].expand(n, a, 6))


def _mbd_candidates(cls_prob, loc_pred, anchor, clip, threshold, bg,
                    variances, force_suppress):
    """MultiBoxDetection up to its NMS: (decoded boxes [N, A, 4], best
    foreground score and class [N, A], valid [N, A], and the rows the
    sweep runs over, sel [N, rows, A]: one row a foreground class, or one
    row with ``force_suppress``)."""
    cls_prob = cls_prob.detach()
    anchors = anchor[0].detach()
    n, n_cls, a = cls_prob.shape
    boxes = _decode(anchors, loc_pred.detach().reshape(n, a, 4), variances)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    is_bg = torch.zeros(n_cls, dtype=torch.bool, device=cls_prob.device)
    is_bg[bg] = True
    fg = torch.where(is_bg[:, None], -1.0, cls_prob)    # [N, cls, A]
    score, cls_id = _argmax_first(fg, 1)                # [N, A]
    valid = score > threshold
    if force_suppress:
        sel = valid[:, None]
    else:
        classes = torch.tensor([c for c in range(n_cls) if c != bg],
                               device=cls_prob.device)
        sel = valid[:, None] & (cls_id[:, None] == classes[:, None])
    return boxes, score, cls_id, valid, sel


def _score_rows(boxes, score, sel):
    """Every row of ``sel`` [N, rows, A] in its own score order (rows'
    members by score, stable; the others after them at -1): (order,
    boxes in that order [N, rows, A, 4], sel in that order)."""
    n, r, a = sel.shape
    _, order = _sort_desc(torch.where(sel, score[:, None], -1.0), 2)
    sorted_boxes = torch.gather(boxes[:, None].expand(n, r, a, 4), 2,
                                order[..., None].expand(n, r, a, 4))
    return order, sorted_boxes, torch.gather(sel, 2, order)


# ---------------------------------------------------------------------------
# Proposal — contrib/proposal-inl.h (Faster R-CNN RPN proposals)
# ---------------------------------------------------------------------------

def _gen_base_anchors(base_size, scales, ratios):
    """Standard RPN base anchors around (0, 0) (proposal-inl.h
    GenerateAnchor): Python's round (half to even) of float64 roots."""
    px = (base_size - 1) * 0.5
    py = (base_size - 1) * 0.5
    anchors = []
    area = base_size * base_size
    for r in ratios:
        size_r = area / r
        ws = int(round(np.sqrt(size_r)))
        hs = int(round(ws * r))
        for s in scales:
            w = ws * s
            h = hs * s
            anchors.append([px - (w - 1) * 0.5, py - (h - 1) * 0.5,
                            px + (w - 1) * 0.5, py + (h - 1) * 0.5])
    return np.array(anchors, np.float32)


def _proposal_infer(attrs, in_shapes):
    cls_prob = in_shapes[0]
    if cls_prob is None:
        return list(in_shapes), [None], []
    post = int(attrs.get("rpn_post_nms_top_n", 300))
    n = cls_prob[0]
    outs = [(n * post, 5)]
    if attrs.get("output_score"):
        outs.append((n * post, 1))
    return list(in_shapes), outs, []


def _proposal_num_outputs(attrs):
    return 2 if attrs.get("output_score") else 1


@register("_contrib_Proposal", aliases=("Proposal",),
          input_names=("cls_prob", "bbox_pred", "im_info"),
          num_outputs=_proposal_num_outputs, infer_shape=_proposal_infer)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals for the whole batch: base anchors slid over the
    feature map, bbox_pred decoded, clipped to the image, small boxes
    dropped, the pre-NMS top-N by score, NMS, the post-NMS top-N (zero
    rows where fewer survive).  rois (N*post, 5) [batch, x1, y1, x2, y2]
    and, with ``output_score``, their scores (N*post, 1)."""
    cls_prob = cls_prob.detach()
    bbox_pred = bbox_pred.detach()
    im_info = im_info.detach()
    n, _two_a, h, w = cls_prob.shape
    dev = cls_prob.device
    scales = tuple(float(s) for s in (
        scales if isinstance(scales, (list, tuple)) else (scales,)))
    ratios = tuple(float(r) for r in (
        ratios if isinstance(ratios, (list, tuple)) else (ratios,)))
    base = torch.from_numpy(_gen_base_anchors(
        int(feature_stride), scales, ratios)).to(dev)    # [A0, 4]
    a0 = base.shape[0]
    sy = torch.arange(h, dtype=torch.float32, device=dev) * feature_stride
    sx = torch.arange(w, dtype=torch.float32, device=dev) * feature_stride
    syg, sxg = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([sxg, syg, sxg, syg], dim=-1)    # [h, w, 4]
    anchors = (shift[:, :, None, :] + base[None, None]).reshape(-1, 4)
    post = int(rpn_post_nms_top_n)
    pre = min(int(rpn_pre_nms_top_n), anchors.shape[0])
    # cls_prob [N, 2*A0, h, w]: background scores first, foreground last
    fg = cls_prob[:, a0:].permute(0, 2, 3, 1).reshape(n, -1)
    d = bbox_pred.reshape(n, a0, 4, h, w).permute(0, 3, 4, 1, 2) \
        .reshape(n, -1, 4)
    # decode (unnormalized RPN parameterization: variances = 1)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw * 0.5
    acy = anchors[:, 1] + ah * 0.5
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    ww = torch.exp(d[..., 2].clamp(-10, 10)) * aw
    hh = torch.exp(d[..., 3].clamp(-10, 10)) * ah
    x1 = cx - (ww - 1) * 0.5
    y1 = cy - (hh - 1) * 0.5
    x2 = cx + (ww - 1) * 0.5
    y2 = cy + (hh - 1) * 0.5
    im_h = im_info[:, 0:1]
    im_w = im_info[:, 1:2]

    def _clip(v, hi):
        return torch.minimum(v.clamp(min=0), hi - 1)

    boxes = torch.stack([_clip(x1, im_w), _clip(y1, im_h), _clip(x2, im_w),
                         _clip(y2, im_h)], dim=-1)       # [N, K, 4]
    min_size = rpn_min_size * im_info[:, 2:3]
    keep_size = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size)
    score = torch.where(keep_size, fg, -1.0)
    top_score, top_idx = _sort_desc(score, 1)
    top_score, top_idx = top_score[:, :pre], top_idx[:, :pre]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(n, pre, 4))
    keep = _nms_sweep(top_boxes, top_score > 0, threshold, pre)
    rank_score = torch.where(keep, top_score, -1.0)
    sel_score, sel = _sort_desc(rank_score, 1)
    sel_score, sel = sel_score[:, :post], sel[:, :post]
    picked = torch.gather(top_boxes, 1, sel[..., None].expand(n, post, 4))
    out_boxes = torch.where((sel_score > 0)[..., None], picked, 0.0)
    out_score = sel_score.clamp(min=0.0)
    batch_idx = torch.arange(n, dtype=torch.float32, device=dev) \
        .repeat_interleave(post)
    rois = torch.cat([batch_idx[:, None], out_boxes.reshape(n * post, 4)],
                     dim=1)
    if output_score:
        return rois, out_score.reshape(n * post, 1)
    return rois


# ---------------------------------------------------------------------------
# FFT / IFFT — contrib/fft-inl.h: real input -> interleaved real/imag
# output of length 2d
# ---------------------------------------------------------------------------

def _fft_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return list(in_shapes), [None], []
    return [tuple(d)], [d[:-1] + (d[-1] * 2,)], []


@register("_contrib_fft", aliases=("fft",), infer_shape=_fft_infer)
def fft(data, compute_size=128):
    """FFT along the last dim; complex output interleaved [re, im, re, im,
    ...] (fft-inl.h output layout, 2*d)."""
    f = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([f.real, f.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (data.shape[-1] * 2,))


def _ifft_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return list(in_shapes), [None], []
    return [tuple(d)], [d[:-1] + (d[-1] // 2,)], []


@register("_contrib_ifft", aliases=("ifft",), infer_shape=_ifft_infer)
def ifft(data, compute_size=128):
    """Inverse of ``_contrib_fft``: interleaved complex -> real, times d
    (the reference's unnormalized inverse)."""
    d = data.shape[-1] // 2
    c = data.to(torch.float32).reshape(data.shape[:-1] + (d, 2))
    z = torch.complex(c[..., 0], c[..., 1])
    return torch.fft.ifft(z, dim=-1).real * d


# ---------------------------------------------------------------------------
# count_sketch — contrib/count_sketch-inl.h
# ---------------------------------------------------------------------------

def _cs_infer(attrs, in_shapes):
    d = in_shapes[0]
    out_dim = int(attrs["out_dim"])
    if d is None:
        return list(in_shapes), [None], []
    return list(in_shapes), [(d[0], out_dim)], []


@register("_contrib_count_sketch", aliases=("count_sketch",),
          input_names=("data", "h", "s"), infer_shape=_cs_infer)
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """Count-sketch projection: out[:, h[j]] += s[j] * data[:, j], h in
    [0, out_dim), s in {+1, -1}; a scatter-add (``index_add``), linear, so
    autograd gives the gradient of data and s."""
    hj = h.reshape(-1).to(torch.int64)
    sj = s.reshape(-1).to(data.dtype)
    vals = data * sj
    out = data.new_zeros(data.shape[:-1] + (int(out_dim),))
    return out.index_add(data.dim() - 1, hj, vals)


# ---------------------------------------------------------------------------
# Attention — the symbol-level entry to ``parallel/ring_attention.py``'s
# full_attention (the flash kernel for sequences above one flash block)
# ---------------------------------------------------------------------------

def _attention_infer(attrs, in_shapes):
    q = in_shapes[0]
    if q is None:
        return list(in_shapes), [None], []
    return [tuple(s) if s is not None else None for s in in_shapes], \
        [tuple(q)], []


@register("_contrib_Attention", aliases=("Attention", "attention"),
          input_names=("query", "key", "value"),
          infer_shape=_attention_infer)
def contrib_attention(query, key, value, num_heads=1, causal=False,
                      scale=-1.0):
    """Multi-head scaled-dot-product attention (numerically-stable
    softmax; sequences longer than ``MXTPU_FLASH_BLOCK`` keys take the
    flash kernel).  query/key/value: (batch, seq, d_model); heads split
    from d_model.  Output: (batch, seq_q, d_model)."""
    from ..parallel.ring_attention import full_attention
    num_heads = int(num_heads)
    B, T, D = query.shape
    Tk = key.shape[1]
    if D % num_heads != 0:
        raise MXNetError("d_model %d not divisible by num_heads %d"
                         % (D, num_heads))
    if causal and T > Tk:
        raise MXNetError(
            "causal attention needs seq_q (%d) <= seq_k (%d): earlier "
            "query positions would have no visible keys" % (T, Tk))
    hd = D // num_heads
    q = query.reshape(B, T, num_heads, hd)
    k = key.reshape(B, Tk, num_heads, hd)
    v = value.reshape(B, Tk, num_heads, hd)
    s = None if float(scale) <= 0 else float(scale)
    out = full_attention(q, k, v, causal=bool(causal), scale=s)
    return out.reshape(B, T, D)
