"""concat_fuse — merge sibling conv→BN(→act) tower heads into one conv.

Port of ``mxnet_tpu/kernels/concat_fuse.py``.  Inception's towers run
parallel convolutions the card would execute as N narrow convolutions
back to back.  Two merge shapes (:func:`mxnet_tpu_torch.mxfuse.
pass_concat_fuse`):

- **shared input** (the 1x1 branch and the 3x3 / double-3x3 "reduce"
  layers over one tensor): ONE conv over the concatenated filters does the
  same per-output-channel math.
- **sibling inputs** (parallel 3x3 convs over different tensors):
  channel-concatenate the inputs and run ONE grouped conv (``num_group`` =
  member count); group *i* reads input block *i* and writes output block
  *i*, the per-member convs' math.

The plan pass rewrites each member's BatchNorm entry with
:func:`make_group_member`.  The group's merged body — the merged conv, the
merged per-channel BN through ``fused_bn_act`` in training (one ``bn_act``
launch over the merged channels on the card), or each member's BN folded
into its slice of the merged weights at inference — is computed ONCE per
forward: the first member the interpreter reaches computes it and stores
it in the forward's memo (a dict the interpreter creates for each plan
run and hands to every override that sets ``uses_memo``), keyed by the
group; the other members slice the stored result.  Every member's slice
is a view of one tensor, so autograd sees one merged conv and one merged
BN.  (The JAX package has each member recompute the body and relies on
XLA's common-subexpression elimination to keep one copy; the eager port
has no such pass, hence the memo.)  :data:`MERGED_BODIES` counts merged
bodies computed.

Numerics: a convolution is independent per output channel and per group,
so the merged result is the members' result up to the order in which the
convolution sums (cuDNN may pick another algorithm for a wider or grouped
conv than for its members) — the reassociation tolerance the ``bn_fold``
pass carries.  BN statistics are per channel, so the merged statistics'
slices are the members' statistics under the same tolerance.
"""
from __future__ import annotations

import torch

__all__ = ["make_group_member", "MERGED_BODIES"]

#: merged group bodies computed (one per group per forward) since the
#: process started or the caller last reset it
MERGED_BODIES = 0


def make_group_member(member_ix, n_members, conv_attrs, act_type,
                      offsets, has_bias, do_fold, grouped=False, key=None):
    """The override body for member ``member_ix`` of a merged group.

    Called at the member's BatchNorm entry as ``fused(conv_out, gamma,
    beta, mm, mv, *extra, is_train=..., memo=..., **bn_attrs)`` where
    ``extra`` is ``[x]`` (shared-input mode) or ``[x_0..x_{n-1}]``
    (grouped mode) followed by every member's ``w (, b), gamma, beta, mm,
    mv``.  The member's own positional inputs are ignored (the original
    per-branch conv is dead on both paths).  Returns ``(member slice,
    mm_new, mv_new)`` with the member's aux updates sliced from the merged
    statistics.  ``key`` names the group in the forward's ``memo``; every
    member of one group gets the same key.

    Grouped mode needs every member input to carry the same channel count
    (a grouped conv splits evenly); the shapes at run time decide, and a
    mismatched group falls back to the member's own unfused math.
    """
    lo, hi = offsets[member_ix], offsets[member_ix + 1]
    call_attrs = {k: v for k, v in conv_attrs.items() if k != "no_bias"}

    def _unpack(extra):
        n_x = n_members if grouped else 1
        xs = list(extra[:n_x])
        ws, bs, gams, bets, mms, mvs = [], [], [], [], [], []
        k = n_x
        for _ in range(n_members):
            ws.append(extra[k])
            k += 1
            if has_bias:
                bs.append(extra[k])
                k += 1
            gams.append(extra[k])
            bets.append(extra[k + 1])
            mms.append(extra[k + 2])
            mvs.append(extra[k + 3])
            k += 4
        return xs, ws, bs, gams, bets, mms, mvs

    def merged_body(xs, ws, bs, gams, bets, mms, mvs, is_train, bn_attrs):
        global MERGED_BODIES
        from ..ops.nn import activation, convolution
        from . import bn_act as _ba
        attrs = dict(call_attrs)
        if grouped:
            x = torch.cat(xs, dim=1)
            attrs["num_group"] = n_members * int(attrs.get("num_group", 1))
        else:
            x = xs[0]
        attrs["num_filter"] = offsets[-1]
        MERGED_BODIES += 1
        if not is_train and do_fold:
            # inference: fold each member's frozen stats into ITS slice of
            # the merged weights — the BN leaves the forward
            folded = [_ba.fold_bn_into_conv(
                w, (bs[i] if has_bias else None), gams[i], bets[i],
                mms[i], mvs[i], eps=bn_attrs.get("eps", 0.001),
                fix_gamma=bn_attrs.get("fix_gamma", True))
                for i, w in enumerate(ws)]
            wm = torch.cat([f[0] for f in folded], dim=0)
            bm = torch.cat([f[1] for f in folded], dim=0)
            out = convolution(x, wm, bm, **attrs)
            if act_type:
                out = activation(out, act_type=act_type)
            return out, None, None
        wm = torch.cat(ws, dim=0)
        bm = torch.cat(bs, dim=0) if has_bias else None
        conv_out = convolution(x, wm, bm, **attrs)
        return _ba.fused_bn_act(
            conv_out, torch.cat(gams), torch.cat(bets), torch.cat(mms),
            torch.cat(mvs), act_type=act_type, is_train=is_train, **bn_attrs)

    def fused(_data, _gamma, _beta, _moving_mean, _moving_var, *extra,
              is_train=False, memo=None, **bn_attrs):
        bn_attrs.pop("output_mean_var", None)   # fusion requires False
        xs, ws, bs, gams, bets, mms, mvs = _unpack(extra)
        if grouped and (len({x.shape[1] for x in xs}) != 1
                        or len({w.shape for w in ws}) != 1):
            # uneven siblings cannot share a grouped conv — run this
            # member's own (unfused) math instead
            return _member_solo(
                xs[member_ix], ws[member_ix],
                bs[member_ix] if has_bias else None, gams[member_ix],
                bets[member_ix], mms[member_ix], mvs[member_ix],
                dict(call_attrs), act_type, is_train, bn_attrs, do_fold)
        body = memo.get(key) if memo is not None else None
        if body is None:
            body = merged_body(xs, ws, bs, gams, bets, mms, mvs, is_train,
                               bn_attrs)
            if memo is not None:
                memo[key] = body
        full, mm_new, mv_new = body
        if mm_new is None:      # the folded inference body
            return full[:, lo:hi], mms[member_ix], mvs[member_ix]
        return full[:, lo:hi], mm_new[lo:hi], mv_new[lo:hi]

    fused.uses_memo = True
    fused.folds_conv = do_fold
    fused.group = key
    fused.grouped = grouped
    return fused


def _member_solo(x, w, b, gamma, beta, mm, mv, conv_attrs, act_type,
                 is_train, bn_attrs, do_fold):
    """One member's ORIGINAL math (conv + BN (+act)) — the fallback when a
    grouped merge turns out shape-ineligible."""
    from ..ops.nn import activation, convolution
    from . import bn_act as _ba
    if not is_train and do_fold:
        w2, b2 = _ba.fold_bn_into_conv(
            w, b, gamma, beta, mm, mv,
            eps=bn_attrs.get("eps", 0.001),
            fix_gamma=bn_attrs.get("fix_gamma", True))
        out = convolution(x, w2, b2, **conv_attrs)
        if act_type:
            out = activation(out, act_type=act_type)
        return out, mm, mv
    conv_out = convolution(x, w, b, **conv_attrs)
    return _ba.fused_bn_act(conv_out, gamma, beta, mm, mv,
                            act_type=act_type, is_train=is_train,
                            **bn_attrs)
