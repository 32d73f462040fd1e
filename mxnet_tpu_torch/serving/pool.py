"""Warm multi-model pool (port of ``mxnet_tpu/serving/pool.py``): named
models, device-resident weights, one cached executor per (model, bucket
shape).

Load surfaces mirror the training side's artifacts:

- ``load(name, prefix, epoch)`` — the ``prefix-symbol.json`` +
  ``prefix-%04d.params`` pair every ``save_checkpoint`` writes.
- ``load_dir(name, directory)`` — a ``CheckpointManager`` directory:
  ``restore`` picks the newest INTACT epoch (checksum verification +
  corrupt-epoch walk-back included).
- ``add(name, symbol, arg_params, aux_params)`` — in-process handoff.

Both packages read the same files, so the port serves what the JAX
package trained.  Every entry runs on one context, fixed when the pool is
made (``gpu(0)`` unless the caller passes another): forwards run on the
batchers' dispatcher threads, which do not share a ``with ctx:`` scope.

Weight dtypes (``MXTPU_SERVE_DTYPE``), as the JAX package computes them:

- ``float32``: the weights live on the device inside the model's
  ``predict.Predictor``.
- ``bfloat16``: floating-point weights are rounded to bfloat16 and
  stored so on the device (half the bytes).  The inputs stay float32 and
  JAX promotes ``conv(f32, bf16)`` to float32 arithmetic, so each forward
  upcasts the stored weights to float32 where the plan consumes them:
  the ``bn_act`` kernel sees float32, and the BN fold folds the upcast
  values.
- ``int8``: dense/conv weights are quantized per OUTPUT CHANNEL with a
  symmetric scale (``q = round(w / s)`` clipped to ±127, ``s = max|w| /
  127``); the int8 tensors + float32 scales live on the device (about a
  quarter of the bytes), and each forward dequantizes them with the same
  float32 multiply as numpy (``q.float() * s``), so its outputs equal a
  float32 forward on the dequantized weights bit for bit.

In both low-precision modes the float32 weights exist only during a
forward (:class:`_CastForward`).

``analyze(bucket)`` lints one bucket's forward with the graph linter
(``analysis/graph_lint.py``); with ``MXTPU_ANALYZE=1`` each new serving
signature is linted before it serves and findings warn, with ``strict``
they refuse it (sticky per signature).
"""
from __future__ import annotations

import os
import threading

import numpy as np

from ..base import MXNetError, get_env, register_env
from .aot import _dtype_name

__all__ = ["ModelPool", "PooledModel", "ENV_SERVE_DTYPE", "quantize_int8"]

ENV_SERVE_DTYPE = register_env(
    "MXTPU_SERVE_DTYPE", default="float32",
    doc="Serving weight dtype: `bfloat16` casts floating-point weights "
        "at load time (weight-cast serving; inputs stay f32); `int8` "
        "quantizes dense/conv weights per output channel (symmetric "
        "scale, dequantized for each forward)")

_CASTABLE = ("float32", "float64")
_DTYPES = ("float32", "bfloat16", "int8")

def quantize_int8(weight):
    """Per-output-channel symmetric int8 quantization of one weight.

    Axis 0 is the output channel for both FullyConnected ``(out, in)``
    and Convolution ``(out, in, kh, kw)`` weights.  Returns ``(q int8,
    scale f32)`` numpy arrays with ``scale`` shaped ``(out, 1, ...)`` so
    ``q * scale`` broadcasts back; an all-zero channel gets scale 1 so
    dequant never divides by zero."""
    w = np.asarray(weight.asnumpy() if hasattr(weight, "asnumpy")
                   else weight, dtype=np.float32)
    reduce_axes = tuple(range(1, w.ndim))
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _int8_eligible(name, value):
    """Weight-only quantization targets: the 2-D+ ``*weight`` tensors
    (dense/conv kernels).  Biases, BN gamma/beta/moving stats and
    embeddings-as-1-D stay in float — they are small and scale-critical."""
    return (name.endswith("weight") and _dtype_name(value) in _CASTABLE
            and len(getattr(value, "shape", ())) >= 2)


def _tensor(v, device):
    """An NDArray's or numpy array's values as a tensor on ``device``
    (no copy when it is there already)."""
    import torch
    from ..ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


class _CastForward(object):
    """The bfloat16 / int8 serving executor: the stored (bfloat16, or
    int8 + float32 scale) weights stay on the device, and each forward
    writes their float32 values into a ``Predictor``'s bound arrays, runs
    it, and drops them again.  Between forwards those arrays hold a
    zero-stride view of one scalar, so the float32 weights occupy memory
    only while a forward runs.  The ``Predictor``'s per-shape executor
    cache is the float32 path's, so the bucket bit-exactness contract
    holds unchanged."""

    def __init__(self, model):
        self._ctx = model.ctx
        self._pred = None
        self.refresh(model)

    def refresh(self, model):
        """(Re-)stage ``model``'s current params on the device — the
        low-precision half of the hot-swap path (``swap_params``).  The
        cached executors survive: they read their bound arrays at every
        forward."""
        dev = self._ctx.torch_device
        #: "arg:name"/"aux:name" -> (stored tensor, float32 scale or None)
        self._stage = {}
        for prefix, params in (("arg", model.arg_params),
                               ("aux", model.aux_params)):
            for k, v in params.items():
                s = model._wt_scales.get(k) if prefix == "arg" else None
                self._stage["%s:%s" % (prefix, k)] = (
                    _tensor(v, dev),
                    None if s is None else _tensor(s, dev))
        if self._pred is not None:
            for key, arr in self._targets():
                t, s = self._stage[key]
                if not self._expands(t, s):
                    arr._data = t
        return self

    @staticmethod
    def _expands(t, s):
        import torch
        return s is not None or t.dtype == torch.bfloat16

    @staticmethod
    def _float(t, s):
        """The float32 values one stored tensor serves: ``q.float() * s``
        (numpy's dequantize, one float32 multiply) or the upcast."""
        return t.float() * s if s is not None else t.float()

    def _targets(self):
        for prefix, d in (("arg", self._pred._arg_params),
                          ("aux", self._pred._aux_params)):
            for k, arr in d.items():
                yield "%s:%s" % (prefix, k), arr

    def _placeholder(self, t):
        import torch
        return torch.zeros((), dtype=torch.float32,
                           device=t.device).expand(t.shape)

    def _predictor(self, model, shapes):
        from .. import predict
        from ..ndarray import NDArray
        if self._pred is None:
            blob = {}
            for key, (t, s) in self._stage.items():
                data = self._placeholder(t) if self._expands(t, s) else t
                blob[key] = NDArray._from_torch(data, self._ctx)
            self._pred = predict.Predictor(model.symbol, blob, shapes,
                                           ctx=self._ctx)
        else:
            self._pred.reshape(shapes)
        return self._pred

    def forward(self, model, inputs, shapes, new_sig):
        pred = self._pred if self._pred is not None and not new_sig \
            else self._predictor(model, shapes)
        live = [(arr, self._stage[key]) for key, arr in self._targets()
                if self._expands(*self._stage[key])]
        try:
            for arr, (t, s) in live:
                arr._data = self._float(t, s)
            pred.forward(**inputs)
            return [pred.get_output(i)
                    for i in range(len(model.output_names))]
        finally:
            for arr, (t, s) in live:
                arr._data = self._placeholder(t)

    def resident_weight_bytes(self):
        """Device bytes held by the stored low-precision weights (int8 +
        scales, or the bfloat16 tensors) — the figure the memory tests pin
        at about 1/4 (int8) of float32."""
        total = 0
        for t, s in self._stage.values():
            if self._expands(t, s):
                total += t.numel() * t.element_size()
                if s is not None:
                    total += s.numel() * s.element_size()
        return total


class PooledModel(object):
    """One warm model: symbol + device-resident params + a Predictor
    whose per-shape executor cache holds one executor per bucket.  All
    forwards are expected on ONE thread (the model's batcher
    dispatcher)."""

    def __init__(self, name, symbol, arg_params, aux_params=None,
                 dtype=None, ctx=None, sample_shapes=None):
        from .. import symbol as sym_mod
        from ..context import current_context
        self.name = name
        self.symbol = symbol if hasattr(symbol, "list_arguments") \
            else sym_mod.load_json(symbol)
        self.dtype = dtype if dtype is not None else get_env(ENV_SERVE_DTYPE)
        if (self.dtype or "float32") not in _DTYPES:
            raise MXNetError("serving dtype %r is not one of %s"
                             % (self.dtype, list(_DTYPES)))
        self.ctx = ctx if ctx is not None else current_context()
        #: name -> per-channel scale for int8-quantized weights (empty
        #: for every other dtype; filled by ``_cast``)
        self._wt_scales = {}
        self._lowp = None
        #: bucket -> loaded AOT program (serving/aot.py), and the device
        #: param/aux lists it is called with
        self._aot = {}
        self._aot_args = None
        self.arg_params = self._cast(arg_params or {})
        self.aux_params = self._cast(aux_params or {})
        #: checkpoint provenance: the epoch currently served (None for
        #: in-memory models) and, for directory loads, where new epochs
        #: appear — what CheckpointWatcher tails (serving/deploy.py)
        self.loaded_epoch = None
        self.source_dir = None
        self.source_prefix = "checkpoint"
        #: {input_name: per-sample shape} once declared or first served
        self.sample_shapes = dict(sample_shapes) if sample_shapes else None
        self._pred = None
        self._cur_shapes = None
        self._analyzed = set()      # signatures the gate found clean
        self._refused = {}          # signature -> strict-mode message
        arg_names = self.symbol.list_arguments()
        #: data inputs = arguments with no loaded weight that aren't
        #: loss labels (labels are zero-filled by Predictor.reshape)
        self.input_names = [n for n in arg_names
                            if n not in self.arg_params
                            and not n.endswith("label")]
        self.output_names = self.symbol.list_outputs()

    def _cast(self, params):
        if self.dtype in (None, "", "float32"):
            return dict(params)
        from ..ndarray import NDArray, _torch_dtype
        out = {}
        for k, v in params.items():
            if self.dtype == "int8":
                # weight-only quantization: dense/conv kernels go int8
                # per channel, everything else (biases, BN stats) rides
                # the float path unchanged
                if _int8_eligible(k, v):
                    q, s = quantize_int8(v)
                    out[k] = q
                    self._wt_scales[k] = s
                else:
                    out[k] = v
            elif _dtype_name(v) in _CASTABLE:
                # rounded once, stored on the device in the serving dtype
                out[k] = NDArray._from_torch(
                    _tensor(v, self.ctx.torch_device).to(
                        _torch_dtype(self.dtype)), self.ctx)
            else:
                out[k] = v
        return out

    def _blob(self):
        blob = {"arg:%s" % k: v for k, v in self.arg_params.items()}
        blob.update({"aux:%s" % k: v for k, v in self.aux_params.items()})
        return blob

    def forward(self, inputs, n_valid=None):
        """One batch forward at the given (bucket) shapes -> list of
        per-output numpy arrays.  Shapes repeat -> the Predictor's cached
        executor; a new shape binds once.  ``n_valid`` (how many leading
        rows are real vs padding) is accepted for batcher-runner
        compatibility; the whole padded batch always runs."""
        shapes = {k: tuple(np.shape(v)) for k, v in inputs.items()}
        new_sig = self._cur_shapes != shapes
        if new_sig:
            self._maybe_env_analyze(shapes)
        aot_fn = self._aot_forward_for(shapes)
        if aot_fn is not None:
            outs = self._aot_call(aot_fn, inputs)
            self._cur_shapes = shapes
        elif self.dtype not in (None, "", "float32"):
            if self._lowp is None:
                self._lowp = _CastForward(self)
                new_sig = True
            outs = self._lowp.forward(self, inputs, shapes, new_sig)
            self._cur_shapes = shapes
        else:
            from .. import predict
            if self._pred is None:
                self._pred = predict.Predictor(self.symbol, self._blob(),
                                               shapes, ctx=self.ctx)
            elif new_sig:
                self._pred.reshape(shapes)
            self._cur_shapes = shapes
            self._pred.forward(**inputs)
            outs = [self._pred.get_output(i)
                    for i in range(len(self.output_names))]
        if self.sample_shapes is None:
            # commit only AFTER a successful forward: a malformed first
            # request must never pin wrong shapes and brick the model
            # for every correct request that follows
            self.sample_shapes = {k: s[1:] for k, s in shapes.items()}
        return outs

    def resident_weight_bytes(self):
        """Device bytes of the stored low-precision weights (None for a
        float32 model, or before its first forward)."""
        return None if self._lowp is None \
            else self._lowp.resident_weight_bytes()

    def warmup(self, buckets):
        """Bind (and fault in) one executor per bucket ahead of traffic.
        Needs ``sample_shapes`` (declared at load time or via the first
        request)."""
        if self.sample_shapes is None:
            raise MXNetError(
                "model %r has no declared sample_shapes to warm up "
                "(pass sample_shapes= at load, or serve one request "
                "first)" % self.name)
        rs = np.random.RandomState(0)
        for b in buckets:
            dummy = {k: rs.rand(int(b), *s).astype(np.float32)
                     for k, s in self.sample_shapes.items()}
            self.forward(dummy)
        return self

    # -- hot swap (serving/deploy.py) ---------------------------------------
    @staticmethod
    def _param_sig(params):
        """{name: (shape, dtype)} — the program identity of a parameter
        set.  Two sets with equal signatures run the SAME cached
        executors; anything else is a different program."""
        return {k: (tuple(int(n) for n in np.shape(v)), _dtype_name(v))
                for k, v in params.items()}

    @staticmethod
    def _shelve(params):
        """A rollback-safe snapshot of a param dict: a COPY of every
        tensor (``clone``), never a reference.  The Predictor swap path
        replaces its bound arrays' tensors, and a bound array may be the
        very NDArray held here — a snapshot of references would restore
        the new weights onto themselves."""
        from ..ndarray import NDArray
        return {k: (NDArray._from_torch(v._data.clone(), v.context)
                    if isinstance(v, NDArray) else np.array(v, copy=True))
                for k, v in params.items()}

    def swap_params(self, arg_params, aux_params=None):
        """Hot-swap this model's device-resident weights to RAW
        checkpoint values (the pool's dtype cast / int8 quantization is
        re-applied here, exactly as at load).  Returns an opaque
        snapshot of the previous weights for :meth:`restore_params`.

        The caller owns the dispatch boundary: run this inside
        :meth:`BucketBatcher.run_exclusive` (``CheckpointWatcher``
        does) so no batch forward is in flight.

        The parameter SET must be identical after the cast (names,
        shapes, dtypes): every cached executor is reused as-is, so a
        different set is a different program: a restart, not a swap."""
        snapshot = (self._shelve(self.arg_params),
                    self._shelve(self.aux_params),
                    dict(self._wt_scales))
        prev_scales = self._wt_scales
        self._wt_scales = {}
        try:
            new_args = self._cast(arg_params or {})
            new_auxs = self._cast(aux_params or {})
            if self._param_sig(new_args) != self._param_sig(snapshot[0]) \
                    or self._param_sig(new_auxs) != \
                    self._param_sig(snapshot[1]):
                raise MXNetError(
                    "model %r: the swapped-in parameter set does not "
                    "match the serving set (names/shapes/dtypes) — a "
                    "program change needs a reload, swaps only change "
                    "weights" % self.name)
            self._install(new_args, new_auxs, self._wt_scales)
        except Exception:
            self._wt_scales = prev_scales
            raise
        return snapshot

    def restore_params(self, snapshot):
        """Roll back to a :meth:`swap_params` snapshot (the post-swap
        probe-failed path)."""
        self._install(*snapshot)
        return self

    def _install(self, arg_params, aux_params, wt_scales):
        """Point every serving path at these (already-cast) params: the
        Predictor's bound executors, the low-precision device stage, and
        the loaded AOT programs' call-time param lists."""
        self.arg_params = arg_params
        self.aux_params = aux_params
        self._wt_scales = wt_scales
        if self._pred is not None:
            self._pred.set_params(self._blob())
        if self._lowp is not None:
            self._lowp.refresh(self)
        if self._aot_args is not None:
            self._aot_args = self._aot_param_lists()

    # -- AOT program store (serving/aot.py) ---------------------------------
    def _aot_param_lists(self):
        """The loaded programs' call-time ``(param_list, aux_list)``: this
        model's device-resident tensors in sorted-name order."""
        from .aot import dev_array
        dev = self.ctx.torch_device
        return ([dev_array(self.arg_params[n], dev)
                 for n in sorted(self.arg_params)],
                [dev_array(self.aux_params[n], dev)
                 for n in sorted(self.aux_params)])

    def _aot_forward_for(self, shapes):
        """The loaded AOT program for these batch shapes when they are
        exactly a loaded bucket's, or None (the Predictor path).  A
        program runs the Predictor's aten ops on each bucket's concrete
        shapes, so the bucket bit-stability contract is unchanged."""
        if not self._aot or self.sample_shapes is None:
            return None
        b = next(iter(shapes.values()))[0]
        fn = self._aot.get(b)
        if fn is None:
            return None
        want = {k: (b,) + tuple(s) for k, s in self.sample_shapes.items()}
        return fn if shapes == want else None

    def _aot_call(self, fn, inputs):
        """One forward through a loaded program -> per-output numpy."""
        import torch
        dev = self.ctx.torch_device
        pv, av = self._aot_args
        xs = [torch.from_numpy(np.ascontiguousarray(inputs[n],
                                                    dtype=np.float32))
              .to(dev) for n in sorted(inputs)]
        with torch.no_grad():
            outs = fn(pv, av, *xs)
        return [o.cpu().numpy() for o in outs[:len(self.output_names)]]

    def export_aot(self, buckets, store_dir):
        """Export this model's forward for every bucket into
        ``store_dir`` (the fleet warm-store build; weight-free programs,
        see serving/aot.py): one batch-dynamic program written for each
        bucket, or, when the plan fixes the batch, one program a
        bucket (the LM's init-state fills carry the batch).  Every
        forward kernel is a registered ``mxt`` op, so the programs of
        LSTM, attention and rtc graphs launch their kernels as the
        ``Predictor`` does.  int8 pools keep their in-process path (the
        dequantizing forward is built per process) and refuse; a graph
        with a ``Custom`` op refuses too, before anything is written."""
        from . import aot
        if self.sample_shapes is None:
            raise MXNetError("model %r: declare sample_shapes before "
                             "export_aot()" % self.name)
        if self._wt_scales:
            raise MXNetError("model %r: int8 pools cannot export AOT "
                             "programs (the dequantizing forward is built "
                             "in-process)" % self.name)
        aot.refuse_unexportable(self.symbol,
                                "model %r: export_aot" % self.name)
        dev = self.ctx.torch_device
        store = aot.AotStore(store_dir, aot.platform_of(self.ctx), dev)
        meta = aot.entry_meta(self)
        buckets = sorted(int(b) for b in buckets)
        from torch._dynamo.exc import UserError
        try:
            # one batch-dynamic program serves every bucket
            program, _, signature = aot.build_forward(
                self.symbol, self.arg_params, self.aux_params,
                self.sample_shapes, buckets[-1], dev, dynamic_batch=True)
            programs = dict.fromkeys(buckets, (aot.save_program(program),
                                               signature))
        except UserError as e:      # the plan fixes the batch
            _log().info("model %r: no batch-dynamic program (%s: %s); one "
                        "program a bucket", self.name, type(e).__name__, e)
            programs = {}
            for b in buckets:
                program, _, signature = aot.build_forward(
                    self.symbol, self.arg_params, self.aux_params,
                    self.sample_shapes, b, dev)
                programs[b] = (aot.save_program(program), signature)
        for b, (blob, signature) in programs.items():
            store.save(self.name, b, blob, meta, signature)
        return store

    def load_aot(self, store_dir, buckets=None):
        """Load this model's programs from an AOT store -> number of
        buckets loaded (0 = nothing usable: an absent store, another
        model, dtype or parameter set, a foreign platform or runtime, or
        an int8 pool, an rtc body this process has not registered; the
        caller falls back to :meth:`warmup`).  One loaded program is
        validated with a real call, so a corrupt store surfaces at
        bring-up, not at the first request: its outputs must have the
        shapes ``symbol.infer_shape`` gives at that bucket (a time-major
        LM answers (T * b, V) rows; the JAX package's check of the first
        output's leading dim against the bucket refuses it)."""
        from . import aot
        if self._wt_scales:
            return 0                    # int8: in-process path only
        store = aot.AotStore(store_dir, aot.platform_of(self.ctx),
                             self.ctx.torch_device)
        if store.verify(self.name, aot.entry_meta(self)) is None:
            return 0
        have = store.buckets(self.name)
        wanted = sorted(int(b) for b in buckets) if buckets else have
        loaded = {}
        for b in wanted:
            if b not in have:
                continue
            fn = store.load(self.name, b)
            if fn is not None:
                loaded[b] = fn
        if not loaded:
            return 0
        prev_args = self._aot_args
        if self._aot_args is None:
            self._aot_args = self._aot_param_lists()
        # fault-in + integrity: one real forward through the smallest
        # loaded bucket (a program that cannot run must not serve)
        b0 = min(loaded)
        rs = np.random.RandomState(0)
        try:
            xs = {k: rs.rand(b0, *self.sample_shapes[k]).astype(np.float32)
                  for k in sorted(self.sample_shapes)}
            outs = self._aot_call(loaded[b0], xs)
            _, want, _ = self.symbol.infer_shape(
                **{k: v.shape for k, v in xs.items()})
            got = [tuple(np.shape(o)) for o in outs]
            if got != [tuple(s) for s in want]:
                raise MXNetError("wrong validation output shape: %s, the "
                                 "graph gives %s at bucket %d"
                                 % (got, want, b0))
        except Exception as e:  # noqa: BLE001 — stale/corrupt store
            _log().warning("AOT store %s: validation call failed for "
                           "%r (%s: %s) — falling back to the bucket "
                           "warmup", store_dir, self.name,
                           type(e).__name__, e)
            self._aot_args = prev_args
            return 0
        self._aot.update(loaded)
        return len(loaded)

    # -- static analysis ---------------------------------------------------
    def analyze(self, bucket=1):
        """mxlint graph lint of this model's bucket-``bucket`` forward
        (an inference forward obeys the same host-sync/dtype/kernel rules
        as a training step, has no carries, and on one device shows NO
        collectives).  The weights are the values the forward serves:
        an int8 model's dequantized ``q * scale``, a bfloat16 model's
        upcast.  Returns the :class:`~..analysis.report.Report`."""
        import torch
        from ..analysis import graph_lint
        from ..executor import _build_eval
        if self.sample_shapes is None:
            raise MXNetError("model %r: declare sample_shapes before "
                             "analyze()" % self.name)
        dev = self.ctx.torch_device
        eval_fn = _build_eval(self.symbol)

        def served(params, scales=None):
            out = {}
            for k, v in params.items():
                t = _tensor(v, dev)
                s = (scales or {}).get(k)
                # the int8 path serves dequantized weights, the bfloat16
                # path upcast ones — lint the math that actually runs
                out[k] = _CastForward._float(
                    t, None if s is None else _tensor(s, dev)) \
                    if s is not None or t.dtype == torch.bfloat16 else t
            return out

        params = served(self.arg_params, self._wt_scales)
        auxs = served(self.aux_params)
        shapes = {k: (int(bucket),) + tuple(s)
                  for k, s in self.sample_shapes.items()}
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**shapes)
        for n, shp in zip(self.symbol.list_arguments(), arg_shapes):
            if n not in params and n not in shapes:
                params[n] = torch.zeros(shp, dtype=torch.float32, device=dev)
        for n, shp in zip(self.symbol.list_auxiliary_states(), aux_shapes):
            if n not in auxs:
                auxs[n] = torch.zeros(shp, dtype=torch.float32, device=dev)
        input_names = sorted(shapes)

        def infer(*inputs):
            merged = dict(params)
            merged.update(zip(input_names, inputs))
            with torch.no_grad():
                outs, _ = eval_fn(merged, auxs, False, 0, device=dev)
            return tuple(outs)

        rs = np.random.RandomState(0)
        args = [torch.from_numpy(rs.rand(*shapes[n]).astype(np.float32))
                .to(dev) for n in input_names]
        report = graph_lint.lint_step(infer, *args, expect_allgather=False)
        # plan-fusion-parity: the served graph's mxfuse rewrite (the
        # bn_fold serving default and the inference-trace pruning
        # included) must keep the plain-plan monitored path intact
        report.merge(graph_lint.audit_plan_fusion(self.symbol))
        return report

    def _maybe_env_analyze(self, shapes):
        """The ``MXTPU_ANALYZE`` gate, per new signature: warn (``1``) or
        refuse to serve (``strict``) on findings."""
        from ..analysis import ENV_ANALYZE
        mode = get_env(ENV_ANALYZE)
        if not mode or str(mode).strip().lower() in ("0", "off", "false",
                                                     "no"):
            return
        sig = tuple(sorted(shapes.items()))
        if sig in self._refused:
            # a strict refusal is STICKY: a retry of the same signature
            # must not slip the violating forward into service
            raise MXNetError(self._refused[sig])
        if sig in self._analyzed:
            return
        bucket = next(iter(shapes.values()))[0]
        report = self.analyze(bucket=bucket)
        if report.ok:
            self._analyzed.add(sig)
            _log().info("MXTPU_ANALYZE: serving forward %s@%s is clean",
                        self.name, bucket)
            return
        text = report.format_text()
        if str(mode).strip().lower() == "strict":
            msg = ("MXTPU_ANALYZE=strict: serving forward %s@%s has "
                   "findings:\n%s" % (self.name, bucket, text))
            self._refused[sig] = msg
            raise MXNetError(msg)
        self._analyzed.add(sig)
        _log().warning("MXTPU_ANALYZE: serving forward %s@%s has "
                       "findings:\n%s", self.name, bucket, text)


def _log():
    import logging
    return logging.getLogger(__name__)


class ModelPool(object):
    """Name -> :class:`PooledModel` registry (admin ops are locked; the
    per-model forward path is single-threaded by its batcher).  ``ctx``
    is resolved once, here (default: ``current_context()``, ``gpu(0)``
    outside a ``with`` scope)."""

    def __init__(self, ctx=None, dtype=None):
        from ..context import current_context
        self.ctx = ctx if ctx is not None else current_context()
        self.dtype = dtype
        self._models = {}
        self._lock = threading.Lock()

    def _put(self, entry):
        with self._lock:
            self._models[entry.name] = entry
        return entry

    def add(self, name, symbol, arg_params=None, aux_params=None,
            sample_shapes=None, dtype=None):
        """Register an in-memory model."""
        return self._put(PooledModel(
            name, symbol, arg_params, aux_params,
            dtype=dtype if dtype is not None else self.dtype,
            ctx=self.ctx, sample_shapes=sample_shapes))

    def load(self, name, prefix, epoch=0, sample_shapes=None, dtype=None):
        """Load ``prefix-symbol.json`` + ``prefix-%04d.params`` (the
        ``save_checkpoint`` pair)."""
        from ..model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        entry = self._put(PooledModel(
            name, symbol, arg_params, aux_params,
            dtype=dtype if dtype is not None else self.dtype,
            ctx=self.ctx, sample_shapes=sample_shapes))
        entry.loaded_epoch = int(epoch)
        return entry

    def load_dir(self, name, directory, epoch=None, sample_shapes=None,
                 dtype=None):
        """Load the newest intact epoch from a ``CheckpointManager``
        directory (checksum-verified, walk-back past corrupt epochs)."""
        from ..resilience import CheckpointManager
        man = CheckpointManager(directory)
        symbol, arg_params, aux_params, _states, ep = man.restore(epoch)
        if symbol is None:
            raise MXNetError(
                "checkpoint directory %r has no symbol file — serving "
                "needs the graph, not just params" % directory)
        entry = self._put(PooledModel(
            name, symbol, arg_params, aux_params,
            dtype=dtype if dtype is not None else self.dtype,
            ctx=self.ctx, sample_shapes=sample_shapes))
        entry.loaded_epoch = ep
        entry.source_dir = os.fspath(directory)
        entry.source_prefix = man.prefix
        return entry

    def get(self, name):
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise MXNetError("no model %r in the pool (have: %s)"
                             % (name, self.names()))
        return entry

    def __contains__(self, name):
        with self._lock:
            return name in self._models

    def names(self):
        with self._lock:
            return sorted(self._models)

    def remove(self, name):
        with self._lock:
            self._models.pop(name, None)

    def warmup(self, buckets, names=None):
        """Warm every (or the named) model over ``buckets``."""
        for n in (self.names() if names is None else names):
            self.get(n).warmup(buckets)
        return self
