"""SPMDTrainer — the fused training step, on one device (port of
``mxnet_tpu/parallel/trainer.py:79-1314`` with ``mesh=None``).

One :meth:`SPMDTrainer.step` runs forward, backward (torch autograd over
the executor's fused plan, the parameters the only leaves), the all-finite
guard and the optimizer update (the registered update ops of
``ops/tensor.py``) on the trainer's device, with no host read inside the
step.  The guard's skip counters live on the device as one int32[3]
tensor and are read one step late, at the next step's entry
(:meth:`flush_step_guard`), as in the JAX package.

Numerics match the JAX package's: gradients are summed over the batch
(pass ``rescale_grad=1/batch``), weight decay follows the optimizer's
per-name multipliers (gammas keep it), Adam's bias correction uses the
applied-update count.  The JAX package compiles the step into one XLA
program that updates in place; here the step runs eagerly and makes new
parameter tensors each step.

``remat=True`` (or ``MXNET_BACKWARD_DO_MIRROR=1``) runs the step's
forward as checkpointed segments that the backward recomputes.  Arguments
that belong to later slices of the port (a mesh, zero/zero3 gradient
sync, a sharding plan, parameter shardings, deferred metrics, the
watchdog, fault injection) raise :class:`MXNetError`.
"""
from __future__ import annotations

import logging
import math
import pickle

import numpy as np
import torch

from .. import optimizer as opt_mod
from .. import random as _random
from ..base import (ENV_MAX_BAD_STEPS, ENV_STEP_GUARD, MXNetError, get_env,
                    register_env)
from ..context import Context, cpu, current_context
from ..executor import (ENV_BACKWARD_DO_MIRROR, _build_eval,
                        mirror_segments_for)
from ..io import DataDesc
from ..ndarray import NDArray, tensor_from_numpy, zeros as nd_zeros
from ..ops import tensor as T

__all__ = ["SPMDTrainer", "SUPPORTED_OPTIMIZERS", "UPDATE_RANGE"]

#: the ``torch.profiler.record_function`` range around each step's
#: guard + optimizer update + aux merge
UPDATE_RANGE = "SPMDTrainer.update"

#: optimizers with an in-step update rule (_apply_update)
SUPPORTED_OPTIMIZERS = ("sgd", "ccsgd", "adam", "rmsprop")

ENV_GRAD_SYNC = register_env(
    "MXNET_GRAD_SYNC", default="allreduce",
    doc="Gradient sync of the fused step: allreduce on one device here; "
        "zero/zero3 come with the multi-GPU slice")
ENV_FAULTS = register_env(
    "MXTPU_FAULTS", default="",
    doc="Fault-injection points; come with the resilience slice")

_LOG = logging.getLogger(__name__)


def _later(what, slice_name):
    raise MXNetError("SPMDTrainer: %s is not ported yet (it comes with the "
                     "%s slice of mxnet_tpu_torch)" % (what, slice_name))


class SPMDTrainer(object):
    """Fused training step for a Symbol + Optimizer on one device.

    ``ctx`` is the device (the current context, ``gpu(0)`` by default);
    ``input_transforms`` maps an input name to a torch function applied to
    the batch inside the step."""

    def __init__(self, symbol, optimizer="sgd", optimizer_params=None,
                 mesh=None, data_axis="dp", param_shardings=None,
                 compute_dtype=None, remat=None, input_transforms=None,
                 grad_sync=None, step_guard=None,
                 max_consecutive_bad_steps=None, plan=None, ctx=None):
        if mesh is not None:
            _later("a device mesh", "multi-GPU")
        if grad_sync is None:
            grad_sync = get_env(ENV_GRAD_SYNC, "allreduce")
        if grad_sync != "allreduce":
            _later("grad_sync=%r" % (grad_sync,), "multi-GPU")
        if plan is not None:
            _later("a sharding plan", "multi-GPU")
        if param_shardings:
            _later("param_shardings", "multi-GPU")
        if remat is None:
            remat = str(get_env(ENV_BACKWARD_DO_MIRROR, "0")) == "1"
        self.remat = bool(remat)
        if str(get_env(ENV_FAULTS, "")).strip():
            _later("fault injection (MXTPU_FAULTS)", "resilience")
        self.symbol = symbol
        self.mesh = None
        self.grad_sync = "allreduce"
        self.data_axis = data_axis
        self._ctx = Context(ctx) if ctx is not None else current_context()
        self._device = self._ctx.torch_device
        self.input_transforms = dict(input_transforms or {})
        self.compute_dtype = None
        if compute_dtype is not None:
            from ..ndarray import _torch_dtype
            self.compute_dtype = _torch_dtype(compute_dtype)
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        kind = type(optimizer).__name__.lower()
        if kind not in SUPPORTED_OPTIMIZERS:
            raise MXNetError(
                "SPMDTrainer: in-step rule for optimizer %r not implemented "
                "(sgd/adam/rmsprop supported)" % kind)
        self.optimizer = optimizer
        # remat: the step's forward as checkpointed segments, recomputed
        # by the backward (the memory mirror mode)
        self._eval = _build_eval(
            symbol,
            mirror_segments=mirror_segments_for(symbol, force=self.remat))
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()

        # NaN/Inf step guard: an all-finite check over the gradients on
        # the device; a non-finite step applies NO update (params, aux and
        # optimizer state pass through unchanged by torch.where) and
        # counts itself in the device-side (total, consecutive, trips)
        # int32[3] counters, which the host reads one step late
        if step_guard is None:
            step_guard = str(get_env(ENV_STEP_GUARD, "1")) != "0"
        self.step_guard = bool(step_guard)
        if max_consecutive_bad_steps is None:
            max_consecutive_bad_steps = int(get_env(ENV_MAX_BAD_STEPS, "10"))
        self.max_consecutive_bad_steps = int(max_consecutive_bad_steps)
        self._skipped_steps = 0           # total guarded skips, ever
        self._consecutive_bad_steps = 0   # current bad-step run length
        self._skip_base = 0               # host total when counters placed
        self._guard_acc = None            # device (total, consec, trips) i32
        self._guard_pending = False       # unread counters in flight
        self._trips_seen = 0              # abort events already raised
        self.last_step_skipped = False    # most recently FLUSHED step
        self.watchdog = None
        self.params = None        # dict name -> tensor (float32 master)
        self.aux = None
        self.opt_state = None
        self._num_update = 0
        self._outputs = None

    # -- setup ------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None):
        data_shapes = [d if isinstance(d, DataDesc) else DataDesc(d[0], d[1])
                       for d in data_shapes]
        label_shapes = [l if isinstance(l, DataDesc) else DataDesc(l[0], l[1])
                        for l in (label_shapes or [])]
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [l.name for l in label_shapes]
        self.input_names = self.data_names + self.label_names
        unknown_tf = set(self.input_transforms) - set(self.input_names)
        if unknown_tf:
            raise MXNetError(
                "input_transforms keys %s are not bound inputs %s"
                % (sorted(unknown_tf), self.input_names))
        shapes = {d.name: d.shape for d in data_shapes + label_shapes}
        arg_shapes, out_shapes, aux_shapes = self.symbol.infer_shape(**shapes)
        self.arg_shapes = dict(zip(self.arg_names, arg_shapes))
        self.aux_shapes = dict(zip(self.aux_names, aux_shapes))
        self.out_shapes = out_shapes
        self.param_names = [n for n in self.arg_names
                            if n not in self.input_names]
        self.batch_size = data_shapes[0].shape[0]
        # seed the per-name wd/lr multipliers now that param names are
        # known (zero wd for biases and betas), keeping multipliers the
        # user already set
        self.optimizer.idx2name = dict(enumerate(self.param_names))
        user_lr = dict(getattr(self.optimizer, "lr_mult", {}) or {})
        user_wd = dict(getattr(self.optimizer, "wd_mult", {}) or {})
        self.optimizer.set_wd_mult({})
        self.optimizer.set_lr_mult({})
        self.optimizer.lr_mult.update(user_lr)
        self.optimizer.wd_mult.update(user_wd)
        return self

    def init_params(self, initializer, arg_params=None, aux_params=None):
        """Allocate params and aux on the trainer's device: from
        ``arg_params``/``aux_params`` (NDArrays or numpy) where given,
        else from ``initializer``; then zero optimizer state."""
        params, aux = {}, {}
        for name in self.param_names:
            arr = nd_zeros(self.arg_shapes[name], ctx=self._ctx)
            if arg_params and name in arg_params:
                arr[:] = arg_params[name]
            elif initializer is not None:
                initializer(name, arr)
            params[name] = arr._data
        for name in self.aux_names:
            arr = nd_zeros(self.aux_shapes[name], ctx=self._ctx)
            if aux_params and name in aux_params:
                arr[:] = aux_params[name]
            elif initializer is not None:
                initializer(name, arr)
            aux[name] = arr._data
        self.params = params
        self.aux = aux
        self.opt_state = self._init_opt_state()

    def _init_opt_state(self):
        state = {}
        kind = type(self.optimizer).__name__.lower()
        for name in self.param_names:
            p = self.params[name]
            if kind in ("sgd", "ccsgd") and \
                    getattr(self.optimizer, "momentum", 0.0):
                s = (torch.zeros_like(p),)
            elif kind == "adam":
                s = (torch.zeros_like(p), torch.zeros_like(p))
            elif kind == "rmsprop":
                s = (torch.zeros_like(p),)
            else:
                s = ()
            state[name] = s
        return state

    # -- the fused step ----------------------------------------------------
    def _apply_update(self, name, p, g, s, lr, wd, t):
        """The optimizer rule for one parameter (same ops as the
        reference's server-side update, optimizer_op.cc)."""
        o = self.optimizer
        clip = o.clip_gradient if o.clip_gradient is not None else -1.0
        rescale = o.rescale_grad
        lr = lr * o.lr_mult.get(name, 1.0)
        wd = wd * o.wd_mult.get(name, 1.0)
        kind = type(o).__name__.lower()
        if kind in ("sgd", "ccsgd"):
            if s:
                w, m = T.sgd_mom_update(p, g, s[0], lr=lr,
                                        momentum=o.momentum, wd=wd,
                                        rescale_grad=rescale,
                                        clip_gradient=clip)
                return w, (m,)
            return T.sgd_update(p, g, lr=lr, wd=wd, rescale_grad=rescale,
                                clip_gradient=clip), ()
        if kind == "adam":
            coef1 = 1.0 - o.beta1 ** t
            coef2 = 1.0 - o.beta2 ** t
            lr_t = lr * math.sqrt(coef2) / coef1
            w, mean, var = T.adam_update(p, g, s[0], s[1], lr=lr_t,
                                         beta1=o.beta1, beta2=o.beta2,
                                         epsilon=o.epsilon, wd=wd,
                                         rescale_grad=rescale,
                                         clip_gradient=clip)
            return w, (mean, var)
        if kind == "rmsprop":
            w, n = T.rmsprop_update(p, g, s[0], lr=lr, gamma1=o.gamma1,
                                    epsilon=o.epsilon, wd=wd,
                                    rescale_grad=rescale, clip_gradient=clip,
                                    clip_weights=-1.0)
            return w, (n,)
        raise MXNetError("SPMDTrainer: in-step rule for optimizer %r not "
                         "implemented (sgd/adam/rmsprop supported)" % kind)

    def _cast(self, params):
        """The compute-dtype copy of the float32 master, made per step."""
        if self.compute_dtype is None:
            return params
        return {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                for k, v in params.items()}

    def _xform(self, data):
        tf = self.input_transforms
        return {k: (tf[k](v) if k in tf else v) for k, v in data.items()}

    def _step_tail(self, outs, auxu, grads, lr, wd, t):
        """The epilogue of the step (the JAX package's :665-757): the
        all-finite guard over the gradients, the optimizer update, the aux
        merge and the stacked int32[3] skip counters — device work only."""
        params, aux, opt_state = self.params, self.aux, self.opt_state
        guard = self.step_guard
        finite = None
        if guard:
            finite = torch.isfinite(torch.cat(
                [grads[n].reshape(-1) for n in self.param_names])).all()
        new_params, new_state = {}, {}
        for name in self.param_names:
            g = grads[name].to(params[name].dtype)
            w, s = self._apply_update(name, params[name], g,
                                      opt_state[name], lr, wd, t)
            if guard:
                # non-finite step: params AND optimizer state pass
                # through unchanged
                w = torch.where(finite, w, params[name])
                s = tuple(torch.where(finite, sn, so)
                          for sn, so in zip(s, opt_state[name]))
            new_params[name] = w
            new_state[name] = s
        new_aux = dict(aux)
        for name, v in auxu.items():
            # BN moving stats from a poisoned batch must not stick either
            new_aux[name] = torch.where(finite, v, aux[name]) if guard else v
        if guard:
            acc = self._guard_acc
            total, consec, trips = acc[0], acc[1], acc[2]
            new_consec = torch.where(finite, torch.zeros_like(consec),
                                     consec + 1)
            if self.max_consecutive_bad_steps > 0:
                trips = trips + (new_consec == self.max_consecutive_bad_steps
                                 ).to(trips.dtype)
            self._guard_acc = torch.stack(
                [torch.where(finite, total, total + 1), new_consec, trips])
        self.params, self.aux, self.opt_state = new_params, new_aux, new_state
        return [o.detach() for o in outs]

    def _stage(self, batch_arrays):
        """Input dict on the device: NDArrays and tensors as they are,
        numpy through a host copy; floating inputs cast to the compute
        dtype."""
        if len(batch_arrays) != len(self.input_names):
            raise MXNetError("step: %d arrays given for inputs %s"
                             % (len(batch_arrays), self.input_names))
        out = {}
        for name, v in zip(self.input_names, batch_arrays):
            if isinstance(v, NDArray):
                v = v._data
            elif not isinstance(v, torch.Tensor):
                v = tensor_from_numpy(np.asarray(v))
            v = v.to(self._device)
            if self.compute_dtype is not None and v.is_floating_point():
                v = v.to(self.compute_dtype)
            out[name] = v
        return out

    # -- public API --------------------------------------------------------
    def step(self, *batch_arrays, key=None):
        """One training step on data+labels in ``input_names`` order
        (numpy, NDArrays, or tensors already on the device).  Returns the
        outputs as tensors on the device.  ``key`` is the integer seed of
        the step's random draws (dropout masks), a new one from
        :func:`random.next_seed` when None: a caller that previewed the
        step with ``forward_only(key=k)`` passes the same ``k`` so both
        passes draw the same masks."""
        # consume the PREVIOUS step's guard counters before dispatching
        # this one: a one-deep pipeline (the device runs step N while the
        # host prepares N+1)
        self.flush_step_guard()
        data = self._stage(batch_arrays)
        if key is None:
            key = _random.next_seed()
        self._num_update += 1
        lr = self.optimizer.lr if self.optimizer.lr_scheduler is None else \
            self.optimizer.lr_scheduler(self._num_update)
        if self.step_guard and self._guard_acc is None:
            self._guard_acc = torch.zeros(3, dtype=torch.int32,
                                          device=self._device)
            self._trips_seen = 0
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        with torch.enable_grad():
            merged = self._xform(data)
            merged.update(self._cast(leaves))
            outs, auxu = self._eval(merged, self.aux, True, key)
            diff = [o for o in outs if o.requires_grad]
            grads = [None] * len(self.param_names)
            if diff:
                grads = torch.autograd.grad(
                    diff, [leaves[n] for n in self.param_names],
                    [torch.ones_like(o) for o in diff], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(leaves[n]))
                 for n, g in zip(self.param_names, grads)}
        # the named range lets a profile attribute the update's kernels
        with torch.no_grad(), torch.profiler.record_function(UPDATE_RANGE):
            outs = self._step_tail(outs, auxu, grads, lr,
                                   self.optimizer.wd, self._num_update)
        if self.step_guard:
            self._guard_pending = True
        self._outputs = outs
        return outs

    @property
    def skipped_steps(self):
        """Total guard-skipped updates (flushes the in-flight counters)."""
        self.flush_step_guard()
        return self._skipped_steps

    @property
    def consecutive_bad_steps(self):
        """Current run of guard-skipped updates (flushes)."""
        self.flush_step_guard()
        return self._consecutive_bad_steps

    def flush_step_guard(self):
        """Fold the device-side skip counters into host state: ONE
        device->host read of the int32[3] stack, which waits for the last
        dispatched step.  Called at step() entry, at get_params/set_params
        and by the counter properties.  A skipped step rolls the update
        counter back, so lr schedules and Adam's bias correction see only
        applied steps.  Raises the consecutive-bad-steps abort when the
        flushed run reached the limit."""
        if not self._guard_pending:
            return
        self._guard_pending = False
        acc = self._guard_acc.cpu().numpy()
        total, consec, trips = int(acc[0]), int(acc[1]), int(acc[2])
        total += self._skip_base
        delta = total - self._skipped_steps
        self.last_step_skipped = consec > 0
        self._consecutive_bad_steps = consec
        if delta > 0:
            self._num_update -= delta
            self._skipped_steps = total
            _LOG.warning(
                "step guard: non-finite gradients — %d update(s) skipped "
                "(%d consecutive, %d total)", delta,
                self._consecutive_bad_steps, self._skipped_steps)
        if trips > self._trips_seen and self.max_consecutive_bad_steps > 0:
            self._trips_seen = trips
            raise MXNetError(
                "step guard: %d consecutive steps produced non-finite "
                "gradients — model has diverged (raise MXTPU_MAX_BAD_STEPS "
                "or set MXTPU_STEP_GUARD=0 to disable the guard)"
                % self.max_consecutive_bad_steps)

    def install_metric(self, graph_fn, flush_interval=0, key=None):
        _later("install_metric (deferred in-step metrics)", "Module")

    def install_watchdog(self, watchdog):
        if watchdog is not None:
            _later("the step watchdog", "resilience")
        return watchdog

    def _forward(self, batch_arrays, is_train, key):
        data = self._stage(batch_arrays)
        with torch.no_grad():
            merged = self._xform(data)
            merged.update(self._cast(self.params))
            outs, _ = self._eval(merged, self.aux, is_train, key)
        return outs

    def eval_step(self, *batch_arrays):
        """Inference-mode forward; outputs as tensors on the device."""
        return self._forward(batch_arrays, False, _random.next_seed())

    def forward_only(self, *batch_arrays, key=None):
        """Train-mode forward without the update (and without the aux
        update), for looking at outputs between steps.  With no ``key``
        it draws with the seed the next ``step`` will take (peeked, not
        taken), so stochastic layers give that step's masks."""
        if key is None:
            key = _random.peek_seed()
        return self._forward(batch_arrays, True, key)

    @property
    def outputs(self):
        return [NDArray._from_torch(o, self._ctx)
                for o in (self._outputs or [])]

    def get_params(self):
        """Copies of params and aux as host NDArrays (cpu context)."""
        self.flush_step_guard()
        host = cpu()

        def _copy(d):
            return {k: NDArray._from_torch(v.detach().to("cpu", copy=True),
                                           host) for k, v in d.items()}
        return _copy(self.params), _copy(self.aux)

    def set_params(self, arg_params, aux_params):
        """Replace parameter values, keeping optimizer state; names
        missing from the given dicts keep their values."""
        self.flush_step_guard()
        for current, given in ((self.params, arg_params),
                               (self.aux, aux_params)):
            for name, v in (given or {}).items():
                if name not in current:
                    continue
                if isinstance(v, NDArray):
                    v = v._data
                elif not isinstance(v, torch.Tensor):
                    v = tensor_from_numpy(np.asarray(v))
                cur = current[name]
                current[name] = v.to(cur.device, cur.dtype, copy=True)

    def get_states(self):
        """Serialized optimizer state (the ``Updater.get_states`` analog):
        a pickle of ``{"num_update", "states": {name: (numpy, ...)}}``, the
        JAX package's format."""
        self.flush_step_guard()
        host = {k: tuple(v.detach().cpu().numpy() for v in s)
                for k, s in self.opt_state.items()}
        return pickle.dumps({"num_update": self._num_update,
                             "states": host})

    def set_states(self, blob):
        """Restore optimizer state from :meth:`get_states`'s format, or
        from an ``Updater`` blob (``{index_or_name: state}``, what the
        executor route of a Module saves), so a checkpoint resumes across
        the two routes.  Restored state opens a fresh guard window: the
        pending counters and the consecutive-bad count are dropped, the
        lifetime skip total is kept."""
        self._guard_pending = False
        self._guard_acc = None
        self._skip_base = self._skipped_steps
        self._consecutive_bad_steps = 0
        payload = pickle.loads(blob)
        if isinstance(payload, dict) and "states" in payload \
                and "num_update" in payload:
            states = payload["states"]
            self._num_update = payload["num_update"]
            # this format records every param's slot tuple: a missing
            # param means the blob belongs to a different model
            missing = sorted(set(self.params) - set(states))
            if missing:
                raise MXNetError(
                    "optimizer-state blob has no entry for parameter(s) "
                    "%s — the checkpoint belongs to a different model"
                    % ", ".join(missing))
        else:
            idx2name = getattr(self.optimizer, "idx2name", {}) or {}
            states = {}
            for k, v in payload.items():
                name = idx2name.get(k, k)
                if v is None:
                    states[name] = ()
                elif isinstance(v, (tuple, list)):
                    states[name] = tuple(np.asarray(x) for x in v)
                else:
                    states[name] = (np.asarray(v),)
        placed = {}
        for name, s in states.items():
            if name not in self.params:
                raise MXNetError(
                    "optimizer state for unknown parameter %r" % (name,))
            p = self.params[name]
            placed[name] = tuple(
                tensor_from_numpy(np.asarray(x)).to(p.device, p.dtype)
                for x in s)
        for name in self.param_names:
            placed.setdefault(name, self.opt_state[name])
        self.opt_state = placed

    # -- lifecycle --------------------------------------------------------
    def close(self):
        """Drop this trainer's tensors (params, aux, optimizer state,
        outputs, counters); the trainer is unusable afterwards."""
        for attr in ("params", "aux", "opt_state", "_outputs", "_guard_acc"):
            setattr(self, attr, None)
        self._guard_pending = False
        self._eval = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False
