"""Multi-process runtime (port of ``mxnet_tpu/distributed.py``).

N symmetric processes, one per device, joined into one
``torch.distributed`` process group.  The JAX package joins them into one
global device topology and lets GSPMD place its collectives; here every
collective is an explicit call, routed through torch's functional
collectives (``torch.ops._c10d_functional.*``) so that the graph lint's
dispatch record sees each one.

- :func:`initialize` reads the ``MXTPU_*`` envs that ``tools/launch.py``
  plants (``MXTPU_COORDINATOR``, ``MXTPU_NUM_WORKERS``,
  ``MXTPU_WORKER_RANK``, ``MXTPU_PLATFORM``), joins through a TCP store at
  the coordinator's address (rank 0 hosts it) with the JAX package's
  retry ladder (``MXTPU_INIT_RETRIES``/``_TIMEOUT``/``_BACKOFF``), and
  does nothing unlaunched or in a helper process.  Each rank owns one
  device: ``gpu(rank % device_count)``, or ``cpu()`` under
  ``MXTPU_PLATFORM=cpu``; that device becomes the process's default
  context.  The backend is chosen once and printed: ``nccl`` when every
  rank has a card of its own, ``gloo`` when ranks share a card or run on
  the host.  A collective that gloo cannot run on CUDA tensors
  (:data:`GLOO_CUDA_HOST`) copies its buffer through pinned host memory
  on every call when ranks on the card talk over gloo
  (:data:`TRANSPORTS`, printed at the join).  Every collective carries the process group's
  timeout (:data:`COLLECTIVE_TIMEOUT`), so a lost peer fails the run.
- :func:`rank`, :func:`num_workers`, :func:`barrier`, :func:`agree_flag`
  (a cross-rank OR, the preemption consensus) run over a gloo group on
  the host.
- :class:`Collective` — ``allreduce_sum``/``broadcast`` for the dist
  kvstore, with the fault points ``collective`` and ``hang_collective``.
- :func:`all_gather`, :func:`reduce_scatter`, :func:`all_reduce`,
  :func:`broadcast_tensors` and the differentiable :func:`allreduce_sum`
  for the data-parallel trainer, and :func:`dp_scope`, under which
  BatchNorm takes its statistics over the global batch
  (:func:`batch_stats`) and a stochastic op draws the global batch's
  rows and keeps this rank's (:func:`draw_rows`).
- For meshes across ranks: :func:`make_subgroups` (one process group a
  set of ranks a mesh's collectives join, made by every rank in one
  order), :func:`subgroup`, :func:`global_devices` (every rank's
  ``(rank, Context)`` positions, rank-major) and :func:`transport_scope`
  (a collective's own device-host copies, which the graph lint counts
  apart from the step's host syncs).
- Heartbeats over the process group's store: :func:`start_heartbeat`,
  :func:`heartbeat_ages`, :func:`num_dead_nodes`,
  :func:`heartbeat_supported`, measured on the observer's clock as in the
  JAX package.
"""
from __future__ import annotations

import contextlib
import sys
import threading

from .base import MXNetError, get_env, register_env

__all__ = ["initialize", "is_initialized", "rank", "num_workers",
           "STATS", "reset_stats",
           "Collective", "barrier", "agree_flag", "backend", "device",
           "TRANSPORTS", "all_gather", "reduce_scatter", "all_reduce",
           "allreduce_sum", "broadcast_tensors", "dp_scope", "batch_stats",
           "draw_rows", "start_heartbeat", "heartbeat_ages",
           "num_dead_nodes", "heartbeat_supported", "make_subgroups",
           "subgroup", "global_devices", "transport_scope", "in_transport"]

_INITIALIZED = False

ENV_COORDINATOR = register_env(
    "MXTPU_COORDINATOR", scope="tools",
    doc="host:port of the process group's TCP store (set by "
        "tools/launch.py; rank 0 hosts it)")
ENV_NUM_WORKERS = register_env(
    "MXTPU_NUM_WORKERS", scope="tools", doc="Process count")
ENV_RANK = register_env(
    "MXTPU_WORKER_RANK", scope="tools", doc="This process's rank")
ENV_PLATFORM = register_env(
    "MXTPU_PLATFORM", scope="tools",
    doc="cpu = every rank runs on the host (the virtual cluster of the "
        "tests); unset = one CUDA device a rank")

#: seconds a collective (and the join) may wait for a peer before the
#: run fails: a lost rank must fail the job, never hang it
COLLECTIVE_TIMEOUT = 300.0

#: collective kind -> "native" (the backend runs it on the tensor's
#: device) or "host" (the buffer goes through pinned host memory), set
#: by initialize
TRANSPORTS = {}
_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast")
#: the kinds gloo cannot run on CUDA tensors: its all_gather_into_tensor
#: on a CUDA tensor kills the process (SIGSEGV, torch 2.11 on the H100
#: host), while all_reduce, broadcast and reduce_scatter take CUDA
#: tensors; a crash cannot be probed for, so the table is fixed
GLOO_CUDA_HOST = ("all_gather",)

_BACKEND = None
_DEVICE = None          # torch.device of this rank
_CPU_GROUP = None       # gloo group for host-side agreement
_STORE = None
_COORD = None           # (host, port)


def is_initialized():
    return _INITIALIZED


def _dist():
    import torch.distributed as dist
    return dist


def backend():
    """The process group's backend ("nccl" or "gloo"), None unjoined."""
    return _BACKEND


def device():
    """This rank's ``torch.device`` (None unjoined)."""
    return _DEVICE


def _choose_device(platform, process_id, num_processes):
    """(torch device, backend) for this rank: one device a rank."""
    import torch
    if platform == "cpu":
        return torch.device("cpu"), "gloo"
    if platform not in (None, "", "gpu", "cuda", "tpu"):
        raise MXNetError("distributed.initialize: unknown platform %r "
                         "(cpu, or unset for CUDA)" % (platform,))
    if not torch.cuda.is_available():
        raise MXNetError(
            "distributed.initialize: rank %d has no CUDA device (launch "
            "with --platform cpu to run the ranks on the host)"
            % process_id)
    count = torch.cuda.device_count()
    dev = torch.device("cuda", process_id % count)
    # nccl refuses two ranks of one communicator on one card: ranks that
    # share a card talk through gloo
    return dev, ("nccl" if count >= num_processes else "gloo")


def _join(host, port, num_processes, process_id, timeout, backend_name,
          init_method=None):
    """One attempt to join (separated so the retry ladder wraps exactly
    the flaky part)."""
    import datetime
    dist = _dist()
    td = datetime.timedelta(seconds=float(timeout))
    if init_method is not None:
        dist.init_process_group(backend_name, init_method=init_method,
                                rank=process_id, world_size=num_processes,
                                timeout=td)
        return None
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=td)
    try:
        dist.init_process_group(backend_name, store=store, rank=process_id,
                                world_size=num_processes, timeout=td)
    except Exception:
        del store
        raise
    return store


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               platform=None, init_method=None):
    """Join the process group.

    Arguments default to the ``MXTPU_*`` envs of ``tools/launch.py``;
    ``init_method`` (a ``file://`` or ``tcp://`` URL) joins without the
    coordinator's store (the tests' file store).  Without a coordinator
    or with one process this is a no-op, and a helper process
    (``multiprocessing``'s children) never joins from the envs it
    inherited."""
    global _INITIALIZED, _BACKEND, _DEVICE, _CPU_GROUP, _STORE, _COORD
    if _INITIALIZED:
        return
    if coordinator_address is None and init_method is None:
        import multiprocessing
        if multiprocessing.current_process().name != "MainProcess":
            return
    coordinator_address = coordinator_address or get_env(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(get_env(ENV_NUM_WORKERS, "0") or 0)
    if process_id is None:
        process_id = int(get_env(ENV_RANK, "-1") or -1)
    platform = platform or get_env(ENV_PLATFORM)
    if not (coordinator_address or init_method) or num_processes <= 1:
        return
    if process_id < 0:
        raise MXNetError(
            "distributed.initialize: %s is set but %s is not — launch with "
            "tools/launch.py or pass process_id" % (ENV_COORDINATOR, ENV_RANK))
    dev, backend_name = _choose_device(platform, process_id, num_processes)
    host, port = None, None
    if init_method is None:
        host, _, port = str(coordinator_address).rpartition(":")
        host = host or "127.0.0.1"
    from .resilience import (ENV_INIT_BACKOFF, ENV_INIT_RETRIES,
                             ENV_INIT_TIMEOUT, retry)
    attempts = int(get_env(ENV_INIT_RETRIES, "3"))
    timeout = float(get_env(ENV_INIT_TIMEOUT) or COLLECTIVE_TIMEOUT)
    backoff = float(get_env(ENV_INIT_BACKOFF, "1.0"))
    store = retry(lambda: _join(host, port, num_processes, process_id,
                                timeout, backend_name, init_method),
                  attempts=attempts, backoff=backoff,
                  retry_on=(RuntimeError, ConnectionError, TimeoutError,
                            ValueError),
                  name="distributed.initialize[rank %d]" % process_id)
    dist = _dist()
    import datetime
    _CPU_GROUP = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT)
    ) if backend_name != "gloo" else dist.group.WORLD
    _STORE, _COORD = store, (host, port)
    _BACKEND, _DEVICE = backend_name, dev
    if dev.type == "cuda":
        import torch
        torch.cuda.set_device(dev)
    from .context import Context, set_process_default
    set_process_default(Context("cpu", 0) if dev.type == "cpu"
                        else Context("gpu", dev.index))
    TRANSPORTS.clear()
    TRANSPORTS.update({k: "native" for k in _KINDS})
    if dev.type == "cuda" and backend_name == "gloo":
        TRANSPORTS.update({k: "host" for k in GLOO_CUDA_HOST})
    _INITIALIZED = True
    print("mxnet_tpu_torch.distributed: rank %d/%d on %s over %s "
          "(transports %s)" % (process_id, num_processes, dev, backend_name,
                               ",".join("%s=%s" % kv for kv in
                                        sorted(TRANSPORTS.items()))),
          file=sys.stderr, flush=True)


def rank():
    return _dist().get_rank() if _INITIALIZED else 0


def num_workers():
    return _dist().get_world_size() if _INITIALIZED else 1


def barrier(tag="mxtpu_barrier"):
    """Every rank waits for every other (a no-op in one process)."""
    del tag
    if _INITIALIZED and num_workers() > 1:
        _dist().barrier(group=_CPU_GROUP)


def agree_flag(flag):
    """Cross-process OR of a local boolean — the preemption consensus.
    SIGTERM lands on different ranks at different instants; agreeing at
    every step boundary makes every rank take the same branch there (any
    rank signaled => every rank checkpoints) instead of one rank entering
    the checkpoint gather while another enters the next step's
    collectives.  One host all-reduce of an int32 per call."""
    if not _INITIALIZED or num_workers() == 1:
        return bool(flag)
    import torch
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    _dist().all_reduce(t, op=_dist().ReduceOp.MAX, group=_CPU_GROUP)
    return bool(int(t[0]) > 0)


def all_gather_object(obj):
    """Every rank's picklable ``obj``, in rank order (host group)."""
    if not _INITIALIZED or num_workers() == 1:
        return [obj]
    out = [None] * num_workers()
    _dist().all_gather_object(out, obj, group=_CPU_GROUP)
    return out


_SUBGROUPS = {}      # sorted rank tuple -> process group


def make_subgroups(rank_sets):
    """One process group for each rank set (a tuple of two or more ranks)
    not made yet, made in sorted order.  ``torch.distributed.new_group``
    is collective over the whole process group: every rank must call
    this with the same sets (a mesh's, at build time), including the sets
    it is not in, or the ranks hang.  The set of every rank is the
    process group itself."""
    import datetime
    dist = _dist()
    world = tuple(range(num_workers()))
    for ranks in sorted({tuple(sorted(r)) for r in rank_sets}):
        if len(ranks) < 2 or ranks in _SUBGROUPS:
            continue
        _SUBGROUPS[ranks] = dist.group.WORLD if ranks == world else \
            dist.new_group(list(ranks), timeout=datetime.timedelta(
                seconds=COLLECTIVE_TIMEOUT))


def subgroup(ranks):
    """The process group over ``ranks`` (made by :func:`make_subgroups`)."""
    ranks = tuple(sorted(ranks))
    if ranks not in _SUBGROUPS:
        raise MXNetError("no process group over ranks %s (a mesh makes "
                         "its groups when it is built)" % (ranks,))
    return _SUBGROUPS[ranks]


def global_devices(contexts=None):
    """Every rank's ``(rank, Context)`` positions in rank-major order (the
    JAX package's ``sorted(jax.devices(), key=(process_index, id))``):
    each rank's ``contexts`` (its own device when None), gathered from
    every rank (collective).  Outside a process group, this process's
    contexts at rank 0."""
    from .context import Context, current_context
    mine = [Context(c) for c in (contexts if contexts is not None
                                 else [current_context()])]
    every = all_gather_object([(c.device_type, c.device_id) for c in mine])
    return [(r, Context(t, i)) for r, cs in enumerate(every)
            for t, i in cs]


# ---------------------------------------------------------------------------
# collectives over the device group (functional ops, so the graph lint's
# dispatch record sees them)
# ---------------------------------------------------------------------------

def _group_name(group=None):
    return (group if group is not None else _dist().group.WORLD).group_name


def _raw(kind, x, root=0, group=None):
    """One functional collective on ``x`` as it lies (no transport), over
    ``group`` (the whole process group when None)."""
    import torch
    F = torch.ops._c10d_functional
    name = _group_name(group)
    world = num_workers() if group is None else \
        _dist().get_world_size(group)
    x = x.contiguous()
    if kind == "all_reduce":
        out = F.all_reduce(x, "sum", name)
    elif kind == "all_gather":
        out = F.all_gather_into_tensor(x, world, name)
    elif kind == "reduce_scatter":
        out = F.reduce_scatter_tensor(x, "sum", world, name)
    elif kind == "broadcast":
        out = F.broadcast(x, int(root), name)
    else:
        raise MXNetError("unknown collective %r" % (kind,))
    return F.wait_tensor(out)


#: kind -> {"count", "bytes", "seconds"}: the collectives this process
#: issued through the functional ops, the bytes they returned and the
#: host seconds spent in them (each call waits for its result); zero it
#: with :func:`reset_stats`
STATS = {}


def reset_stats():
    STATS.clear()
    STATS.update({k: {"count": 0, "bytes": 0, "seconds": 0.0}
                  for k in _KINDS})


reset_stats()


_TRANSPORT = threading.local()


@contextlib.contextmanager
def transport_scope():
    """Marks the calling thread's copies between the device and the host
    as a collective's transport (a gloo collective on CUDA tensors
    stages through pinned host memory; a cross-rank exchange reads its
    header): the graph lint counts them as transport syncs, not as the
    step's own host syncs."""
    prev = getattr(_TRANSPORT, "on", False)
    _TRANSPORT.on = True
    try:
        yield
    finally:
        _TRANSPORT.on = prev


def in_transport():
    """True inside :func:`transport_scope` on the calling thread."""
    return getattr(_TRANSPORT, "on", False)


def _collective(kind, x, root=0, group=None):
    """Run collective ``kind`` on ``x`` over ``group`` (the whole process
    group when None) through its transport: a CUDA tensor whose kind
    gloo cannot run on the card goes through a pinned host buffer, and
    the result comes back to ``x``'s device."""
    import time
    t0 = time.perf_counter()
    if not x.is_cuda or TRANSPORTS.get(kind, "native") == "native":
        out = _raw(kind, x, root, group)
    else:
        import torch
        with transport_scope():
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            out = _raw(kind, host, root, group).to(x.device,
                                                   non_blocking=True)
    st = STATS[kind]
    st["count"] += 1
    st["bytes"] += out.numel() * out.element_size()
    st["seconds"] += time.perf_counter() - t0
    return out


def all_gather(x):
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    return _collective("all_gather", x)


def reduce_scatter(x):
    """The sum over ranks of ``x`` (dim 0 divisible by the world), of
    which this rank keeps block ``rank`` along dim 0."""
    return _collective("reduce_scatter", x)


def all_reduce(x):
    """The sum over ranks of ``x``."""
    return _collective("all_reduce", x)


def broadcast(x, root=0):
    """Rank ``root``'s ``x`` on every rank."""
    return _collective("broadcast", x, root)


def broadcast_tensors(tensors, root=0):
    """Rank ``root``'s values of ``tensors`` on every rank, one
    collective per dtype (a flat bucket); returns new tensors."""
    import torch
    tensors = list(tensors)
    if not _INITIALIZED or num_workers() == 1 or not tensors:
        return tensors
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for _, idx in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = broadcast(flat, root)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].reshape(tensors[i].shape)
            off += n
    return out


def _allreduce_fn():
    import torch

    class AllReduceSum(torch.autograd.Function):
        """``sum over ranks`` whose backward is the same sum: each
        rank's contribution reaches every rank's loss."""

        @staticmethod
        def forward(ctx, x):
            return all_reduce(x)

        @staticmethod
        def backward(ctx, g):
            return all_reduce(g)

    return AllReduceSum


_ALLREDUCE_FN = None


def allreduce_sum(x):
    """Differentiable sum over ranks."""
    global _ALLREDUCE_FN
    if _ALLREDUCE_FN is None:
        _ALLREDUCE_FN = _allreduce_fn()
    return _ALLREDUCE_FN.apply(x)


# ---------------------------------------------------------------------------
# the data-parallel step's scope: global BatchNorm statistics and the
# global batch's random rows
# ---------------------------------------------------------------------------

_DP = threading.local()   # .scope: (world, rank, sync_stats, allreduce)


def _dp():
    return getattr(_DP, "scope", None)


@contextlib.contextmanager
def dp_scope(world, me, sync_stats=True, allreduce=None):
    """Run a forward as one member of a ``world``-way data-parallel step:
    BatchNorm reduces its statistics over every member's rows when
    ``sync_stats`` (the JAX package's allreduce and zero steps are one
    global program), and stochastic ops keep this member's rows of the
    global batch's draw.  Members are ranks, or the positions of an
    in-process mesh, whose ``allreduce`` (a differentiable sum over the
    ``dp`` axis) replaces the one over ranks.  The scope is the calling
    thread's."""
    prev = _dp()
    _DP.scope = (int(world), int(me), bool(sync_stats),
                 allreduce or allreduce_sum) if world > 1 else None
    try:
        yield
    finally:
        _DP.scope = prev


def batch_stats(data, axes):
    """``(mean, biased var)`` of ``data`` over ``axes`` — over the global
    batch inside a :func:`dp_scope` with ``sync_stats``: the per-channel
    sums, then the squared deviations, summed over the members through a
    differentiable all-reduce (equal local batches)."""
    import torch
    scope = _dp()
    if scope is None or not scope[2]:
        return (torch.mean(data, dim=axes),
                torch.var(data, dim=axes, unbiased=False))
    world, reduce = scope[0], scope[3]
    count = (data.numel() // max(1, data.shape[1])) * world
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    # the per-channel sums accumulate in float64 (a cast inside the
    # reduction), so splitting the batch over members moves the
    # statistics by rounding of the result only
    f64 = torch.float64
    mean = reduce(torch.sum(data, dim=axes, dtype=f64)) / count
    d = data - mean.to(data.dtype).reshape(bshape)
    var = reduce(torch.sum(d * d, dim=axes, dtype=f64)) / count
    return mean.to(data.dtype), var.to(data.dtype)


def draw_rows(shape, draw):
    """``draw(shape)`` for one member: inside a :func:`dp_scope` the draw
    is made at the global batch's shape (dim 0 times the world) and this
    member keeps its rows, so a stochastic op under dp masks each row as
    a one-member step at the global batch would."""
    shape = tuple(shape)
    scope = _dp()
    if scope is None or not shape:
        return draw(shape)
    world, me = scope[0], scope[1]
    n = shape[0]
    full = draw((n * world,) + shape[1:])
    return full[me * n:(me + 1) * n]


class Collective(object):
    """Cross-process sums and broadcasts for the dist kvstore (the
    reference's push-side reduction and server aggregation as one
    collective)."""

    def __init__(self):
        self.num_workers = num_workers()
        self.rank = rank()

    @staticmethod
    def _fault_point():
        """``collective`` raises (a peer dropped: every rank sees the
        failure), ``hang_collective`` stalls the caller (a wedged
        reduction, the watchdog's target)."""
        from .resilience import faults
        faults.maybe_hang("hang_collective")
        faults.maybe_fail(
            "collective", "injected collective failure (a peer is gone; "
            "relaunch and resume)")

    def allreduce_sum(self, x):
        """Sum a same-shaped tensor across every worker process."""
        self._fault_point()
        if self.num_workers == 1:
            return x
        return all_reduce(x)

    def broadcast(self, x, root=0):
        """Every process receives root's value (shape and dtype agree)."""
        self._fault_point()
        if self.num_workers == 1:
            return x
        return broadcast(x, root)


# ---------------------------------------------------------------------------
# Liveness heartbeats (the reference's ps-lite heartbeat behind
# KVStore::get_num_dead_node, kvstore_dist.h:158-167): each process stamps
# a key in the process group's store; any process counts peers whose
# stamp has gone stale.  Collectives stay all-or-nothing.
# ---------------------------------------------------------------------------

_HB_PREFIX = "mxtpu_hb/"
_HB_THREAD = None
_HB_STOP = None
HEARTBEAT_INTERVAL = 2.0


class _StoreClient(object):
    """The coordination-KV surface of the JAX package's heartbeat code
    over a ``torch.distributed`` store: ``key_value_set`` and a
    non-blocking ``key_value_try_get`` (``check`` first, so a missing
    key never blocks)."""

    def __init__(self, store):
        self._store = store

    def key_value_set(self, key, value, allow_overwrite=True):
        del allow_overwrite
        self._store.set(key, value)

    def key_value_try_get(self, key):
        if not self._store.check([key]):
            raise KeyError(key)
        return self._store.get(key).decode()


_CLIENT = None


def _kv_client():
    global _CLIENT
    if not _INITIALIZED or _STORE is None:
        return None
    if _CLIENT is None or _CLIENT._store is not _STORE:
        _CLIENT = _StoreClient(_STORE)
    return _CLIENT


def _thread_client():
    """A store connection of the heartbeat thread's own."""
    import datetime
    host, port = _COORD
    return _StoreClient(_dist().TCPStore(
        host, int(port), is_master=False,
        timeout=datetime.timedelta(seconds=30)))


def start_heartbeat(interval=None):
    """Begin stamping this process's liveness key (idempotent), on a
    daemon thread; dist kvstores start it."""
    global _HB_THREAD, _HB_STOP
    if _kv_client() is None or _HB_THREAD is not None:
        return False
    import threading
    import time as _time

    interval = float(interval or HEARTBEAT_INTERVAL)
    key = _HB_PREFIX + str(rank())
    client = _thread_client()
    stop = threading.Event()

    def beat():
        while not stop.is_set():
            try:
                client.key_value_set(key, repr(_time.time()))
            except Exception:  # noqa: BLE001 — store gone: job is over
                return
            stop.wait(interval)

    t = threading.Thread(target=beat, daemon=True, name="mxtpu-heartbeat")
    t.start()
    _HB_THREAD, _HB_STOP = t, stop
    import atexit
    atexit.register(stop.set)
    return True


def stop_heartbeat():
    """Stop this process's stamps (its peers then see it age out)."""
    global _HB_THREAD, _HB_STOP
    if _HB_STOP is not None:
        _HB_STOP.set()
    _HB_THREAD = _HB_STOP = None


# Observer-side liveness cache: rank -> (last stamp value seen, local
# monotonic time it changed, provisional).  Ages use the observer's clock
# from the moment the stamp last changed, never a remote wall clock; a
# stamp seen only once reports age None (unknown) until it changes.
_HB_OBSERVED = {}
_HB_CLIENT = None


def _hb_observed(client):
    global _HB_CLIENT
    if client is not _HB_CLIENT:
        _HB_OBSERVED.clear()
        _HB_CLIENT = client
    return _HB_OBSERVED


def _hb_stamps(client):
    """rank -> raw stamp for every rank currently published."""
    out = {}
    for r in range(num_workers()):
        try:
            out[r] = client.key_value_try_get(_HB_PREFIX + str(r))
        except Exception:  # noqa: BLE001 — not yet written
            pass
    return out


def heartbeat_supported():
    """True when this process can publish and observe heartbeats (any
    joined process group: its store has both surfaces)."""
    return _kv_client() is not None


def heartbeat_ages():
    """rank -> seconds since its heartbeat value was last seen to change,
    on the local monotonic clock; None = unknown (never written, or not
    yet seen to change)."""
    import time as _time
    client = _kv_client()
    if client is None:
        return {}
    obs = _hb_observed(client)
    now = _time.monotonic()
    stamps = _hb_stamps(client)
    ages = {}
    for r in range(num_workers()):
        if r not in stamps:
            ages[r] = None
            continue
        stamp = stamps[r]
        prev = obs.get(r)
        if prev is None:
            obs[r] = (stamp, now, True)
        elif prev[0] != stamp:
            obs[r] = (stamp, now, False)
        rec = obs[r]
        ages[r] = None if rec[2] else now - rec[1]
    return ages


def num_dead_nodes(node_id=-1, timeout=60):
    """Workers whose heartbeat is older than ``timeout`` seconds (the
    reference's get_num_dead_node; ``node_id`` filtering reduces to "any
    worker").  A worker that never stamped is not dead; one whose stamp
    stayed frozen for a whole > ``timeout`` observation window is."""
    import time as _time
    del node_id
    ages = heartbeat_ages()
    now = _time.monotonic()
    dead = 0
    for r, age in ages.items():
        if age is not None and age > timeout:
            dead += 1
            continue
        rec = _HB_OBSERVED.get(r)
        if (age is None and rec is not None and rec[2]
                and now - rec[1] > timeout):
            dead += 1
    return dead
