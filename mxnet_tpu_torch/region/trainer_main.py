#!/usr/bin/env python
"""The region's elastic zero3 trainer (the counterpart of the trainer
script the JAX package's ``tools/region.py`` generates, ``:129-245``).

::

    REGION_WORLD=2 REGION_CONTEXT='gpu(0)' ... \\
        python mxnet_tpu_torch/region/trainer_main.py

Everything comes from the environment the region's supervisor sets for
each spawn: ``REGION_WORLD`` (the mesh's size, so a resize is a SIGKILL
and a respawn at another world), ``REGION_CONTEXT`` (``gpu(0)`` by
default, every mesh position on it; ``cpu`` in the tests),
``REGION_BATCH``, ``REGION_EPOCHS``, ``REGION_EPOCH_GAP_S``,
``REGION_CKPT_DIR``, ``REGION_STATUS_FILE``, ``REGION_CMD_FILE``,
``REGION_DATA_SERVERS`` (the data servers' ``host:port`` list),
``REGION_REC`` and ``REGION_IDX``.

The model is the drill's MLP (data 3x8x8 -> FC 32 -> relu -> FC 7 ->
``SoftmaxOutput``) under ``SPMDTrainer(grad_sync="zero3")`` on
``local_mesh("dp", devices=[ctx] * world)``, sgd lr 0.05, momentum 0.9,
``rescale_grad`` 1 / batch, Xavier after ``mx.random.seed(7)``.  Batches
arrive over the network from the data servers (``ImageRecordIter`` with
``data_service=``).  Every epoch publishes a verified checkpoint
(sharded-native under ``MXTPU_CKPT_SHARDED=1``) that the fleet's rolling
swap picks up, then writes the status file and prints
``REGION_TRAINER epoch=<e> world=<w>``; a respawn with ``MXTPU_RESUME=1``
restores the newest checkpoint (elastic: another world re-shards it).

The command file carries the region's orders, each applied once:
``arm point:times[@after]`` arms a fault point before the next save (so
an armed ``rot_checkpoint`` rots the very next publish), and ``go``
opens the drill: after its first publish the trainer waits for ``go``,
which the region appends once every replica serves that publish and the
clients run, so every scheduled fault lands on a live publish.
A reconnect to a data server is written to the status file as soon as
the iterator counts it (:class:`Status`), not at the next publish, so a
process killed mid-epoch (the storm's resize) has already reported it.
``REGION_TRAINER_TIMES <json>`` lines give the wall time of a resume and
of each epoch with its step time.
"""
import json
import os
import re
import sys
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch.parallel import SPMDTrainer, local_mesh  # noqa: E402
from mxnet_tpu_torch.resilience import (  # noqa: E402
    ENV_RESUME, CheckpointManager, faults)

FEATS = 3 * 8 * 8
#: seconds between reads of the command file while waiting for ``go``
GO_POLL_S = 0.05


def parse_context(text):
    """``gpu(0)``, ``gpu``, ``cpu(0)`` or ``cpu`` -> a Context."""
    m = re.fullmatch(r"\s*(cpu|gpu)\s*(?:\(\s*(\d+)\s*\))?\s*", text or "")
    if m is None:
        raise SystemExit("REGION_CONTEXT: want gpu(N) or cpu, got %r"
                         % text)
    return mx.Context(m.group(1), int(m.group(2) or 0))


class Config(object):
    """The ``REGION_*`` environment of one spawn."""

    def __init__(self, env):
        self.world = int(env["REGION_WORLD"])
        self.ctx = parse_context(env.get("REGION_CONTEXT", "gpu(0)"))
        self.batch = int(env["REGION_BATCH"])
        self.epochs = int(env["REGION_EPOCHS"])
        self.gap_s = float(env["REGION_EPOCH_GAP_S"])
        self.status = env["REGION_STATUS_FILE"]
        self.cmd = env["REGION_CMD_FILE"]
        self.ckpt_dir = env["REGION_CKPT_DIR"]
        self.servers = env["REGION_DATA_SERVERS"]
        self.rec = env["REGION_REC"]
        self.idx = env["REGION_IDX"]
        self.resume = env.get(ENV_RESUME) == "1"


def build(cfg):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=7, name="fc2")
    sym = mx.sym.SoftmaxOutput(net, name="softmax")
    t = SPMDTrainer(sym, "sgd",
                    {"learning_rate": 0.05, "momentum": 0.9,
                     "rescale_grad": 1.0 / cfg.batch},
                    mesh=local_mesh("dp", devices=[cfg.ctx] * cfg.world),
                    grad_sync="zero3")
    t.bind([("data", (cfg.batch, FEATS))], [("softmax_label", (cfg.batch,))])
    mx.random.seed(7)
    t.init_params(mx.initializer.Xavier())
    return t


def data_iter(cfg):
    return mx.io.ImageRecordIter(
        path_imgrec=cfg.rec, path_imgidx=cfg.idx,
        data_shape=(3, 8, 8), batch_size=cfg.batch, shuffle=True,
        rand_crop=True, rand_mirror=False, seed=11, dtype="float32",
        host_batches=True, data_service=cfg.servers, ctx=cfg.ctx,
        preprocess_threads=1)


def host(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


class Commands(object):
    """The region's command file: each line applied once, in order."""

    def __init__(self, path):
        self.path = path
        self.applied = set()
        self.go = False

    def poll(self):
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            lines = f.read().splitlines()
        for n, line in enumerate(lines):
            line = line.strip()
            if not line or n in self.applied:
                continue
            self.applied.add(n)
            verb, _, spec = line.partition(" ")
            if verb == "go":
                self.go = True
                continue
            if verb != "arm" or not spec:
                continue
            point, _, rest = spec.partition(":")
            times_s, _, after_s = rest.partition("@")
            faults.arm(point, times=int(times_s or 1),
                       after=int(after_s or 0))
            print("REGION_TRAINER armed %s" % spec, flush=True)

    def wait_go(self):
        """Block until the region has appended ``go`` (at once on a
        respawn: the line stays in the file)."""
        while not self.go:
            self.poll()
            if not self.go:
                time.sleep(GO_POLL_S)


def reconnects(it):
    """The iterator's reconnects to its data servers so far."""
    st = it.stats() if it is not None else {}
    return sum(s.get("reconnects", 0)
               for s in (st.get("servers") or {}).values())


def write_status(cfg, epoch, it, batches, t0):
    """Replace the status file; returns the reconnects it holds."""
    doc = {"epoch": epoch, "world": cfg.world, "pid": os.getpid(),
           "reconnects": reconnects(it), "batches": batches,
           "time": time.time(), "uptime_s": round(time.time() - t0, 3)}
    tmp = cfg.status + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, cfg.status)
    return doc["reconnects"]


def times_line(**rec):
    rec["wall"] = time.time()
    print("REGION_TRAINER_TIMES " + json.dumps(rec, sort_keys=True),
          flush=True)


class Status(object):
    """The status file of one trainer process: written after every
    publish (:meth:`publish`) and, by a watcher thread, as soon as the
    data iterator counts a reconnect it does not hold yet, with the last
    published epoch.  A reconnect completes inside a blocked ``next``,
    and the storm's resize may kill the process before its next publish
    or even its next batch: the watcher reports it within ``period``."""

    def __init__(self, cfg, it, t0, period=0.1):
        self.cfg, self.it, self.t0, self.period = cfg, it, t0, period
        self.epoch = self.batches = self.reported = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch,
                                        name="region-status", daemon=True)

    def start(self, epoch):
        self.epoch = epoch
        self._thread.start()
        return self

    def count(self, n=1):
        with self._lock:
            self.batches += n

    def write(self, epoch=None, if_new=False):
        """Write the file (``epoch``: a new publish); with ``if_new`` only
        when the iterator counts reconnects the file does not hold."""
        with self._lock:
            if if_new and reconnects(self.it) <= self.reported:
                return
            if epoch is not None:
                self.epoch = epoch
            self.reported = write_status(self.cfg, self.epoch, self.it,
                                         self.batches, self.t0)

    def _watch(self):
        while not self._stop.wait(self.period):
            self.write(if_new=True)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


def train_epoch(cfg, t, it, status):
    """One pass over ``it``: ``(batches, step seconds)``, each batch
    counted in ``status``."""
    step_s, n = 0.0, 0
    for b in it:
        x = host(b.data[0]).astype("f").reshape(cfg.batch, -1)
        y = host(b.label[0]).astype("f")
        s0 = time.perf_counter()
        t.step(x, y)
        if cfg.ctx.device_type == "gpu":
            torch.cuda.synchronize()
        step_s += time.perf_counter() - s0
        n += 1
        status.count()
    return n, step_s


def main():
    cfg = Config(os.environ)
    mgr = CheckpointManager(cfg.ckpt_dir, keep_last=None)
    t = build(cfg)
    start_epoch = 0
    if cfg.resume and mgr.latest() is not None:
        start_epoch = t.restore(mgr)
        print("REGION_TRAINER resumed epoch=%d world=%d"
              % (start_epoch, cfg.world), flush=True)
        times_line(event="resumed", epoch=start_epoch, world=cfg.world)
    cmds = Commands(cfg.cmd)
    it = data_iter(cfg)
    status = Status(cfg, it, time.time()).start(start_epoch)
    for epoch in range(start_epoch + 1, cfg.epochs + 1):
        n, step_s = train_epoch(cfg, t, it, status)
        it.reset()
        cmds.poll()
        t.save_checkpoint(mgr, epoch, blocking=True)
        status.write(epoch)
        print("REGION_TRAINER epoch=%d world=%d" % (epoch, cfg.world),
              flush=True)
        times_line(event="epoch", epoch=epoch, world=cfg.world, batches=n,
                   step_ms=1e3 * step_s / max(1, n))
        cmds.wait_go()
        time.sleep(cfg.gap_s)
    status.stop()
    it.close()
    print("REGION_TRAINER done epochs=%d" % cfg.epochs, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
