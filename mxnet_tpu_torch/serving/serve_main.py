#!/usr/bin/env python
"""mxserve daemon on the port: serve trained checkpoints over HTTP (the
counterpart of the JAX package's ``tools/serve.py``, with its flags and
its lifecycle, plus ``--context``).

::

    python mxnet_tpu_torch/serving/serve_main.py \\
        --model mlp=/ckpts/mlp:3 --model resnet=/ckpts/resnet-dir \\
        --input-shape mlp:data=784 --input-shape resnet:data=3,224,224 \\
        --port 8100 [--context gpu(0)] [--buckets 1,2,4,8,16,32] \\
        [--dtype bfloat16] [--warmup] [--watch] [--port-file FILE]

Model specs: ``name=prefix:epoch`` loads the ``prefix-symbol.json`` +
``prefix-%04d.params`` pair; ``name=directory`` (a path holding a
``CheckpointManager`` manifest) loads the newest intact epoch with
checksum verification.  Both packages write these files the same way.

``--context`` is the device every model runs on: ``gpu(0)`` by default,
``cpu`` for the host.  Without CUDA a gpu context exits 2 instead of
serving on the host.

Lifecycle: SIGTERM/SIGINT drain (finish accepted requests, print the
kernel launch counters of the whole run on one stderr line,
``mxserve: launches {...}``, and the batches dispatched on the next,
``mxserve: stats {...}``, then exit 0); a wedged forward is killed by
the StepWatchdog (``MXTPU_STEP_TIMEOUT``, exit 87) so
``tools/supervise.py`` can relaunch the daemon.

The AOT store (``serving/aot.py``) lives under ``MXTPU_COMPILE_CACHE``:
``--warmup-only --export-aot`` is its builder (a weight-free
``torch.export`` program for each (model, bucket) into ``<cache>/aot/``,
no serving); ``--warmup`` loads each model's programs from it and warms
through the executors only the buckets the store lacks.  Either prints
``mxserve: warmup_s=<s>``.  Serving knobs: ``MXTPU_SERVE_*`` or the
equivalent flags below.
"""
import argparse
import json
import os
import re
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(os.path.dirname(_HERE)))


def _parse_shape_specs(specs):
    """``["mlp:data=784", "data=3,32,32"]`` -> {model_or_None: {input:
    shape}} (no model prefix = applies to every model)."""
    out = {}
    for spec in specs or ():
        model = None
        head, _, tail = spec.partition("=")
        if ":" in head:
            model, _, head = head.partition(":")
        shape = tuple(int(x) for x in tail.split(",") if x)
        out.setdefault(model, {})[head] = shape
    return out


def _parse_context(mx, text):
    """``gpu(0)``, ``gpu``, ``cpu`` or ``cpu(0)`` -> a Context."""
    m = re.fullmatch(r"\s*(cpu|gpu)\s*(?:\(\s*(\d+)\s*\))?\s*", text or "")
    if m is None:
        raise SystemExit("bad --context %r (want gpu(N) or cpu)" % text)
    return mx.Context(m.group(1), int(m.group(2) or 0))


def _load_models(pool, specs, shape_specs):
    for spec in specs:
        name, _, target = spec.partition("=")
        if not name or not target:
            raise SystemExit("bad --model spec %r (want name=prefix:epoch "
                             "or name=ckpt-dir)" % spec)
        shapes = shape_specs.get(name, shape_specs.get(None))
        if os.path.isdir(target):
            entry = pool.load_dir(name, target, sample_shapes=shapes)
            src = "%s (epoch %d)" % (target, entry.loaded_epoch)
        else:
            prefix, _, epoch = target.rpartition(":")
            if not prefix or not epoch.isdigit():
                raise SystemExit("bad --model target %r (want "
                                 "prefix:epoch or a checkpoint dir)"
                                 % target)
            pool.load(name, prefix, int(epoch), sample_shapes=shapes)
            src = "%s:%s" % (prefix, epoch)
        sys.stderr.write("mxserve: loaded model %r from %s\n" % (name, src))


def launch_counts(mx):
    """Every kernel wrapper's launch counter in this process, by the
    names of ``chip_smoke.py``'s kernel table."""
    ba, lc = mx.kernels.bn_act, mx.kernels.lstm_cell
    return {"bn_act_fwd": ba.LAUNCHES, "bn_act_bwd": ba.BWD_LAUNCHES,
            "lstm_cell_fwd": lc.LAUNCHES, "lstm_cell_bwd": lc.BWD_LAUNCHES,
            "lstm_seq_fwd": lc.SEQ_LAUNCHES,
            "lstm_seq_bwd": lc.SEQ_BWD_LAUNCHES,
            "flash_attention_fwd": mx.kernels.flash_attention.LAUNCHES,
            "rtc_elementwise": mx.rtc.LAUNCHES}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="inference serving daemon (the port's tools/serve.py)")
    parser.add_argument("--model", action="append", default=[],
                        metavar="NAME=PREFIX:EPOCH|NAME=DIR",
                        help="model to serve (repeatable)")
    parser.add_argument("--input-shape", action="append", default=[],
                        metavar="[MODEL:]INPUT=D1,D2,...",
                        help="per-sample input shape, enables --warmup "
                             "(repeatable)")
    parser.add_argument("--context", default="gpu(0)",
                        help="device of every model: gpu(N) (default "
                             "gpu(0)) or cpu")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8100,
                        help="0 = ephemeral (see --port-file)")
    parser.add_argument("--port-file", default=None,
                        help="write 'host:port' here once listening")
    parser.add_argument("--buckets", default=None,
                        help="override MXTPU_SERVE_BUCKETS")
    parser.add_argument("--max-wait-ms", type=float, default=None,
                        help="override MXTPU_SERVE_MAX_WAIT_MS")
    parser.add_argument("--max-queue", type=int, default=None,
                        help="override MXTPU_SERVE_MAX_QUEUE")
    parser.add_argument("--seq-buckets", default=None,
                        help="sequence-LENGTH buckets for "
                             "/predict_seq, e.g. '8,16,32' (default: "
                             "MXTPU_SERVE_SEQ_BUCKETS)")
    parser.add_argument("--tenant-weights", default=None,
                        help="weighted-fair tenant shares, e.g. "
                             "'gold:4,free:1' (default: "
                             "MXTPU_SERVE_TENANT_WEIGHTS)")
    parser.add_argument("--tenant-quota", type=int, default=None,
                        help="per-tenant queued-request quota; beyond "
                             "it a tenant is shed 429 (default: "
                             "MXTPU_SERVE_TENANT_QUOTA; 0 disables)")
    parser.add_argument("--slo-ms", type=float, default=None,
                        help="override MXTPU_SERVE_SLO_MS")
    parser.add_argument("--dtype", default=None,
                        help="override MXTPU_SERVE_DTYPE (bfloat16, int8)")
    parser.add_argument("--warmup", action="store_true",
                        help="bind every bucket per model before "
                             "accepting traffic (needs --input-shape)")
    parser.add_argument("--watch", action="store_true",
                        help="tail each checkpoint-DIRECTORY model for "
                             "new epochs and hot-swap verified ones in "
                             "with zero dropped requests (MXTPU_SWAP_* "
                             "knobs)")
    parser.add_argument("--warmup-only", action="store_true",
                        help="warm every (model, bucket) forward, print "
                             "`mxserve: warmup_s=<s>`, exit 0 WITHOUT "
                             "serving")
    parser.add_argument("--export-aot", action="store_true",
                        help="build the AOT store under "
                             "MXTPU_COMPILE_CACHE: export every (model, "
                             "bucket) forward (with --warmup-only: the "
                             "warm-store builder)")
    args = parser.parse_args(argv)
    if not args.model:
        parser.error("at least one --model is required")

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.resilience import (StepWatchdog,
                                            step_timeout_configured)
    from mxnet_tpu_torch.serving import (ModelPool, ServingFrontend,
                                         parse_buckets)

    ctx = _parse_context(mx, args.context)
    try:
        ctx.torch_device
    except MXNetError as e:
        sys.stderr.write("mxserve: %s\n" % e)
        return 2
    from mxnet_tpu_torch.base import ENV_COMPILE_CACHE, get_env
    if args.export_aot and not get_env(ENV_COMPILE_CACHE):
        sys.stderr.write("mxserve: --export-aot needs MXTPU_COMPILE_CACHE "
                         "set (the store is <cache>/aot)\n")
        return 2

    pool = ModelPool(ctx=ctx, dtype=args.dtype)
    _load_models(pool, args.model, _parse_shape_specs(args.input_shape))

    watchdog = None
    if step_timeout_configured():
        watchdog = StepWatchdog()

    frontend = ServingFrontend(
        pool, host=args.host, port=args.port, buckets=args.buckets,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        slo_ms=args.slo_ms, watchdog=watchdog,
        tenant_weights=args.tenant_weights,
        tenant_quota=args.tenant_quota,
        seq_buckets=args.seq_buckets)

    # handlers + bind BEFORE the warmup: a SIGTERM during warmup must
    # drain to exit 0, not die rc 143 on the default handler.  The port
    # file is only written after warmup, so no client connects early.
    frontend.install_signal_handlers()
    frontend.start()

    if args.warmup or args.warmup_only or args.export_aot:
        import time as _time

        from mxnet_tpu_torch.serving.aot import aot_dir_for_cache

        cache_dir = get_env(ENV_COMPILE_CACHE)
        aot_dir = aot_dir_for_cache(cache_dir) if cache_dir else None
        tic = _time.monotonic()
        buckets = parse_buckets(args.buckets)
        for name in pool.names():
            if frontend.draining:     # SIGTERM mid-warmup: stop binding
                break
            entry = pool.get(name)
            if entry.sample_shapes is None:
                sys.stderr.write("mxserve: cannot warm %r — no "
                                 "--input-shape declared\n" % name)
                continue
            if args.export_aot:
                # the store BUILDER: export each bucket's program (no
                # executor warmup: this process does not serve them)
                entry.export_aot(buckets, aot_dir)
                sys.stderr.write("mxserve: exported AOT programs for %r "
                                 "over buckets %s\n"
                                 % (name, list(buckets)))
                continue
            loaded = entry.load_aot(aot_dir, buckets) if aot_dir else 0
            if loaded:
                sys.stderr.write("mxserve: warmed %r from the AOT store "
                                 "(%d/%d buckets)\n"
                                 % (name, loaded, len(buckets)))
            missing = [b for b in buckets if b not in entry._aot]
            if missing:
                # no store, a partial one or a meta mismatch: warm the
                # executors of what the store lacks
                entry.warmup(missing)
                sys.stderr.write("mxserve: warmed %r over buckets %s\n"
                                 % (name, missing))
        sys.stderr.write("mxserve: warmup_s=%.3f\n"
                         % (_time.monotonic() - tic))
    if args.warmup_only:
        sys.stderr.write("mxserve: warmup-only — exiting 0\n")
        sys.stderr.flush()
        return 0
    if args.watch:
        for name in pool.names():
            entry = pool.get(name)
            if entry.source_dir:
                frontend.watcher(name, start=True)
                sys.stderr.write(
                    "mxserve: watching %s (epoch %s) for new epochs of "
                    "%r\n" % (entry.source_dir, entry.loaded_epoch, name))
            else:
                sys.stderr.write(
                    "mxserve: --watch: model %r was loaded from a "
                    "prefix:epoch pair, not a checkpoint directory — "
                    "not watchable\n" % name)
    sys.stderr.write("mxserve: listening on %s:%d (models: %s, context %s)\n"
                     % (frontend.host, frontend.port, pool.names(), ctx))
    sys.stderr.flush()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write("%s:%d" % (frontend.host, frontend.port))
        os.replace(tmp, args.port_file)
    frontend.serve_forever()
    snap = frontend.stats.snapshot()
    sys.stderr.write("mxserve: launches %s\n"
                     % json.dumps(launch_counts(mx), sort_keys=True))
    sys.stderr.write("mxserve: stats %s\n" % json.dumps(
        {"batches": snap["batches"]["count"],
         "completed": snap["counters"]["completed"]}, sort_keys=True))
    sys.stderr.write("mxserve: drained — exiting 0\n")
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
