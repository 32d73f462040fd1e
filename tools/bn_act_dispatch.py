"""Time the ``bn_act`` forward's call path on the card for one or more
checkouts, each run a fresh process, in turns.

    python3 tools/bn_act_dispatch.py [--tree DIR ...] [--order ABBA]
        [--calls 2000] [--forwards 20]

Each run imports its checkout's ``mxnet_tpu_torch``, builds the
``bn_act`` kernels, and measures on ``cuda:0``:

- ``wrapper_us``: host microseconds a call of ``kernels.bn_act.norm_act``
  on a tiny (1, 64, 8, 8) float32 tensor (``--calls`` calls, one device
  sync at the end: the host cost of the call path, kernel included);
- ``resnet50_ms``: a ResNet-50 ``Predictor`` forward (17 ``bn_act``
  launches) at batch 1 and at batch 32, host clock from the call to a
  device sync, the median of ``--forwards`` after 3 warm-up forwards.

With two trees and ``--order ABBA`` the runs go A, B, B, A, so a drift of
the shared host falls on both alike.  One JSON line a run,
``BN_ACT_DISPATCH {...}``, goes to standard output.  Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree, calls, forwards):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    if not torch.cuda.is_available():
        print("bn_act_dispatch: CUDA is not available", file=sys.stderr)
        return 2
    mx.kernels.build(["bn_act"])
    ba = mx.kernels.bn_act
    dev = torch.device("cuda:0")
    x = torch.randn(1, 64, 8, 8, device=dev)
    scale = torch.rand(64, device=dev)
    shift = torch.rand(64, device=dev)
    for _ in range(100):
        ba.norm_act(x, scale, shift, "relu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        ba.norm_act(x, scale, shift, "relu")
    torch.cuda.synchronize()
    wrapper_us = (time.perf_counter() - t0) * 1e6 / calls
    with mx.name.NameManager():
        symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                      image_shape=cs.IMAGE)
    w_args, w_aux = cs.draw_weights(symbol, (1,) + cs.IMAGE, 0)
    args, aux = mx.convert.params_from_numpy((w_args, w_aux), ctx=mx.cpu())
    rec = {"tree": tree, "card": torch.cuda.get_device_name(0),
           "wrapper_us": wrapper_us, "resnet50_ms": {}}
    for batch in (1, 32):
        pred = mx.predict.Predictor(symbol, cs._with_prefixes(args, aux),
                                    {"data": (batch,) + cs.IMAGE},
                                    ctx=mx.gpu(0))
        data = np.random.RandomState(batch).standard_normal(
            (batch,) + cs.IMAGE).astype(np.float32)
        before = ba.LAUNCHES
        times = []
        for i in range(3 + forwards):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.forward(data=data)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        rec["resnet50_ms"][batch] = float(np.median(times))
        rec.setdefault("launches_a_forward", {})[batch] = \
            (ba.LAUNCHES - before) / (3 + forwards)
        del pred
    print("BN_ACT_DISPATCH " + json.dumps(rec), flush=True)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=None,
                        help="a checkout (repeatable; default this one)")
    parser.add_argument("--order", default=None,
                        help="run order over the trees, e.g. ABBA")
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--forwards", type=int, default=20)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        return child(args.child, args.calls, args.forwards)
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    order = args.order or "".join(chr(65 + i) for i in range(len(trees)))
    rc = 0
    for letter in order:
        tree = trees[ord(letter) - 65]
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--calls", str(args.calls), "--forwards", str(args.forwards)],
            cwd=tree, capture_output=True, text=True)
        sys.stdout.write("".join(ln + "\n" for ln in res.stdout.splitlines()
                                 if ln.startswith("BN_ACT_DISPATCH")))
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-3000:])
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
