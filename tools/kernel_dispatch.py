"""Time the LSTM, flash-attention and rtc forward kernels' call paths on the
card for one or more checkouts, each run a fresh process, in turns.

    python3 tools/kernel_dispatch.py [--tree DIR ...] [--order ABBA]
        [--calls 2000] [--forwards 20]

Each run imports its checkout's ``mxnet_tpu_torch`` and ``chip_smoke``,
builds the kernels, and measures on ``cuda:0`` with grad off (the
inference path, which calls the registered ``mxt`` ops where a checkout
has them):

- ``wrapper_us``: host microseconds a call, ``--calls`` calls and one
  device sync at the end (the host cost of the call path, kernel
  included), of ``kernels.lstm_cell.lstm_seq`` on a (2, 1, 4 x 32)
  sequence, ``lstm_cell`` on (1, 4 x 32) gates, ``flash_attention`` on
  (1, 16, 1, 16) q, k, v and an rtc silu kernel on 64 floats;
- ``lm_ms``: a ``Predictor`` forward of the LM (``chip_smoke.lm_symbol``:
  vocab 10000, width 200, 2 layers, 2 ``lstm_seq`` launches) at batch 32;
- ``route_b_ms``: a ``Predictor`` forward of the unrolled LM
  (``chip_smoke.route_b_symbol``: 64 cell launches) at batch 32;

each forward the median of ``--forwards`` after 3 warm-up forwards, host
clock from the call to a device sync.  With two trees and ``--order
ABBA`` the runs go A, B, B, A, so a drift of the shared host falls on
both alike.  One JSON line a run, ``KERNEL_DISPATCH {...}``, goes to
standard output.  Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _per_call_us(torch, fn, calls):
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def _forward_ms(torch, np, pred, feed, forwards):
    times = []
    for i in range(3 + forwards):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.forward(**feed)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def child(tree, calls, forwards):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    if not torch.cuda.is_available():
        print("kernel_dispatch: CUDA is not available", file=sys.stderr)
        return 2
    mx.kernels.build(["lstm_cell", "flash_attention"])
    lc, fa = mx.kernels.lstm_cell, mx.kernels.flash_attention
    silu = cs.rtc_kernels(torch, mx)["silu"]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    H = 32
    seq = (rand(2, 1, 4 * H), rand(4 * H, H) * 0.1, rand(1, H), rand(1, H))
    cell = (rand(1, 4 * H), rand(1, H))
    qkv = tuple(rand(1, 16, 1, 16) for _ in range(3))
    x = rand(64)
    rec = {"tree": tree, "card": torch.cuda.get_device_name(0),
           "wrapper_us": {}}
    with torch.no_grad():
        for name, fn in (
                ("lstm_seq", lambda: lc.lstm_seq(*seq)),
                ("lstm_cell", lambda: lc.lstm_cell(*cell)),
                ("flash_attention", lambda: fa.flash_attention(*qkv)),
                ("rtc", lambda: silu(x))):
            rec["wrapper_us"][name] = _per_call_us(torch, fn, calls)
    shape = (cs.LM_BATCH, cs.LM_SEQ)
    rs = np.random.RandomState(0)
    feed = {"data": rs.randint(0, cs.LM_VOCAB, shape).astype(np.float32),
            "softmax_label": np.zeros(shape, np.float32)}
    for key, symbol in (("lm_ms", cs.lm_symbol(mx)),
                        ("route_b_ms", cs.route_b_symbol(mx))):
        w, _ = cs._lm_weights(symbol, cs.LM_BATCH, 0)
        pred = mx.predict.Predictor(symbol, cs._with_prefixes(w, {}),
                                    {k: shape for k in feed}, ctx=mx.gpu(0))
        before = (lc.SEQ_LAUNCHES, lc.LAUNCHES)
        rec[key] = _forward_ms(torch, np, pred, feed, forwards)
        rec.setdefault("launches_a_forward", {})[key] = [
            (a - b) / (3 + forwards) for a, b in zip(
                (lc.SEQ_LAUNCHES, lc.LAUNCHES), before)]
        del pred
    print("KERNEL_DISPATCH " + json.dumps(rec), flush=True)
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
                                 if ln.startswith("KERNEL_DISPATCH")))
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-3000:])
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
