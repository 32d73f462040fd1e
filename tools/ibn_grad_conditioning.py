#!/usr/bin/env python3
"""Inception-BN training gradients at a small batch against float64, over
seeds, on the card: conditioning or algorithm choice?

    python3 tools/ibn_grad_conditioning.py [--seeds 5] [--batch 2]

For each seed it draws ``chip_smoke.draw_weights`` weights and a batch
(the smoke's Inception-BN agreement draws, seed offsets 70 and 71), runs
one ``forward(is_train=True)`` -> ``backward()`` on the port's CPU path in
float32 and float64, and on the card fused and with
``MXTPU_FUSED_KERNELS=0``, each with deterministic cuDNN and with cuDNN's
default algorithm choice.  It prints, per seed, each run's gradients'
relative L2 error against the float64 run and its ratio to the CPU
float32 run's, beside the card's name and power limit, then a JSON line
of all of them.  If the card's ratios move with the seed alike for fused
and unfused and under both cuDNN settings, the excess is conditioning
(float32 ReLU masks flipping under another summation order); if the
fused run alone stays high, it is the merged convolutions' arithmetic.
Needs one CUDA device and ``nvcc`` (it builds ``bn_act``); imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ibn_grad_conditioning: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    mx.kernels.build(["bn_act"])
    gpu = mx.gpu(0)
    gpu.torch_device            # pins float32 numerics (TF32 off)
    net = cs.zoo_symbol(mx, "inception-bn", cs.IMAGE, 1000)
    shape = (args.batch,) + cs.IMAGE
    rows = []
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        weights = cs.draw_weights(net, shape, seed + 70)
        rs = np.random.RandomState(seed + 71)
        x = rs.standard_normal(shape).astype(np.float32)
        y = rs.randint(0, 1000, args.batch).astype(np.float32)
        cpu32 = cs._executor_step(mx, net, weights, x, y, mx.cpu())
        exact = cs._executor_step(mx, net, weights, x.astype(np.float64),
                                  y.astype(np.float64), mx.cpu())
        keys = [k for k in exact if k.startswith("grad:")]
        row = {"seed": seed, "cpu_f32": cs._rel_l2(np, cpu32, exact, keys)}
        for cudnn in ("deterministic", "default"):
            for plan in ("fused", "unfused"):
                with cs.fused_kernels("1" if plan == "fused" else "0"):
                    if cudnn == "deterministic":
                        with cs._deterministic_cudnn(torch):
                            got = cs._executor_step(mx, net, weights, x, y,
                                                    gpu)
                    else:
                        got = cs._executor_step(mx, net, weights, x, y, gpu)
                row["%s_%s" % (plan, cudnn)] = cs._rel_l2(np, got, exact,
                                                          keys)
        rows.append(row)
        print("seed %d (batch %d, %.1f s): relative L2 against float64: cpu "
              "float32 %.4g; card fused / unfused, deterministic cuDNN "
              "%.4g / %.4g (x%.2f / x%.2f of the CPU), default cuDNN "
              "%.4g / %.4g (x%.2f / x%.2f); on %s" % (
                  seed, args.batch, time.perf_counter() - t0, row["cpu_f32"],
                  row["fused_deterministic"], row["unfused_deterministic"],
                  row["fused_deterministic"] / row["cpu_f32"],
                  row["unfused_deterministic"] / row["cpu_f32"],
                  row["fused_default"], row["unfused_default"],
                  row["fused_default"] / row["cpu_f32"],
                  row["unfused_default"] / row["cpu_f32"], card),
              flush=True)
    print(json.dumps({"card": card, "batch": args.batch, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
