#!/usr/bin/env python3
"""Where one step of the persistent LSTM kernels spends its time, on the card.

    python3 tools/lstm_seq_phases.py [--steps 32] [--batch 32] [--hidden 200]

Builds an instrumented copy of ``mxnet_tpu_torch/csrc/lstm_cell.cu`` (under
``mxnet_tpu_torch/_build/rtc/``, the committed source untouched) in which
thread 0 of block 0 reads ``clock64()`` at the borders of each phase of a
step, runs the forward and the backward of one layer at (T, N, H) in
float32 and bfloat16 on the plan ``lstm_seq_plan`` picks, and prints the
median cycles of each phase over the steps after the first, beside the
card's name, power limit and SM clock.  Forward phases: the block's
product (``gemm``), the block barrier, the cell with the h exchange
through distributed shared memory (``cell``), the cluster barrier's
arrive (a release), the global stores, the wait.  Backward: the cell,
the product, the arrive, the stores, the wait, the sum of the cluster's
partial products (``reduce``).  Needs one CUDA device and ``nvcc``;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "lstm_cell.cu")
MAX_STEPS = 64
FWD = ("gemm", "block barrier", "cell + h exchange", "arrive", "stores",
       "wait")
BWD = ("cell", "gemm", "arrive", "stores", "wait", "reduce")


def _insert(text, anchor, before="", after=""):
    if text.count(anchor) != 1:
        raise SystemExit("instrumentation anchor not found once: %r" % anchor)
    return text.replace(anchor, before + anchor + after)


def instrumented(src):
    """The source with clock probes: probe(k, i) stores clock64() of
    thread 0, block 0 into g_clock[k][step][i] (k 0 forward, 1 backward).
    """
    cut = src.index("__global__ void __launch_bounds__(kSeqThreads, 1) "
                    "lstm_seq_bwd_kernel(")
    fwd, bwd = src[:cut], src[cut:]
    fwd = _insert(fwd, "namespace {\n", after=(
        "__device__ unsigned long long g_clock[2][%d][8];\n"
        "#define PROBE(k, step, i) if (threadIdx.x == 0 && blockIdx.x == 0"
        " && (step) < %d) g_clock[k][step][i] = clock64();\n"
        % (MAX_STEPS, MAX_STEPS)))
    fwd = _insert(fwd, "    block_gemm(w_s, ph, R,",
                  before="    PROBE(0, t, 0)\n")
    fwd = _insert(fwd, "    __syncthreads();\n    T* h_next",
                  before="    PROBE(0, t, 1)\n")
    fwd = _insert(fwd, "    T* h_next", before="    PROBE(0, t, 2)\n")
    fwd = _insert(fwd, "    cluster_arrive();\n",
                  before="    PROBE(0, t, 3)\n", after="    PROBE(0, t, 4)\n")
    fwd = _insert(fwd, "    cluster_wait();\n",
                  before="    PROBE(0, t, 5)\n", after="    PROBE(0, t, 6)\n")
    step = "(steps - 1 - t)"
    bwd = _insert(bwd, "  for (int t = steps - 1; t >= 0; --t) {\n",
                  after="    PROBE(1, %s, 0)\n" % step)
    bwd = _insert(bwd, "    __syncthreads();\n    float* p_buf",
                  before="    PROBE(1, %s, 1)\n" % step)
    bwd = _insert(bwd, "    cluster_arrive();\n",
                  before="    PROBE(1, %s, 2)\n" % step,
                  after="    PROBE(1, %s, 3)\n" % step)
    bwd = _insert(bwd, "    cluster_wait();\n",
                  before="    PROBE(1, %s, 4)\n" % step,
                  after="    PROBE(1, %s, 5)\n" % step)
    bwd = _insert(bwd,
                  "        dh_rec[s] = round_to<T>(sum);\n      }\n    }\n",
                  after="    PROBE(1, %s, 6)\n" % step)
    bwd += ('\nextern "C" int lstm_seq_clock(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_clock, '
            'sizeof(g_clock));\n}\n')
    return fwd + bwd


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--hidden", type=int, default=200)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lstm_seq_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    kernels, lc = mx.kernels, mx.kernels.lstm_cell
    with open(SOURCE) as f:
        text = instrumented(f.read())
    lib = kernels.load_library("lstm_seq_phases", source=text)
    fns = lc._bind(lib)
    lib.lstm_seq_clock.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    T, N, H = args.steps, args.batch, args.hidden
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        plan = lc.lstm_seq_plan(N, H, dtype)
        if plan is None:
            print("%s: (N, H) = (%d, %d) takes per_step" % (dtype, N, H))
            continue
        xg = torch.randn((T, N, 4 * H), generator=gen, device=dev).to(dtype)
        w = ((torch.rand((4 * H, H), generator=gen, device=dev) * 2 - 1)
             * (6.0 / (5 * H)) ** 0.5).to(dtype)
        h0, c0 = (0.5 * torch.randn((N, H), generator=gen, device=dev)
                  .to(dtype) for _ in range(2))
        hs, cs = (torch.empty((T, N, H), device=dev, dtype=dtype)
                  for _ in range(2))
        hT, cT, dh0, dc0 = (torch.empty_like(h0) for _ in range(4))
        gates, dgates = torch.empty_like(xg), torch.empty_like(xg)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):   # the last launch's clocks are read
            err = fns["lstm_seq_fwd"](
                xg.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
                hT.data_ptr(), cT.data_ptr(), T, N, H, plan["cluster"],
                plan["rows"], code, stream)
            err = err or fns["lstm_seq_bwd"](
                gates.data_ptr(), cs.data_ptr(), w.data_ptr(),
                hs.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, N, H,
                plan["cluster"], plan["rows"], code, stream)
            if err:
                raise SystemExit("launch failed: CUDA error %d" % err)
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * (2 * MAX_STEPS * 8))()
        if lib.lstm_seq_clock(raw) != 0:
            raise SystemExit("reading the clocks failed")
        print("%s, (T, N, H) = (%d, %d, %d), %d clusters of %d blocks x %d "
              "rows; median cycles a step over steps 2-%d:"
              % (dtype, T, N, H, plan["clusters"], plan["cluster"],
                 plan["rows"], min(T, MAX_STEPS)))
        for k, names in ((0, FWD), (1, BWD)):
            rows = [raw[(k * MAX_STEPS + s) * 8:(k * MAX_STEPS + s) * 8 + 8]
                    for s in range(1, min(T, MAX_STEPS))]
            phases = [statistics.median(r[i + 1] - r[i] for r in rows)
                      for i in range(len(names))]
            total = statistics.median(r[len(names)] - r[0] for r in rows)
            print("  %s: %s; step %d" % (
                "forward " if k == 0 else "backward", ", ".join(
                    "%s %d" % kv for kv in zip(names, phases)), total))
    return 0


if __name__ == "__main__":
    sys.exit(main())
