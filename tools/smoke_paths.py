"""Run named paths of ``chip_smoke.py`` alone on the card, for one or more
checkouts in turn, and time each.

    python3 tools/smoke_paths.py [--tree DIR ...] [--order ABBA]
        [--seed 0] [--out FILE] PATH [PATH ...]

Each run is a fresh process in its checkout: it builds that checkout's
kernels (``phase_setup``), then runs each named path of that checkout's
``chip_smoke.py`` (``dist_paths``, ``model_parallel_paths``, ...) and
reports each path's wall seconds and whether its checks held.  With two
trees (``--tree A --tree B``) and ``--order ABBA`` the runs go A, B, B, A,
so that a drift of the shared host over the call falls on both alike.
The default tree is the checkout holding this script.  Every run's
output goes to ``--out`` (default ``chiprun_out/smoke_paths.log``); one
JSON line a run, ``SMOKE_PATHS {...}``, goes to standard output.  Exits
1 if a check failed in any run.  Needs a CUDA card, as ``chip_smoke.py``
does.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree, paths, seed):
    """One run in ``tree``: set up, run each path, print the record."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    if not torch.cuda.is_available():
        print("smoke_paths: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = cs.phase_setup(torch, mx, cs.rtc_kernels(torch, mx))
    rec = {"tree": tree, "card": card,
           "setup_s": round(time.perf_counter() - t0, 1), "paths": {}}
    ok = True
    for name in paths:
        t0 = time.perf_counter()
        try:
            getattr(cs, name)(torch, mx, seed, card)
            err = None
        except cs.SmokeFailure as e:
            err = str(e)[:2000]
            ok = False
        rec["paths"][name] = {"seconds": round(time.perf_counter() - t0, 1),
                              "failed": err}
    print("SMOKE_PATHS " + json.dumps(rec), flush=True)
    return 0 if ok else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("paths", nargs="+", help="chip_smoke path functions")
    parser.add_argument("--tree", action="append", default=None,
                        help="a checkout (repeat for two; default: this one)")
    parser.add_argument("--order", default=None,
                        help="the runs' order by tree letter (default: each "
                             "tree once, A first)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                      "smoke_paths.log"))
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        return child(args.child, args.paths, args.seed)
    trees = [os.path.abspath(t) for t in (args.tree or [ROOT])]
    order = args.order or "".join(chr(ord("A") + i) for i in range(len(trees)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rc = 0
    with open(args.out, "a") as log:
        for letter in order:
            tree = trees[ord(letter) - ord("A")]
            cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
                   "--seed", str(args.seed)] + list(args.paths)
            log.write("=== %s %s\n" % (letter, tree))
            log.flush()
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=tree, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log.write(proc.stdout)
            log.flush()
            recs = [line for line in proc.stdout.splitlines()
                    if line.startswith("SMOKE_PATHS ")]
            wall = time.perf_counter() - t0
            if recs:
                rec = json.loads(recs[-1][len("SMOKE_PATHS "):])
            else:
                rec = {"tree": tree, "failed": proc.stdout[-2000:]}
            rec.update(run=letter, exit=proc.returncode, wall_s=round(wall, 1))
            print("SMOKE_PATHS " + json.dumps(rec), flush=True)
            rc = rc or (1 if proc.returncode else 0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
