"""The readings that a cell's limits are set from, on the card at the
cell's own size, over many seeds in one process (the benchmark's own runs
never run this):

- ``program``: the program's checked iterations against the plain
  reference (the lower readings);
- ``control``: the reference computed with TF32 on, the precision below
  the configuration's float32, against the reference (the upper end);
- ``half_batch``: the reference with half of each batch left out, the
  mean taken over the rest, against the reference (a fault's reading).
  A step that returns its state unchanged reads 1 by the measure of
  ``change`` and needs no run.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... [--out file.jsonl]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings_for(workload: str, seed: int, device: str = "cuda", overrides=None) -> dict:
    import torch

    from benchmark.harness import cell, loops
    from benchmark.harness.compare import readings

    ctx = cell.build(workload, seed, device, overrides)
    checked = ctx.loop.checked_steps()
    ctx.loop = ctx.modules = ctx.data = None
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
    init = loops.initial(ctx)
    ref = loops.reference(ctx)
    return {"seed": seed,
            "program": readings(checked, ref, init),
            "control": readings(loops.reference(ctx, tf32=True), ref, init),
            "half_batch": readings(loops.reference(ctx, fault="half_batch"), ref, init)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    args = p.parse_args()
    from benchmark.harness import env

    env.pin_caches(ROOT)
    env.require_cards(1)
    import torch

    card = {"kind": torch.cuda.get_device_name(0), "power_limit": env.power_limit()}
    for seed in args.seeds:
        t = time.perf_counter()
        row = {"workload": args.workload, **card, **readings_for(args.workload, seed),
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
