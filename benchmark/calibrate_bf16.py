"""``calibrate.py``'s readings for a cell whose configuration computes in
bfloat16, with one more control. On the card at the cell's own size, over
many seeds in one process (the benchmark's own runs never run this):

- ``program``: the program's checked iterations against the plain
  reference (the lower readings), with ``dtype`` (the layers that computed
  in another dtype, ``phases/gan_bf16.py``);
- ``float32``: the reference computed in float32 throughout (its float32
  switch, ``fault="float32"``: what a program that dropped bf16 computes)
  against the bf16 reference, the control of the configuration's dtype;
- ``control``: the reference with TF32 on against the reference
  (``calibrate.py``'s; under bf16 it moves only the float32 layers);
- ``half_batch``: the reference with half of each batch left out.

    python3 benchmark/calibrate_bf16.py --workload bbh_bf16-gan --seeds 1 2 3 ... [--out file.jsonl]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings_for(workload: str, seed: int, device: str = "cuda", overrides=None) -> dict:
    import torch

    from benchmark.harness import cell, loops

    ctx = cell.build(workload, seed, device, overrides)
    checked = ctx.loop.checked_steps()
    ctx.loop = ctx.modules = ctx.data = None
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()
    init, readings = loops.initial(ctx), ctx.phase.readings
    ref = loops.reference(ctx)
    program = {**readings(checked, ref, init), "dtype": ctx.phase.dtype_reading(ctx.cfg, checked)}
    return {"seed": seed, "program": program,
            "float32": readings(loops.reference(ctx, fault="float32"), ref, init),
            "control": readings(loops.reference(ctx, tf32=True), ref, init),
            "half_batch": readings(loops.reference(ctx, fault="half_batch"), ref, init)}


def main():
    from benchmark import calibrate

    calibrate.readings_for = readings_for  # its loop over the seeds, with these readings
    calibrate.main()


if __name__ == "__main__":
    main()
