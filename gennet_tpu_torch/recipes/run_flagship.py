"""The flagship at the reference's 500k schedule on the port: the
counterpart of the JAX package's ``scripts/run_flagship.py``.

The reference's deliverable is the 500k-iteration GAN loop
(ref: bbhMahoGANy.py:88,1241-1382). This runs a recipe of
:mod:`gennet_tpu_torch.recipes.bbh_sweep` (``r4flag`` unless told
otherwise) at that schedule, with the JAX runner's overrides
(:func:`flagship_config`):

- eval cadence thinned to 10k (50 eval points on the full schedule);
- checkpoints every 10k, so a lost machine costs at most 10k steps;
- ``resume=True`` always: the same command starts the run or continues it
  from its newest checkpoint, so a long run goes in stages.

The variant comes from argv, else from the file ``flagship_variant`` in
the temporary directory (``/tmp`` unless ``TMPDIR`` says otherwise), else
``r4flag``. The row appends to ``out/torch/bbh_sweeps/results.jsonl``; the
run's files go to ``out/torch/bbh_r5``.

A command that finds the run already complete trains no step and appends
no row (the JAX runner appends a row of nulls then): it prints one line
saying so.

Plots are on, as in the JAX runner; ``--plots false`` turns them off where
matplotlib is missing.

Usage: python -m gennet_tpu_torch.recipes.run_flagship [VARIANT] [GAN_ITERS]
       [--device cuda] [--plots true|false]
"""

import argparse
import json
import os
import sys
import tempfile
import time
from dataclasses import replace

import torch

from gennet_tpu_torch import runtime
from gennet_tpu_torch.cli.workloads import run_bbh
from gennet_tpu_torch.recipes import append_row, bbh_sweep
from gennet_tpu_torch.train.checkpoints import CheckpointManager

OUT_DIR = "out/torch/bbh_r5"
DEFAULT_VARIANT = "r4flag"


def flagship_config(variant: str, iters: int):
    """``variant`` of the sweep at ``iters`` GAN steps with the flagship's
    overrides (ref: run_flagship.py:44-49), over the sweep's ``BASE``."""
    overrides = dict(bbh_sweep.VARIANTS[variant])
    overrides.update(
        seed=0, gan_iters=iters, eval_cadence=10_000, ckpt_every=10_000,
        plots=True, out_dir=OUT_DIR, resume=True,
    )
    return replace(bbh_sweep.BASE, **overrides)


def resume_step(out_dir: str) -> int:
    """The GAN step a resumed run in ``out_dir`` starts from: the step of
    the state in its newest GAN checkpoint (0 without one). After a run
    with evals that is the best-whiteness state saved at ``gan_iters + 1``,
    whose own step may be earlier, as in the reference."""
    ckpt_dir = os.path.join(out_dir, "ckpt_gan")
    step = CheckpointManager(ckpt_dir).latest_step()
    if step is None:
        return 0
    payload = torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"), map_location="cpu",
                         weights_only=True)
    return int(payload["state"]["step"])


def _default_variant() -> str:
    try:
        with open(os.path.join(tempfile.gettempdir(), "flagship_variant")) as fh:
            return fh.read().strip() or DEFAULT_VARIANT
    except OSError:
        return DEFAULT_VARIANT


def run(cfg, variant: str, *, device):
    """Run (or continue) the flagship ``cfg``. Returns the appended row, or
    None when the run was already complete and no step was trained."""
    start = resume_step(cfg.out_dir)
    t0 = time.time()
    out = run_bbh(cfg, device=device)
    if out["final_step"] <= start:
        print(f"flagship {variant} already complete at step {out['final_step']} in "
              f"{cfg.out_dir}: no step trained, no row appended", flush=True)
        return None
    row = {
        "variant": f"{variant}_flagship", "seed": cfg.seed, "iters": cfg.gan_iters,
        **bbh_sweep.bbh_row(out),
        "selected_at": out.get("selected_at"),
        "out_dir": cfg.out_dir,
        "wall_s": round(time.time() - t0, 1),
    }
    append_row(bbh_sweep.RESULTS, row, "FLAGSHIP RESULT:")
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("variant", nargs="?", default="")
    p.add_argument("iters", nargs="?", type=int, default=500_000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--plots", choices=("true", "false"), default="true")
    args = p.parse_args(argv)
    variant = args.variant or _default_variant()
    if variant not in bbh_sweep.VARIANTS:
        p.error(f"unknown variant {variant!r}")
    cfg = flagship_config(variant, args.iters)
    if args.plots == "false":
        cfg = replace(cfg, plots=False)
    print(json.dumps({"runtime": runtime.setup(args.device)}), flush=True)
    return run(cfg, variant, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
