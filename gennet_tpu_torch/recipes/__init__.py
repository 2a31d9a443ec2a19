"""The production recipe runners (counterparts of the JAX package's
``scripts/bbh_sweep.py``, ``scripts/run_flagship.py`` and
``scripts/burst_sweep.py``, module for module).

Each runner holds its base schedule (``BASE``) and its named recipes
(``VARIANTS``, the research record, copied with their comments), runs one
recipe through the port's workload and appends one row per run to a
results file under ``out/torch/``. The rows have the JAX runners' keys, so
the two packages' results files read alike::

    python -m gennet_tpu_torch.recipes.bbh_sweep VARIANT [SEED] [GAN_ITERS]
    python -m gennet_tpu_torch.recipes.bbh_sweep --queue "v1,v2:0:50000,..."
    python -m gennet_tpu_torch.recipes.run_flagship [VARIANT] [GAN_ITERS]
    python -m gennet_tpu_torch.recipes.burst_sweep VARIANT [SEED] [ITERS]

Every runner takes ``--device`` (default ``cuda``; no fallback to the CPU).
``walls`` splits a run's time-stamped log into its setup, PE, GAN and
evaluation walls.
"""

import argparse
import json
import os

from gennet_tpu_torch import runtime


def append_row(path: str, row: dict, label: str | None = None):
    """Append ``row`` as one JSON line to ``path`` and, given a ``label``
    (``SWEEP RESULT:``, ``FLAGSHIP RESULT:``), print it after the label."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(row) + "\n")
    if label is not None:
        print(label, json.dumps(row), flush=True)


def sweep_main(argv, run_one, default_iters, variants: dict, doc: str):
    """The sweep runners' command line: ``VARIANT [SEED] [ITERS]`` or
    ``--queue "name[:seed[:iters]],..."`` (a serial queue on the one card),
    and ``--device``. Refuses a name missing from ``variants`` before any
    run, sets the device up as the CLI does, then calls
    ``run_one(name, seed, iters, device=...)`` for each run; ``ITERS``
    defaults to ``default_iters()``, read when the command runs."""
    p = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("variant", nargs="?")
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("iters", nargs="?", type=int)
    p.add_argument("--queue", help='"name[:seed[:iters]],name,..."')
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if (args.queue is None) == (args.variant is None):
        p.error("give either VARIANT [SEED] [ITERS] or --queue")
    if args.queue is not None:
        runs = []
        for item in args.queue.split(","):
            parts = item.split(":")
            runs.append((parts[0], int(parts[1]) if len(parts) > 1 else 0,
                         int(parts[2]) if len(parts) > 2 else default_iters()))
    else:
        runs = [(args.variant, args.seed,
                 default_iters() if args.iters is None else args.iters)]
    unknown = [name for name, _, _ in runs if name not in variants]
    if unknown:
        p.error(f"unknown variant(s) {', '.join(unknown)}")
    print(json.dumps({"runtime": runtime.setup(args.device)}), flush=True)
    return [run_one(name, seed, iters, device=args.device) for name, seed, iters in runs]
