"""Pool the clouds of a finished flagship run's top-K ELBO evaluations and
rescore the pool (port of ``scripts/elbo_stack_eval.py``).

The selection stays truth-free: the saved clouds are ranked by the ELBO
the run logged for them in ``bbh_metrics.jsonl``; the pool of the top K is
rescored by its own ELBO, and β and grid overlap are computed after the
ranking, for the report only. One row per K (default 1 2 3 4 5 8 12 50;
a K beyond the clouds is skipped) goes to
``out/torch/bbh_sweeps/stacking.jsonl``, then the row of the K with the
largest pooled ELBO is printed.

As in the script, a pool over 8000 rows is cut to a uniform 8000 with
numpy's ``default_rng(seed)`` (the same draw as the script's), the grid
and syntheses use the run's geometry, the synthesis clips (mc, q) as the
run's does, and the lalinference products' posterior is the reference
when the run has one. The script's best-K comparison is kept: a first K
whose pooled ELBO is not finite leaves ``None`` to compare with, and a
later finite one then raises ``TypeError`` (ROADMAP queue 3).

Usage: python -m gennet_tpu_torch.studies.elbo_stack_eval RUN_DIR [K ...] [--device cuda]
"""

import json
import os
import sys

import numpy as np
import torch

from gennet_tpu_torch.cli.workloads import _bbh_bank_cfg, bbh_synth, effective_n_sig
from gennet_tpu_torch.eval import posterior_post as pp
from gennet_tpu_torch.recipes import append_row
from gennet_tpu_torch.studies import _run

OUT = f"{_run.BBH_OUT}/stacking.jsonl"
KS = [1, 2, 3, 4, 5, 8, 12, 50]


def logged_elbos(run_dir: str) -> dict:
    """step → the ELBO the run logged at that evaluation."""
    out = {}
    with open(os.path.join(run_dir, "bbh_metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r.get("elbo") is not None:
                out[int(r["step"])] = float(r["elbo"])
    return out


def stack_rows(run: str, clouds: dict, elbo_by_step: dict, ks, synth, measured, n_sig: float,
               ref_samples, grid, seed: int) -> tuple:
    """(one row per K in ``ks``, the row of the largest pooled ELBO), as
    the script builds them (:102-132): the clouds ranked by their logged
    ELBO, the top K pooled (cut to 8000 rows), scored and rescored."""
    ranked = sorted(clouds, key=lambda s: -elbo_by_step[s])
    print(f"{len(ranked)} clouds; ELBO-ranked head: "
          f"{[(s, round(elbo_by_step[s], 2)) for s in ranked[:6]]}")
    rows, best = [], None
    for k in ks:
        if k > len(ranked):
            continue
        pool = np.concatenate([clouds[s] for s in ranked[:k]], axis=0)
        if len(pool) > 8000:
            # cap the scored set: β's KDE and the ELBO's synthesis are O(n)
            pool = pool[np.random.default_rng(seed).choice(len(pool), 8000, replace=False)]
        beta, go = _run.score(pool, ref_samples, grid)
        e = pp.elbo_score(pool, synth, measured, n_sig)
        row = {"run": run, "k": k, "steps": ranked[:k], "beta": round(float(beta), 4),
               "grid_overlap": round(float(go), 4),
               "elbo_pooled": round(float(e), 2) if np.isfinite(e) else None}
        rows.append(row)
        append_row(OUT, row, "STACK:")
        if best is None or (row["elbo_pooled"] is not None
                            and row["elbo_pooled"] > best["elbo_pooled"]):
            best = row
    return rows, best


def study(run_dir: str, ks, device) -> tuple:
    cfg = _run.load_bbh_config(run_dir)
    elbo_by_step = logged_elbos(run_dir)
    clouds = {st: _run.load_cloud(p) for st, p in _run.snapshot_paths(run_dir)
              if st in elbo_by_step}
    if not clouds:
        sys.exit(f"no (cloud, elbo) pairs under {run_dir}")
    (_, _, signal, measured, norm, psd, _, lalinf_samples), _ = _run.bbh_event(cfg, device)
    bank_cfg = _bbh_bank_cfg(cfg)
    grid, grid_samples = _run.bbh_grid(cfg, measured, signal, psd, norm, bank_cfg)
    ref_samples = lalinf_samples if lalinf_samples is not None else grid_samples
    synth = bbh_synth(psd, bank_cfg, norm, device, clip=True)
    rows, best = stack_rows(os.path.basename(run_dir.rstrip("/")), clouds, elbo_by_step, ks,
                            synth, measured, effective_n_sig(cfg, norm), ref_samples, grid,
                            cfg.seed)
    print("ELBO-argmax K:", json.dumps(best))
    return rows, best


def main(argv=None) -> tuple:
    args = _run.parse(argv, __doc__, ("run_dir", {"metavar": "RUN_DIR"}),
                      ("ks", {"nargs": "*", "type": int, "metavar": "K"}))
    return study(args.run_dir, args.ks or KS, torch.device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])
