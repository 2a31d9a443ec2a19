"""Replay every saved cloud of finished burst runs through a battery of
truth-free scores (port of ``scripts/burst_rescore_study.py``).

For each score, the study reports its rank correlation (Spearman) with the
exact-grid overlap across the run's clouds, the overlap of the cloud it
ranks first, and that of the pool of the clouds within 0.1 of its best.
The scores use only ``measured``, the forward model and the cloud:

    elbo_g   ELBO with a Gaussian entropy (the in-run selector)
    elbo_k   ELBO with the k-NN entropy
    mlogl    E_q[log L] alone (no entropy; for diagnosis)
    white    whiteness of the posterior-mean residual
    w_elbo   elbo_g where white ≥ 0.5, else −inf

One row per run goes to ``out/torch/sweeps/rescore_study.jsonl``. As in
the script, the config is the default ``BurstSmokeConfig`` (with the
script's cadence, ``eval_every`` and cache) at the seed the directory
name ends with, a cloud with a constant column is skipped, and
``final_overlap`` is that of the last scoreable cloud in file-name order.
The event is drawn from the seed as the port's ``run_burst_smoke`` draws
it. No score draws at random.

Usage: python -m gennet_tpu_torch.studies.burst_rescore_study RUN_DIR [...] [--device cuda]
"""

import sys
from dataclasses import replace

import numpy as np
import torch

from gennet_tpu_torch.cli.workloads import BurstSmokeConfig
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.eval import posterior_post as pp
from gennet_tpu_torch.eval.whiteness import posterior_whiteness
from gennet_tpu_torch.recipes import append_row
from gennet_tpu_torch.studies import _run

OUT = f"{_run.BURST_OUT}/rescore_study.jsonl"
SCORES = ("elbo_g", "elbo_k", "mlogl", "white", "w_elbo")


def spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    ca, cb = ra - ra.mean(), rb - rb.mean()
    den = np.sqrt((ca**2).sum() * (cb**2).sum())
    return float((ca * cb).sum() / den) if den > 0 else 0.0


def cloud_scores(clouds: dict, synth, measured, n_sig: float, grid) -> list:
    """One dict per scoreable cloud (:74-89): its step, the five scores and
    its grid overlap."""
    meas_np = measured.cpu().numpy() if torch.is_tensor(measured) else np.asarray(measured)
    rows = []
    for step, s in clouds.items():
        if s[:, 0].var() <= 0 or s[:, 1].var() <= 0:
            continue  # collapsed clouds are never selectable in-run either
        wf = synth(s).cpu().numpy()
        wmean = wf.mean(axis=0, keepdims=True)
        ws = posterior_whiteness(meas_np / n_sig, wmean / n_sig, 1.0)
        eg = pp.elbo_score(s, synth, measured, n_sig)
        ek = pp.elbo_score(s, synth, measured, n_sig, entropy="knn")
        d = meas_np[None, :] - wf
        mlogl = float(np.mean(-0.5 * np.sum(d**2, axis=1) / n_sig**2))
        rows.append({"step": step, "elbo_g": eg, "elbo_k": ek, "mlogl": mlogl,
                     "white": ws["overall"],
                     "w_elbo": eg if ws["overall"] >= 0.5 else float("-inf"),
                     "overlap": float(gp.grid_overlap_score(s, *grid))})
    return rows


def rescore_row(run: str, clouds: dict, rows: list, grid) -> dict:
    """The run's row (:90-119) from its per-cloud ``rows``."""
    ov = np.array([r["overlap"] for r in rows])
    print(f"\n=== {run}  ({len(rows)} scoreable clouds) ===")
    print(f"{'score':8s} {'spearman':>9s} {'argmax step':>11s} {'argmax ovl':>10s} "
          f"{'stack ovl':>9s}")
    out = {"run": run, "n": len(rows)}
    for name in SCORES:
        v = np.array([r[name] for r in rows])
        finite = np.isfinite(v)
        if not finite.any():
            print(f"{name:8s}  (no finite scores)")
            continue
        rho = spearman(v[finite], ov[finite])
        best = int(np.argmax(np.where(finite, v, -np.inf)))
        # plateau stack: the clouds within 0.1 of the best score
        mx = v[best]
        members = [r["step"] for r, vi, f in zip(rows, v, finite)
                   if f and vi >= mx - 0.1] or [rows[best]["step"]]
        pool = np.concatenate([clouds[s] for s in members], axis=0)
        sg = gp.grid_overlap_score(pool, *grid)
        print(f"{name:8s} {rho:9.3f} {rows[best]['step']:11d} {rows[best]['overlap']:10.4f} "
              f"{float(sg):9.4f}  (stack K={len(members)})")
        out[name] = {"spearman": round(rho, 3), "argmax_step": rows[best]["step"],
                     "argmax_overlap": round(rows[best]["overlap"], 4),
                     "stack_overlap": round(float(sg), 4), "stack_k": len(members)}
    out["best_overlap"] = round(float(ov.max()), 4)
    out["final_overlap"] = round(float(ov[-1]), 4)
    print(f"best-in-run overlap {ov.max():.4f}; per-cloud table:")
    for r in rows:
        print(f"  {r['step']:6d} ovl={r['overlap']:.4f} elbo_g={r['elbo_g']:8.1f} "
              f"elbo_k={r['elbo_k']:8.1f} white={r['white']:.2f} mlogl={r['mlogl']:8.1f}")
    return out


def study(run_dir: str, cfg: BurstSmokeConfig, device):
    measured, grid, synth = _run.burst_reference(cfg, device)
    clouds = _run.burst_clouds(run_dir)
    if not clouds:
        print(f"{run_dir}: no saved clouds")
        return None
    out = rescore_row(run_dir, clouds, cloud_scores(clouds, synth, measured, cfg.n_sig, grid),
                      grid)
    append_row(OUT, out)
    return out


def main(argv=None) -> list:
    args = _run.parse(argv, __doc__, ("run_dirs", {"nargs": "+", "metavar": "RUN_DIR"}))
    base = BurstSmokeConfig(plots=False, cadence=500, eval_every=5,
                            cnn_cache=f"{_run.BURST_OUT}/cnn_cache")
    return [study(run_dir, replace(base, seed=_run.burst_seed(run_dir), out_dir=run_dir),
                  torch.device(args.device)) for run_dir in args.run_dirs]


if __name__ == "__main__":
    main(sys.argv[1:])
