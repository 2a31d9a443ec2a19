"""The candidate-library selection on finished burst runs, truth-free (port
of ``scripts/burst_pool_study.py``).

Applies the production rule (``posterior_post.select_final_cloud``) to a
run's saved per-evaluation clouds: the in-run ELBO argmax cloud, the
ELBO-plateau pool (δ = 0.1 nats), the pool of all clouds, their smoothed
likelihood resamples (``plat_is``, ``pool_is``) and the KDE importance
resample of the pool (``kde_is``), chosen by ``elbo_score``. Reports each
candidate's ELBO and exact-grid overlap, the chosen candidate and its
overlap, and appends one row per run to ``out/torch/sweeps/pool_study.jsonl``.

As in the script, the config is the default ``BurstSmokeConfig`` at the
seed the directory name ends with (``…_s<seed>``), a cloud with a
constant column is left out, and the row's ``candidates`` table is
written after the chosen candidate's entry has been set to its overlap
alone (an argmax, plateau or pool choice loses its ELBO and size there).
The event is drawn from the seed as the port's ``run_burst_smoke`` draws
it, and the selection's draws from a ``torch.Generator`` seeded
``seed + 7`` (the script's ``PRNGKey(seed + 7)``; the streams differ): a
test passes JAX's in through ``draws``.

Usage: python -m gennet_tpu_torch.studies.burst_pool_study RUN_DIR [...] [--device cuda]
"""

import sys
from dataclasses import replace

import numpy as np
import torch

from gennet_tpu_torch.cli.workloads import _BURST_BOUNDS, BurstSmokeConfig
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.eval import posterior_post as pp
from gennet_tpu_torch.recipes import append_row
from gennet_tpu_torch.studies import _run

OUT = f"{_run.BURST_OUT}/pool_study.jsonl"


def pool_row(run: str, clouds: dict, synth, measured, n_sig: float, grid, gen,
             draws: dict | None = None):
    """The study of one run's clouds (:49-97): the row, or None when no
    cloud is scoreable. ``draws``: ``select_final_cloud``'s."""
    clouds = {s: c for s, c in clouds.items() if c[:, 0].var() > 0 and c[:, 1].var() > 0}
    if not clouds:
        print(f"{run}: no scoreable clouds")
        return None
    chosen_name, chosen_cloud, info = pp.select_final_cloud(clouds, synth, measured, n_sig, gen,
                                                            bounds=_BURST_BOUNDS, draws=draws)
    # the candidate library again, for the per-candidate overlap table
    per = {s: pp.elbo_score(c, synth, measured, n_sig) for s, c in clouds.items()}
    plat, _ = pp.plateau_pool(clouds, per, delta=0.1)
    pool = np.concatenate(list(clouds.values()), axis=0)
    rows = {}
    for name, c in (("argmax", clouds[info["argmax_step"]]), ("plateau", plat), ("pool", pool)):
        ovl = float(gp.grid_overlap_score(c, *grid))
        rows[name] = {"elbo": round(float(info["scores"][name]), 2)
                      if name in info["scores"] else None,
                      "overlap": round(ovl, 4), "n": int(c.shape[0])}
        print(f"  {name:8s} elbo={info['scores'].get(name)} overlap={ovl:.4f}")
    ov_chosen = float(gp.grid_overlap_score(chosen_cloud, *grid))
    print("  scores: " + ", ".join(f"{k}: {v:.1f}" for k, v in info["scores"].items()))
    out = {"run": run, "argmax_step": info["argmax_step"],
           "plateau_k": len(info["plateau_members"]), "pool_ess": round(info["pool_ess"], 1),
           "kde_ess": round(info.get("kde_ess", 0.0), 1),
           "scores": {k: round(v, 2) for k, v in info["scores"].items()},
           "candidates": rows, "chosen": chosen_name, "chosen_overlap": round(ov_chosen, 4)}
    rows[chosen_name] = {"overlap": round(ov_chosen, 4)}
    print(f"  -> chosen {chosen_name} overlap {ov_chosen:.4f} (pool ESS {info['pool_ess']:.0f}, "
          f"KDE-IS ESS {info.get('kde_ess', 0.0):.0f})")
    return out


def study(run_dir: str, cfg: BurstSmokeConfig, device):
    measured, grid, synth = _run.burst_reference(cfg, device)
    out = pool_row(run_dir, _run.burst_clouds(run_dir), synth, measured, cfg.n_sig, grid,
                   torch.Generator(device=device).manual_seed(cfg.seed + 7))
    if out is not None:
        append_row(OUT, out)
    return out


def main(argv=None) -> list:
    args = _run.parse(argv, __doc__, ("run_dirs", {"nargs": "+", "metavar": "RUN_DIR"}))
    base = BurstSmokeConfig(plots=False)
    outs, finals = [], []
    for run_dir in args.run_dirs:
        seed = _run.burst_seed(run_dir)
        print(f"=== {run_dir} (seed {seed}) ===")
        r = study(run_dir, replace(base, seed=seed, out_dir=run_dir), torch.device(args.device))
        outs.append(r)
        if r:
            finals.append(r["chosen_overlap"])
    if finals:
        print(f"\nchosen-overlap median over {len(finals)} seeds: "
              f"{float(np.median(finals)):.4f}  (all: {finals})")
    return outs


if __name__ == "__main__":
    main(sys.argv[1:])
