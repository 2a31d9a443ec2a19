"""Score the truth-free post-processing routes, and the library selection,
on a finished flagship run's saved clouds (port of
``scripts/bbh_postproc_eval.py``).

The routes (:mod:`gennet_tpu_torch.eval.posterior_post`) are eval-time
transforms of the sampled cloud, so no retraining is involved: the study
restores the run's newest saved cloud and its cached CNN, rebuilds the
exact grid reference from the run's seed, and writes one row per route
(β, grid overlap, ELBO; the resampling routes add their ESS), then one row
per candidate of ``select_final_cloud`` over the clouds saved at steps ≤
``gan_iters``, to ``out/torch/bbh_sweeps/postproc.jsonl``.

As in the script: the "raw" route is the run's newest cloud (under
``select_best="elbo"`` that is the library-selected final cloud), the
grid and the syntheses are built on ``tb.BankConfig()`` whatever the run's
config says (a run at n_pix ≠ 1024, where the script fails, is refused),
the PE comes from the run's CNN cache entry (a run without a
``cnn_cache`` is refused), and the noise std is the effective one. The
draws come from one ``torch.Generator`` seeded ``seed + 77`` (the script's
``PRNGKey(seed + 77)``; the streams differ): a test passes JAX's in
through ``draws``.

Usage: python -m gennet_tpu_torch.studies.bbh_postproc_eval [--library-only] RUN_DIR [...]
       (--library-only: the library selection only; --device, default cuda)
"""

import os
import sys

import numpy as np
import torch

from gennet_tpu_torch.cli import workloads
from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.eval import posterior_post as pp
from gennet_tpu_torch.models import CombinedPE, DualBranchPE
from gennet_tpu_torch.recipes import append_row
from gennet_tpu_torch.studies import _run
from gennet_tpu_torch.train.cnn import predict as cnn_predict

OUT = f"{_run.BBH_OUT}/postproc.jsonl"


def route_clouds(cloud, synth, cnn, measured, n_sig: float, gen, draws: dict | None = None):
    """The script's eight routes of ``cloud`` (:133-152), in its order:
    (clouds by route name, "raw" first; ESS of the likelihood weights at
    temper 1 and 0.5). ``draws``: per route, the draws its function takes
    (``noise``, ``jitter``, ``u0``)."""
    d = draws or {}
    routes = {"raw": cloud}
    routes["debias1"] = pp.self_calibrate(cloud, synth, cnn, gen, n_sig, rounds=1,
                                          **d.get("debias1", {}))
    routes["debias2"] = pp.self_calibrate(cloud, synth, cnn, gen, n_sig, rounds=2,
                                          **d.get("debias2", {}))
    routes["bootcal"] = pp.bootstrap_calibrate(cloud, synth, cnn, gen, n_sig,
                                               **d.get("bootcal", {}))
    routes["debias1_bootcal"] = pp.bootstrap_calibrate(routes["debias1"], synth, cnn, gen, n_sig,
                                                       **d.get("debias1_bootcal", {}))
    routes["mlrc"] = pp.ml_recenter(cloud, synth, measured, gen, **d.get("mlrc", {}))
    routes["mlrc_reweight1"] = pp.likelihood_resample(routes["mlrc"], synth, measured, n_sig, gen,
                                                      temper=1.0, **d.get("mlrc_reweight1", {}))
    routes["reweight1"] = pp.likelihood_resample(cloud, synth, measured, n_sig, gen, temper=1.0,
                                                 **d.get("reweight1", {}))
    routes["reweight05"] = pp.likelihood_resample(cloud, synth, measured, n_sig, gen, temper=0.5,
                                                  **d.get("reweight05", {}))
    ess = {t: round(pp.effective_sample_size(cloud, synth, measured, n_sig, temper=t), 1)
           for t in (1.0, 0.5)}
    return routes, ess


def route_rows(run: str, cloud_name: str, routes: dict, ess: dict, synth, measured, n_sig: float,
               ref_samples, grid) -> list:
    """One row per route (:154-170): run, route, β, grid overlap, ELBO
    (None when not finite), cloud; the resampling routes add their ESS."""
    rows = []
    for name, s in routes.items():
        b, g = _run.score(np.asarray(s), ref_samples, grid)
        e = pp.elbo_score(np.asarray(s), synth, measured, n_sig)
        row = {"run": run, "route": name, "beta": round(float(b), 4),
               "grid_overlap": round(float(g), 4),
               "elbo": round(float(e), 2) if np.isfinite(e) else None, "cloud": cloud_name}
        if name.startswith("reweight"):
            row["ess"] = ess[1.0 if name == "reweight1" else 0.5]
        rows.append(row)
    return rows


def library_rows(run: str, lib: dict, synth, measured, n_sig: float, gen, ref_samples, grid,
                 draws: dict | None = None) -> list:
    """``select_final_cloud`` over ``lib`` (step → cloud) in the grid's
    (mc, q) box, and one row per candidate (:176-207), or none when nothing
    was chosen. ``draws``: ``select_final_cloud``'s."""
    sel_name, chosen, info = pp.select_final_cloud(lib, synth, measured, n_sig, gen,
                                                   bounds=workloads.BBH_BOUNDS, draws=draws)
    rows = []
    if chosen is None:
        return rows
    for cname, ccloud in info["candidates"].items():
        b, g = _run.score(np.asarray(ccloud), ref_samples, grid)
        e = info["scores"][cname]
        row = {"run": run, "route": f"library:{cname}", "beta": round(float(b), 4),
               "grid_overlap": round(float(g), 4),
               "elbo": round(float(e), 2) if np.isfinite(e) else None,
               "chosen": cname == sel_name, "plateau_k": len(info["plateau_members"]),
               "pool_ess": round(info["pool_ess"], 1),
               "kde_ess": round(info.get("kde_ess", 0.0), 1)}
        se = info.get("score_ses", {}).get(cname)
        if se is not None and np.isfinite(se):
            row["elbo_se"] = round(float(se), 3)
        if cname == sel_name and "tiebreak" in info:
            row["tiebreak"] = {k: round(v, 4) if isinstance(v, float) else v
                               for k, v in info["tiebreak"].items()}
        rows.append(row)
    return rows


def study(run_dir: str, device, library_only: bool = False, ctx_cache: dict | None = None) -> list:
    """The rows of one run, each printed after ``POSTPROC:`` and appended
    to ``OUT``; runs that share the data, grid and PE fields share one
    context through ``ctx_cache``, as in the script."""
    cfg = _run.load_bbh_config(run_dir)
    _run.require_bank_geometry(cfg, "bbh_postproc_eval")
    ctx_cache = {} if ctx_cache is None else ctx_cache
    ctx_key = (cfg.seed, cfg.n_pix, cfg.training_num, cfg.pe_iters, cfg.pe_batch_size, cfg.lr,
               cfg.cnn_noise_frac, cfg.pe_ema_decay, cfg.pe_lr_decay, cfg.comb_pe_model,
               cfg.grid_grain)
    if ctx_key not in ctx_cache:
        (_, _, signal, measured, norm, psd, _, _), _ = _run.bbh_event(cfg, device)
        bank_cfg = tb.BankConfig()
        grid, ref_samples = _run.bbh_grid(cfg, measured, signal, psd, norm, bank_cfg)
        model = CombinedPE(n_pix=cfg.n_pix) if cfg.comb_pe_model else DualBranchPE(n_pix=cfg.n_pix)
        pe_state = _run.cached_pe(cfg, model, device)
        ctx_cache[ctx_key] = (pe_state, measured, psd, norm, bank_cfg, grid, ref_samples)
    pe_state, measured, psd, norm, bank_cfg, grid, ref_samples = ctx_cache[ctx_key]
    pe_use_ema = cfg.pe_ema_decay > 0

    paths = _run.snapshot_paths(run_dir)
    if not paths:
        print(f"SKIP {run_dir}: no saved clouds")
        return []
    cloud = _run.load_cloud(paths[-1][1])
    synth = workloads.bbh_synth(psd, bank_cfg, norm, device, clip=False)

    def cnn(w):
        return cnn_predict(pe_state, w, use_ema=pe_use_ema)

    gen = torch.Generator(device=device).manual_seed(cfg.seed + 77)
    n_sig = workloads.effective_n_sig(cfg, norm)
    run = os.path.basename(run_dir.rstrip("/"))
    rows = []
    if not library_only:
        routes, ess = route_clouds(cloud, synth, cnn, measured, n_sig, gen)
        rows += _emit(route_rows(run, os.path.basename(paths[-1][1]), routes, ess, synth,
                                 measured, n_sig, ref_samples, grid))
    lib = {st: _run.load_cloud(p) for st, p in paths if st <= cfg.gan_iters}
    return rows + _emit(library_rows(run, lib, synth, measured, n_sig, gen, ref_samples, grid))


def _emit(rows: list) -> list:
    for row in rows:
        append_row(OUT, row, "POSTPROC:")
    return rows


def main(argv=None) -> list:
    args = _run.parse(argv, __doc__, ("--library-only", {"action": "store_true"}),
                      ("run_dirs", {"nargs": "+", "metavar": "RUN_DIR"}))
    ctx_cache, rows = {}, []
    for run_dir in args.run_dirs:
        rows += study(run_dir, torch.device(args.device), args.library_only, ctx_cache)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
