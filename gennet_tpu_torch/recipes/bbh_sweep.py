"""Flagship (BBH) recipe screens on the port: the counterpart of the JAX
package's ``scripts/bbh_sweep.py``, with its base schedule and all of its
recipes, run through :func:`gennet_tpu_torch.cli.workloads.run_bbh`.

The recipes below are the research record of the posterior-quality search
(round-3 goal: final β ≥ 0.9 × the CNN sanity bound with whiteness ≥ 0.9;
``r4flag`` is the method's deliverable recipe). Their comments report what
the JAX package measured on its TPU, not this port. Rows append to
``out/torch/bbh_sweeps/results.jsonl`` with the JAX runner's keys.

Usage: python -m gennet_tpu_torch.recipes.bbh_sweep VARIANT [SEED] [GAN_ITERS]
       python -m gennet_tpu_torch.recipes.bbh_sweep --queue "v1,v2:0:50000,..."
       (both take --device, default cuda)
"""

import sys
import time
from dataclasses import replace

from gennet_tpu_torch.cli.workloads import BBHConfig, run_bbh
from gennet_tpu_torch.recipes import append_row, sweep_main

ROOT = "out/torch/bbh_sweeps"
RESULTS = f"{ROOT}/results.jsonl"

BASE = BBHConfig(plots=False, pe_iters=60_000, gan_iters=50_000,
                 eval_cadence=2500, pe_cadence=5000, ckpt_every=25_000,
                 cnn_cache=f"{ROOT}/cnn_cache",
                 out_dir=ROOT)

VARIANTS = {
    # the r2 recipe exactly (control): train-mode res route w=1, bootstrap
    # sampler, unreachable freeze threshold
    "r2recipe": {"res_loss_weight": 1.0, "res_eval_mode": False,
                 "posterior_noise": 1.0, "freeze_on_white": 0.99},
    # r3 diagnosed fixes, one at a time on top of the r2 recipe:
    # burst-proven residual weight
    "resw10": {"res_loss_weight": 10.0, "res_eval_mode": False,
               "posterior_noise": 1.0},
    # eval-mode res route (constrain the sampled mode)
    "evalres": {"res_loss_weight": 10.0, "res_eval_mode": True,
                "posterior_noise": 1.0},
    # eval-mode res route + plain eval draws (the constrained mode IS the
    # sampler; dispersion from the latent + bootstrap noise)
    "evalres_evaldraw": {"res_loss_weight": 10.0, "res_eval_mode": True,
                         "posterior_dropout": False, "posterior_noise": 1.0},
    # dispersion-calibrated weak-dropout sampler (training drate 0.2)
    "evalres_drop05": {"res_loss_weight": 10.0, "res_eval_mode": True,
                       "posterior_drate": 0.05},
    "evalres_drop02": {"res_loss_weight": 10.0, "res_eval_mode": True,
                       "posterior_drate": 0.02},
    # burst recipe transplanted whole: no instance noise + resw10
    "noin_evalres": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                     "res_eval_mode": True, "posterior_noise": 1.0},
    # BN-free generator (structural train/eval consistency)
    "gnorm_none": {"g_norm": "none", "res_loss_weight": 10.0,
                   "res_eval_mode": True, "posterior_noise": 1.0},
    "gnorm_group": {"g_norm": "group", "res_loss_weight": 10.0,
                    "res_eval_mode": True, "posterior_noise": 1.0},
    # reachable whiteness freeze (r2 grazed 0.99 at 145k, never crossed)
    "evalres_freeze": {"res_loss_weight": 10.0, "res_eval_mode": True,
                       "posterior_noise": 1.0, "freeze_on_white": 0.95},
    # train-mode res w10 + reachable combined gate (queue-1 showed the
    # EVAL-mode route collapses the BN generator; this keeps the burst
    # recipe's weight on the train-mode route and adds the early stop)
    "resw10_freeze": {"res_loss_weight": 10.0, "res_eval_mode": False,
                      "posterior_noise": 1.0, "freeze_on_white": 0.95},
    # truth-free estimator post-processing on the flagship cloud
    "evalres_rw": {"res_loss_weight": 10.0, "res_eval_mode": True,
                   "posterior_noise": 1.0, "reweight_temper": 1.0},
    "evalres_debias": {"res_loss_weight": 10.0, "res_eval_mode": True,
                       "posterior_noise": 1.0, "pe_debias": 1},
    # CNN-ceiling screens (VERDICT #3: the sanity bound itself must be
    # stable and >0.9): batch 8 starves the MXU AND leaves SGD noisy;
    # larger PE batches + longer EMA horizons. Run with tiny gan_iters —
    # only the PE phase and its cnn_sanity_beta history matter.
    "pe_b64": {"pe_batch_size": 64},
    "pe_b256": {"pe_batch_size": 256},
    "pe_b64_ema4": {"pe_batch_size": 64, "pe_ema_decay": 0.9999},
    "pe_b256_ema4": {"pe_batch_size": 256, "pe_ema_decay": 0.9999},
    "pe_b256_lr4": {"pe_batch_size": 256, "lr": 3.6e-4},
    # ---- round-4 screens (VERDICT r3 #3/#4): raise the RAW cloud --------
    # All use the stabilized batch-64 CNN and log beta_raw; debug_probes on
    # for per-term NaN/stall observability.
    # r3 flagship recipe exactly, instrumented (NaN repro + d_acc stall)
    "r4_r3probe": {"pe_batch_size": 64, "res_loss_weight": 1.0,
                   "posterior_noise": 1.0, "freeze_on_white": 0.95,
                   "pe_mlrc": 1, "reweight_temper": 1.0,
                   "select_best": "elbo", "debug_probes": True},
    # terminal anneal: last 20% with D frozen + adversarial term off, so the
    # FINAL raw state settles deterministically on the residual optimum
    "r4_anneal": {"pe_batch_size": 64, "res_loss_weight": 1.0,
                  "posterior_noise": 1.0, "anneal_frac": 0.2,
                  "pe_mlrc": 1, "reweight_temper": 1.0,
                  "debug_probes": True},
    # GroupNorm generator: no running statistics → train/eval gap closed
    # structurally; eval-mode res route is then safe (the r3 BN collapse
    # cannot happen: no stale stats to chase)
    "r4_grp": {"pe_batch_size": 64, "g_norm": "group",
               "res_loss_weight": 1.0, "posterior_noise": 1.0,
               "pe_mlrc": 1, "reweight_temper": 1.0,
               "debug_probes": True},
    "r4_grp_evalres": {"pe_batch_size": 64, "g_norm": "group",
                       "res_loss_weight": 10.0, "res_eval_mode": True,
                       "posterior_noise": 1.0, "pe_mlrc": 1,
                       "reweight_temper": 1.0, "debug_probes": True},
    # snapshot pooling: posterior pooled over 4 recent eval states (averages
    # over the adversarial oscillation instead of sampling one phase of it)
    "r4_snap4": {"pe_batch_size": 64, "res_loss_weight": 1.0,
                 "posterior_noise": 1.0, "n_snapshots": 4,
                 "pe_mlrc": 1, "reweight_temper": 1.0,
                 "debug_probes": True},
    # the combination bet: structural G + anneal + pooling
    "r4_combo": {"pe_batch_size": 64, "g_norm": "group",
                 "res_loss_weight": 3.0, "posterior_noise": 1.0,
                 "anneal_frac": 0.2, "n_snapshots": 4,
                 "pe_mlrc": 1, "reweight_temper": 1.0,
                 "debug_probes": True},
    # ---- r4 scheme fix: ch1-only D + analytic residual route ------------
    # The pair scheme is unwinnable (D memorizes the one fixed event-noise
    # vector in ch2; a PERFECT generator scores P(real)=0.008 —
    # scripts/d_memorization_probe.py). These screens drop ch2 from D
    # (pair_d=False) and let the residual-moment loss carry the whiteness
    # pressure, the architecture the burst workload already validates.
    "ch1res_w1": {"pe_batch_size": 64, "pair_d": False,
                  "res_loss_weight": 1.0, "posterior_noise": 1.0,
                  "pe_mlrc": 1, "reweight_temper": 1.0,
                  "debug_probes": True, "eval_cadence": 5000},
    "ch1res_w3": {"pe_batch_size": 64, "pair_d": False,
                  "res_loss_weight": 3.0, "posterior_noise": 1.0,
                  "pe_mlrc": 1, "reweight_temper": 1.0,
                  "debug_probes": True, "eval_cadence": 5000},
    "ch1res_w10": {"pe_batch_size": 64, "pair_d": False,
                   "res_loss_weight": 10.0, "posterior_noise": 1.0,
                   "pe_mlrc": 1, "reweight_temper": 1.0,
                   "debug_probes": True, "eval_cadence": 5000},
    "ch1res_grp": {"pe_batch_size": 64, "pair_d": False, "g_norm": "group",
                   "res_loss_weight": 3.0, "posterior_noise": 1.0,
                   "pe_mlrc": 1, "reweight_temper": 1.0,
                   "debug_probes": True, "eval_cadence": 5000},
    # ---- r4 scheme fix, take 2: frequency-resolved residual target ------
    # The ch1res_* screens all collapsed to beta 0 with res_loss ~1e-3: the
    # 2-moment target is satisfiable WITHOUT subtracting (a near-zero G
    # leaves the signal's energy spread over 1024 bins — per-bin excess
    # SNR²/n is inside the moment noise floor at n_sig=0.25). The banded
    # periodogram (losses.residual_spectral_loss) concentrates the signal's
    # evidence into few bands where it cannot hide; bands=8 keeps the
    # white-noise floor low (1/128 per band), bands=32 localizes harder.
    "ch1spec8_w3": {"pe_batch_size": 64, "pair_d": False,
                    "res_loss_weight": 3.0, "res_spectral_bands": 8,
                    "posterior_noise": 1.0, "pe_mlrc": 1,
                    "reweight_temper": 1.0, "debug_probes": True,
                    "eval_cadence": 5000},
    "ch1spec32_w3": {"pe_batch_size": 64, "pair_d": False,
                     "res_loss_weight": 3.0, "res_spectral_bands": 32,
                     "posterior_noise": 1.0, "pe_mlrc": 1,
                     "reweight_temper": 1.0, "debug_probes": True,
                     "eval_cadence": 5000},
    "ch1spec32_w10": {"pe_batch_size": 64, "pair_d": False,
                      "res_loss_weight": 10.0, "res_spectral_bands": 32,
                      "posterior_noise": 1.0, "pe_mlrc": 1,
                      "reweight_temper": 1.0, "debug_probes": True,
                      "eval_cadence": 5000},
    # spectral route on TOP of the reference pair scheme (keeps parity
    # default, adds the analytic whiteness pressure)
    "pairspec32_w3": {"pe_batch_size": 64, "pair_d": True,
                      "res_loss_weight": 3.0, "res_spectral_bands": 32,
                      "posterior_noise": 1.0, "pe_mlrc": 1,
                      "reweight_temper": 1.0, "debug_probes": True,
                      "eval_cadence": 5000},
    # ---- the r4 combination: every root-caused fix together --------------
    # ch1-only D (kills the memorized-noise-vector cue) + spectral residual
    # (binding whiteness test) + event-norm n_sig (correct target, default
    # on) + GroupNorm G (no train/eval statistics gap — the measured reason
    # ch1spec32_w3's TRAIN-mode residual whitened while its EVAL-mode cloud
    # collapsed: BN running averages were never constrained)
    "ch1spec32_grp": {"pe_batch_size": 64, "pair_d": False, "g_norm": "group",
                      "res_loss_weight": 3.0, "res_spectral_bands": 32,
                      "posterior_noise": 1.0, "pe_mlrc": 1,
                      "reweight_temper": 1.0, "debug_probes": True,
                      "eval_cadence": 5000},
    # + constrain the EVAL-mode output directly (safe without BN: the r3
    # eval-route collapse was BN chasing stale statistics)
    "ch1spec32_grp_ev": {"pe_batch_size": 64, "pair_d": False,
                         "g_norm": "group", "res_loss_weight": 3.0,
                         "res_spectral_bands": 32, "res_eval_mode": True,
                         "posterior_noise": 1.0, "pe_mlrc": 1,
                         "reweight_temper": 1.0, "debug_probes": True,
                         "eval_cadence": 5000},
    # the r4 flagship recipe: the combination above + zero-knob state
    # selection, snapshot pooling (dispersion), and a terminal anneal
    # (D frozen, residual-only settling of the FINAL raw state)
    "r4flag": {"pe_batch_size": 64, "pair_d": False, "g_norm": "group",
               "res_loss_weight": 3.0, "res_spectral_bands": 32,
               "posterior_noise": 1.0, "pe_mlrc": 1,
               "reweight_temper": 1.0, "n_snapshots": 4,
               "select_best": "elbo", "anneal_frac": 0.1,
               "debug_probes": True, "eval_cadence": 5000},
    # ---- round-5 screens (VERDICT r4 #2/#5) ------------------------------
    # Event-twin fix: the memorization probe measured D scoring the TRUE
    # waveform −1.7 logits below bank templates because the twin is the one
    # waveform never in the real set — adversarial pressure repels G from
    # the truth and the raw cloud degrades after ~25k. twin_boost restores
    # real density at the truth point (500 copies = 1% of real draws).
    "r5_tw500": {"pe_batch_size": 64, "pair_d": False, "g_norm": "group",
                 "res_loss_weight": 3.0, "res_spectral_bands": 32,
                 "posterior_noise": 1.0, "pe_mlrc": 1,
                 "reweight_temper": 1.0, "n_snapshots": 4,
                 "select_best": "elbo", "anneal_frac": 0.1,
                 "twin_boost": 500,
                 "debug_probes": True, "eval_cadence": 5000},
    # dose-response: 4% of real draws
    "r5_tw2k": {"pe_batch_size": 64, "pair_d": False, "g_norm": "group",
                "res_loss_weight": 3.0, "res_spectral_bands": 32,
                "posterior_noise": 1.0, "pe_mlrc": 1,
                "reweight_temper": 1.0, "n_snapshots": 4,
                "select_best": "elbo", "anneal_frac": 0.1,
                "twin_boost": 2000,
                "debug_probes": True, "eval_cadence": 5000},
    # twin fix on the reference PAIR scheme (the ch2 memorized-noise cue
    # remains — isolates how much of the pair failure is the twin cue)
    "pairspec32_tw500": {"pe_batch_size": 64, "pair_d": True,
                         "res_loss_weight": 3.0, "res_spectral_bands": 32,
                         "posterior_noise": 1.0, "pe_mlrc": 1,
                         "reweight_temper": 1.0, "twin_boost": 500,
                         "debug_probes": True, "eval_cadence": 5000},
    # VERDICT r4 #5: flagship batch decided on evidence — the r4 recipe at
    # batch 64 (scaling study: +20% MFU, 10× fewer dispatches), lr scaled
    # ~√(64/8); control = out/bbh_r4 (same recipe, batch 8, 50k)
    "r4flag_b64": {"pe_batch_size": 64, "pair_d": False, "g_norm": "group",
                   "res_loss_weight": 3.0, "res_spectral_bands": 32,
                   "posterior_noise": 1.0, "pe_mlrc": 1,
                   "reweight_temper": 1.0, "n_snapshots": 4,
                   "select_best": "elbo", "anneal_frac": 0.1,
                   "batch_size": 64, "lr": 5.6e-4,
                   "debug_probes": True, "eval_cadence": 5000},
    # r4flag_b64 CONFOUNDED (measured r5): `lr` feeds the CNN PE too, so
    # 5.6e-4 (6× the 9e-5 base, and a fresh cache tag) retrained the PE hot
    # — cnn_sanity 0.0, every downstream score zeroed — AND the GAN itself
    # diverged (res_loss 577k at 20k, g_loss →1400). v2 decouples: PE keeps
    # lr 9e-5 (cache hit on the r4flag batch-64 CNN, sanity 0.973), GAN
    # gets √(64/8)-scaled gan_lr = 2.5e-4.
    "r4flag_b64v2": {"pe_batch_size": 64, "pair_d": False, "g_norm": "group",
                     "res_loss_weight": 3.0, "res_spectral_bands": 32,
                     "posterior_noise": 1.0, "pe_mlrc": 1,
                     "reweight_temper": 1.0, "n_snapshots": 4,
                     "select_best": "elbo", "anneal_frac": 0.1,
                     "batch_size": 64, "gan_lr": 2.5e-4,
                     "debug_probes": True, "eval_cadence": 5000},
}


def bbh_row(out: dict) -> dict:
    """The summary's columns of a results row (ref: bbh_sweep.py:256-269)."""
    return {
        "beta": out.get("beta"), "beta_raw": out.get("beta_raw"),
        "grid_overlap_raw": out.get("grid_overlap_raw"),
        "beta_sanity": out.get("beta_sanity"),
        "cnn_sanity_beta": out.get("cnn_sanity_beta"),
        "grid_overlap": out.get("grid_overlap"),
        "whiteness": (out.get("whiteness") or {}).get("overall"),
        "frozen_at": out.get("frozen_at"),
    }


def run_one(name, seed, iters, *, device):
    """One recipe at ``seed`` for ``iters`` GAN steps; appends its row to
    ``RESULTS``, prints it after ``SWEEP RESULT:`` and returns it."""
    cfg = replace(BASE, **VARIANTS[name], seed=seed, gan_iters=iters,
                  out_dir=f"{ROOT}/{name}_s{seed}")
    t0 = time.time()
    out = run_bbh(cfg, device=device)
    row = {
        "variant": name, "seed": seed, "iters": iters, **bbh_row(out),
        "selected_route": out.get("selected_route"),
        "pool_ess": out.get("pool_ess"),
        "plateau_k": out.get("plateau_k"),
        "wall_s": round(time.time() - t0, 1),
    }
    append_row(RESULTS, row, "SWEEP RESULT:")
    return row


def main(argv=None):
    return sweep_main(argv, run_one, lambda: BASE.gan_iters, VARIANTS, __doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
