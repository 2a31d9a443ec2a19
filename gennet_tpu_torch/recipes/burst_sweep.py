"""Burst-smoke recipe screens on the port: the counterpart of the JAX
package's ``scripts/burst_sweep.py``, with its base schedule and all of
its recipes, run through
:func:`gennet_tpu_torch.cli.workloads.run_burst_smoke`.

The recipes below are the research record of the burst posterior search
(round-2 goal: final-state grid overlap ≥ 0.9 × the CNN sanity bound,
~0.98, across 3 seeds; ``mlrc_sel`` is the production recipe). Their
comments report what the JAX package measured on its TPU, not this port.
Rows append to ``out/torch/sweeps/results.jsonl`` with the JAX runner's
keys.

Usage: python -m gennet_tpu_torch.recipes.burst_sweep VARIANT [SEED] [ITERS]
       python -m gennet_tpu_torch.recipes.burst_sweep --queue "v1,v2:0:50000,..."
       (both take --device, default cuda)
"""

import sys
import time
from dataclasses import replace

from gennet_tpu_torch.cli.workloads import BurstSmokeConfig, run_burst_smoke
from gennet_tpu_torch.recipes import append_row, sweep_main

ROOT = "out/torch/sweeps"
RESULTS = f"{ROOT}/results.jsonl"

BASE = BurstSmokeConfig(plots=False, cadence=500, eval_every=5,
                        cnn_cache=f"{ROOT}/cnn_cache")

VARIANTS = {
    # the r2 DEFAULT recipe (noin + resw10 + noise-augmented unnormalized
    # CNN + whiteness-gated early stop) — config defaults, no overrides
    "default": {},
    # round-1 recipe re-run under the refactored step (parity check).
    # NOTE (ADVICE r4): since r4, instance noise is also applied to the
    # G-route D input (train/gan.py) — r4+ re-runs of this variant are NOT
    # bit-comparable with r1-r3 'base' results when instance_noise > 0.
    "base": {"instance_noise": -1.0, "res_loss_weight": 1.0,
             "pe_iters": 20000, "pe_noise_frac": 0.0, "pe_no_norm": False,
             "n_posterior": 1000, "freeze_on_white": 0.0, "freeze_on_res": 0.0},
    # adaptive D/G balance: D updates only while its accuracy < gate
    "gate90": {"d_acc_gate": 0.90},
    "gate75": {"d_acc_gate": 0.75},
    "gate60": {"d_acc_gate": 0.60},
    # mode-seeking diversity regularizer on G
    "div05": {"diversity_weight": 0.05},
    "div20": {"diversity_weight": 0.2},
    # snapshot-ensemble posterior over a long horizon (states 2.5k iters apart)
    "snap8": {"n_snapshots": 8, "snapshot_every": 5},
    "snap16": {"n_snapshots": 16, "snapshot_every": 5},
    # per-sample CNN max normalization (train + posterior consistent)
    "psmax": {"per_sample_max": True},
    # residual-moment weight
    "resw3": {"res_loss_weight": 3.0},
    "resw10": {"res_loss_weight": 10.0},
    "resw30": {"res_loss_weight": 30.0},
    # EXACT reference recipe: no label smoothing, no instance noise, equal
    # D lr (the round-1 stabilizers may be what blurs D into uselessness:
    # measured wf_corr only ~0.6 under the stabilized base)
    "refclean": {"label_smoothing": False, "instance_noise": 0.0,
                 "d_lr_scale": 1.0},
    "refclean_resw10": {"label_smoothing": False, "instance_noise": 0.0,
                        "d_lr_scale": 1.0, "res_loss_weight": 10.0},
    # stabilizer ablations (which one hurts?)
    "no_inoise": {"instance_noise": 0.0},
    "no_smooth": {"label_smoothing": False},
    "no_dscale": {"d_lr_scale": 1.0},
    # terminal anneal (D frozen + adversarial off for the tail) — makes the
    # final state deterministic; combine with no instance noise (fidelity)
    # and snapshot pooling (dispersion from the adversarial phase)
    "anneal": {"instance_noise": 0.0, "anneal_frac": 0.1},
    "anneal_snap8": {"instance_noise": 0.0, "anneal_frac": 0.1,
                     "n_snapshots": 8, "snapshot_every": 5},
    "anneal_resw10": {"instance_noise": 0.0, "anneal_frac": 0.1,
                      "res_loss_weight": 10.0},
    "noin_snap8": {"instance_noise": 0.0, "n_snapshots": 8,
                   "snapshot_every": 5},
    "noin_resw10": {"instance_noise": 0.0, "res_loss_weight": 10.0},
    "noin_drop05": {"instance_noise": 0.0, "posterior_drate": 0.05},
    # resw10 was q2's winner (0.42 best at 15k) — combine with anneal/snap
    "resw10_anneal": {"res_loss_weight": 10.0, "anneal_frac": 0.1},
    "resw10_snap8": {"res_loss_weight": 10.0, "n_snapshots": 8,
                     "snapshot_every": 5},
    "resw10_anneal_snap8": {"res_loss_weight": 10.0, "anneal_frac": 0.1,
                            "n_snapshots": 8, "snapshot_every": 5},
    # latent temperature < 1: shrink the draw cloud toward the posterior
    # width (resw10's best cloud is ~2 cells in t0 / 1.7x in tau — close)
    "resw10_temp05": {"res_loss_weight": 10.0, "posterior_temp": 0.5},
    "resw10_temp03": {"res_loss_weight": 10.0, "posterior_temp": 0.3},
    "resw10_psmax": {"res_loss_weight": 10.0, "per_sample_max": True},
    "resw10_div05": {"res_loss_weight": 10.0, "diversity_weight": 0.05},
    # annealed final state (high-fidelity center, whiteness 1.0) + weak-
    # dropout variational sampler for the dispersion the collapse removed
    "anres_drop02": {"res_loss_weight": 10.0, "anneal_frac": 0.1,
                     "posterior_drate": 0.02},
    "anres_drop05": {"res_loss_weight": 10.0, "anneal_frac": 0.1,
                     "posterior_drate": 0.05},
    "anres_drop10": {"res_loss_weight": 10.0, "anneal_frac": 0.1,
                     "posterior_drate": 0.10},
    # q3's stable winner (noin_resw10: final=best=0.24, whiteness 1.0,
    # tau under-dispersed 0.5x) + weak-dropout sampler to restore it
    "noinres": {"instance_noise": 0.0, "res_loss_weight": 10.0},
    "noinres_drop02": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                       "posterior_drate": 0.02},
    "noinres_drop05": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                       "posterior_drate": 0.05},
    "noinres_drop10": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                       "posterior_drate": 0.10},
    "noinres_temp15": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                       "posterior_temp": 1.5},
    # parametric-bootstrap sampler: noise-calibrated CNN + fresh n_sig noise
    # on draws — dispersion set by the likelihood, not a dropout knob
    "noinres_boot": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                     "pe_noise_frac": 0.5, "posterior_noise": 1.0},
    "anres_boot": {"res_loss_weight": 10.0, "anneal_frac": 0.1,
                   "pe_noise_frac": 0.5, "posterior_noise": 1.0},
    "boot": {"pe_noise_frac": 0.5, "posterior_noise": 1.0},
    # noise-augmented CNN WITHOUT added draw noise: pure de-biasing of the
    # estimates on imperfect G draws (a clean-trained CNN is measured to be
    # catastrophically biased off-manifold: bootstrap-of-truth t0 0.12 vs
    # 0.5, overlap 0.0)
    "noinres_pnf": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                    "pe_noise_frac": 0.5},
    "noinres_pnf_drop02": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                           "pe_noise_frac": 0.5, "posterior_drate": 0.02},
    "resw10_pnf": {"res_loss_weight": 10.0, "pe_noise_frac": 0.5},
    # longer-trained noise-augmented CNN (the 20k pnf CNN's residual t0 bias
    # ~1.6 cells is a convergence artifact) + bigger draw clouds
    "pnf60": {"instance_noise": 0.0, "res_loss_weight": 10.0,
              "pe_noise_frac": 0.5, "pe_iters": 60000},
    "pnf60_n4k": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                  "pe_noise_frac": 0.5, "pe_iters": 60000,
                  "n_posterior": 4000},
    "pnf60_boot": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                   "pe_noise_frac": 0.5, "pe_iters": 60000,
                   "posterior_noise": 1.0, "n_posterior": 4000},
    "anres_pnf60_boot": {"res_loss_weight": 10.0, "anneal_frac": 0.1,
                         "pe_noise_frac": 0.5, "pe_iters": 60000,
                         "posterior_noise": 1.0, "n_posterior": 4000},
    # no input normalization: remove the batch-max scale coupling (measured:
    # it biases tau low on noisy inputs and breaks the augmented CNN on
    # clean ones)
    "nn_boot": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                "pe_noise_frac": 0.5, "pe_iters": 60000, "pe_no_norm": True,
                "posterior_noise": 1.0, "n_posterior": 4000},
    "nn_anres_boot": {"res_loss_weight": 10.0, "anneal_frac": 0.1,
                      "pe_noise_frac": 0.5, "pe_iters": 60000,
                      "pe_no_norm": True, "posterior_noise": 1.0,
                      "n_posterior": 4000},
    "nn_plain": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                 "pe_noise_frac": 0.5, "pe_iters": 60000,
                 "pe_no_norm": True, "n_posterior": 4000},
    # tuned bootstrap scale (CPU ceiling: 0.83 @ 0.7sigma vs 0.77 @ 1.0)
    "nn_boot07": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                  "pe_noise_frac": 0.5, "pe_iters": 60000,
                  "pe_no_norm": True, "posterior_noise": 0.7,
                  "n_posterior": 4000},
    # champion + truth-free early stopping (freeze all training once
    # res_loss < 2e-4, i.e. G locked onto the event) — survives the
    # reference's full 50k schedule with the converged state as final
    "nn_freeze": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                  "pe_noise_frac": 0.5, "pe_iters": 60000,
                  "pe_no_norm": True, "n_posterior": 4000,
                  "freeze_on_res": 2e-4},
    # r3: truth-free estimator post-processing (VERDICT #4 — the residual
    # τ-bias of the CNN on G draws is the measured remaining gap)
    "debias": {"pe_debias": 1},
    "debias2": {"pe_debias": 2},
    # parametric-bootstrap calibration (debias at the cloud center + shrink
    # to the estimator's noise-limited width) — the oracle-debias diagnosis
    # (scripts/burst_debias_diag.py) showed removing the mean shift alone
    # recovers 0.88 on the seed-1 reconstruction
    "bootcal": {"pe_bootcal": 1},
    "debias_bootcal": {"pe_debias": 1, "pe_bootcal": 1},
    # ML recentering: translate the cloud onto the refined max-likelihood
    # point — the truth-free analogue of the oracle debias (0.88 on the
    # seed-1 reconstruction); round-trip routes measure ~zero shift because
    # the CNN bias lives on off-manifold G draws
    "mlrc": {"pe_mlrc": 1},
    # bootcal shrinks the over-dispersed axes about the (still biased)
    # center, then mlrc fixes the center — the two measured error terms
    "mlrc_bootcal": {"pe_mlrc": 1, "pe_bootcal": 1},
    # best raw-final recipe (nn_freeze: terminal anneal + 4000 draws +
    # 60k noise-augmented unnormalized CNN) + the calibration stack
    "nnf_mlrc": {"instance_noise": 0.0, "res_loss_weight": 10.0,
                 "pe_noise_frac": 0.5, "pe_iters": 60000,
                 "pe_no_norm": True, "n_posterior": 4000,
                 "freeze_on_res": 2e-4, "pe_mlrc": 1, "pe_bootcal": 1},
    # ELBO state selection on top of the calibration stack: whiteness
    # saturates at 1.0 across late states whose overlaps range 0.76–0.93,
    # so the freeze gate can stop on a mediocre one; ELBO (= −KL to the
    # exact posterior + const, truth-free) picks among them. No freeze —
    # selection wants the full eval trajectory to choose from.
    "mlrc_sel": {"pe_mlrc": 1, "pe_bootcal": 1, "select_best": "elbo",
                 "freeze_on_white": 0.0, "freeze_on_res": 0.0},
    # selection + freeze: cheaper (stops early) but selects only among
    # pre-freeze states
    "mlrc_sel_frz": {"pe_mlrc": 1, "pe_bootcal": 1, "select_best": "elbo"},
    # the full automatic stack: ELBO picks the calibration route per draw
    # AND the state across the whole trajectory — zero hand-chosen
    # calibration knobs
    "auto": {"select_route": "elbo", "select_best": "elbo",
             "freeze_on_white": 0.0, "freeze_on_res": 0.0},
    "reweight": {"reweight_temper": 1.0},
    "reweight05": {"reweight_temper": 0.5},
    "debias_reweight": {"pe_debias": 1, "reweight_temper": 1.0},
    # latent temperature on posterior draws
    "temp15": {"posterior_temp": 1.5},
    # R1 gradient penalty on D (smooth decision surface, anti-saturation)
    "r1g01": {"r1_gamma": 0.1},
    "r1g1": {"r1_gamma": 1.0},
    "r1g01_snap8": {"r1_gamma": 0.1, "n_snapshots": 8, "snapshot_every": 5},
    # weak-dropout posterior sampler (training drate is 0.3; 0.3 measured
    # harmful for draws, but a collapsed G may need SOME variational noise)
    "pdrop05": {"posterior_drate": 0.05},
    "pdrop10": {"posterior_drate": 0.10},
    "div20_snap8": {"diversity_weight": 0.2, "n_snapshots": 8, "snapshot_every": 5},
    # combinations
    "gate90_snap8": {"d_acc_gate": 0.90, "n_snapshots": 8, "snapshot_every": 5},
    "gate75_snap8": {"d_acc_gate": 0.75, "n_snapshots": 8, "snapshot_every": 5},
    "gate75_div05": {"d_acc_gate": 0.75, "diversity_weight": 0.05},
    "gate75_snap8_psmax": {"d_acc_gate": 0.75, "n_snapshots": 8,
                           "snapshot_every": 5, "per_sample_max": True},
}


def run_one(name, seed, iters, *, device):
    """One recipe at ``seed`` for ``iters`` GAN steps; appends its row to
    ``RESULTS``, prints it after ``SWEEP RESULT:`` and returns it (ref:
    burst_sweep.py:220-240)."""
    cfg = replace(BASE, **VARIANTS[name], seed=seed, gan_iters=iters,
                  out_dir=f"{ROOT}/{name}_s{seed}")
    t0 = time.time()
    out = run_burst_smoke(cfg, device=device)
    row = {
        "variant": name, "seed": seed, "iters": iters,
        "grid_overlap_final": out["grid_overlap"],
        "grid_overlap_best": out["grid_overlap_best"],
        "whiteness": out["whiteness"], "rms": out["rms"],
        "frozen_at": out.get("frozen_at"),
        "selected_at": out.get("selected_at"),
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
