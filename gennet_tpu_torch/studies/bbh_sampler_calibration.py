"""Calibrate the posterior sampler on a finished flagship run's final state
(port of ``scripts/bbh_sampler_calibration.py``).

The sampler (BatchNorm mode, MC dropout, bootstrap noise) is an eval-time
choice, so no retraining is involved: the study restores the run's GAN and
PE checkpoints and prints one JSON row per cell of the grid BatchNorm mode
(eval, batch) × dropout (on, off) × posterior noise (0, 0.2, 0.5, 1.0):
β, grid overlap, and the cloud's mc bias and mc and q dispersions in the
grid posterior's standard deviations. The script writes no file, and
neither does the port.

As in the script: the grid is built on ``tb.BankConfig()`` whatever the
run's config says; G and D are restored as the default batch-norm G and
the pair D (in bfloat16 when the run's ``bf16``), the PE from the run's
``ckpt_pe`` and evaluated with its raw weights, not its EMA; and the draws
go on from the stream that drew the event and the bank, as the script's
key does. Where the script fails (a run at n_pix ≠ 1024, ``g_norm`` other
than batch, ``pair_d=False``, no ``ckpt_pe`` such as a run with a
``cnn_cache``) the port refuses the run before any work (ROADMAP queue 3).

Usage: python -m gennet_tpu_torch.studies.bbh_sampler_calibration RUN_DIR [N_DRAWS]
       (N_DRAWS draws a cell, default 4000; --device, default cuda)
"""

import json
import os
import sys

import numpy as np
import torch

from gennet_tpu_torch.cli.workloads import effective_n_sig
from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.eval import overlap as ov
from gennet_tpu_torch.models import BBHGenerator, CombinedPE, DualBranchPE, PairDiscriminator
from gennet_tpu_torch.studies import _run
from gennet_tpu_torch.train.cnn import CNNConfig
from gennet_tpu_torch.train.cnn import predict as cnn_predict
from gennet_tpu_torch.train.gan import GANConfig, sample_generator

CELLS = [(bn_mode, dropout, pn) for bn_mode in ("eval", "batch") for dropout in (True, False)
         for pn in (0.0, 0.2, 0.5, 1.0)]


def check_run(cfg):
    """Refuse what the script cannot restore or score (see the module)."""
    _run.require_bank_geometry(cfg, "bbh_sampler_calibration")
    bad = []
    if cfg.g_norm != "batch":
        bad.append(f"g_norm={cfg.g_norm!r} (G is restored into the batch-norm generator)")
    if not cfg.pair_d:
        bad.append("pair_d=False (D is restored into the pair discriminator)")
    if bad:
        raise ValueError("bbh_sampler_calibration cannot run, as its JAX script cannot: "
                         + "; ".join(bad))
    if cfg.grid_grain <= 0:
        sys.exit("run has grid_grain<=0: no exact grid to calibrate against")


def cell_cloud(G, gan_state, gan_cfg, pe_state, n: int, bn_mode: str, dropout: bool, pn: float,
               n_sig: float, gen, z=None, noise=None) -> np.ndarray:
    """One cell's cloud (:89-93): ``n`` G draws, plus ``pn``·n_sig of
    noise, through the PE (its raw weights). ``z``: optional latents (see
    :func:`sample_generator`); ``noise``: optional unit normals of the draws'
    shape."""
    wf = sample_generator(G, gan_state, gen, n, gan_cfg, dropout=dropout, bn_mode=bn_mode, z=z)
    eps = (torch.randn(wf.shape, generator=gen, device=gen.device, dtype=wf.dtype)
           if noise is None else torch.as_tensor(noise, dtype=wf.dtype))
    return cnn_predict(pe_state, wf + pn * n_sig * eps.to(wf.device)).cpu().numpy()


def cell_row(s: np.ndarray, bn_mode: str, dropout: bool, pn: float, ref_samples, grid,
             gm) -> dict:
    """A cell's row (:94-101): β, grid overlap, the mc bias and the mc and
    q dispersions in the grid posterior's standard deviations."""
    return {"bn_mode": bn_mode, "dropout": dropout, "posterior_noise": pn,
            "beta": ov.beta_overlap(s, ref_samples) if s[:, 0].var() > 0 else 0.0,
            "grid_overlap": gp.grid_overlap_score(s, *grid),
            "bias_mc": (s[:, 0].mean() - gm[0]) / max(gm[2], 1e-12),
            "disp_mc": s[:, 0].std() / max(gm[2], 1e-12),
            "disp_q": s[:, 1].std() / max(gm[3], 1e-12)}


def rounded(row: dict) -> dict:
    """The printed row: numbers to 4 places, flags and names as they are."""
    return {k: (round(float(v), 4) if not isinstance(v, (bool, str)) else v)
            for k, v in row.items()}


def study(run_dir: str, n: int, device) -> list:
    cfg = _run.load_bbh_config(run_dir)
    check_run(cfg)
    pe_dir = os.path.join(run_dir, "ckpt_pe")
    if not os.path.isdir(pe_dir):
        raise FileNotFoundError(f"no ckpt_pe in {run_dir} (a run with a cnn_cache keeps its PE "
                                "there): bbh_sampler_calibration reads the PE from ckpt_pe only, "
                                "as its JAX script does")
    (_, _, signal, measured, norm, psd, _, _), gen = _run.bbh_event(cfg, device, skip_bank=False)
    grid, ref_samples = _run.bbh_grid(cfg, measured, signal, psd, norm, tb.BankConfig())
    gan_cfg = GANConfig(n_pix=cfg.n_pix, batch_size=cfg.batch_size)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    G = BBHGenerator(n_out=cfg.n_pix, conv_impl=cfg.conv_impl, dtype=dtype)
    D = PairDiscriminator(n_pix=cfg.n_pix, conv_impl=cfg.conv_impl, dtype=dtype)
    gan_state, step = _run.restore_gan(run_dir, G, D, gan_cfg, cfg.seed, device)
    pe = CombinedPE(n_pix=cfg.n_pix) if cfg.comb_pe_model else DualBranchPE(n_pix=cfg.n_pix)
    pe_state = _run.restore_pe(pe_dir, pe, CNNConfig(n_pix=cfg.n_pix,
                                                     batch_size=cfg.pe_batch_size),
                               cfg.seed, device, "PE")
    print(f"restored GAN step {step}")
    gm = gp.grid_moments(*grid)
    rows = []
    for bn_mode, dropout, pn in CELLS:
        s = cell_cloud(G, gan_state, gan_cfg, pe_state, n, bn_mode, dropout, pn,
                       effective_n_sig(cfg, norm), gen)
        row = rounded(cell_row(s, bn_mode, dropout, pn, ref_samples, grid, gm))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> list:
    args = _run.parse(argv, __doc__, ("run_dir", {"metavar": "RUN_DIR"}),
                      ("n_draws", {"nargs": "?", "type": int, "default": 4000}))
    return study(args.run_dir, args.n_draws, torch.device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])
