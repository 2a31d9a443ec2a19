"""The burst grid geometry and the oracle corrections of seeds 0-2 (port
of ``scripts/burst_debias_diag.py``, whose work runs at import time; here
it is :func:`diagnose`, called by :func:`main`).

For each seed: the exact (t0, τ) posterior's moments, its t0 node spacing
and top t0 nodes, and the τ nodes holding over 1% of the mass. For seed
1, a Gaussian cloud with the moments a default-recipe run logged
(bias −1093.28σ in t0, −4.30σ in τ; dispersion 1829.88 and 0.5656) is
scored against the grid as it is, debiased by the oracle (its mean moved
to the grid's), and likelihood-resampled at temper 1, 0.5 and 0.1 (the
script's float64 formula). Then the overlap of seed 1 against a residual
t0 and τ bias, and ``ml_recenter`` on the seed-1 cloud, the truth-free
counterpart of the oracle debias.

The events are those of the port's ``run_burst_smoke`` at the default
config (n_pix 512, n_sig 0.25, grain 95) and seeds 0-2. The clouds and
resampling indices come from numpy's ``default_rng(0)``, as in the
script; ``ml_recenter``'s draw from a ``torch.Generator`` seeded 9 (the
script's ``PRNGKey(9)``; the streams differ): a test passes JAX's in.
The script writes no file, and neither does the port.

Usage: python -m gennet_tpu_torch.studies.burst_debias_diag [--device cuda]
"""

import sys
from dataclasses import replace

import numpy as np
import torch

from gennet_tpu_torch.cli.workloads import BurstSmokeConfig
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.eval import posterior_post as pp
from gennet_tpu_torch.physics.burst import sine_gaussian
from gennet_tpu_torch.studies import _run

# the final cloud moments a default-recipe run of seed 1 logged: t0 and τ
# bias and dispersion, in the grid posterior's standard deviations
LOGGED = (-1093.28, -4.30, 1829.88, 0.5656)


def _seed1_cloud(mx, my, sx, sy, rng):
    b_t0, b_tau, d_t0, d_tau = LOGGED
    return np.stack([mx + b_t0 * sx + rng.normal(0, d_t0 * sx, 1000),
                     my + b_tau * sy + rng.normal(0, abs(d_tau) * sy, 1000)], -1)


def diagnose(measured_by_seed: dict, n_pix: int = 512, n_sig: float = 0.25, grain: int = 95,
             gen=None, jitter=None) -> dict:
    """The study on the events ``measured_by_seed`` (seed → measured;
    seed 1 is the one the corrections use): a dict of what it prints.
    ``gen``: ``ml_recenter``'s generator; ``jitter``: its draw."""
    out = {"seeds": {}}
    for seed, measured in measured_by_seed.items():
        L, gx, gy = gp.burst_grid_posterior(measured, n_sig, grain)
        mx, my, sx, sy = gp.grid_moments(L, gx, gy)
        Ln = np.asarray(L, np.float64)
        Ln /= Ln.sum()
        pt0, ptau = Ln.sum(axis=0), Ln.sum(axis=1)   # L is (tau, t0)
        top = np.argsort(pt0)[::-1][:4]
        print(f"seed {seed}: t0 mean {mx:.6f} std {sx:.3e}  tau mean {my:.6f} std {sy:.3e}")
        print(f"  t0 node spacing {gx[1]-gx[0]:.5f}; top t0 nodes "
              f"{[(int(i), gx[i].round(4), pt0[i].round(3)) for i in top]}")
        print(f"  tau nodes with >1% mass: {int((ptau > 0.01).sum())}")
        row = {"moments": (mx, my, sx, sy), "spacing": float(gx[1] - gx[0]),
               "top_t0": [(int(i), float(gx[i]), float(pt0[i])) for i in top],
               "tau_nodes": int((ptau > 0.01).sum())}
        if seed == 1:
            rng = np.random.default_rng(0)
            cloud = _seed1_cloud(mx, my, sx, sy, rng)
            row["reconstructed"] = float(gp.grid_overlap_score(cloud, L, gx, gy))
            print(f"  reconstructed-cloud overlap: {row['reconstructed']:.4f}")
            # oracle debias: the mean shift removed
            cloud_db = cloud - cloud.mean(0) + np.array([mx, my])
            row["oracle"] = float(gp.grid_overlap_score(cloud_db, L, gx, gy))
            print(f"  oracle-debiased overlap:     {row['oracle']:.4f}")
            # the likelihood resample of the biased cloud (exact formula)
            x = np.arange(n_pix)[None, :] / 512.0 - cloud[:, 0:1]
            templ = np.sin(2 * np.pi * 100.0 * x + 2 * np.pi) * np.exp(-(x**2) / cloud[:, 1:2]**2)
            d = measured.cpu().numpy().astype(np.float64)[None, :]
            logl = -0.5 * np.sum(((d - templ) / n_sig) ** 2, -1)
            row["resample"] = {}
            for temper in (1.0, 0.5, 0.1):
                w = np.exp(temper * (logl - logl.max()))
                w /= w.sum()
                ess = 1.0 / np.sum(w**2)
                idx = rng.choice(1000, 1000, p=w)
                ovl = float(gp.grid_overlap_score(cloud[idx], L, gx, gy))
                row["resample"][temper] = (float(ess), ovl)
                print(f"  resample t={temper}: ESS {ess:.1f} overlap {ovl:.4f}")
        out["seeds"][seed] = row

    # tolerance: the residual t0 and τ bias against the overlap (seed 1)
    L, gx, gy = gp.burst_grid_posterior(measured_by_seed[1], n_sig, grain)
    mx, my, sx, sy = gp.grid_moments(L, gx, gy)
    rng = np.random.default_rng(0)
    base_t0, base_tau = rng.normal(0, LOGGED[2] * sx, 1000), rng.normal(0, LOGGED[3] * sy, 1000)
    print("residual-bias tolerance (t0_bias_s, tau_bias_sig -> overlap):")
    out["tolerance"] = {}
    for bt in (0.0, 2.5e-4, 5e-4, 1e-3, 2e-3):
        for btau in (0.0, 1.0):
            cloud = np.stack([mx + bt + base_t0, my + btau * sy + base_tau], -1)
            ovl = float(gp.grid_overlap_score(cloud, L, gx, gy))
            out["tolerance"][(bt, btau)] = ovl
            print(f"  t0+{bt:g}s tau+{btau:g}sig: {ovl:.3f}")

    # ml_recenter on the seed-1 cloud: expect about the oracle's overlap
    # if the refined ML point lands on the exact posterior's node
    cloud = _seed1_cloud(mx, my, sx, sy, np.random.default_rng(0))
    measured = measured_by_seed[1]

    def synth(s):
        s = torch.as_tensor(s, dtype=torch.float32, device=measured.device)
        return sine_gaussian(s[:, 0], s[:, 1], N=n_pix)

    fixed = pp.ml_recenter(cloud, synth, measured, gen, jitter=jitter)
    out["ml_recenter"] = float(gp.grid_overlap_score(fixed, L, gx, gy))
    out["raw"] = float(gp.grid_overlap_score(cloud, L, gx, gy))
    out["shift"] = np.asarray(fixed.mean(0) - cloud.mean(0))
    print(f"ml_recenter overlap: {out['ml_recenter']:.4f} (raw {out['raw']:.4f}; oracle 0.88)")
    print(f"  center shift: {out['shift']} vs needed "
          f"{np.array([-LOGGED[0] * sx, -LOGGED[1] * sy])}")
    return out


def events(device, cfg: BurstSmokeConfig | None = None) -> dict:
    """seed → measured of seeds 0-2, as the port's ``run_burst_smoke``
    draws them at ``cfg`` (the default config)."""
    cfg = cfg or BurstSmokeConfig()
    return {seed: _run.burst_measured(replace(cfg, seed=seed), device) for seed in (0, 1, 2)}


def main(argv=None) -> dict:
    args = _run.parse(argv, __doc__)
    device = torch.device(args.device)
    return diagnose(events(device), gen=torch.Generator(device=device).manual_seed(9))


if __name__ == "__main__":
    main(sys.argv[1:])
