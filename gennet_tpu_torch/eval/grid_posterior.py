"""Exact grid posteriors and the grid-based scores (port of
``gennet_tpu.eval.grid_posterior``): the (t0, τ) grid of the ``smoke``
workload's sine-Gaussian burst and the (mc, q) grid of the synthetic
flagship event.

The synthetic flagship event is built by the same template pipeline (event-twin
template + N(0, σ) whitened noise, peak at the safe-window centre), so the
Gaussian likelihood over a grid of templates synthesised at that peak index
is exact ground truth (the flagship analogue of
ref: burstMahoGANy.py:716-726).
"""

import numpy as np
import torch

from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.eval.overlap import gaussian_kde_pdf
from gennet_tpu_torch.physics import priors


def burst_grid_posterior(measured, n_sig: float = 0.25, grain: int = 95,
                         t0_range=(0.25, 0.75), tau_range=(1.0 / 60.0, 1.0 / 15.0)):
    """Exact (t0, τ) likelihood grid of the sine-Gaussian burst,
    L ∝ exp(−½ Σ_t ((d − h(t0, τ)) / σ)²) normalised to max 1
    (ref: burstMahoGANy.py:716-726), in float64 numpy on the host with
    t = n/512, as the JAX package evaluates it.

    Returns (L (grain, grain) with axes (τ, t0), as the reference
    transposes it, t0 grid, τ grid).
    """
    t0 = np.linspace(*t0_range, grain)
    tau = np.linspace(*tau_range, grain)
    T0, TAU = np.meshgrid(t0, tau, indexing="ij")
    d = (measured.detach().cpu().numpy() if isinstance(measured, torch.Tensor)
         else np.asarray(measured)).astype(np.float64).reshape(1, -1)
    t = np.arange(d.shape[-1]) / 512.0
    x = t[None, :] - T0.ravel()[:, None]
    tt = TAU.ravel()[:, None]
    templ = np.sin(2.0 * np.pi * 100.0 * x + 2.0 * np.pi) * np.exp(-(x**2) / tt**2)
    logL = -0.5 * np.sum(((d - templ) / n_sig) ** 2, axis=-1)
    logL = logL.reshape(grain, grain).T
    return np.exp(logL - np.max(logL)), t0, tau


# the exact BBH grid's (mc, q) box
BBH_MC_RANGE, BBH_Q_RANGE = (20.0, 35.0), (0.5, 1.0)


def bbh_grid_posterior(measured: torch.Tensor, psd: torch.Tensor, bank_cfg,
                       norm_constant: float, noise_sigma: float, grain: int = 95,
                       mc_range=BBH_MC_RANGE, q_range=BBH_Q_RANGE, chunk: int = 4096):
    """Likelihood L over a (grain × grain) (mc, q) grid, normalised to max 1.

    Returns (L (grain, grain) float64 numpy with axes (q, mc), mc grid, q grid).
    Templates are synthesised ``chunk`` at a time on psd's device.
    """
    mc = np.linspace(*mc_range, grain)
    q = np.linspace(*q_range, grain)
    MC, Q = np.meshgrid(mc, q, indexing="ij")
    dev = psd.device
    m1, m2 = priors.mc_q_to_m1m2(torch.as_tensor(MC.ravel(), dtype=torch.float32, device=dev),
                                 torch.as_tensor(Q.ravel(), dtype=torch.float32, device=dev))
    d = measured.reshape(1, -1)
    parts = []
    for i in range(0, m1.shape[0], chunk):
        h = tb.make_templates_from_params(m1[i : i + chunk], m2[i : i + chunk],
                                          psd, bank_cfg, norm_constant)
        parts.append(-0.5 * torch.sum(((d - h) / noise_sigma) ** 2, dim=-1))
    logL = torch.cat(parts).cpu().numpy().astype(np.float64).reshape(grain, grain)
    L = np.exp(logL - logL.max())
    return L.T, mc, q


def sample_grid_posterior(L: np.ndarray, x_grid: np.ndarray, y_grid: np.ndarray,
                          n: int, seed: int = 0) -> np.ndarray:
    """(x, y) draws from a (y, x)-convention grid posterior: categorical
    over cells plus uniform jitter within each cell."""
    rng = np.random.default_rng(seed)
    p = np.asarray(L, np.float64).T  # → (x, y)
    p = p / p.sum()
    flat_idx = rng.choice(p.size, size=n, p=p.ravel())
    ix, iy = np.unravel_index(flat_idx, p.shape)
    dx = x_grid[1] - x_grid[0] if len(x_grid) > 1 else 0.0
    dy = y_grid[1] - y_grid[0] if len(y_grid) > 1 else 0.0
    x = x_grid[ix] + rng.uniform(-0.5, 0.5, n) * dx
    y = y_grid[iy] + rng.uniform(-0.5, 0.5, n) * dy
    return np.stack([x, y], axis=-1)


def grid_moments(L: np.ndarray, x_grid: np.ndarray, y_grid: np.ndarray):
    """(mean_x, mean_y, std_x, std_y) of a (y, x)-convention grid posterior."""
    p = np.asarray(L, np.float64).T
    p = p / p.sum()
    px = p.sum(axis=1)
    py = p.sum(axis=0)
    mx = float(np.dot(px, x_grid))
    my = float(np.dot(py, y_grid))
    sx = float(np.sqrt(np.dot(px, (x_grid - mx) ** 2)))
    sy = float(np.sqrt(np.dot(py, (y_grid - my) ** 2)))
    return mx, my, sx, sy


def grid_credible_interval(L: np.ndarray, levels=(0.68, 0.9, 0.99)):
    """Density thresholds of ``L`` enclosing the ``levels`` probability
    masses: the contour levels the reference found by bisection on a 2-D
    histogram (ref: make_contour_plot, bbhMahoGANy.py:752-784), found here
    by sorting. In float64 numpy, in ``L``'s units."""
    L = np.asarray(L, np.float64)
    p = L / L.sum()
    flat = np.sort(p.ravel())[::-1]
    csum = np.cumsum(flat)
    out = []
    for lv in levels:
        k = int(np.searchsorted(csum, lv))
        out.append(flat[min(k, flat.size - 1)] * L.sum())
    return out


def grid_overlap_score(samples: np.ndarray, L: np.ndarray, x_grid: np.ndarray,
                       y_grid: np.ndarray) -> float:
    """β-style overlap of a sample cloud with a grid posterior: Scott's-rule
    KDE of the samples on the grid, cosine similarity with L, in [0, 1]."""
    X, Y = np.meshgrid(x_grid, y_grid, indexing="ij")
    pts = np.vstack([X.ravel(), Y.ravel()])
    pk = gaussian_kde_pdf(np.asarray(samples, np.float64).T, pts).reshape(len(x_grid), len(y_grid))
    Lg = np.asarray(L, np.float64).T
    num = float((pk * Lg).sum())
    den = float(np.sqrt((pk**2).sum() * (Lg**2).sum()))
    return num / den if den > 0 else 0.0
