"""Residual-whiteness statistics.

The data-subtraction method's core claim is that h(t) − x_gen is
unit-variance white Gaussian noise; the reference only eyeballed this via
residual plots and the residual-moment training targets (ref:
burstMahoGANy.py:798-802, bbhMahoGANy.py:931-936). Here it is a quantitative
test (SURVEY.md §4 idiom 4): moment checks plus a Ljung-Box portmanteau
statistic on the residual autocorrelation. A copy of
``gennet_tpu.eval.whiteness``, so both packages score alike.
"""

import numpy as np


def residual_moments(residual: np.ndarray, n_sig: float = 1.0):
    """Per-sample (mean, variance/n_sig²) — the training targets (0, 1)."""
    r = np.asarray(residual, np.float64)
    r = r.reshape(-1, r.shape[-1])
    return r.mean(axis=-1), r.var(axis=-1) / n_sig**2


def ljung_box(residual: np.ndarray, n_lags: int = 20):
    """Ljung-Box Q statistic and its χ²(n_lags) p-value per residual row.

    Q = n(n+2) Σ_k ρ_k²/(n−k); under whiteness Q ~ χ²(n_lags).
    """
    from scipy.stats import chi2

    r = np.asarray(residual, np.float64)
    r = r.reshape(-1, r.shape[-1])
    r = r - r.mean(axis=-1, keepdims=True)
    n = r.shape[-1]
    denom = np.sum(r * r, axis=-1)
    q = np.zeros(r.shape[0])
    for k in range(1, n_lags + 1):
        rho_k = np.sum(r[:, k:] * r[:, :-k], axis=-1) / denom
        q += rho_k**2 / (n - k)
    q *= n * (n + 2)
    return q, chi2.sf(q, n_lags)


def whiteness_score(residual: np.ndarray, n_sig: float = 1.0, n_lags: int = 20,
                    dispersion: np.ndarray | None = None):
    """Summary dict: fraction of residual rows passing moment bounds and the
    Ljung-Box test at p > 0.01 — a single trainable-quality gate.

    ``dispersion``: optional per-row variance to subtract from the measured
    residual variance before comparing against n_sig². When the residual
    rows are ``measured − draw_i`` for POSTERIOR draws (not point
    estimates), each row's variance is inflated by that draw's deviation
    from the truth — for a centred cloud ≈ its deviation from the cloud
    mean, ``mean((draw_i − cloud_mean)²)``, which is observable and
    truth-free. Without this correction a perfectly-subtracting run with a
    deliberately dispersed posterior reads var_pass ≈ 0 (the measured r4
    flagship artifact: whiteness_final 0.087 against res_loss 9e-4)."""
    mean, var = residual_moments(residual, n_sig)
    if dispersion is not None:
        var = var - np.asarray(dispersion, np.float64).reshape(-1) / n_sig**2
    n = np.asarray(residual).shape[-1]
    mean_ok = np.abs(mean) < 4.0 * n_sig / np.sqrt(n)
    var_ok = np.abs(var - 1.0) < 6.0 / np.sqrt(n)
    _, p = ljung_box(residual, n_lags)
    lb_ok = p > 0.01
    return {
        "mean_pass": float(np.mean(mean_ok)),
        "var_pass": float(np.mean(var_ok)),
        "ljung_box_pass": float(np.mean(lb_ok)),
        "overall": float(np.mean(mean_ok & var_ok & lb_ok)),
    }


def posterior_whiteness(measured: np.ndarray, draws: np.ndarray,
                        n_sig: float = 1.0, n_lags: int = 20):
    """Whiteness of the subtraction product for a posterior CLOUD.

    The subtraction method's claim is about ``h(t) − x_gen`` (ref:
    bbhMahoGANy.py:931-936, a single G output). For a cloud of draws the
    right gate object is the residual of the posterior-MEAN waveform (the
    MMSE subtraction product); per-draw residuals carry the cloud's
    dispersion by construction. Returns the mean-waveform score dict plus
    the dispersion-corrected per-draw score under ``"draws"``.
    """
    measured = np.asarray(measured, np.float64).reshape(-1)
    draws = np.asarray(draws, np.float64).reshape(-1, measured.shape[-1])
    mean_wf = draws.mean(axis=0, keepdims=True)
    out = whiteness_score(measured[None, :] - mean_wf, n_sig, n_lags)
    disp = ((draws - mean_wf) ** 2).mean(axis=-1)
    out["draws"] = whiteness_score(measured[None, :] - draws, n_sig, n_lags,
                                   dispersion=disp)
    return out
