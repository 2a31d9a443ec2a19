"""Posterior-comparison statistics: the β overlap.

The quality north-star (ref: overlap_tests, bbhMahoGANy.py:811-873):
β = Σ(p_a·p_b) / sqrt(Σp_a²·Σp_b²) of the two Gaussian-KDE densities
evaluated on a common 100×100 grid spanning the pooled samples.

The KDE is implemented directly (Scott's-rule bandwidth, the
scipy.stats.gaussian_kde default the reference used) in vectorized numpy.
A copy of ``gennet_tpu.eval.overlap``, so both packages score alike.
"""

import numpy as np


def _scott_cov(samples: np.ndarray):
    """Scott's-rule KDE covariance: cov(data) · n^(−2/(d+4)), with a floor
    on the diagonal so degenerate sample clouds (e.g. a collapsed generator
    early in training — the reference guards this with its var≠0 check,
    bbhMahoGANy.py:1354-1355) stay invertible."""
    d, n = samples.shape
    factor = n ** (-1.0 / (d + 4))
    cov = np.atleast_2d(np.cov(samples)) * factor**2
    scale = max(np.trace(cov) / d, 1e-300)
    cov = cov + np.eye(d) * max(1e-12 * scale, 1e-24)
    return cov


def gaussian_kde_pdf(samples: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Evaluate a Scott's-rule Gaussian KDE of ``samples`` (d, n) at
    ``points`` (d, m). Matches scipy.stats.gaussian_kde defaults."""
    samples = np.asarray(samples, np.float64)
    points = np.asarray(points, np.float64)
    d, n = samples.shape
    cov = _scott_cov(samples)
    prec = np.linalg.inv(cov)
    norm = 1.0 / (n * np.sqrt((2 * np.pi) ** d * np.linalg.det(cov)))
    # (m, n, d) differences → quadratic form, batched over eval points
    diff = points.T[:, None, :] - samples.T[None, :, :]
    maha = np.einsum("mnd,de,mne->mn", diff, prec, diff)
    return norm * np.exp(-0.5 * maha).sum(axis=1)


def beta_overlap(samples_a: np.ndarray, samples_b: np.ndarray, grain: int = 100) -> float:
    """β overlap of two 2-D sample clouds (ref: :853-870).

    samples_*: (n, 2) arrays of (mc, q) draws. Grid spans the pooled
    per-parameter ranges with ``grain`` points per axis, exactly as the
    reference's np.mgrid construction.
    """
    a = np.asarray(samples_a, np.float64)
    b = np.asarray(samples_b, np.float64)
    comb = np.concatenate([a, b], axis=0)
    gx = np.linspace(comb[:, 0].min(), comb[:, 0].max(), grain)
    gy = np.linspace(comb[:, 1].min(), comb[:, 1].max(), grain)
    X, Y = np.meshgrid(gx, gy, indexing="ij")
    pts = np.vstack([X.ravel(), Y.ravel()])
    pa = gaussian_kde_pdf(a.T, pts)
    pb = gaussian_kde_pdf(b.T, pts)
    return float(np.sum(pa * pb) / np.sqrt(np.sum(pa**2) * np.sum(pb**2)))
