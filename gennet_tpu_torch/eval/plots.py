"""The training dashboards (port of ``gennet_tpu.eval.plots``): loss and
accuracy curves on a logit-rescaled accuracy axis (ref: plot_losses,
bbhMahoGANy.py:541-590), the true-vs-estimated PE scatter (ref: :592-621),
the posterior corner plot with 68/90/99% KDE contours (ref: :623-795), the
waveform percentile bands and residuals (ref: :875-957) and the β history
(ref: :1356-1359). File names and dpi are the JAX package's, and a
``latest/`` subdirectory keeps the most recent copies (ref: :620,720,944).

Everything here is numpy and matplotlib on the host. matplotlib is imported
at first use, on the Agg backend, never when the package is imported:
:func:`require_matplotlib` lets a workload refuse ``plots=True`` before any
work where it is missing.
"""

import os

import numpy as np

from gennet_tpu_torch.eval.overlap import beta_overlap, gaussian_kde_pdf

_DPI = 200


def require_matplotlib():
    """Raise ImportError, naming matplotlib, when it cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("plots=True needs matplotlib, which cannot be imported here "
                          f"({e}); install it or pass --plots false") from e


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _logit(p):
    p = np.clip(p, 1e-6, 1 - 1e-6)
    return np.log(p / (1 - p))


def _save(fig, out_path, fname, latest_name=None):
    os.makedirs(out_path, exist_ok=True)
    fig.savefig(os.path.join(out_path, fname), dpi=_DPI)
    if latest_name:
        latest = os.path.join(out_path, "latest")
        os.makedirs(latest, exist_ok=True)
        fig.savefig(os.path.join(latest, latest_name), dpi=_DPI)
    _pyplot().close(fig)


def plot_losses(history: dict, out_path: str, fname: str = "losses.png", logscale: bool = False):
    """Loss curves (top) and logit-rescaled accuracy curves (bottom) of a
    dict of 1-D arrays: keys ending in ``_loss`` go on top, ``_acc`` below."""
    fig, (ax1, ax2) = _pyplot().subplots(2, 1, figsize=(7, 6))
    for k, v in history.items():
        if k.endswith("_loss") and len(v):
            ax1.plot(v, label=k, linewidth=0.7)
    ax1.set_xlabel("iteration")
    ax1.set_ylabel("loss")
    ax1.legend(loc="upper left", fontsize=7)
    if logscale:
        ax1.set_xscale("log")
        ax1.set_yscale("log")

    ticks = [0.001, 0.01, 0.1, 0.5, 0.9, 0.99, 0.999]
    for k, v in history.items():
        if k.endswith("_acc") and len(v):
            ax2.plot(_logit(np.asarray(v)), label=k, linewidth=0.7)
    ax2.set_yticks(_logit(np.asarray(ticks)))
    ax2.set_yticklabels([str(t) for t in ticks])
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("accuracy")
    ax2.legend(loc="lower right", fontsize=7)
    _save(fig, out_path, fname)


def plot_pe_accuracy(true_pars, est_pars, out_path, fname="pe_accuracy.png"):
    """True-vs-estimated scatter, one panel per parameter."""
    true_pars = np.asarray(true_pars)
    est_pars = np.asarray(est_pars)
    fig, axes = _pyplot().subplots(1, true_pars.shape[1], figsize=(5 * true_pars.shape[1], 5))
    for p, ax in enumerate(np.atleast_1d(axes)):
        ax.plot(true_pars[:, p], est_pars[:, p], ".b", markersize=0.5)
        m = float(np.max(true_pars[:, p]))
        ax.plot([0, m], [0, m], "--k")
        ax.set_xlabel(f"True parameter {p + 1}")
        ax.set_ylabel(f"Estimated parameter {p + 1}")
        ax.set_aspect("equal", adjustable="box")
    _save(fig, out_path, fname, "pe_accuracy.png")


def _kde_contours(ax, samples, color):
    """68/90/99% credible contours of a 2-D cloud: its KDE on a 100×100
    grid, thresholded at the sorted-mass levels (ref: make_contour_plot,
    :752-792, with the bisection replaced by direct thresholds)."""
    x, y = samples[:, 0], samples[:, 1]
    gx = np.linspace(x.min(), x.max(), 100)
    gy = np.linspace(y.min(), y.max(), 100)
    X, Y = np.meshgrid(gx, gy, indexing="ij")
    Z = gaussian_kde_pdf(samples.T, np.vstack([X.ravel(), Y.ravel()])).reshape(100, 100)
    flat = np.sort((Z / Z.sum()).ravel())[::-1]
    csum = np.cumsum(flat)
    levels = sorted({float(flat[min(int(np.searchsorted(csum, lv)), flat.size - 1)] * Z.sum())
                     for lv in (0.99, 0.9, 0.68)})
    if len(levels) >= 2:
        ax.contour(X, Y, Z, levels=levels, colors=color, alpha=0.5)


def plot_pe_samples(pe_samples, truth, out_path, index=0, ref_samples=None, pe_std=None,
                    grid=None, fname=None):
    """Posterior corner plot: scatter, KDE contours, marginal histograms and
    truth crosshairs, over an optional grid posterior ``(L, gx, gy)`` (the
    burst workload). Returns the β overlap against ``ref_samples`` when both
    clouds are given, else None (ref: :623-724; it feeds the β history)."""
    fig = _pyplot().figure(figsize=(7, 7))
    ax1 = fig.add_subplot(223)
    beta = None

    pe_samples = None if pe_samples is None else np.asarray(pe_samples)
    if grid is not None:
        L, gx, gy = grid
        ax1.contourf(gx, gy, np.asarray(L), levels=10, cmap="Greys", alpha=0.6)
    if pe_samples is not None:
        ax1.plot(pe_samples[:, 0], pe_samples[:, 1], ".r", markersize=0.8)
        if len(pe_samples) > 50:
            _kde_contours(ax1, pe_samples, "red")
    if ref_samples is not None:
        ref_samples = np.asarray(ref_samples)
        ax1.plot(ref_samples[:, 0], ref_samples[:, 1], ".b", markersize=0.8)
        if len(ref_samples) > 50:
            _kde_contours(ax1, ref_samples, "blue")
        if pe_samples is not None:
            beta = beta_overlap(pe_samples, ref_samples)
            ax1.legend([f"Overlap: {beta:.3f}"], fontsize=8)

    if truth is not None:
        ax1.axvline(truth[0], color="k", alpha=0.5)
        ax1.axhline(truth[1], color="k", alpha=0.5)
        if pe_std is not None:
            ax1.plot([truth[0] - pe_std[0], truth[0] + pe_std[0]], [truth[1]] * 2, "-c")
            ax1.plot([truth[0]] * 2, [truth[1] - pe_std[1], truth[1] + pe_std[1]], "-c")

    ax2 = fig.add_subplot(221)
    ax3 = fig.add_subplot(224)
    for cloud in (pe_samples, ref_samples):
        if cloud is not None:
            ax2.hist(cloud[:, 0], bins=100, alpha=0.5, density=True)
            ax3.hist(cloud[:, 1], bins=100, orientation="horizontal", alpha=0.5, density=True)
    ax2.set_xticks([])
    ax3.set_yticks([])
    ax1.set_xlabel("mc")
    ax1.set_ylabel("mass ratio")
    _save(fig, out_path, fname or f"pe_samples{index:05d}.png", "pe_samples.png")
    return beta


def plot_waveform_est(signal, measured, generated, out_path, index=0, zoom=None, n_viewed=25,
                      fname=None):
    """Waveform dashboard: measured and true series, the 5/25/75/90
    percentile bands of the generated draws, and the residuals of the first
    ``n_viewed`` draws; ``zoom`` = (start, stop) restricts the time axis."""
    signal = np.asarray(signal).ravel()
    measured = np.asarray(measured).ravel()
    generated = np.asarray(generated)
    gen = generated[:n_viewed].reshape(min(n_viewed, len(generated)), -1)

    fig, (ax1, ax2, ax3) = _pyplot().subplots(3, 1, sharey=True, figsize=(8, 7))
    ax1.plot(signal, color="cyan", alpha=0.5, linewidth=0.5)
    ax1.plot(measured, color="green", alpha=0.35, linewidth=0.5)

    perc = np.percentile(generated, [5, 25, 75, 90], axis=0)
    x = np.arange(perc.shape[1])
    ax2.plot(signal, color="cyan", linewidth=0.5, alpha=0.5)
    ax2.fill_between(x, perc[3], perc[0], lw=0, facecolor="#d5d8dc")
    ax2.fill_between(x, perc[2], perc[1], lw=0, facecolor="#808b96")
    ax2.set_ylabel("Amplitude (counts)")

    residuals = measured[None, :] - gen
    ax3.plot(residuals[0], color="black", linewidth=0.5)
    ax3.plot(residuals.T, color="red", alpha=0.25, linewidth=0.5)
    ax3.set_xlabel("Time")

    if zoom is not None:
        for ax in (ax1, ax2, ax3):
            ax.set_xlim(zoom)
    tag = "waveform_zoomed" if zoom is not None else "waveform"
    _save(fig, out_path, fname or f"{tag}_results{index:05d}.png", f"most_recent_{tag}.png")


def plot_beta_history(beta_hist, steps, out_path, fname="beta_hist.png"):
    """β overlap against the training step."""
    fig, ax = _pyplot().subplots()
    ax.plot(steps, beta_hist)
    ax.set_xlabel("iteration")
    ax.set_ylabel("β overlap")
    _save(fig, out_path, fname, fname)


def plot_image_recovery(signal, measured, mean_gen, n_pix: int, out_path: str,
                        fname: str = "image_gan_recovery.png"):
    """The image GAN's recovery panel: the clean image, the measured
    (noisy) one and the mean generated one, greyscale, side by side
    (``run_image_gan``'s figure, at its dpi of 150)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    for ax, (arr, title) in zip(axes, [(signal, "signal"), (measured, "measured"),
                                       (mean_gen, "mean generated")]):
        ax.imshow(np.asarray(arr).reshape(n_pix, n_pix), cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    os.makedirs(out_path, exist_ok=True)
    fig.savefig(os.path.join(out_path, fname), dpi=150)
    plt.close(fig)
