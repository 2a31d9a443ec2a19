"""Synthetic lalinference product directories (port of
``gennet_tpu.data.synth_products``).

The reference's flagship reads a lalinference engine output directory:
``*-freqData.dat`` / ``*-freqDataWithInjection.dat`` / ``*-PSD.dat`` ASCII
and a nested-sampling posterior HDF5 (ref: gw_template_maker.py:752-795,
get_lalinf_pars.py:39-91). This module writes such a directory in the same
layout: a PhenomD injection at the GW150914 template masses, Gaussian noise
coloured by the analytic detector PSD, physical strain units, and
(optionally) a posterior HDF5 drawn from the event's exact (mc, q)
likelihood grid. ``run_bbh --lalinf-dir <dir>`` then runs the real-data
branch with a known truth; without the posterior file it scores against
the exact grid instead.

The files are the exact inverse of
:func:`gennet_tpu_torch.data.lalinf_io.load_event_products`:

- the loader whitens by h̃·√(2/(psd·fs)), then irfft (ref: :243-286,774-777);
- the bank's whitened templates are irfft(A·gain·K·fs·e^{−iΨ})
  (``template_bank.whitened_ampphase``; ×fs = continuous FT → rDFT);
- so the injection file holds h̃(f) = (fs/STRAIN_SCALE)·K·A·e^{−iΨ'} in
  physical units, and the noise file ñ(f) = rfft(n_white)/(gain·SCALE)
  for unit-variance whitened noise n_white.

The writer is numpy float64 on the host, with PhenomD, the PSD and the
whitening gain in float32 from the port's physics, as the JAX writer takes
them from its float32 physics. Only the posterior's likelihood grid runs on
``device`` (the template bank's synthesis, so the phasor kernel on a card),
and only the posterior file needs h5py, imported when it is written.
"""

import os

import numpy as np
import torch

from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.physics import priors, waveform, whiten
from gennet_tpu_torch.physics import psd as psd_mod
from gennet_tpu_torch.physics.constants import STRAIN_SCALE


def _psd_and_gain(cfg: tb.BankConfig):
    """(PSD, whitening gain) on the safe window's rfft grid, float32 values
    as float64 arrays."""
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe)
    gain = whiten.whitening_gain(psd, cfg.fs)
    return psd.numpy().astype(np.float64), gain.numpy().astype(np.float64)


def event_fd_physical(cfg: tb.BankConfig = tb.BankConfig(), peak_frac: float = 0.5) -> np.ndarray:
    """The GW150914-like template as a one-sided physical-units FD series
    h̃(f) over the safe window (ref: gw_template_maker.py:462-630), its
    whitened envelope peak at ``peak_frac`` of the safe window."""
    N = cfg.n_safe
    freqs = cfg.freqs()
    amp, phase = waveform.imrphenomd_ampphase(
        torch.as_tensor(freqs, dtype=torch.float32), cfg.tmpl_m1, cfg.tmpl_m2,
        dist_mpc=cfg.dist_mpc, f_low=cfg.f_low, f_high=cfg.fs / 2)
    amp, phase = amp.double().numpy(), phase.double().numpy()

    K, delta, tdelay, _, _ = tb._antenna_projection(cfg)
    phase = phase + (delta + 2.0 * cfg.phi) + 2.0 * np.pi * freqs * tdelay
    h = K * amp * np.exp(-1j * phase)

    # peak alignment as the bank does it (envelope argmax → FD phase ramp,
    # ref: :521-528,554-556), on the whitened series, where the reference
    # locates the peak
    _, gain = _psd_and_gain(cfg)
    ht = np.fft.irfft(h * gain * cfg.fs, N)
    qt = np.fft.irfft(1j * h * gain * cfg.fs, N)  # quadrature (+π/2 phase)
    peak = int(np.argmax(ht * ht + qt * qt))
    shift = (int(peak_frac * N) - peak) / cfg.fs
    return h * np.exp(-2j * np.pi * freqs * shift)


def write_synthetic_products(directory: str, seed: int = 0,
                             cfg: tb.BankConfig = tb.BankConfig(), n_posterior: int = 4000,
                             grid_grain: int = 64, event_time: str = "1126259462",
                             noise_sigma: float = 1.0, mc_range=(20.0, 35.0),
                             q_range=(0.5, 1.0), posterior: bool = True, device="cuda"):
    """Write a synthetic lalinference product directory.

    ``posterior=False`` writes the three ASCII files only: no likelihood
    grid, no ``posterior_samples.hdf5``, no h5py (``device`` is then
    unused). Returns the ground truth: the whitened signal and measured
    central second (normalised), the norm constant, the (mc, q) truth
    point, and the posterior samples written (None without the file).
    """
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    N = cfg.n_safe
    freqs = cfg.freqs()
    psd_scaled, gain = _psd_and_gain(cfg)

    # signal: the physical-units FD injection (see the module docstring)
    h_file = event_fd_physical(cfg) * cfg.fs / STRAIN_SCALE
    # noise: unit-variance whitened noise, un-whitened into the file; bins
    # the whitener zeroes (DC, undefined PSD) carry nothing and are written
    # as zeros (the reference's own files have NaN/0 low bins, scrubbed by
    # the loader, ref: :762-763)
    n_fd_white = np.fft.rfft(noise_sigma * rng.normal(size=N))
    ok = gain > 0
    n_file = np.where(ok, n_fd_white / np.where(ok, gain, 1.0), 0.0) / STRAIN_SCALE

    base = f"lalinferencenest-0-{cfg.det}-{event_time}.0-0.hdf5{cfg.det}"

    def write_fd(name, z):
        np.savetxt(os.path.join(directory, name), np.stack([freqs, z.real, z.imag], -1))

    write_fd(f"{base}-freqData.dat", n_file)
    write_fd(f"{base}-freqDataWithInjection.dat", n_file + h_file)
    np.savetxt(os.path.join(directory, f"{base}-PSD.dat"),
               np.stack([freqs, psd_scaled / STRAIN_SCALE**2], -1))

    wht_meas = np.fft.irfft((n_file + h_file) * STRAIN_SCALE * gain, N)
    wht_sig = np.fft.irfft(h_file * STRAIN_SCALE * gain, N)
    norm = 1.0 / np.std(wht_meas)
    c0 = N // 2 - cfg.fs // 2
    measured_1s = (wht_meas * norm)[c0:c0 + cfg.fs].astype(np.float32)

    samples = None
    if posterior:
        # the grid likelihood divides the normalised residual by its noise
        # std, so the whitened noise std is scaled by the norm constant (the
        # event-norm convention of run_bbh's effective_n_sig)
        dev = torch.device(device)
        L, mc_grid, q_grid = gp.bbh_grid_posterior(
            torch.as_tensor(measured_1s, device=dev),
            torch.as_tensor(psd_scaled, dtype=torch.float32, device=dev), cfg,
            norm_constant=float(norm), noise_sigma=noise_sigma * float(norm), grain=grid_grain,
            mc_range=mc_range, q_range=q_range)
        samples = gp.sample_grid_posterior(L, mc_grid, q_grid, n_posterior, seed=seed)

        import h5py

        m1, m2 = priors.mc_q_to_m1m2(samples[:, 0], samples[:, 1])
        with h5py.File(os.path.join(directory, "posterior_samples.hdf5"), "w") as hf:
            g = hf.create_group("lalinference/lalinference_nest")
            g.create_dataset("mc", data=samples[:, 0])
            g.create_dataset("q", data=samples[:, 1])
            g.create_dataset("m1", data=np.asarray(m1))
            g.create_dataset("m2", data=np.asarray(m2))

    mc_t, _ = priors.chirp_mass_eta(cfg.tmpl_m1, cfg.tmpl_m2)
    return {
        "signal_whitened": (wht_sig * norm)[c0:c0 + cfg.fs].astype(np.float32),
        "measured_whitened": measured_1s,
        "norm_constant": float(norm),
        "truth": (float(mc_t), cfg.tmpl_m2 / cfg.tmpl_m1),
        "posterior_mc_q": samples,
    }
