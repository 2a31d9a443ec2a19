"""Plain synthesis of whitened BBH template rows and of the event, as the
template bank defines them (ref: gw_template_maker.py:462-740):

    (m1, m2) → IMRPhenomD (amp, phase) on the safe FD grid → whitening gain
    → antenna projection and geocentre delay → pass A: quadrature iDFT
    around t = 0, envelope-peak search → pass B: FD phase ramp to the
    requested peak index, iDFT onto the central second with the centred
    Tukey window folded into the tables.

Both iDFT passes are plain float32 matrix products of the phasor with
column slices of the iDFT tables. ``bank`` is a configuration's ``bank``
section (see ``benchmark/configs/*.json``).
"""

import numpy as np
import torch

from .physics import detector, psd as psd_mod, waveform, whiten, windows

PEAK_SEARCH = 64  # envelope-peak search half-width around t = 0, samples


def n_safe(bank: dict) -> int:
    return bank["fs"] * bank["T_obs"] * bank["safe"]


def beta_index_bounds(bank: dict) -> tuple:
    """[lo, hi) of the peak index in the safe window (ref: :133-159)."""
    T_safe = bank["T_obs"] * bank["safe"]
    lo = (bank["beta"][0] + 0.5 * bank["safe"] - 0.5) / bank["safe"]
    hi = (bank["beta"][1] + 0.5 * bank["safe"] - 0.5) / bank["safe"]
    return int(T_safe * bank["fs"] * lo), int(T_safe * bank["fs"] * hi)


def mc_q_to_m1m2(mc, q):
    """(chirp mass, q = m2/m1 ≤ 1) → (m1, m2)."""
    eta = q / (1.0 + q) ** 2
    M = mc * eta ** (-3.0 / 5.0)
    return M / (1.0 + q), q * M / (1.0 + q)


def psd(bank: dict, device) -> torch.Tensor:
    return psd_mod.analytic_advligo_psd(bank["fs"], bank["T_obs"] * bank["safe"], device=device)


def _tables(N: int, start: int, width: int, weights=None, device=None):
    Nf = N // 2 + 1
    k = np.arange(Nf)[:, None]
    n = (np.arange(start, start + width) % N)[None, :]
    ang = 2.0 * np.pi * k * n / N
    w = np.full((Nf, 1), 2.0)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    c = (w * np.cos(ang) / N).astype(np.float32)
    s = (w * np.sin(ang) / N).astype(np.float32)
    if weights is not None:
        c *= np.asarray(weights, np.float32)
        s *= np.asarray(weights, np.float32)
    return torch.as_tensor(c, device=device), torch.as_tensor(s, device=device)


def _idft(amp, phase, N, start, width, weights=None):
    cos_t, sin_t = _tables(N, start, width, weights, amp.device)
    return (amp * torch.cos(phase)) @ cos_t + (amp * torch.sin(phase)) @ sin_t


def templates(bank: dict, m1, m2, idx, psd_t: torch.Tensor, norm: float = 1.0) -> torch.Tensor:
    """(B,) masses and peak indices → (B, fs) whitened, peak-placed,
    windowed central seconds, times ``norm``."""
    device, fs = psd_t.device, bank["fs"]
    N = n_safe(bank)
    freqs = torch.as_tensor(np.arange(N // 2 + 1) / (bank["T_obs"] * bank["safe"]),
                            dtype=torch.float32, device=device)
    m1 = torch.as_tensor(m1, dtype=torch.float32, device=device).reshape(-1)
    m2 = torch.as_tensor(m2, dtype=torch.float32, device=device).reshape(-1)
    amp, phase = waveform.imrphenomd_ampphase(freqs, m1, m2, dist_mpc=bank["dist_mpc"],
                                              f_low=bank["f_low"], f_high=fs / 2)
    fp, fc = detector.antenna_response(bank["event_time"], bank["ra"], bank["dec"],
                                       bank["psi"], bank["det"])
    tdelay = float(detector.time_delay_from_earth_center(bank["event_time"], bank["ra"],
                                                         bank["dec"], bank["det"]))
    cosi = np.cos(bank["iota"])
    a_p, a_c = 0.5 * (1 + cosi**2) * float(fp), cosi * float(fc)
    K, delta = float(np.hypot(a_p, a_c)), float(np.arctan2(a_c, a_p))
    amp = amp * (whiten.whitening_gain(psd_t, fs) * K * fs)
    phase = phase + (delta + 2.0 * bank["phi"])
    phase = phase + 2.0 * np.pi * freqs * torch.full((), tdelay, dtype=torch.float32,
                                                     device=device)
    # pass A: the envelope peak near t = 0
    start = N - PEAK_SEARCH
    h_a = _idft(amp, phase, N, start, 2 * PEAK_SEARCH)
    q_a = _idft(amp, phase + 0.5 * np.pi, N, start, 2 * PEAK_SEARCH)
    peak = torch.argmax(h_a * h_a + q_a * q_a, dim=-1).to(torch.int32) - PEAK_SEARCH
    # pass B: a phase ramp to the requested index, the central second
    idx = torch.as_tensor(idx, device=device).reshape(-1).to(torch.int32)
    dt_shift = (idx + bank["calibration_offset"] - peak).to(torch.float32) / fs
    phase = phase + 2.0 * np.pi * freqs * dt_shift[:, None]
    c0 = N // 2 - fs // 2
    win = windows.centered_tukey_window_np(N, safe=bank["safe"])[c0:c0 + fs]
    return _idft(amp, phase, N, c0, fs, weights=win) * norm


def event(bank: dict, noise: torch.Tensor, psd_t: torch.Tensor):
    """The event: its template (peak at the centre of the safe window) plus
    the benchmark's unit noise, normalised to unit std over the second.
    Returns (measured, norm)."""
    tmpl = templates(bank, [bank["tmpl_m1"]], [bank["tmpl_m2"]], [n_safe(bank) // 2], psd_t)[0]
    raw = tmpl + noise
    norm = 1.0 / torch.std(raw, correction=0)
    return raw * norm, float(norm)
