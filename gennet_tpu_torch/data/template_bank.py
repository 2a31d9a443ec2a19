"""Whitened BBH template-bank synthesis.

Port of ``gennet_tpu.data.template_bank`` (the reference's ``sim_data`` /
``gen_bbh`` / ``make_bbh``, ref: gw_template_maker.py:462-740):

    masses ~ prior → IMRPhenomD (amp, phase) on the safe FD grid
    → whitening gain (amp ·= g) → antenna projection and geocentre delay
    → pass A: quadrature iDFT around t = 0, envelope-peak search
    → pass B: FD phase ramp to the requested peak index, iDFT onto the
      central second with the centred Tukey window folded into the tables

Both iDFT passes go through :func:`gennet_tpu_torch.ops.phasor_dft.
phasor_irdft_slice`: the CUDA kernel for CUDA tensors, its plain version on
the CPU. The pipeline always works on the ``nf = N//2+1`` bins; the kernel
masks ragged edges itself, so nothing is padded.
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from gennet_tpu_torch.ops.phasor_dft import phasor_irdft_slice
from gennet_tpu_torch.physics import constants, detector, priors, waveform, whiten, windows


@dataclass(frozen=True)
class BankConfig:
    """Template-bank configuration (reference defaults throughout)."""

    fs: int = 1024                    # sampling rate [Hz] (ref: :123)
    T_obs: int = 2                    # output obs window before safe× [s] (ref: :124)
    safe: int = 2                     # safety multiplier (ref: :54)
    det: str = "H1"                   # detector (ref: :125)
    mdist: str = "hunt_constrain"     # mass prior (ref: :805-806)
    beta: tuple = (0.45, 0.55)        # peak placement fraction (ref: :806)
    f_low: float = constants.DEFAULT_F_LOW
    dist_mpc: float = constants.DEFAULT_DISTANCE_MPC
    ra: float = constants.GW150914_FIXED_EXTRINSIC["ra"]
    dec: float = constants.GW150914_FIXED_EXTRINSIC["dec"]
    iota: float = constants.GW150914_FIXED_EXTRINSIC["iota"]
    phi: float = constants.GW150914_FIXED_EXTRINSIC["phi"]
    psi: float = constants.GW150914_FIXED_EXTRINSIC["psi"]
    event_time: float = constants.GW150914_EVENT_TIME
    calibration_offset: int = 0       # the reference used −11 (quirk, ref: :554)
    tmpl_m1: float = constants.GW150914_TEMPLATE_MASSES[0]
    tmpl_m2: float = constants.GW150914_TEMPLATE_MASSES[1]

    @property
    def n_safe(self) -> int:
        return self.fs * self.T_obs * self.safe

    @property
    def n_out(self) -> int:
        return self.fs  # central 1 s crop (ref: :695)

    @property
    def nf(self) -> int:
        return self.n_safe // 2 + 1

    def freqs(self) -> np.ndarray:
        return np.arange(self.nf) / (self.T_obs * self.safe)

    def beta_index_bounds(self) -> tuple:
        """convert_beta (ref: gw_template_maker.py:133-159): β fractions of
        the central window → absolute sample indices in the safe window."""
        T_safe = self.T_obs * self.safe
        lo = (self.beta[0] + 0.5 * self.safe - 0.5) / self.safe
        hi = (self.beta[1] + 0.5 * self.safe - 0.5) / self.safe
        return int(T_safe * self.fs * lo), int(T_safe * self.fs * hi)


def _antenna_projection(cfg: BankConfig):
    """Per-config scalars (host float64): effective amplitude K and phase
    offset δ of h_det = F+·h+ + F×·h× for the fixed extrinsics, and the
    geocentre time delay; h̃_det = K·A e^{−i(Ψ + δ)}."""
    return _antenna_projection_cached(cfg.event_time, cfg.ra, cfg.dec,
                                      cfg.psi, cfg.det, cfg.iota)


@lru_cache(maxsize=16)
def _antenna_projection_cached(event_time, ra, dec, psi, det, iota):
    fp, fc = detector.antenna_response(event_time, ra, dec, psi, det)
    tdelay = float(detector.time_delay_from_earth_center(event_time, ra, dec, det))
    fp, fc = float(fp), float(fc)
    cosi = np.cos(iota)
    a_p = 0.5 * (1 + cosi**2) * fp
    a_c = cosi * fc
    K = float(np.hypot(a_p, a_c))
    delta = float(np.arctan2(a_c, a_p))
    return K, delta, tdelay, a_p, a_c


# envelope-peak search half-width around t = 0 (samples); the measured peak
# sits at −4…−3 for the whole mass prior
_PEAK_SEARCH = 64


_FREQS: dict = {}  # (nf, T_obs·safe, device) → the FD grid there, made once


def _device_freqs(cfg: BankConfig, device) -> torch.Tensor:
    """``cfg.freqs()`` in float32 on ``device``, copied there once, so that
    a synthesis makes no host-to-device copy (a CUDA graph records it)."""
    key = (cfg.nf, cfg.T_obs * cfg.safe, str(device))
    if key not in _FREQS:
        _FREQS[key] = torch.as_tensor(cfg.freqs(), dtype=torch.float32, device=device)
    return _FREQS[key]


def whitened_ampphase(m1, m2, psd, cfg: BankConfig):
    """Whitened, antenna-projected FD templates as (amp, phase), each (B, nf),
    plus the frequency grid (nf,), on psd's device."""
    dtype = torch.float32
    device = psd.device
    freqs = _device_freqs(cfg, device)
    m1 = torch.as_tensor(m1, dtype=dtype, device=device).reshape(-1)
    m2 = torch.as_tensor(m2, dtype=dtype, device=device).reshape(-1)
    amp, phase = waveform.imrphenomd_ampphase(freqs, m1, m2, dist_mpc=cfg.dist_mpc,
                                              f_low=cfg.f_low, f_high=cfg.fs / 2)
    # whitening is an amplitude gain, the antenna projection a scalar
    # amp/phase offset, the geocentre delay a phase ramp (ref: :612,616-617)
    K, delta, tdelay, _, _ = _antenna_projection(cfg)
    gain = whiten.whitening_gain(psd.to(dtype), cfg.fs)
    # ×fs converts the continuous-FT waveform to the discrete rDFT
    # convention, so whitened templates share unit-variance noise's units
    amp = amp * (gain * K * cfg.fs)
    phase = phase + (delta + 2.0 * cfg.phi)
    phase = phase + 2.0 * np.pi * freqs * torch.full((), tdelay, dtype=dtype, device=device)
    return amp, phase, freqs


def pass_a_slice(cfg: BankConfig) -> tuple:
    """(start, width) of pass A's iDFT: ±_PEAK_SEARCH samples around t = 0."""
    return cfg.n_safe - _PEAK_SEARCH, 2 * _PEAK_SEARCH


def pass_b_slice(cfg: BankConfig) -> tuple:
    """(start, width, weights) of pass B's iDFT: the central second with the
    centred Tukey window (ref: :536-538,571) folded into the tables."""
    N = cfg.n_safe
    c0 = N // 2 - cfg.n_out // 2
    win = windows.centered_tukey_window_np(N, safe=cfg.safe)
    return c0, cfg.n_out, tuple(float(x) for x in win[c0 : c0 + cfg.n_out])


def _synthesize(m1, m2, idx, psd, cfg: BankConfig):
    """(m1, m2, target idx) → whitened, peak-placed, windowed central second,
    shape (B, n_out), on psd's device."""
    amp, phase, freqs = whitened_ampphase(m1, m2, psd, cfg)
    N = cfg.n_safe

    # ---- pass A: localise the envelope peak near t = 0 (ref: :521-528) ----
    start, width = pass_a_slice(cfg)
    h_a = phasor_irdft_slice(amp, phase, N, start, width)
    q_a = phasor_irdft_slice(amp, phase + 0.5 * np.pi, N, start, width)
    peak = torch.argmax(h_a * h_a + q_a * q_a, dim=-1).to(torch.int32)
    peak = peak - _PEAK_SEARCH  # offset relative to t = 0, in (−S, S)

    # ---- pass B: exact circular shift as an FD phase ramp (ref: :554-556) --
    idx = torch.as_tensor(idx, device=psd.device).reshape(-1).to(torch.int32)
    shift = idx + cfg.calibration_offset - peak
    dt_shift = shift.to(freqs.dtype) / cfg.fs
    phase = phase + 2.0 * np.pi * freqs * dt_shift[:, None]
    start, width, weights = pass_b_slice(cfg)
    return phasor_irdft_slice(amp, phase, N, start, width, weights=weights)


def make_template_batch(gen: torch.Generator, n: int, psd: torch.Tensor,
                        cfg: BankConfig = BankConfig(), norm_constant: float = 1.0):
    """``n`` whitened, peak-placed, cropped templates from the prior.

    Returns ``(templates (n, fs), params)`` with params a dict of (n,)
    tensors m1, m2, mc, eta, M, q, idx (peak index in the safe window).
    """
    masses = priors.sample_masses(gen, n, mdist=cfg.mdist)
    lo, hi = cfg.beta_index_bounds()
    idx = torch.randint(lo, max(hi, lo + 1), (n,), generator=gen, device=gen.device)
    t_work = _synthesize(masses["m1"], masses["m2"], idx, psd, cfg) * norm_constant
    params = dict(masses)
    params.pop("valid")
    params["q"] = masses["m2"] / masses["m1"]
    params["idx"] = idx
    return t_work, params


def make_noisy_template_batch(gen: torch.Generator, n: int, psd: torch.Tensor,
                              cfg: BankConfig = BankConfig(), norm_constant: float = 1.0,
                              n_noise: int = 1, time_grid: int = 1):
    """The bank with per-template noise realisations and/or a grid of
    merger-time placements per mass draw (ref: sim_data's ``Nnoise`` and
    ``do_time_grid``, gw_template_maker.py:57,685-715). ``n_noise = 0`` is
    a clean bank; ``n_noise ≥ 1`` stacks that many copies, each plus
    N(0, 1) (whitened signal plus coloured noise is template + N(0, 1) in
    the whitened domain); ``time_grid`` random peak placements per draw.

    Returns (templates (n·time_grid·max(n_noise, 1), fs), params dict of
    m1, m2, mc, q, idx), on psd's device.
    """
    masses = priors.sample_masses(gen, n, mdist=cfg.mdist)
    m1 = torch.repeat_interleave(masses["m1"], time_grid)
    m2 = torch.repeat_interleave(masses["m2"], time_grid)
    lo, hi = cfg.beta_index_bounds()
    idx = torch.randint(lo, max(hi, lo + 1), (n * time_grid,), generator=gen, device=gen.device)
    clean = _synthesize(m1, m2, idx, psd, cfg) * norm_constant
    n_rep = max(n_noise, 1)
    out = clean.repeat(n_rep, 1)
    if n_noise >= 1:
        out = out + torch.randn(out.shape, generator=gen, device=gen.device,
                                dtype=out.dtype).to(out.device)
    params = {
        "m1": m1.repeat(n_rep), "m2": m2.repeat(n_rep),
        "mc": torch.repeat_interleave(masses["mc"], time_grid).repeat(n_rep),
        "q": torch.repeat_interleave(masses["m2"] / masses["m1"], time_grid).repeat(n_rep),
        "idx": idx.repeat(n_rep),
    }
    return out, params


def make_templates_from_params(m1, m2, psd: torch.Tensor, cfg: BankConfig = BankConfig(),
                               norm_constant: float = 1.0, idx=None):
    """Templates for GIVEN mass rows (ref: lalinf_post_waveform_maker.py:
    385-405,719-721): the CNN sanity set and the grid posterior. Peaks
    default to the centre of the safe window."""
    m1 = torch.as_tensor(m1, device=psd.device).reshape(-1)
    if idx is None:
        idx = torch.full(m1.shape, cfg.n_safe // 2, dtype=torch.int32, device=psd.device)
    return _synthesize(m1, m2, idx, psd, cfg) * norm_constant


def make_event_template(psd: torch.Tensor, cfg: BankConfig = BankConfig()):
    """The GW150914-like template: masses (36, 29), peak at the centre of
    the safe window (ref: gw_template_maker.py:446-458). Shape (fs,)."""
    return _synthesize([cfg.tmpl_m1], [cfg.tmpl_m2], [cfg.n_safe // 2], psd, cfg)[0]


def make_event(gen: torch.Generator, psd: torch.Tensor, cfg: BankConfig = BankConfig(),
               noise_sigma: float = 1.0):
    """Synthetic measured event: whitened event template plus unit whitened
    noise, and the bank normalisation 1/std(measured) over the central
    second (ref: gw_template_maker.py:779-784).

    Returns (h_signal, h_measured, norm_constant), the last a 0-d tensor.
    """
    tmpl = make_event_template(psd, cfg)
    noise = noise_sigma * torch.randn(tmpl.shape, generator=gen, device=gen.device,
                                      dtype=tmpl.dtype).to(tmpl.device)
    measured = tmpl + noise
    norm = 1.0 / torch.std(measured, correction=0)
    return tmpl * norm, measured * norm, norm


def make_bank(gen: torch.Generator, n_total: int, psd: torch.Tensor,
              cfg: BankConfig = BankConfig(), norm_constant: float = 1.0,
              batch: int = 4096, append_event_template: bool = True):
    """Build an ``n_total``-template bank in device batches; the event-twin
    template goes last (ref: gw_template_maker.py:729-739).

    Returns (templates (n_total, fs), params dict of (n_total,) tensors),
    on psd's device.
    """
    n_rand = n_total - int(append_event_template)
    chunks, parts = [], []
    done = 0
    while done < n_rand:
        m = min(batch, n_rand - done)
        t, p = make_template_batch(gen, m, psd, cfg, norm_constant)
        chunks.append(t)
        parts.append(p)
        done += m
    device = psd.device
    templates = (torch.cat(chunks) if chunks
                 else torch.zeros((0, cfg.n_out), dtype=torch.float32, device=device))
    keys = ("m1", "m2", "mc", "eta", "M", "q", "idx")
    params = {k: torch.cat([p[k] for p in parts]) for k in keys} if parts else {}

    if append_event_template:
        ev = make_event_template(psd, cfg)[None] * norm_constant
        templates = torch.cat([templates, ev])
        mc, eta = priors.chirp_mass_eta(cfg.tmpl_m1, cfg.tmpl_m2)
        extra = {
            "m1": cfg.tmpl_m1, "m2": cfg.tmpl_m2, "mc": float(mc), "eta": float(eta),
            "M": cfg.tmpl_m1 + cfg.tmpl_m2, "q": cfg.tmpl_m2 / cfg.tmpl_m1,
            "idx": cfg.n_safe // 2,
        }
        if not params:
            params = {k: torch.zeros((0,), device=device) for k in keys}
            params["idx"] = params["idx"].to(torch.int64)
        for k in keys:
            params[k] = torch.cat([params[k], torch.tensor([extra[k]], dtype=params[k].dtype,
                                                           device=device)])
    return templates, params


def make_bank_sharded(gen: torch.Generator, n_total: int, psd: torch.Tensor, mesh,
                      cfg: BankConfig = BankConfig(), norm_constant: float = 1.0):
    """Data-parallel bank synthesis (ref: template_bank.py:358-385): each
    rank synthesizes its ``n_total // world`` rows from its own generator
    in one :func:`make_template_batch` call, and the rows are gathered by
    rank. No event twin is appended, as in the reference's sharded bank.
    ``mesh=None`` is a world of 1. ``n_total`` must divide by the world.

    Returns (templates (n_total, fs), params dict of (n_total,) tensors) on
    every rank, on psd's device.
    """
    from gennet_tpu_torch.train.mesh import check_rows

    world = 1 if mesh is None else mesh.world
    check_rows(n_total, world, "the sharded bank")
    t, p = make_template_batch(gen, n_total // world, psd, cfg, norm_constant)
    if mesh is None:
        return t, p
    keys = ("m1", "m2", "mc", "eta", "M", "q", "idx")
    # one gather: the idx column (< n_safe) is exact in float32
    rows = mesh.gather_rows(torch.cat([t, torch.stack([p[k].to(t.dtype) for k in keys], -1)], -1))
    params = {k: rows[:, cfg.n_out + i].contiguous() for i, k in enumerate(keys)}
    params["idx"] = params["idx"].to(p["idx"].dtype)
    return rows[:, : cfg.n_out].contiguous(), params
