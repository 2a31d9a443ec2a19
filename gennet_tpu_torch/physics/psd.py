"""Analytic noise PSDs on the rfft grid.

Same curves as ``gennet_tpu.physics.psd`` (range-calibrated AdV P1200087
scenarios and the aLIGO zero-detuning high-power fit), evaluated host-side
in float64 numpy, in the framework's scaled strain units (× STRAIN_SCALE²,
see :mod:`.constants`). :func:`aligo_zdhp_psd` and :func:`advirgo_psd`
return the curve in the dtype and on the device of the frequencies they
are given; :func:`analytic_advligo_psd` builds the scenario PSD from them
as a float32 tensor.
"""

from functools import lru_cache

import numpy as np
import torch

from gennet_tpu_torch.physics.constants import STRAIN_SCALE

# scenario → (published BNS range [Mpc], low-frequency wall [Hz])
_SCENARIOS = {
    "AdvDesign": (125.0, 18.0),
    "AdvEarlyLow": (20.0, 40.0),
    "AdvEarlyHigh": (65.0, 40.0),
    "AdvMidLow": (65.0, 30.0),
    "AdvMidHigh": (85.0, 30.0),
    "AdvLateLow": (65.0, 25.0),
    "AdvLateHigh": (115.0, 25.0),
}

_G_SI = 6.67430e-11
_C_SI = 299792458.0
_MSUN_SI = 1.98892e30
_MPC_SI = 3.085677581491367e22


def bns_range_mpc(f: np.ndarray, psd_true: np.ndarray, rho0: float = 8.0,
                  f_min: float = 10.0, f_max: float = 1570.0) -> float:
    """Sky-averaged BNS (1.4+1.4 M☉) inspiral range of a PSD in true strain
    units (horizon distance at SNR ``rho0`` over 2.2643)."""
    f = np.asarray(f, np.float64)
    S = np.asarray(psd_true, np.float64)
    m = 1.4 * _MSUN_SI
    mc = (m * m) ** 0.6 / (2 * m) ** 0.2
    mask = (f >= f_min) & (f <= f_max) & np.isfinite(S) & (S > 0)
    I = np.trapezoid(f[mask] ** (-7.0 / 3.0) / S[mask], f[mask])
    d_h = np.sqrt(5.0 / 6.0 * np.pi ** (-4.0 / 3.0)
                  * (_G_SI * mc / _C_SI**3) ** (5.0 / 3.0) * I) * _C_SI / rho0
    return float(d_h / _MPC_SI / 2.2643)


def _host(f) -> np.ndarray:
    return (f.detach().cpu().numpy() if torch.is_tensor(f) else np.asarray(f)).astype(np.float64)


def _like(x: np.ndarray, f) -> torch.Tensor:
    """``x`` in ``f``'s dtype and device (float32 on the CPU for an array)."""
    if torch.is_tensor(f):
        return torch.as_tensor(x, dtype=f.dtype if f.is_floating_point() else torch.float32,
                               device=f.device)
    return torch.as_tensor(x, dtype=torch.float32)


def aligo_zdhp_psd(f) -> torch.Tensor:
    """aLIGO zero-detuning high-power analytic PSD fit [arXiv:0903.0338] at
    the frequencies ``f`` [Hz], in scaled strain units; bins where the fit
    is not positive and finite (DC) are 0."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        x = _host(f) / 215.0
        x = np.where(x > 0, x, np.inf)
        psd = (1e-49 * STRAIN_SCALE**2) * (
            x ** (-4.14) - 5.0 * x ** (-2) + 111.0 * (1.0 - x**2 + 0.5 * x**4) / (1.0 + 0.5 * x**2))
        return _like(np.where(np.isfinite(psd) & (psd > 0), psd, 0.0), f)


def advirgo_psd(f) -> torch.Tensor:
    """Advanced Virgo design analytic PSD (the Manzotti-Dietz ASD fit,
    squared) at the frequencies ``f`` [Hz], in scaled strain units; 0 at
    DC."""
    fh = _host(f)
    return _like(np.where(fh > 0, (1.259e-24 * STRAIN_SCALE * _adv_asd_shape(fh)) ** 2, 0.0), f)


def regularize_psd(psd: torch.Tensor, fs: float, T_obs: float, f_low: float = 10.0) -> torch.Tensor:
    """Zero the sub-``f_low``, non-finite and non-positive bins of an
    arbitrary PSD on the rfft grid (a measured one, say), so whitening is
    well defined downstream."""
    f = torch.as_tensor(rfft_freqs(fs, T_obs), device=psd.device)
    good = torch.isfinite(psd) & (psd > 0) & (f >= f_low)
    return torch.where(good, psd, torch.zeros_like(psd))


def _adv_asd_shape(f: np.ndarray) -> np.ndarray:
    """Manzotti-Dietz AdV ASD shape (without its 1.259e-24 amplitude)."""
    x = np.log(np.where(f > 0, f, 1.0) / 300.0)
    return (0.07 * np.exp(-0.142 - 1.437 * x + 0.407 * x**2)
            + 3.10 * np.exp(-0.466 - 1.043 * x - 0.548 * x**2)
            + 0.40 * np.exp(-0.304 + 2.896 * x - 0.293 * x**2)
            + 0.09 * np.exp(1.466 + 3.722 * x - 0.984 * x**2))


@lru_cache(maxsize=32)
def _scenario_calibration(op: str) -> tuple:
    """(amplitude², f_wall) such that the walled, scaled AdV curve's BNS
    range equals the published scenario range."""
    target, f_wall = _SCENARIOS[op]
    f = np.linspace(1.0, 4096.0, 65536)
    S = (1.259e-24 * _adv_asd_shape(f)) ** 2 * (1.0 + (f_wall / f) ** 8)
    amp = bns_range_mpc(f, S) / target  # range scales as 1/amplitude
    return float(amp**2), float(f_wall)


def rfft_freqs(fs: float, T_obs: float) -> np.ndarray:
    """Frequency grid of the rfft layout: N//2+1 bins at df = 1/T_obs."""
    N = int(T_obs * fs)
    return np.arange(N // 2 + 1) / T_obs


def analytic_advligo_psd(fs: float, T_obs: float, op: str = "AdvDesign", det: str = "H1",
                         f_low: float = 10.0, device=None) -> torch.Tensor:
    """PSD on the rfft grid for a named scenario/detector, zeroed below
    ``f_low`` (the reference's ``gen_psd`` surface,
    ref: gw_template_maker.py:195-241)."""
    if det not in ("H1", "L1", "V1"):
        raise ValueError(f"unknown detector {det!r}")
    f = rfft_freqs(fs, T_obs)
    f64 = torch.as_tensor(f, dtype=torch.float64)  # the curves in float64, as before
    if op == "aLIGOZDHP":
        psd = aligo_zdhp_psd(f64).numpy()
    elif op in _SCENARIOS:
        amp2, f_wall = _scenario_calibration(op)
        with np.errstate(divide="ignore"):
            wall = 1.0 + (f_wall / np.where(f > 0, f, np.inf)) ** 8
        psd = advirgo_psd(f64).numpy() * (amp2 * wall)
    else:
        raise ValueError(f"unknown noise option {op!r}")
    psd = np.where(f >= f_low, psd, 0.0)
    return torch.as_tensor(psd, dtype=torch.float32, device=device)
