"""Detector antenna response and Earth-centre time delays (host float64 numpy).

A numpy copy of ``gennet_tpu.physics.detector``'s host geometry: GPS epochs
(~1e9 s) lose ~64 s of precision in float32, so this is always evaluated on
the host in float64 and folded into the device pipeline as scalars. The
frequency-domain time shifts at the end work on tensors.
"""

import numpy as np
import torch

from gennet_tpu_torch.physics import constants

# cumulative GPS−UTC leap seconds, keyed by the GPS second they take effect
_LEAP_TABLE = np.array(
    [
        (0, 0),
        (46828800, 1),      # 1981-07-01
        (78364801, 2),      # 1982-07-01
        (109900802, 3),     # 1983-07-01
        (173059203, 4),     # 1985-07-01
        (252028804, 5),     # 1988-01-01
        (315187205, 6),     # 1990-01-01
        (346723206, 7),     # 1991-01-01
        (393984007, 8),     # 1992-07-01
        (425520008, 9),     # 1993-07-01
        (457056009, 10),    # 1994-07-01
        (504489610, 11),    # 1996-01-01
        (551750411, 12),    # 1997-07-01
        (599184012, 13),    # 1999-01-01
        (820108813, 14),    # 2006-01-01
        (914803214, 15),    # 2009-01-01
        (1025136015, 16),   # 2012-07-01
        (1119744016, 17),   # 2015-07-01
        (1167264017, 18),   # 2017-01-01
    ],
    dtype=np.float64,
)


def gps_to_gmst(gps) -> np.ndarray:
    """Greenwich mean sidereal time [rad] from a GPS time (UT1 ≈ UTC, USNO
    linear approximation)."""
    gps = np.asarray(gps, np.float64)
    idx = np.searchsorted(_LEAP_TABLE[:, 0], gps, side="right") - 1
    leap = _LEAP_TABLE[:, 1][idx]
    utc = gps - leap
    # days of UT1 since J2000.0 (JD 2451545.0); GPS epoch JD = 2444244.5
    d = (utc / 86400.0) + 2444244.5 - 2451545.0
    gmst_hours = 18.697374558 + 24.06570982441908 * d
    return np.mod(gmst_hours, 24.0) * (2.0 * np.pi / 24.0)


def _polarization_basis(ra, dec, psi, gmst):
    """LAL-convention polarization axis vectors X, Y in the Earth-fixed frame."""
    gha = gmst - ra
    cg, sg = np.cos(gha), np.sin(gha)
    cd, sd = np.cos(dec), np.sin(dec)
    cp, sp = np.cos(psi), np.sin(psi)
    X = np.stack(
        [-cp * sg - sp * cg * sd, -cp * cg + sp * sg * sd, sp * cd * np.ones_like(gha)], axis=-1
    )
    Y = np.stack(
        [sp * sg - cp * cg * sd, sp * cg + cp * sg * sd, cp * cd * np.ones_like(gha)], axis=-1
    )
    return X, Y


def antenna_response(gps_time, ra, dec, psi, det: str = "H1"):
    """(F+, F×) for a detector at a GPS time — LAL ComputeDetAMResponse
    (ref: gw_template_maker.py:612). Numpy broadcasting, float64."""
    d = constants.detector_tensor(det)
    gmst = gps_to_gmst(gps_time)
    X, Y = _polarization_basis(
        np.asarray(ra, np.float64), np.asarray(dec, np.float64),
        np.asarray(psi, np.float64), gmst,
    )
    dX = np.einsum("ij,...j->...i", d, X)
    dY = np.einsum("ij,...j->...i", d, Y)
    fplus = np.sum(X * dX, axis=-1) - np.sum(Y * dY, axis=-1)
    fcross = np.sum(X * dY, axis=-1) + np.sum(Y * dX, axis=-1)
    return fplus, fcross


def time_delay_from_earth_center(gps_time, ra, dec, det: str = "H1"):
    """t_detector − t_geocenter [s] for a plane wave from (ra, dec)
    (ref: gw_template_maker.py:617)."""
    loc = np.asarray(constants.DETECTORS[det]["location"], np.float64)
    gmst = gps_to_gmst(gps_time)
    gha = gmst - np.asarray(ra, np.float64)
    dec = np.asarray(dec, np.float64)
    n = np.stack(
        [np.cos(dec) * np.cos(-gha), np.cos(dec) * np.sin(-gha), np.sin(dec) * np.ones_like(gha)],
        axis=-1,
    )
    return -np.sum(loc * n, axis=-1) / constants.C_SI


def fd_time_shift_phase(phase: torch.Tensor, dt_shift, T_obs: float) -> torch.Tensor:
    """The time shift of h̃ = amp·e^{−iΨ} in its phase: delaying by
    ``dt_shift`` seconds (batched over ``phase``'s leading axes) is
    Ψ → Ψ + 2πf·Δt on the rfft grid."""
    f = (torch.arange(phase.shape[-1], device=phase.device) / T_obs).to(phase.dtype)
    dt = torch.as_tensor(dt_shift, dtype=phase.dtype, device=phase.device)
    return phase + 2.0 * np.pi * f * dt[..., None]


def fd_time_shift(htilde: torch.Tensor, dt_shift, T_obs: float) -> torch.Tensor:
    """Delay a frequency-domain (rfft layout) series by ``dt_shift``
    seconds through the exact phase ramp exp(−2πi f Δt); ``dt_shift``
    broadcasts against ``htilde``'s leading axes."""
    f = torch.arange(htilde.shape[-1], device=htilde.device, dtype=torch.float64) / T_obs
    dt = torch.as_tensor(dt_shift, dtype=torch.float64, device=htilde.device)[..., None]
    return htilde * torch.exp(-2j * np.pi * f * dt).to(htilde.dtype)
