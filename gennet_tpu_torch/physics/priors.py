"""Component-mass priors with masked rejection sampling.

Each lane draws a fixed budget of candidates from a ``torch.Generator`` and
keeps its first accept (the reference's one-pair-at-a-time while-loop,
ref: gw_template_maker.py:289-370, made batch-parallel). Draws land on the
generator's device.
"""

import torch

M_MIN_DEFAULT = 5.0
M_MAX_DEFAULT = 100.0

# Candidates per lane. Acceptance: astro ≈ 0.45, hunt_constrain ≈ 0.08,
# gh ≈ 0.9, metric ≈ 0.5, so a lane misses with probability < 1e-18.
_BUDGET = 512


def chirp_mass_eta(m1, m2):
    """(mc, eta) from component masses."""
    M = m1 + m2
    eta = m1 * m2 / M**2
    mc = M * eta ** (3.0 / 5.0)
    return mc, eta


def mc_q_to_m1m2(mc, q):
    """Closed-form inversion of (mc, q=m2/m1≤1) → (m1, m2)
    (ref: BBH_version/data/get_lalinf_pars.py:52-67)."""
    eta = q / (1.0 + q) ** 2
    M = mc * eta ** (-3.0 / 5.0)
    m1 = M / (1.0 + q)
    m2 = q * M / (1.0 + q)
    return m1, m2


def _uniform(gen: torch.Generator, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return lo + u * (hi - lo)


def _first_accept(cands: torch.Tensor, ok: torch.Tensor):
    """Each lane's first accepted candidate: cands (n, B, k), ok (n, B)."""
    idx = torch.argmax(ok.to(torch.int32), dim=1)
    any_ok = ok.any(dim=1)
    picked = torch.take_along_dim(cands, idx[:, None, None], dim=1)[:, 0, :]
    return picked, any_ok


def sample_masses(gen: torch.Generator, n: int, mdist: str = "astro",
                  m_min: float = M_MIN_DEFAULT, M_max: float = M_MAX_DEFAULT):
    """Draw ``n`` mass pairs from the named distribution (astro,
    hunt_constrain, gh or metric).

    Returns a dict of (n,) tensors: m1, m2, mc, eta, M, and ``valid`` (False
    only where a lane exhausted its candidate budget).
    """
    if mdist in ("astro", "hunt_constrain"):
        log_lo = torch.log(torch.tensor(m_min, dtype=torch.float32))
        log_hi = torch.log(torch.tensor(M_max - m_min, dtype=torch.float32))
        u = _uniform(gen, (n, _BUDGET, 2))
        m12 = torch.exp(log_lo.to(u.device) + u * (log_hi - log_lo).to(u.device))
        m1c, m2c = m12[..., 0], m12[..., 1]
        ok = (m1c + m2c < M_max) & (m1c > m_min) & (m2c > m_min) & (m1c >= m2c)
        if mdist == "hunt_constrain":
            mc, _ = chirp_mass_eta(m1c, m2c)
            ok &= (m2c / m1c >= 0.5) & (mc >= 20.0) & (mc <= 35.0)
        picked, valid = _first_accept(m12, ok)
    elif mdist == "gh":
        q = _uniform(gen, (n, _BUDGET), 1.0, 10.0)
        m2c = _uniform(gen, (n, _BUDGET), 5.0, 75.0)
        m1c = m2c * q
        ok = (m1c < 75.0) & (m2c < 75.0) & (m1c > 5.0) & (m1c >= m2c)
        picked, valid = _first_accept(torch.stack([m1c, m2c], -1), ok)
    elif mdist == "metric":
        M_min = 2.0 * m_min
        eta_min = m_min * (M_max - m_min) / M_max**2
        uM = _uniform(gen, (n, _BUDGET))
        ue = _uniform(gen, (n, _BUDGET))
        M = (M_min ** (-7.0 / 3.0) - uM * (M_min ** (-7.0 / 3.0) - M_max ** (-7.0 / 3.0))) ** (-3.0 / 7.0)
        eta = (eta_min ** (-2.0) - ue * (eta_min ** (-2.0) - 16.0)) ** (-0.5)
        disc = torch.clamp(0.25 - eta, min=0.0)
        m1c = 0.5 * M + M * torch.sqrt(disc)
        m2c = M - m1c
        ok = (M < M_max) & (m1c > m_min) & (m2c > m_min) & (m1c >= m2c) & (eta <= 0.25)
        picked, valid = _first_accept(torch.stack([m1c, m2c], -1), ok)
    else:
        raise ValueError(f"unknown mass distribution {mdist!r}")

    m1, m2 = picked[:, 0], picked[:, 1]
    mc, eta = chirp_mass_eta(m1, m2)
    return {"m1": m1, "m2": m2, "mc": mc, "eta": eta, "M": m1 + m2, "valid": valid}
