"""Matched-filter SNR (port of ``gennet_tpu.physics.snr``): the (snr, SNR)
fields the reference's ``bbhparams`` carries and never fills (ref:
gw_template_maker.py:440), for bank diagnostics."""

import torch


def optimal_snr_fd(amp: torch.Tensor, psd: torch.Tensor, T_obs: float) -> torch.Tensor:
    """Optimal SNR ρ = sqrt(4 Σ |h̃(f)|²/S(f) df) of an FD amplitude
    (continuous-FT convention, scaled strain units like the PSD); ``amp``
    (…, Nf), ``psd`` (Nf,); bins where the PSD is not positive count 0."""
    df = 1.0 / T_obs
    good = psd > 0
    integrand = torch.where(good, amp**2 / torch.where(good, psd, torch.ones_like(psd)),
                            torch.zeros((), dtype=amp.dtype, device=amp.device))
    return torch.sqrt(4.0 * torch.sum(integrand, dim=-1) * df)


def whitened_snr(whitened: torch.Tensor) -> torch.Tensor:
    """SNR of a whitened (unit noise variance, discrete) template:
    ρ = sqrt(Σ_t s_w[t]²) over the trailing axis."""
    return torch.sqrt(torch.sum(whitened**2, dim=-1))
