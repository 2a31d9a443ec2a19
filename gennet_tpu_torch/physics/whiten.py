"""PSD whitening for the amplitude/phase template pipeline."""

import torch


def _inverse_psd(psd: torch.Tensor) -> torch.Tensor:
    """1/psd with zero, negative or NaN bins mapped to 0
    (ref: gw_template_maker.py:272-275)."""
    good = psd > 0.0
    safe = torch.where(good, psd, torch.ones_like(psd))
    return torch.where(good, 1.0 / safe, torch.zeros_like(psd))


def whitening_gain(psd: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """The real per-bin whitening gain sqrt(2/(psd·fs)) with undefined bins
    and DC zeroed: whitening h̃ = amp·e^{−iΨ} scales ``amp`` by this."""
    gain = torch.sqrt(2.0 * _inverse_psd(psd) / sample_rate)
    gain[..., 0] = 0.0
    return gain
