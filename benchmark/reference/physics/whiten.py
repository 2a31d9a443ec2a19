"""PSD whitening (port of ``gennet_tpu.physics.whiten``): the gain of the
amplitude/phase template pipeline, and whitening of frequency- and
time-domain series."""

import torch

from .windows import tukey


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
    gain[..., 0].zero_()  # on the device: no host copy, so a CUDA graph can record it
    return gain


def whiten_fd(data_fd: torch.Tensor, psd: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Whiten a frequency-domain series in the rfft layout (trailing axis,
    N//2+1 bins): x̃ · sqrt(2/(psd·fs)) with undefined bins and DC zeroed
    (ref: gw_template_maker.py:243-286). Leading axes broadcast against the
    one PSD."""
    return data_fd * whitening_gain(psd, sample_rate)


def whiten_td(data: torch.Tensor, psd: torch.Tensor, sample_rate: float,
              alpha: float = 1.0 / 8.0) -> torch.Tensor:
    """Whiten a time-domain series (trailing axis): Tukey(``alpha``) window,
    rfft, :func:`whiten_fd`, irfft (ref: gw_template_maker.py:265-284)."""
    n = data.shape[-1]
    win = tukey(n, alpha, dtype=data.dtype, device=data.device)
    xf = whiten_fd(torch.fft.rfft(win * data, dim=-1), psd, sample_rate)
    return torch.fft.irfft(xf, n, dim=-1)
