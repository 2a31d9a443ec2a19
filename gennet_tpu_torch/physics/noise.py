"""Gaussian noise synthesis, white and PSD-coloured (port of
``gennet_tpu.physics.noise``), from an explicit ``torch.Generator`` on its
device (ref: gen_noise, gw_template_maker.py:161-193)."""

import torch


def white_noise(gen: torch.Generator, shape, sigma: float = 1.0,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian noise of standard deviation ``sigma``: the whitened-domain
    noise model the GAN assumes (ref: bbhMahoGANy.py:85,1277)."""
    return sigma * torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def colored_noise(gen: torch.Generator, psd: torch.Tensor, T_obs: float, fs: float,
                  batch_shape=(), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Coloured Gaussian noise from a one-sided PSD: amplitude sqrt(T·psd/4)
    per real and imaginary quadrature, DC and zero-PSD bins zeroed, then
    N · irfft(...) · df. Returns ``batch_shape + (N,)``, N = T_obs·fs."""
    N = int(T_obs * fs)
    Nf = N // 2 + 1
    df = 1.0 / T_obs
    psd = psd.to(gen.device)
    amp = torch.sqrt(0.25 * T_obs * psd)
    amp = torch.where(psd == 0.0, torch.zeros_like(amp), amp)
    re = amp * torch.randn((*batch_shape, Nf), generator=gen, device=gen.device, dtype=dtype)
    im = amp * torch.randn((*batch_shape, Nf), generator=gen, device=gen.device, dtype=dtype)
    re[..., 0] = 0.0
    im[..., 0] = 0.0
    return N * torch.fft.irfft(torch.complex(re, im), N, dim=-1).to(dtype) * df
