"""Sinusoid and Gaussian-pulse toy signals of the gen-2/3 prototypes (port
of ``gennet_tpu.physics.toys``; ref: train_on_wvf_version/nn.py:57-69 and
Gauss_pulse_testing/orig_rricard_model/*).

Each sampler draws its parameters from the caller's ``torch.Generator``
and evaluates them with the deterministic function beside it, on the
generator's device. The sample grids are made on the host with the
reference's float32 rounding (``jnp.arange`` is numpy's float32
``arange``; XLA computes ``jnp.linspace(0, 1, n)`` as iota × float32(1/(n −
1))): at the pulse's arguments of up to ~220 rad, one ulp of t moves the
output by ~2e-5.
"""

import math

import numpy as np
import torch


def sinusoids(offset: torch.Tensor, mul: torch.Tensor, n_out: int = 50,
              x_max: float = 5.0) -> torch.Tensor:
    """sin(offset + x·mul)/2 + 0.5 on x = arange(0, x_max, x_max/n_out),
    for ``offset`` and ``mul`` of shape (n, 1): (n, n_out) in [0, 1]."""
    x = torch.as_tensor(np.arange(0.0, x_max, x_max / n_out, dtype=np.float32),
                        device=offset.device)
    return torch.sin(offset + x[None, :] * mul) / 2.0 + 0.5


def sample_sinusoids(gen: torch.Generator, n: int, n_out: int = 50, x_max: float = 5.0,
                     max_offset: float = 100.0, mul_range=(1.0, 2.0)) -> torch.Tensor:
    """Random-phase and -frequency sinusoids (ref: nn.py:57-69): offset
    ~ U(0, max_offset), mul ~ U(mul_range)."""
    offset = max_offset * torch.rand((n, 1), generator=gen, device=gen.device)
    lo, hi = mul_range
    mul = lo + (hi - lo) * torch.rand((n, 1), generator=gen, device=gen.device)
    return sinusoids(offset, mul, n_out, x_max)


def gauss_pulses(t0: torch.Tensor, n_out: int = 512, fc: float = 50.0,
                 bw: float = 0.3) -> torch.Tensor:
    """Gaussian-modulated sinusoids centred at ``t0`` (n, 1) on
    t = linspace(0, 1, n_out): exp(−a x²) cos(2π fc x), x = t − t0,
    a = (π fc bw)²/(4 ln 2) (scipy.signal.gausspulse's envelope)."""
    t = np.arange(n_out, dtype=np.float32) * (np.float32(1.0) / np.float32(n_out - 1))
    t[-1] = 1.0
    t = torch.as_tensor(t, device=t0.device)[None, :]
    a = (math.pi * fc * bw) ** 2 / (4.0 * math.log(2.0))
    x = t - t0
    return torch.exp(-a * x**2) * torch.cos(2 * math.pi * fc * x)


def gauss_pulse(gen: torch.Generator, n: int, n_out: int = 512, fc: float = 50.0,
                bw: float = 0.3) -> torch.Tensor:
    """``n`` Gaussian pulses at t0 ~ U(0.3, 0.7) (ref: Gauss_pulse_testing/
    orig_rricard_model/scipy_guasspulse.py)."""
    t0 = 0.3 + 0.4 * torch.rand((n, 1), generator=gen, device=gen.device)
    return gauss_pulses(t0, n_out, fc, bw)
