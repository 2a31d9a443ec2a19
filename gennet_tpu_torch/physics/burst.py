"""Analytic sine-Gaussian bursts, the ``smoke`` workload's signal model
(port of ``gennet_tpu.physics.burst``; ref: tests/burstMahoGANy.py:76-98).

The whole bank is one broadcast expression on the caller's device, in
float32 as in the JAX package; randomness comes from an explicit
``torch.Generator``.
"""

import math

import torch


def sine_gaussian(t0, tau, amp: float = 1.0, freq: float = 100.0, dt: float = 1.0 / 512,
                  N: int = 512, phi: float = 2.0 * math.pi, device=None) -> torch.Tensor:
    """h(t) = A sin(2π f (t − t0) + φ) exp(−(t − t0)²/τ²) at t = dt·n.

    ``t0``/``tau`` are scalars or tensors (or arrays) of one shape; the
    output gains a trailing time axis of length ``N``, in float32 on
    ``t0``'s device (``device`` for non-tensor inputs). dt stays 1/512 at
    any ``N``, as in the reference (ref: burstMahoGANy.py:76). Autograd
    flows through ``t0`` and ``tau``.
    """
    if isinstance(t0, torch.Tensor) and device is None:
        device = t0.device
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=device)[..., None]
    tau = torch.as_tensor(tau, dtype=torch.float32, device=device)[..., None]
    t = dt * torch.arange(N, dtype=torch.float32, device=device)
    x = t - t0
    return amp * torch.sin(2.0 * math.pi * freq * x + phi) * torch.exp(-(x**2) / tau**2)


def sample_burst_params(gen: torch.Generator, n: int, t0_range=(0.25, 0.75),
                        tau_range=(1.0 / 60.0, 1.0 / 15.0)) -> torch.Tensor:
    """(t0, τ) uniform over the reference's ``rand5`` prior
    (ref: burstMahoGANy.py:83-86). Returns (n, 2) float32 on ``gen``'s
    device."""
    u = torch.rand((2, n), generator=gen, device=gen.device)
    t0 = t0_range[0] + (t0_range[1] - t0_range[0]) * u[0]
    tau = tau_range[0] + (tau_range[1] - tau_range[0]) * u[1]
    return torch.stack([t0, tau], dim=-1)


def make_burst_bank(gen: torch.Generator, n: int, N: int = 512):
    """A bank of ``n`` sine-Gaussians and their (t0, τ), both on ``gen``'s
    device: the ``smoke`` workload's training set (ref: burstMahoGANy.py:581)."""
    pars = sample_burst_params(gen, n)
    return sine_gaussian(pars[:, 0], pars[:, 1], N=N), pars
