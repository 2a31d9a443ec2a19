"""Plain sine-Gaussian bursts, the burst workload's signal model
(ref: tests/burstMahoGANy.py:76-98): h(t) = A sin(2π f (t − t0) + φ)
exp(−(t − t0)²/τ²) at t = dt·n, every intermediate in float32, the
constants A, 2πf and φ rounded to float32 first."""

import math

import torch


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


def sine_gaussian(t0, tau, N: int, amp: float = 1.0, freq: float = 100.0,
                  dt: float = 1.0 / 512, phi: float = 2.0 * math.pi) -> torch.Tensor:
    """(B,) t0 and τ (float32 tensors on one device) → (B, N)."""
    t0 = t0.to(torch.float32)[..., None]
    tau = tau.to(torch.float32)[..., None]
    t = (dt * torch.arange(N, dtype=torch.float32, device=t0.device))
    x = t - t0
    return _f32(amp) * torch.sin(_f32(2.0 * math.pi * freq) * x + _f32(phi)) * torch.exp(
        -(x**2) / tau**2)
