"""Minke/MDC waveform ingestion and injection-set synthesis (port of
``gennet_tpu.data.waveform_txt``).

- :func:`load_txt_waveforms`: read minke-generated two-column txt
  waveforms, resample to a fixed length, peak-normalise, apply a random
  roll offset (ref: load_txtwfs.py:31-77). Host numpy and scipy, as in the
  reference package.
- :func:`make_sine_gaussian_mdc`: the hardware-injection MDC set the
  reference built through minke (SineGaussian q=15, f∈[100,200] Hz; ref:
  make_hw-xml.py), synthesized in torch from an explicit generator and
  written with :func:`save_mdc_npz`.
"""

import glob
import math
import os

import numpy as np
import torch

from gennet_tpu_torch.physics.constants import STRAIN_SCALE


def load_txt_waveforms(pattern: str, n_out: int = 512, roll_range: int = 100,
                       seed: int = 0, normalize: bool = True) -> np.ndarray:
    """Load the txt waveforms matching ``pattern``; scipy-resample each to
    ``n_out`` samples, peak-normalise, and roll each by a random offset in
    ±roll_range (ref: load_txtwfs.py:36-77)."""
    from scipy.signal import resample

    rng = np.random.default_rng(seed)
    out = []
    for path in sorted(glob.glob(pattern)):
        raw = np.loadtxt(path)
        series = raw[:, 1] if raw.ndim == 2 else raw
        w = resample(series, n_out)
        if normalize and np.max(np.abs(w)) > 0:
            w = w / np.max(np.abs(w))
        w = np.roll(w, int(rng.integers(-roll_range, roll_range + 1)))
        out.append(w)
    if not out:
        raise FileNotFoundError(f"no waveforms match {pattern!r}")
    return np.asarray(out, np.float32)


def make_sine_gaussian_mdc(gen: torch.Generator, n: int, fs: int = 16384,
                           duration: float = 1.0, q: float = 15.0, f_range=(100.0, 200.0),
                           hrss: float = 1e-22):
    """Sine-Gaussian hardware-injection set: q = 15, centre frequency
    uniform in ``f_range`` (ref: make_hw-xml.py's minke SineGaussian
    parameters), on ``gen``'s device. Returns (waveforms (n, fs·duration),
    params dict) in strain·1e21 units.

    h(t) = h_peak sin(2πf₀(t−t₀)) exp(−((t−t₀)/τ)²), τ = q/(πf₀√2), with
    h_peak from the requested hrss: hrss² = ∫h² dt ≈ h_peak²·τ√(π/2)/2.
    """
    dev = gen.device
    n_samp = int(fs * duration)
    f0 = f_range[0] + (f_range[1] - f_range[0]) * torch.rand((n, 1), generator=gen, device=dev)
    t0 = duration * (0.4 + 0.2 * torch.rand((n, 1), generator=gen, device=dev))
    t = torch.arange(n_samp, device=dev)[None, :] / fs
    tau = q / (math.sqrt(2.0) * math.pi * f0)
    h_peak = hrss * STRAIN_SCALE / torch.sqrt(tau * math.sqrt(math.pi / 2.0) / 2.0)
    x = t - t0
    h = h_peak * torch.sin(2 * math.pi * f0 * x) * torch.exp(-((x / tau) ** 2))
    return h, {"f0": f0[:, 0], "t0": t0[:, 0], "q": torch.full((n,), q, device=dev),
               "hrss": torch.full((n,), hrss, device=dev)}


def save_mdc_npz(path: str, waveforms, params: dict):
    """Write the set as one ``.npz`` (``waveforms`` and one array per
    parameter)."""
    def host(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, waveforms=host(waveforms), **{k: host(v) for k, v in params.items()})
