"""Inverse real DFT as matrix products: host tables and the plain slice form.

The tables are float32 numpy, built exactly as ``gennet_tpu.ops.dft`` builds
them, so both packages transform with the same constants. Conventions match
numpy: one-sided spectrum of length Nf = N//2 + 1;
x[n] = (1/N) Σ_k w_k (re_k cos(2πkn/N) − im_k sin(2πkn/N)), w_k = 2 except
w_0 = w_{N/2} = 1 for even N.
"""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=8)
def _irdft_tables(N: int) -> tuple[np.ndarray, np.ndarray]:
    Nf = N // 2 + 1
    k = np.arange(Nf)[:, None]
    n = np.arange(N)[None, :]
    ang = 2.0 * np.pi * k * n / N
    w = np.full((Nf, 1), 2.0)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    cos_t = (w * np.cos(ang) / N).astype(np.float32)
    sin_t = (w * np.sin(ang) / N).astype(np.float32)
    return cos_t, sin_t


@lru_cache(maxsize=32)
def _irdft_slice_tables(N: int, start: int, width: int, weights_key=None):
    """(Nf, width) column slice of the iDFT tables over output samples
    ``[start, start+width) mod N``, with optional per-sample weights folded
    in. ``weights_key`` is a hashable tuple of ``width`` floats."""
    cos_t, sin_t = _irdft_tables(N)
    cols = (np.arange(start, start + width)) % N
    c = cos_t[:, cols].copy()
    s = sin_t[:, cols].copy()
    if weights_key is not None:
        w = np.asarray(weights_key, np.float32)
        c *= w
        s *= w
    return c, s


def irdft_slice(re: torch.Tensor, im: torch.Tensor, N: int, start: int, width: int,
                weights: tuple | None = None) -> torch.Tensor:
    """Inverse real DFT evaluated only on output samples
    ``[start, start+width) mod N``: a column slice of the iDFT matrix with
    optional per-output-sample ``weights`` folded into it."""
    cos_np, sin_np = _irdft_slice_tables(N, start, width, weights)
    cos_t = torch.as_tensor(cos_np, device=re.device)
    sin_t = torch.as_tensor(sin_np, device=re.device)
    return re @ cos_t - im @ sin_t
