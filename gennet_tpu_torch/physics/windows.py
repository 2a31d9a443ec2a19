"""Window functions, in float64 numpy: they are constants folded into the
iDFT tables. Copies of ``gennet_tpu.physics.windows``'s numpy forms, so
both packages fold the same numbers.
"""

import numpy as np
import torch


def tukey_np(M: int, alpha: float = 0.5) -> np.ndarray:
    """Tukey window as float64 numpy: taper half-width
    ``floor(alpha*(M-1)/2)`` as the reference defines it
    (ref: gw_template_maker.py:102-113)."""
    if M <= 0:
        return np.zeros((0,), np.float64)
    if M == 1 or alpha <= 0.0:
        return np.ones((M,), np.float64)

    n = np.arange(M, dtype=np.float64)
    width = int(np.floor(alpha * (M - 1) / 2.0))
    w = np.ones(M, dtype=np.float64)
    left = n[: width + 1]
    w[: width + 1] = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * left / alpha / (M - 1))))
    right = n[M - width - 1 :]
    w[M - width - 1 :] = 0.5 * (
        1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * right / alpha / (M - 1)))
    )
    return w


def centered_tukey_window_np(N: int, safe: int = 2, alpha: float = 1.0 / 8.0) -> np.ndarray:
    """The reference's "aggressive" signal-extraction window: a Tukey window
    of length ``(16/15)·N/safe`` centred in an otherwise-zero length-``N``
    window (ref: gw_template_maker.py:533-538)."""
    w = np.zeros(N, dtype=np.float64)
    tempwin = tukey_np(int((16.0 / 15.0) * N / safe), alpha=alpha)
    start = int((N - tempwin.size) / 2)
    w[start : start + tempwin.size] = tempwin
    return w


def tukey(M: int, alpha: float = 0.5, dtype: torch.dtype = torch.float32,
          device=None) -> torch.Tensor:
    """:func:`tukey_np` as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(tukey_np(M, alpha), dtype=dtype, device=device)
