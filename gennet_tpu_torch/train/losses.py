"""Loss functions of the GAN and CNN training (port of
``gennet_tpu.train.losses``)."""

import torch
import torch.nn.functional as F


def _labels(labels, like: torch.Tensor) -> torch.Tensor:
    """``labels`` (a number or a tensor) broadcast to ``like``, made on
    ``like``'s device: a number is filled in there, never copied from the
    host, so a CUDA-graph capture can record it."""
    if isinstance(labels, torch.Tensor):
        return labels.to(device=like.device, dtype=like.dtype).expand_as(like)
    return torch.full_like(like, labels)


def bce_with_logits(logits: torch.Tensor, labels) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits, mean over the
    batch (ref: Keras 'binary_crossentropy', bbhMahoGANy.py:1101,1107,1115)."""
    logits = logits.reshape(-1)
    labels = _labels(labels, logits)
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels
                      + F.softplus(-torch.abs(logits)))


def binary_accuracy(logits: torch.Tensor, labels) -> torch.Tensor:
    """Fraction of (sigmoid(logit) > 0.5) predictions matching the rounded
    labels (the reference's Keras 'accuracy')."""
    logits = logits.reshape(-1)
    labels = _labels(labels, logits)
    pred = (logits > 0.0).to(logits.dtype)
    return torch.mean((pred == torch.round(labels)).to(logits.dtype))


def chisquare_loss(probs: torch.Tensor, labels, n_sig: float = 1.0) -> torch.Tensor:
    """The reference's optional χ² GAN loss on sigmoid outputs
    (ref: chisquare_Loss, bbhMahoGANy.py:146-162)."""
    probs = probs.reshape(probs.shape[0], -1)
    labels = _labels(labels, probs)
    return torch.mean(torch.sum((labels - probs) ** 2 / n_sig**2, dim=-1))


def mse_multi_output(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-output mean squared error summed over outputs
    (ref: bbhMahoGANy.py:1119,1165)."""
    return torch.sum(torch.mean((pred - target) ** 2, dim=0))


def residual_moment_loss(residual: torch.Tensor, n_sig: float) -> torch.Tensor:
    """The subtraction route's target: per sample, the residual's mean → 0
    and mean square → n_sig², as an MSE on the two moments (ref: MyLayer
    burst variant, burstMahoGANy.py:116-120,798-802)."""
    dims = tuple(range(1, residual.ndim))
    m1 = torch.mean(residual, dim=dims)
    m2 = torch.mean(residual**2, dim=dims)
    return torch.mean(0.5 * (m1**2 + (m2 - n_sig**2) ** 2))


def residual_spectral_loss(residual: torch.Tensor, n_sig: float, n_bands: int) -> torch.Tensor:
    """Frequency-resolved whiteness target of the subtraction route (the
    JAX docstring gives the measured motivation): the periodogram
    |rfft|²/n without DC and Nyquist (E = n_sig² per bin for white
    N(0, n_sig²) noise) in ``n_bands`` equal bands, each band's mean power
    MSE'd against n_sig², plus the mean square of the per-sample mean.
    ``n_bands`` is clamped to [1, bins], so a tiny n_pix never takes a mean
    over an empty band."""
    r = residual.reshape(residual.shape[0], -1)
    n = r.shape[-1]
    p = torch.abs(torch.fft.rfft(r, dim=-1)[:, 1:-1]) ** 2 / n
    nb = max(1, min(int(n_bands), p.shape[-1]))
    bins = p.shape[-1] - (p.shape[-1] % nb)
    bands = p[:, :bins].reshape(r.shape[0], nb, -1).mean(dim=-1)
    m1 = torch.mean(r, dim=-1)
    return torch.mean(m1**2) + torch.mean((bands - n_sig**2) ** 2)
