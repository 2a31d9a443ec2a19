"""Loss functions of the flagship path."""

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, labels) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits, mean over the
    batch (ref: Keras 'binary_crossentropy', bbhMahoGANy.py:1101,1107,1115)."""
    logits = logits.reshape(-1)
    labels = torch.as_tensor(labels, dtype=logits.dtype, device=logits.device).expand_as(logits)
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels
                      + F.softplus(-torch.abs(logits)))


def binary_accuracy(logits: torch.Tensor, labels) -> torch.Tensor:
    """Fraction of (sigmoid(logit) > 0.5) predictions matching the rounded
    labels (the reference's Keras 'accuracy')."""
    logits = logits.reshape(-1)
    labels = torch.as_tensor(labels, dtype=logits.dtype, device=logits.device).expand_as(logits)
    pred = (logits > 0.0).to(logits.dtype)
    return torch.mean((pred == torch.round(labels)).to(logits.dtype))


def chisquare_loss(probs: torch.Tensor, labels, n_sig: float = 1.0) -> torch.Tensor:
    """The reference's optional χ² GAN loss on sigmoid outputs
    (ref: chisquare_Loss, bbhMahoGANy.py:146-162)."""
    probs = probs.reshape(probs.shape[0], -1)
    labels = torch.as_tensor(labels, dtype=probs.dtype, device=probs.device).expand_as(probs)
    return torch.mean(torch.sum((labels - probs) ** 2 / n_sig**2, dim=-1))


def mse_multi_output(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-output mean squared error summed over outputs
    (ref: bbhMahoGANy.py:1119,1165)."""
    return torch.sum(torch.mean((pred - target) ** 2, dim=0))
