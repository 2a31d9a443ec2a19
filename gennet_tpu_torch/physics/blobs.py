"""Parameterised 2-D Gaussian-blob images, the gen-1 toy signal model
(port of ``gennet_tpu.physics.blobs``; ref: tests/ganymede.py:316-342).

Images of a 2-D Gaussian pdf at a random mean, renormalised to [−1, 1].
The whole bank is one broadcast expression on the caller's device, in
float32 as in the JAX package; randomness comes from an explicit
``torch.Generator``.
"""

import torch


def gauss_blob_images(means: torch.Tensor, n_pix: int = 28, blob_scale: float = 0.1) -> torch.Tensor:
    """Images for blob centres ``means`` (…, 2) in fractional [0, 1]
    coordinates, ``means[..., 0]`` the row: the pdf with covariance
    (blob_scale·n_pix)² I, renormalised per image to [−1, 1] (ref: renorm
    + mvn.pdf, ganymede.py:333-336). Returns (…, n_pix, n_pix) on
    ``means``' device."""
    ar = torch.arange(n_pix, dtype=torch.float32, device=means.device)
    xy = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), dim=-1)  # (n, n, 2)
    mu = means[..., None, None, :] * n_pix
    var = (blob_scale * n_pix) ** 2
    img = torch.exp(-0.5 * torch.sum((xy - mu) ** 2, dim=-1) / var)  # ∝ pdf
    lo = torch.amin(img, dim=(-2, -1), keepdim=True)
    hi = torch.amax(img, dim=(-2, -1), keepdim=True)
    half = 0.5 * (hi - lo)
    mid = 0.5 * (hi + lo)
    return (img - mid) / torch.clamp(half, min=1e-12)


def make_blob_bank(gen: torch.Generator, n: int, n_pix: int = 28, blob_scale: float = 0.1):
    """``n`` random-blob images and their fractional (row, column) means,
    both on ``gen``'s device (ref: ganymede.py:327-340)."""
    means = torch.rand((n, 2), generator=gen, device=gen.device)
    return gauss_blob_images(means, n_pix, blob_scale), means


def blob_grid_posterior(measured: torch.Tensor, n_sig: float, grain: int = 28,
                        blob_scale: float = 0.1):
    """Exact likelihood of the blob centre on a grain × grain grid of
    [0, 1]², normalised to max 1 (ref: ganymede.py:578-588), on
    ``measured``'s device. Returns (L (grain, grain), transposed after the
    reshape as in the reference, grid, grid)."""
    n_pix = measured.shape[-1]
    g = torch.linspace(0.0, 1.0, grain, device=measured.device)
    gx, gy = torch.meshgrid(g, g, indexing="ij")
    templ = gauss_blob_images(torch.stack([gx.ravel(), gy.ravel()], -1), n_pix, blob_scale)
    logL = -0.5 * torch.sum(((measured[None] - templ) / n_sig) ** 2, dim=(-2, -1))
    logL = logL.reshape(grain, grain).T
    return torch.exp(logL - torch.max(logL)), g, g
