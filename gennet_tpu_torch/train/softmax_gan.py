"""The gen-3 softmax-style GAN trainer, with a two-class discriminator (port
of ``gennet_tpu.train.softmax_gan``; ref: train_on_wvf_version/nn.py:100-152
and the ht-subtraction variant, ht_noise_subtract_version/nn.py:179-196).

D scores two sigmoid "class" logits: real batches are labelled [0, 1],
generated ones [1, 0], and G is trained towards [0, 1]. D is pretrained
one pass before the alternating loop. The reference's asymmetric
optimisers are kept: SGD(0.0425) for G and Adam(1e-6) with optax's default
β (0.9, 0.999) for D. The latents are U(0, 1).

One dropout key drives all three D passes of a step in the reference (real,
fake, and G's pass through the updated D), so all three use the same masks:
the port rewinds the generator before each (:func:`~gennet_tpu_torch.models.
layers.replay`). The state owns its modules and optimisers and is updated
in place. :func:`softmax_gan_step` draws the latents and calls
:func:`softmax_gan_update`, which takes them as given (so the JAX
package's draws can drive it).
"""

from dataclasses import dataclass

import torch
from torch import nn

from gennet_tpu_torch.models.layers import replay, reset_module
from gennet_tpu_torch.runtime.optim import adam
from gennet_tpu_torch.train import losses as L
from gennet_tpu_torch.train.mesh import DataMesh


@dataclass(frozen=True)
class SoftmaxGANConfig:
    n_out: int = 512
    latent_dim: int = 10
    batch_size: int = 32
    g_lr: float = 0.425e-1           # ref: nn.py:51 (SGD)
    d_lr: float = 1e-6               # ref: nn.py:53 (Adam)
    subtract_ht: bool = False        # gen-3b: fake = h(t) − G(z)


@dataclass
class SoftmaxGANState:
    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


def init_softmax_gan(gen: torch.Generator, generator: nn.Module, discriminator: nn.Module,
                     cfg: SoftmaxGANConfig, device) -> SoftmaxGANState:
    """Initialise both networks from ``gen`` (a CPU generator, flax's
    lecun_normal), move them to ``device``, and build G's SGD and D's Adam."""
    reset_module(generator.cpu(), gen).to(device)
    reset_module(discriminator.cpu(), gen).to(device)
    return SoftmaxGANState(generator=generator, discriminator=discriminator,
                           g_opt=torch.optim.SGD(generator.parameters(), lr=cfg.g_lr),
                           d_opt=adam(discriminator.parameters(), cfg.d_lr, 0.9))


def two_class_bce(logits: torch.Tensor, real: bool) -> torch.Tensor:
    """BCE of (B, 2) logits against the one-hot rows [0, 1] (real) or
    [1, 0] (fake) (ref: sample_data_and_gen labels, nn.py:116-120)."""
    y = torch.tensor([0.0, 1.0] if real else [1.0, 0.0], device=logits.device)
    return L.bce_with_logits(logits, y.expand_as(logits).reshape(-1))


def discriminator_update(state, x_real, x_fake, masks, mesh: DataMesh | None = None):
    """D's step on [real; fake] with the masks ``masks()`` returns, in
    place; under a ``mesh`` the gradients and the loss are rank means.
    Returns the loss."""
    D = state.discriminator
    lr_ = D(x_real, train=True, gen=masks())
    lf_ = D(x_fake, train=True, gen=masks())
    d_loss = 0.5 * (two_class_bce(lr_, True) + two_class_bce(lf_, False))
    state.d_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    d_loss = d_loss.detach()
    if mesh is not None:
        mesh.pmean_([p.grad for p in D.parameters()] + [d_loss])
    state.d_opt.step()
    return d_loss


def generator_update(state, g_input, to_d, masks, mesh: DataMesh | None = None):
    """G's step towards the real class through the (updated, frozen) D, with
    D's input ``to_d(G(g_input))`` and the masks ``masks()`` returns, in
    place. Returns the loss."""
    G, D = state.generator, state.discriminator
    D.requires_grad_(False)
    try:
        g_loss = two_class_bce(D(to_d(G(g_input)), train=True, gen=masks()), True)
        state.g_opt.zero_grad(set_to_none=True)
        g_loss.backward()
    finally:
        D.requires_grad_(True)
    g_loss = g_loss.detach()
    if mesh is not None:
        mesh.pmean_([p.grad for p in G.parameters()] + [g_loss])
    state.g_opt.step()
    return g_loss


def _subtract(cfg: SoftmaxGANConfig, measured):
    if cfg.subtract_ht and measured is not None:
        return lambda x: measured[None, :] - x
    return lambda x: x


def _latents(gen: torch.Generator, n: int, cfg: SoftmaxGANConfig) -> torch.Tensor:
    return torch.rand((n, cfg.latent_dim), generator=gen, device=gen.device)


def softmax_gan_update(state: SoftmaxGANState, x_real: torch.Tensor, z: torch.Tensor,
                       z2: torch.Tensor, gen: torch.Generator | None, *, cfg: SoftmaxGANConfig,
                       measured: torch.Tensor | None = None, mesh: DataMesh | None = None):
    """One epoch-step given its latents: D on [real; fake] (fake = G(z), or
    h(t) − G(z) under ``subtract_ht``), then G on ``z2`` towards the real
    class. All three D passes use one set of masks from ``gen`` (``None``:
    D's dropout must be off). ``mesh`` averages the gradients and the losses
    across the ranks. Returns (state, {"d_loss", "g_loss"})."""
    to_d = _subtract(cfg, measured)
    masks = replay(gen)
    with torch.no_grad():
        x_fake = to_d(state.generator(z))
    d_loss = discriminator_update(state, x_real, x_fake, masks, mesh)
    g_loss = generator_update(state, z2, to_d, masks, mesh)
    state.step += 1
    return state, {"d_loss": d_loss, "g_loss": g_loss}


def softmax_gan_step(state: SoftmaxGANState, x_real: torch.Tensor, gen: torch.Generator, *,
                     cfg: SoftmaxGANConfig, measured: torch.Tensor | None = None,
                     mesh: DataMesh | None = None):
    """One epoch-step (draw both latent batches from ``gen``, then
    :func:`softmax_gan_update`)."""
    z = _latents(gen, x_real.shape[0], cfg)
    z2 = _latents(gen, x_real.shape[0], cfg)
    return softmax_gan_update(state, x_real, z, z2, gen, cfg=cfg, measured=measured, mesh=mesh)


def pretrain_update(state: SoftmaxGANState, x_real: torch.Tensor, z: torch.Tensor,
                    gen: torch.Generator | None, *, cfg: SoftmaxGANConfig,
                    measured: torch.Tensor | None = None):
    """The D-only pass before the alternating loop, given its latents (ref:
    pretrain, nn.py:124-128). It is never averaged across ranks, as in
    the reference. Returns (state, {"d_loss"})."""
    to_d = _subtract(cfg, measured)
    with torch.no_grad():
        x_fake = to_d(state.generator(z))
    return state, {"d_loss": discriminator_update(state, x_real, x_fake, replay(gen))}


def pretrain_discriminator(state: SoftmaxGANState, x_real: torch.Tensor, gen: torch.Generator,
                           *, cfg: SoftmaxGANConfig, measured: torch.Tensor | None = None):
    """Draw the latents from ``gen``, then :func:`pretrain_update`."""
    return pretrain_update(state, x_real, _latents(gen, x_real.shape[0], cfg), gen, cfg=cfg,
                           measured=measured)
