"""The gen-2 method-ablation variants (port of
``gennet_tpu.train.denoise_variants``; ref: Gauss_pulse_testing/
orig_rricard_model/):

- the autoencoder latent (ref: sine_subtract.py:223-260): a small dense
  autoencoder trained to reconstruct clean signals, whose encoder maps
  (noisy) signals into a GAN's latent space;
- the "Stark approach" (ref: stark_approach.py:143-163): the generator is
  a denoiser, fed the noisy signal instead of a latent, and the
  discriminator judges G(signal + noise) against clean signals, with the
  two-class labels and the one-mask D passes of
  :mod:`~gennet_tpu_torch.train.softmax_gan`.
"""

from dataclasses import dataclass

import torch
from torch import nn

from gennet_tpu_torch.models.generator import DenseGenerator
from gennet_tpu_torch.models.layers import Dense, replay, reset_module
from gennet_tpu_torch.runtime.optim import adam
from gennet_tpu_torch.train.softmax_gan import (SoftmaxGANState, discriminator_update,
                                                generator_update)


class SignalAutoencoder(nn.Module):
    """Dense AE: n_out → encoding_dim (relu) → n_out (sigmoid) (ref:
    make_autoencoder, sine_subtract.py:223-251). ``forward`` returns
    (reconstruction, code)."""

    def __init__(self, n_out: int = 50, encoding_dim: int = 10):
        super().__init__()
        self.encoder = Dense(n_out, encoding_dim)
        self.decoder = Dense(encoding_dim, n_out)

    def forward(self, x):
        z = self.encode(x)
        return torch.sigmoid(self.decoder(z)), z

    def encode(self, x):
        """The encoder half alone: a GAN's latent provider."""
        return torch.relu(self.encoder(x))


def train_autoencoder(gen: torch.Generator, model: SignalAutoencoder, x_train: torch.Tensor,
                      epochs: int = 100, batch_size: int = 32, lr: float = 1e-2):
    """Reconstruction training: ``epochs`` Adam(lr) steps, each on
    ``batch_size`` rows drawn with replacement, with BCE on the
    reconstruction clipped to [1e-7, 1 − 1e-7] (ref: train_autoencoder,
    sine_subtract.py:253-260, which used adadelta).

    ``gen`` is a CPU generator: it initialises the model (flax's
    lecun_normal) and draws the rows, which go to ``x_train``'s device, so
    a seed trains the same way on every device. Returns (model, the last
    step's loss)."""
    reset_module(model.cpu(), gen).to(x_train.device)
    opt = adam(model.parameters(), lr, 0.9)
    loss = float("inf")
    for _ in range(epochs):
        idx = torch.randint(0, x_train.shape[0], (batch_size,), generator=gen)
        xb = x_train[idx.to(x_train.device)]
        r = torch.clamp(model(xb)[0], 1e-7, 1.0 - 1e-7)
        bce = -torch.mean(xb * torch.log(r) + (1.0 - xb) * torch.log(1.0 - r))
        opt.zero_grad(set_to_none=True)
        bce.backward()
        opt.step()
        loss = bce.detach()
    return model, float(loss)


class DenoiserGenerator(DenseGenerator):
    """The Stark-approach generator: noisy signal (B, n_out) in, clean
    estimate out, through the gen-3 dense stack (Dense(300) relu →
    Dense(150) relu → Dense(n_out) tanh)."""

    def __init__(self, n_out: int = 50):
        super().__init__(n_out=n_out, latent_dim=n_out, dense_dim=300)


@dataclass(frozen=True)
class DenoiserGANConfig:
    n_out: int = 50
    batch_size: int = 32
    noise_level: float = 0.2       # ref hyperparams.noise_level
    g_lr: float = 1e-3
    d_lr: float = 1e-4


DenoiserGANState = SoftmaxGANState  # the same fields: G, D, their optimisers, the step


def init_denoiser_gan(gen: torch.Generator, generator: nn.Module, discriminator: nn.Module,
                      cfg: DenoiserGANConfig, device) -> DenoiserGANState:
    """Initialise both networks from ``gen`` (a CPU generator), move them to
    ``device``, and build Adam(g_lr) and Adam(d_lr) with optax's default β."""
    reset_module(generator.cpu(), gen).to(device)
    reset_module(discriminator.cpu(), gen).to(device)
    return DenoiserGANState(generator=generator, discriminator=discriminator,
                            g_opt=adam(generator.parameters(), cfg.g_lr, 0.9),
                            d_opt=adam(discriminator.parameters(), cfg.d_lr, 0.9))


def denoiser_gan_update(state: DenoiserGANState, x_real: torch.Tensor, noisy: torch.Tensor,
                        noisy2: torch.Tensor, gen: torch.Generator | None, *,
                        cfg: DenoiserGANConfig):
    """One step given its noisy inputs: D separates the clean ``x_real``
    from G(``noisy``), then G is trained on ``noisy2`` to fool the updated
    D. All three D passes use one set of masks from ``gen`` (``None``: D's
    dropout must be off). Returns (state, {"d_loss", "g_loss"})."""
    masks = replay(gen)
    with torch.no_grad():
        x_fake = state.generator(noisy)
    d_loss = discriminator_update(state, x_real, x_fake, masks)
    g_loss = generator_update(state, noisy2, lambda x: x, masks)
    state.step += 1
    return state, {"d_loss": d_loss, "g_loss": g_loss}


def denoiser_gan_step(state: DenoiserGANState, x_real: torch.Tensor, gen: torch.Generator, *,
                      cfg: DenoiserGANConfig):
    """fake = G(signal + U(−lvl, lvl) noise), with fresh noise for G's
    pass: draw both noisy batches from ``gen``, then
    :func:`denoiser_gan_update`."""
    lvl = cfg.noise_level

    def noisy():
        u = torch.rand(x_real.shape, generator=gen, device=gen.device)
        return x_real + (2.0 * lvl * u - lvl)

    n1 = noisy()
    return denoiser_gan_update(state, x_real, n1, noisy(), gen, cfg=cfg)
