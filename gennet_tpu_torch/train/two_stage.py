"""The gen-4 two-stage pretraining scheme (port of
``gennet_tpu.train.two_stage``; ref: 2_model_version/):

1. pretrain the discriminator against pure noise (ref: noise_gan.py: D
   learns N(0, nstd) noise against G's output; artifact
   best_d_weights.hdf5);
2. pretrain the generator adversarially with the anti-mode-collapse
   latent U(−5, 5) (ref: no_mode_collapse_network.py:184; artifact
   best_g_weights.hdf5);
3. combine the pretrained weights into the subtraction GAN with one-sided
   label smoothing and the residual route (ref: subtract_model.py).

Each stage trains its own copy of the networks through the port's
:func:`~gennet_tpu_torch.train.gan.gan_step`; the weight transfer is a
``load_state_dict`` of G (BatchNorm statistics included) and of D into
freshly initialised networks with fresh Adam states.
"""

import copy
from dataclasses import replace

import torch
from torch import nn

from gennet_tpu_torch.train.gan import GANConfig, GANState, gan_step, init_gan


def pretrain_discriminator_on_noise(init_gen: torch.Generator, gen: torch.Generator,
                                    generator: nn.Module, discriminator: nn.Module,
                                    cfg: GANConfig, n_iters: int, noise_std: float = 1.0,
                                    state: GANState | None = None):
    """Stage 1: the alternating step with the real bank replaced by
    4·batch_size fresh N(0, noise_std) rows each iteration and a zero
    measurement. Only the state's D is the stage's artifact. A new state
    is initialised from ``init_gen`` (CPU) unless ``state`` is given;
    ``gen`` (on the device) drives the iterations. Returns (state, the
    last step's metrics)."""
    state = state or init_gan(init_gen, generator, discriminator, cfg, gen.device)
    measured = torch.zeros(cfg.n_pix, device=gen.device)
    metrics = {}
    for _ in range(n_iters):
        bank = noise_std * torch.randn((cfg.batch_size * 4, cfg.n_pix), generator=gen,
                                       device=gen.device)
        state, metrics = gan_step(state, bank, measured, gen, cfg=cfg)
    return state, metrics


def pretrain_generator(init_gen: torch.Generator, gen: torch.Generator, generator: nn.Module,
                       discriminator: nn.Module, cfg: GANConfig, bank: torch.Tensor,
                       measured: torch.Tensor, n_iters: int, state: GANState | None = None):
    """Stage 2: adversarial G pretraining on ``bank`` (the anti-mode-collapse
    run uses a TransposeGenerator with latent_dim 1 and a cfg with
    latent_low, latent_high = −5, 5). Returns (state, the last step's
    metrics)."""
    state = state or init_gan(init_gen, generator, discriminator, cfg, gen.device)
    metrics = {}
    for _ in range(n_iters):
        state, metrics = gan_step(state, bank, measured, gen, cfg=cfg)
    return state, metrics


def combine_pretrained(init_gen: torch.Generator, generator: nn.Module,
                       discriminator: nn.Module, cfg: GANConfig, g_state: GANState | None,
                       d_state: GANState | None, device) -> GANState:
    """Stage 3's start: ``generator`` and ``discriminator`` initialised from
    ``init_gen`` with fresh Adam states, then G's parameters and BatchNorm
    statistics from ``g_state`` and D's parameters from ``d_state`` (ref:
    the load_weights calls, subtract_model.py no_weight_code:405-414).
    Label smoothing belongs in ``cfg``."""
    state = init_gan(init_gen, generator, discriminator, cfg, device)
    if g_state is not None:
        generator.load_state_dict(g_state.generator.state_dict())
    if d_state is not None:
        discriminator.load_state_dict(d_state.discriminator.state_dict())
    return state


def run_two_stage(seed: int, generator: nn.Module, discriminator: nn.Module,
                  bank: torch.Tensor, measured: torch.Tensor, cfg: GANConfig | None = None,
                  stage1_iters: int = 200, stage2_iters: int = 200, stage3_iters: int = 1000,
                  noise_std: float = 1.0):
    """The three stages on ``bank``'s device: stages 1 and 2 on copies of
    the networks, stage 3 on ``generator`` and ``discriminator``
    themselves, with ``cfg`` (default: the raw-series D at the bank's
    width) plus label smoothing and the residual route. The networks are
    initialised from CPU generators seeded ``seed`` + 1, + 2 and + 3, and
    the iterations draw from one generator on the device seeded ``seed``.
    Returns (the final state, the last step's metrics)."""
    cfg = cfg or GANConfig(n_pix=bank.shape[-1], pair_discriminator=False)
    gen = torch.Generator(device=bank.device).manual_seed(seed)

    def init(k):
        return torch.Generator().manual_seed(seed + k)

    d_pre, _ = pretrain_discriminator_on_noise(init(1), gen, copy.deepcopy(generator),
                                               copy.deepcopy(discriminator), cfg, stage1_iters,
                                               noise_std)
    g_cfg = replace(cfg, latent_low=-5.0, latent_high=5.0)
    g_pre, _ = pretrain_generator(init(2), gen, copy.deepcopy(generator),
                                  copy.deepcopy(discriminator), g_cfg, bank, measured,
                                  stage2_iters)
    cfg3 = replace(cfg, label_smoothing=True, residual_route=True)
    state = combine_pretrained(init(3), generator, discriminator, cfg3, g_pre, d_pre, bank.device)
    metrics = {}
    for _ in range(stage3_iters):
        state, metrics = gan_step(state, bank, measured, gen, cfg=cfg3)
    return state, metrics
