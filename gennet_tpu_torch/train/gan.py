"""Pair-GAN training, the mahoGANy alternating scheme (port of
``gennet_tpu.train.gan``).

One iteration: a discriminator step on (real, fake) pairs, then the
generator's adversarial step against the updated discriminator. As in the
reference there are three Adam states — D, the adversarial G route and the
residual G route (ref: burstMahoGANy.py:652-668) — and the D update,
together with D's Adam state, is held back while D's batch accuracy is at
or above ``d_acc_gate``.

The state owns its modules and optimisers and is updated in place.
:func:`draw_gan_batch` consumes all of an iteration's randomness into a
:class:`GANBatch`, so a batch made elsewhere (e.g. with numpy) drives
:func:`gan_update` unchanged. Dropout masks come from ``GANBatch.gen``.

Not ported yet (ROADMAP queue 1, item 6): the residual route and its
spectral loss, R1, the diversity term, debug probes.
"""

from dataclasses import dataclass

import torch
from torch import nn

from gennet_tpu_torch.models.layers import reset_module
from gennet_tpu_torch.train import losses as L
from gennet_tpu_torch.train.cnn import adam, ema_update, param_copy


@dataclass(frozen=True)
class GANConfig:
    """GAN training config (reference defaults: bbhMahoGANy.py:83-113); the
    field meanings are those of ``gennet_tpu.train.gan.GANConfig``, whose
    residual-route, R1, diversity and debug fields are not ported yet. The
    discriminator always sees (waveform, residual) pairs."""

    n_pix: int = 1024
    latent_dim: int = 100
    batch_size: int = 8
    lr: float = 9e-5
    beta1: float = 0.5
    n_sig: float = 1.0
    chi_loss: bool = False
    label_smoothing: bool = False
    latent_low: float = -1.0
    latent_high: float = 1.0
    n_noise_real: int = 1
    d_lr_scale: float = 1.0
    d_acc_gate: float = 0.0
    d_instance_noise: float = 0.0
    g_steps_per_iter: int = 1
    g_ema_decay: float = 0.0
    d_sees_train_mode: bool = True


@dataclass
class GANKnobs:
    """Continuous training knobs (the ported subset of
    ``gennet_tpu.train.gan.GANKnobs``)."""

    d_acc_gate: float       # D updates only while d_acc < gate; ≥ 1 ⇒ always
    instance_noise: float   # σ scale of the (unit) drawn instance noise
    adv_weight: float       # weight of G's adversarial loss


def knobs_from_cfg(cfg: GANConfig) -> GANKnobs:
    return GANKnobs(d_acc_gate=cfg.d_acc_gate if cfg.d_acc_gate > 0 else 2.0,
                    instance_noise=cfg.d_instance_noise, adv_weight=1.0)


@dataclass
class GANBatch:
    """All random draws of one GAN iteration, materialised."""

    z1: torch.Tensor                  # (B, latent) D-step latents
    real: torch.Tensor                # (B, n_pix) bank gather
    fresh: torch.Tensor               # (B, n_pix) fresh N(0, n_sig) real-pair channel
    in_real: torch.Tensor | None      # (B, n_pix, 2) unit instance noise, real D input
    in_fake: torch.Tensor | None      # (B, n_pix, 2) unit instance noise, fake D input
    in_g: torch.Tensor | None         # (S, B, n_pix, 2) unit instance noise, G route
    y_real: torch.Tensor              # (B,) real labels (smoothed or 1s)
    y_fake: torch.Tensor              # (B,) fake labels (smoothed or 0s)
    z3: torch.Tensor                  # (S, B, latent) adversarial G-step latents
    gen: torch.Generator | None = None  # dropout masks (None: dropout must be off)


@dataclass
class GANState:
    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_res_opt: torch.optim.Optimizer
    g_ema: dict | None = None         # EMA of G params; None ⇒ equal to params
    step: int = 0


def init_gan(gen: torch.Generator, generator: nn.Module, discriminator: nn.Module,
             cfg: GANConfig, device) -> GANState:
    """Initialise both networks from ``gen`` (a CPU generator, flax's
    lecun_normal), move them to ``device`` and build the three Adam states."""
    reset_module(generator, gen).to(device)
    reset_module(discriminator, gen).to(device)
    return GANState(
        generator=generator,
        discriminator=discriminator,
        g_opt=adam(generator.parameters(), cfg.lr, cfg.beta1),
        d_opt=adam(discriminator.parameters(), cfg.lr * cfg.d_lr_scale, cfg.beta1),
        g_res_opt=adam(generator.parameters(), cfg.lr, cfg.beta1),
    )


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def draw_gan_batch(gen: torch.Generator, bank: torch.Tensor, cfg: GANConfig) -> GANBatch:
    """Consume one iteration's randomness. bank: (N_bank, n_pix) on
    ``gen``'s device."""
    B = cfg.batch_size * cfg.n_noise_real
    S = max(1, cfg.g_steps_per_iter)
    z1 = _uniform(gen, (B, cfg.latent_dim), cfg.latent_low, cfg.latent_high)
    ridx = torch.randint(0, bank.shape[0], (cfg.batch_size,), generator=gen, device=gen.device)
    real = bank[ridx].repeat(cfg.n_noise_real, 1)
    fresh = torch.randn(real.shape, generator=gen, device=gen.device) * cfg.n_sig
    in_shape = (B, real.shape[1], 2)
    if cfg.d_instance_noise > 0.0:
        in_real = torch.randn(in_shape, generator=gen, device=gen.device)
        in_fake = torch.randn(in_shape, generator=gen, device=gen.device)
        in_g = torch.randn((S,) + in_shape, generator=gen, device=gen.device)
    else:
        in_real = in_fake = in_g = None
    if cfg.label_smoothing:
        y_real = _uniform(gen, (B,), 0.7, 1.0)
        y_fake = _uniform(gen, (B,), 0.0, 0.3)
    else:
        y_real = torch.ones((B,), device=gen.device)
        y_fake = torch.zeros((B,), device=gen.device)
    z3 = _uniform(gen, (S, B, cfg.latent_dim), cfg.latent_low, cfg.latent_high)
    return GANBatch(z1=z1, real=real, fresh=fresh, in_real=in_real, in_fake=in_fake,
                    in_g=in_g, y_real=y_real, y_fake=y_fake, z3=z3, gen=gen)


def _d_inputs(x_gen, batch: GANBatch, measured, knobs: GANKnobs):
    """Fake and real D inputs: (waveform, measured − waveform) pairs and
    (bank template, fresh noise) pairs (ref: bbhMahoGANy.py:1267-1289)."""
    fake = torch.stack([x_gen, measured[None, :] - x_gen], dim=-1)
    realp = torch.stack([batch.real, batch.fresh], dim=-1)
    if batch.in_real is not None:
        realp = realp + knobs.instance_noise * batch.in_real
        fake = fake + knobs.instance_noise * batch.in_fake
    return fake, realp


def gan_update(state: GANState, batch: GANBatch, measured: torch.Tensor,
               knobs: GANKnobs | None = None, *, cfg: GANConfig):
    """The deterministic half of an iteration, in place: the D update (held
    back, Adam state included, while d_acc ≥ the gate), then the G update(s).
    Returns (state, metrics dict of 0-d tensors)."""
    if knobs is None:
        knobs = knobs_from_cfg(cfg)
    G, D = state.generator, state.discriminator
    B = batch.z1.shape[0]
    if cfg.g_ema_decay > 0.0 and state.g_ema is None:
        state.g_ema = param_copy(G)

    # ---------------- discriminator step --------------------------------
    # train-mode fake (dropout on, batch-statistics BN) without committing
    # the BN update: the D step must not advance the generator's state
    with torch.no_grad():
        x_fake = G(batch.z1, train=cfg.d_sees_train_mode, gen=batch.gen).reshape(B, -1)
    fake_in, real_in = _d_inputs(x_fake, batch, measured, knobs)

    # one dropout key drives both D passes in the reference: same masks
    gen_state = batch.gen.get_state() if batch.gen is not None else None
    lr_ = D(real_in, train=True, gen=batch.gen)
    if gen_state is not None:
        batch.gen.set_state(gen_state)
    lf_ = D(fake_in, train=True, gen=batch.gen)
    d_loss = 0.5 * (L.bce_with_logits(lr_, batch.y_real) + L.bce_with_logits(lf_, batch.y_fake))
    d_acc = 0.5 * (L.binary_accuracy(lr_.detach(), 1.0) + L.binary_accuracy(lf_.detach(), 0.0))
    state.d_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    # automatic D/G balance: skip the D update (and its Adam moments and
    # count) while D already wins; gate ≥ 1 ⇒ always update
    if bool(d_acc < knobs.d_acc_gate):
        state.d_opt.step()

    # ---------------- generator adversarial step(s) ---------------------
    D.requires_grad_(False)
    try:
        for s in range(batch.z3.shape[0]):
            x = G(batch.z3[s], train=True, gen=batch.gen, commit_stats=True)
            xf = x.reshape(B, -1)
            d_in = torch.stack([xf, measured[None, :] - xf], dim=-1)
            if batch.in_g is not None:
                d_in = d_in + knobs.instance_noise * batch.in_g[s]
            logits = D(d_in, train=True, gen=batch.gen)
            if cfg.chi_loss:
                g_loss = L.chisquare_loss(torch.sigmoid(logits), 1.0, cfg.n_sig)
            else:
                g_loss = L.bce_with_logits(logits, 1.0)
            g_loss = knobs.adv_weight * g_loss
            g_acc = L.binary_accuracy(logits.detach(), 1.0)
            state.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
            state.g_opt.step()
    finally:
        D.requires_grad_(True)

    if cfg.g_ema_decay > 0.0:
        ema_update(state.g_ema, G, cfg.g_ema_decay)
    state.step += 1
    metrics = {"d_loss": d_loss.detach(), "d_acc": d_acc, "g_loss": g_loss.detach(),
               "g_acc": g_acc, "res_loss": torch.zeros((), device=d_acc.device)}
    return state, metrics


def gan_step(state: GANState, bank: torch.Tensor, measured: torch.Tensor, gen: torch.Generator,
             knobs: GANKnobs | None = None, *, cfg: GANConfig):
    """One full alternating GAN iteration (draw, then update)."""
    batch = draw_gan_batch(gen, bank, cfg)
    return gan_update(state, batch, measured, knobs, cfg=cfg)


def sample_generator(generator: nn.Module, state: GANState, gen: torch.Generator, n: int,
                     cfg: GANConfig, chunk: int = 256, dropout: bool = False,
                     use_ema: bool = True, temp: float = 1.0, bn_mode: str = "eval"):
    """Draw ``n`` waveform estimates (n, n_pix) with the state's weights
    run through ``generator`` (which may differ from ``state.generator`` in
    its dropout rate).

    ``dropout=True`` keeps dropout active (MC-dropout sampling); with it, or
    with ``bn_mode="batch"``, BatchNorm uses the chunk's own statistics,
    without committing them. Draws go in full chunks of ``chunk`` latents,
    as in the reference, so batch statistics see the same batch size.
    """
    weights = {**dict(state.generator.named_parameters()),
               **dict(state.generator.named_buffers())}
    if use_ema and cfg.g_ema_decay > 0.0 and state.g_ema is not None:
        weights.update(state.g_ema)
    center = 0.5 * (cfg.latent_low + cfg.latent_high)
    kwargs = {"train": dropout, "bn_train": True if bn_mode == "batch" else None, "gen": gen}
    outs, done = [], 0
    with torch.no_grad():
        while done < n:
            z = _uniform(gen, (chunk, cfg.latent_dim), cfg.latent_low, cfg.latent_high)
            if temp != 1.0:
                z = center + temp * (z - center)
            out = torch.func.functional_call(generator, weights, (z,), kwargs)
            outs.append(out.reshape(chunk, -1))
            done += chunk
    return torch.cat(outs)[:n]
