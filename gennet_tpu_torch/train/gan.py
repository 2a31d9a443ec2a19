"""GAN training, the mahoGANy alternating scheme (port of
``gennet_tpu.train.gan``).

One iteration: a discriminator step, the optional residual route (the
burst 3-loss scheme: G pulled towards a white residual ``measured − G(z)``),
then the generator's adversarial step(s) against the updated
discriminator. As in the reference there are three Adam states — D, the
adversarial G route and the residual G route (ref: burstMahoGANy.py:652-668)
— and the D update, together with D's Adam state, is held back while D's
batch accuracy is at or above ``d_acc_gate``: D's Adam step runs, and its
result (parameters, both moments, the count) is kept or dropped on the
device, as the reference's ``_where_tree`` does, so no step waits on the
host.

The state owns its modules and optimisers and is updated in place.
:func:`draw_gan_batch` consumes all of an iteration's randomness into a
:class:`GANBatch`, so a batch made elsewhere (e.g. with numpy) drives
:func:`gan_update` unchanged. Dropout masks come from ``GANBatch.gen``.

With a :class:`~gennet_tpu_torch.train.mesh.DataMesh` the update is the
reference's data-parallel step (``make_gan_step(mesh=...)``): each rank
runs its own batch, the gradients of D, of the residual route and of each
G step are averaged across the ranks before their Adam step, ``d_acc`` is
averaged before the balance gate (so every rank takes the same branch),
the losses are rank means, BatchNorm normalises each rank's batch with its
own statistics, and the running statistics are averaged after the step.

:func:`make_gan_step_scan` runs a chunk of iterations as one call (the
reference's ``lax.scan``), on a card as replays of one captured iteration
(:mod:`gennet_tpu_torch.runtime.graphs`). Every branch the step takes on the
host is fixed by the config, never by a knob's value, and the knobs may be
0-d tensors, which a graph reads at each replay.
"""

from dataclasses import dataclass, fields

import torch
from torch import nn

from gennet_tpu_torch.models.layers import replay, reset_module
from gennet_tpu_torch.runtime import graphs
from gennet_tpu_torch.runtime.optim import adam, init_adam_state
from gennet_tpu_torch.train import losses as L
from gennet_tpu_torch.train.cnn import ema_update, param_copy
from gennet_tpu_torch.train.mesh import DataMesh, running_stats


@dataclass(frozen=True)
class GANConfig:
    """GAN training config (reference defaults: bbhMahoGANy.py:83-113 /
    burstMahoGANy.py:31-48); the field meanings are those of
    ``gennet_tpu.train.gan.GANConfig``."""

    n_pix: int = 1024
    latent_dim: int = 100
    batch_size: int = 8
    lr: float = 9e-5
    beta1: float = 0.5
    n_sig: float = 1.0
    chi_loss: bool = False
    pair_discriminator: bool = True    # D sees (waveform, residual) pairs, else raw series
    residual_route: bool = False       # the burst 3-loss scheme's residual G route
    res_loss_weight: float = 1.0
    res_spectral_bands: int = 0        # > 0: the spectral residual loss over this many bands
    res_eval_mode: bool = False        # the residual route on G's eval-mode output
    label_smoothing: bool = False
    latent_low: float = -1.0
    latent_high: float = 1.0
    n_noise_real: int = 1
    d_lr_scale: float = 1.0
    d_acc_gate: float = 0.0
    d_instance_noise: float = 0.0
    r1_gamma: float = 0.0              # R1 penalty γ/2·E‖∇ₓD(x_real)‖²
    g_steps_per_iter: int = 1
    diversity_weight: float = 0.0      # mode-seeking term (Mao et al. 2019)
    g_ema_decay: float = 0.0
    debug_probes: bool = False         # per-term health metrics in the step's output
    d_sees_train_mode: bool = True


@dataclass
class GANKnobs:
    """Continuous training knobs (``gennet_tpu.train.gan.GANKnobs``), read
    at every update, so a run can change them between steps. Each is a
    number or a 0-d tensor on the step's device (:func:`knob_tensors`)."""

    d_acc_gate: float        # D updates only while d_acc < gate; ≥ 1 ⇒ always
    diversity_weight: float
    res_loss_weight: float
    instance_noise: float    # σ scale of the (unit) drawn instance noise
    r1_gamma: float
    adv_weight: float        # weight of G's adversarial loss; 0 with d_acc_gate < 0
                             # is the terminal anneal (D frozen, residual route only)


def knobs_from_cfg(cfg: GANConfig) -> GANKnobs:
    return GANKnobs(d_acc_gate=cfg.d_acc_gate if cfg.d_acc_gate > 0 else 2.0,
                    diversity_weight=cfg.diversity_weight,
                    res_loss_weight=cfg.res_loss_weight,
                    instance_noise=cfg.d_instance_noise, r1_gamma=cfg.r1_gamma,
                    adv_weight=1.0)


def knob_tensors(knobs: GANKnobs, device, into: GANKnobs | None = None) -> GANKnobs:
    """``knobs`` as 0-d float32 tensors on ``device``, the reference's knob
    operands; with ``into``, written into its tensors (a captured step reads
    them at each replay). Filled on the device: nothing waits on the host."""
    if into is None:
        into = GANKnobs(**{f.name: torch.zeros((), dtype=torch.float32, device=device)
                           for f in fields(GANKnobs)})
    for f in fields(GANKnobs):
        v, t = getattr(knobs, f.name), getattr(into, f.name)
        if isinstance(v, torch.Tensor):
            t.copy_(v)
        else:
            t.fill_(v)
    return into


@dataclass
class GANBatch:
    """All random draws of one GAN iteration, materialised. The instance
    noise has one channel per D input channel (d_ch = 2 for pairs, else 1)."""

    z1: torch.Tensor                  # (B, latent) D-step latents
    real: torch.Tensor                # (B, n_pix) bank gather
    fresh: torch.Tensor               # (B, n_pix) fresh N(0, n_sig) real-pair channel
    in_real: torch.Tensor | None      # (B, n_pix, d_ch) unit instance noise, real D input
    in_fake: torch.Tensor | None      # (B, n_pix, d_ch) unit instance noise, fake D input
    in_g: torch.Tensor | None         # (S, B, n_pix, d_ch) unit instance noise, G route
    y_real: torch.Tensor              # (B,) real labels (smoothed or 1s)
    y_fake: torch.Tensor              # (B,) fake labels (smoothed or 0s)
    z3: torch.Tensor                  # (S, B, latent) adversarial G-step latents
    z2: torch.Tensor | None = None    # (B, latent) residual-route latents
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
    lecun_normal), move them to ``device`` and build the three Adam states.
    Networks already on the device (a restart) are drawn on the CPU again,
    so a seed gives the same weights on every device."""
    reset_module(generator.cpu(), gen).to(device)
    reset_module(discriminator.cpu(), gen).to(device)
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
    in_shape = (B, real.shape[1], 2 if cfg.pair_discriminator else 1)
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
    z2 = (_uniform(gen, (B, cfg.latent_dim), cfg.latent_low, cfg.latent_high)
          if cfg.residual_route else None)
    z3 = _uniform(gen, (S, B, cfg.latent_dim), cfg.latent_low, cfg.latent_high)
    return GANBatch(z1=z1, real=real, fresh=fresh, in_real=in_real, in_fake=in_fake,
                    in_g=in_g, y_real=y_real, y_fake=y_fake, z3=z3, z2=z2, gen=gen)


def _d_inputs(x_gen, batch: GANBatch, measured, cfg: GANConfig, knobs: GANKnobs):
    """Fake and real D inputs: (waveform, measured − waveform) pairs and
    (bank template, fresh noise) pairs (ref: bbhMahoGANy.py:1267-1289), or
    the raw series as one channel (burst)."""
    if cfg.pair_discriminator:
        fake = torch.stack([x_gen, measured[None, :] - x_gen], dim=-1)
        realp = torch.stack([batch.real, batch.fresh], dim=-1)
    else:
        fake, realp = x_gen[..., None], batch.real[..., None]
    if batch.in_real is not None:
        realp = realp + knobs.instance_noise * batch.in_real
        fake = fake + knobs.instance_noise * batch.in_fake
    return fake, realp


def _global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the 2-norm of all entries (a None grad counts as 0)."""
    return torch.nn.utils.get_total_norm([t for t in tensors if t is not None])


def _grad_norm(module: nn.Module) -> torch.Tensor:
    return _global_norm(p.grad for p in module.parameters())


def _gated_step(opt: torch.optim.Optimizer, update: torch.Tensor):
    """``opt.step()`` kept where the 0-d bool ``update`` holds: the
    parameters, both moments and the count are selected on the device
    (the reference's ``_where_tree``), so a held-back step leaves them bit
    for bit as they were, the state of a fresh optimizer included."""
    init_adam_state(opt)
    kept = [t for g in opt.param_groups for p in g["params"]
            for t in (p, *opt.state[p].values())]
    before = [t.detach().clone() for t in kept]
    opt.step()
    with torch.no_grad():
        for t, b in zip(kept, before):
            torch.where(update, t, b, out=t)


def gan_update(state: GANState, batch: GANBatch, measured: torch.Tensor,
               knobs: GANKnobs | None = None, *, cfg: GANConfig, mesh: DataMesh | None = None):
    """The deterministic half of an iteration, in place: the D update (held
    back, Adam state included, while d_acc ≥ the gate), the residual route
    (``cfg.residual_route``), then the adversarial G update(s). ``mesh``:
    this rank's batch is its share of a data-parallel step.
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
    fake_in, real_in = _d_inputs(x_fake, batch, measured, cfg, knobs)

    # one dropout key drives every D pass of the step in the reference
    # (real, fake and R1's): same masks
    d_masks = replay(batch.gen)
    lr_ = D(real_in, train=True, gen=d_masks())
    lf_ = D(fake_in, train=True, gen=d_masks())
    d_loss = 0.5 * (L.bce_with_logits(lr_, batch.y_real) + L.bce_with_logits(lf_, batch.y_fake))
    if cfg.r1_gamma > 0.0:
        # R1: γ/2·E‖∇ₓ D(x_real)‖² (Mescheder et al. 2018), differentiated
        # again with respect to D's weights
        x_real = real_in.detach().requires_grad_(True)
        gx, = torch.autograd.grad(D(x_real, train=True, gen=d_masks()).sum(), x_real,
                                  create_graph=True)
        r1 = torch.mean(torch.sum(gx**2, dim=tuple(range(1, gx.ndim))))
        d_loss = d_loss + 0.5 * knobs.r1_gamma * r1
    d_acc = 0.5 * (L.binary_accuracy(lr_.detach(), 1.0) + L.binary_accuracy(lf_.detach(), 0.0))
    state.d_opt.zero_grad(set_to_none=True)
    d_loss.backward()
    d_loss = d_loss.detach()
    if mesh is not None:
        mesh.pmean_([p.grad for p in D.parameters()] + [d_loss, d_acc])
    probes = {}
    if cfg.debug_probes:
        probes["d_grad_norm"] = _grad_norm(D)
        probes["x_fake_absmax"] = torch.max(torch.abs(x_fake))
        probes["d_logit_absmax"] = torch.maximum(torch.max(torch.abs(lr_.detach())),
                                                 torch.max(torch.abs(lf_.detach())))
    # automatic D/G balance: hold back the D update (and its Adam moments
    # and count) while D already wins; gate ≥ 1 ⇒ always update
    _gated_step(state.d_opt, d_acc < knobs.d_acc_gate)

    # ---------------- residual route (burst scheme) ---------------------
    res_loss = torch.zeros((), device=d_acc.device)
    if cfg.residual_route:
        # eval mode: dropout off, BN running averages, nothing committed;
        # train mode commits this pass's BN statistics
        res_train = not cfg.res_eval_mode
        x = G(batch.z2, train=res_train, gen=batch.gen, commit_stats=res_train)
        resid = measured[None, :, None] - x
        if cfg.res_spectral_bands > 0:
            rl = L.residual_spectral_loss(resid, cfg.n_sig, cfg.res_spectral_bands)
        else:
            rl = L.residual_moment_loss(resid, cfg.n_sig)
        res_loss = knobs.res_loss_weight * rl
        state.g_res_opt.zero_grad(set_to_none=True)
        res_loss.backward()
        res_loss = res_loss.detach()
        if mesh is not None:
            mesh.pmean_([p.grad for p in G.parameters()] + [res_loss])
        if cfg.debug_probes:
            probes["res_grad_norm"] = _grad_norm(G)
        state.g_res_opt.step()

    # ---------------- generator adversarial step(s) ---------------------
    D.requires_grad_(False)
    try:
        for s in range(batch.z3.shape[0]):
            z3 = batch.z3[s]
            x = G(z3, train=True, gen=batch.gen, commit_stats=True)
            xf = x.reshape(B, -1)
            if cfg.pair_discriminator:
                d_in = torch.stack([xf, measured[None, :] - xf], dim=-1)
            else:
                d_in = x if x.ndim == 3 else xf[..., None]
            if batch.in_g is not None:
                d_in = d_in + knobs.instance_noise * batch.in_g[s]
            logits = D(d_in, train=True, gen=batch.gen)
            if cfg.chi_loss:
                g_loss = L.chisquare_loss(torch.sigmoid(logits), 1.0, cfg.n_sig)
            else:
                g_loss = L.bce_with_logits(logits, 1.0)
            g_loss = knobs.adv_weight * g_loss
            # mode-seeking term: distinct latents must map to distinct
            # waveforms; at weight 0 it adds exactly 0. Computed whenever
            # the batch splits in two (B ≥ 2), as in the reference, whatever
            # the weight: a knob never picks a host branch
            h = B // 2
            if h >= 1:
                num = torch.mean(torch.abs(xf[:h] - xf[h : 2 * h]))
                den = torch.mean(torch.abs(z3[:h] - z3[h : 2 * h])) + 1e-8
                g_loss = g_loss + knobs.diversity_weight / (num / den + 1e-5)
            g_acc = L.binary_accuracy(logits.detach(), 1.0)
            state.g_opt.zero_grad(set_to_none=True)
            g_loss.backward()
            g_loss = g_loss.detach()
            if mesh is not None:
                mesh.pmean_([p.grad for p in G.parameters()] + [g_loss, g_acc])
            if cfg.debug_probes:
                probes["g_grad_norm"] = _grad_norm(G)
            state.g_opt.step()
    finally:
        D.requires_grad_(True)

    if mesh is not None:
        mesh.pmean_(running_stats(G, D))
    if cfg.g_ema_decay > 0.0:
        ema_update(state.g_ema, G, cfg.g_ema_decay)
    state.step += 1
    metrics = {"d_loss": d_loss, "d_acc": d_acc, "g_loss": g_loss,
               "g_acc": g_acc, "res_loss": res_loss}
    if cfg.debug_probes:
        # route-separated gradient norms, state norms and activation
        # extremes: whichever diverges first names the culprit term
        with torch.no_grad():
            var_mins = [torch.min(b) for name, b in G.named_buffers() if "var" in name]
            metrics.update({
                "d_grad_norm": probes["d_grad_norm"],
                "g_grad_norm": probes["g_grad_norm"],
                "res_grad_norm": probes.get("res_grad_norm", torch.zeros((), device=d_acc.device)),
                "g_param_norm": _global_norm(p.detach() for p in G.parameters()),
                "d_param_norm": _global_norm(p.detach() for p in D.parameters()),
                "x_fake_absmax": probes["x_fake_absmax"],
                "d_logit_absmax": probes["d_logit_absmax"],
                "bn_var_min": (torch.min(torch.stack(var_mins)) if var_mins
                               else torch.ones((), device=d_acc.device)),
            })
    return state, metrics


def gan_step(state: GANState, bank: torch.Tensor, measured: torch.Tensor, gen: torch.Generator,
             knobs: GANKnobs | None = None, *, cfg: GANConfig, mesh: DataMesh | None = None):
    """One full alternating GAN iteration (draw, then update). Under a
    ``mesh``, ``bank`` is this rank's block of rows and ``gen`` its stream."""
    batch = draw_gan_batch(gen, bank, cfg)
    return gan_update(state, batch, measured, knobs, cfg=cfg, mesh=mesh)


def make_gan_step(generator: nn.Module, discriminator: nn.Module, cfg: GANConfig,
                  mesh: DataMesh | None = None):
    """One GAN iteration as a step function (the JAX package's
    ``make_gan_step``): ``step(state, bank, measured, gen, knobs=None) →
    (state, metrics)``, the config's knobs by default. ``generator`` and
    ``discriminator`` are the state's modules."""
    base = knobs_from_cfg(cfg)
    return lambda state, bank, measured, gen, knobs=None: gan_step(
        state, bank, measured, gen, base if knobs is None else knobs, cfg=cfg, mesh=mesh)


def state_tensors(state: GANState) -> list:
    """Every tensor a GAN step keeps between iterations."""
    return (graphs.module_tensors(state.generator, state.discriminator)
            + graphs.optimizer_tensors(state.g_opt, state.d_opt, state.g_res_opt)
            + list((state.g_ema or {}).values()))


def make_gan_step_scan(generator: nn.Module, discriminator: nn.Module, cfg: GANConfig,
                       n_steps: int, mesh: DataMesh | None = None):
    """``n_steps`` GAN iterations as one call (the JAX package's
    ``make_gan_step_scan``, a ``lax.scan`` of the step): ``step(state, bank,
    measured, gen, knobs=None) → (state, metrics stacked over the n_steps
    iterations)``. The chunk's knobs (the config's by default) are copied
    into 0-d tensors the step reads. On a card the iterations are replays
    of one captured step (:class:`~gennet_tpu_torch.runtime.graphs.StepGraph`,
    exposed as ``step.graph``), elsewhere eager steps."""
    device = next(generator.parameters()).device
    graph = graphs.StepGraph("GAN step", graphs.graphable(device, mesh, "the GAN step"))
    base = knobs_from_cfg(cfg)
    static = knob_tensors(base, device)

    def step(state, bank, measured, gen, knobs=None):
        knob_tensors(base if knobs is None else knobs, device, into=static)
        start = state.step
        m = graph.run(n_steps,
                      lambda: gan_step(state, bank, measured, gen, static, cfg=cfg, mesh=mesh)[1],
                      lambda: state_tensors(state) + [bank, measured,
                                                      *(getattr(static, f.name)
                                                        for f in fields(GANKnobs))],
                      (gen,))
        state.step = start + n_steps
        return state, m

    step.graph = graph
    return step


def sample_generator(generator: nn.Module, state: GANState, gen: torch.Generator, n: int,
                     cfg: GANConfig, chunk: int = 256, dropout: bool = False,
                     use_ema: bool = True, temp: float = 1.0, bn_mode: str = "eval", z=None):
    """Draw ``n`` waveform estimates (n, n_pix) with the state's weights
    run through ``generator`` (which may differ from ``state.generator`` in
    its dropout rate).

    ``dropout=True`` keeps dropout active (MC-dropout sampling); with it, or
    with ``bn_mode="batch"``, BatchNorm uses the chunk's own statistics,
    without committing them. Draws go in full chunks of ``chunk`` latents,
    as in the reference, so batch statistics see the same batch size.
    ``z``: the latents to use in place of draws from ``gen`` (before
    ``temp``), a whole number of chunks in draw order (a test passes the
    reference's).
    """
    weights = {**dict(state.generator.named_parameters()),
               **dict(state.generator.named_buffers())}
    if use_ema and cfg.g_ema_decay > 0.0 and state.g_ema is not None:
        weights.update(state.g_ema)
    center = 0.5 * (cfg.latent_low + cfg.latent_high)
    kwargs = {"train": dropout, "bn_train": True if bn_mode == "batch" else None, "gen": gen}
    if z is not None:
        z = torch.as_tensor(z, dtype=torch.float32, device=next(iter(weights.values())).device)
        if z.shape[0] < n or z.shape[0] % chunk:
            raise ValueError(f"z has {z.shape[0]} rows: {n} draws take whole chunks of {chunk}")
    outs, done = [], 0
    with torch.no_grad():
        while done < n:
            zc = (_uniform(gen, (chunk, cfg.latent_dim), cfg.latent_low, cfg.latent_high)
                  if z is None else z[done:done + chunk])
            if temp != 1.0:
                zc = center + temp * (zc - center)
            out = torch.func.functional_call(generator, weights, (zc,), kwargs)
            outs.append(out.reshape(chunk, -1))
            done += chunk
    return torch.cat(outs)[:n]
