"""CNN point-estimator training (port of ``gennet_tpu.train.cnn``).

Random bank batch, noise augmentation of the first ``noise_frac`` of the
batch with N(0, U(0, 5)) (ref: bbhMahoGANy.py:1160-1161), multi-output MSE
on (mc, q), Adam(b1 = 0.5) with optax's cosine decay, and an EMA of the
parameters for evaluation. On the CPU the decay is a ``LambdaLR``; on a
card Adam is the capturable form and the decay an expression of its step
count on the device, so that :func:`make_cnn_step_scan` can replay the
step as a CUDA graph (:mod:`gennet_tpu_torch.runtime.graphs`).

The state owns its module and updates it in place, so the step functions
take no separate ``model`` argument. Randomness comes from an explicit
``torch.Generator``; :func:`draw_cnn_batch` consumes all of it, so a batch
made elsewhere (e.g. with numpy) drives :func:`cnn_update` unchanged.
With a :class:`~gennet_tpu_torch.train.mesh.DataMesh` the update is the
reference's data-parallel step: gradients and the loss averaged across the
ranks, BatchNorm's running statistics averaged after the step.
"""

import math
from dataclasses import dataclass

import torch
from torch import nn

from gennet_tpu_torch.models.layers import reset_module
from gennet_tpu_torch.runtime import graphs, trace
from gennet_tpu_torch.runtime.optim import adam
from gennet_tpu_torch.train import losses as L
from gennet_tpu_torch.train.mesh import DataMesh, running_stats


@dataclass(frozen=True)
class CNNConfig:
    n_pix: int = 1024
    batch_size: int = 8                 # ref pe_batch_size, :87
    lr: float = 9e-5                    # ref: :98
    beta1: float = 0.5
    noise_frac: float = 1.0 / 8.0       # noisy fraction (ref: :113)
    noise_scale_max: float = 5.0        # N(0, U(0,5)) augmentation (ref: :1161)
    max_normalize: bool = False         # the burst workload's batch-max
                                        # normalisation (ref: burstMahoGANy.py:738)
    max_per_sample: bool = False        # normalise by each sample's max instead
    ema_decay: float = 0.0              # EMA of params for evaluation (0 = off)
    lr_decay_steps: int = 0             # >0: cosine-decay the LR over this many
    lr_min_frac: float = 0.1            # steps to lr·lr_min_frac
    npar: int = 2


def normalize_max(x: torch.Tensor, cfg: CNNConfig) -> torch.Tensor:
    """The burst workload's max normalisation (ref: burstMahoGANy.py:738):
    by the batch's max by default, by each sample's when
    ``cfg.max_per_sample``, the identity when ``cfg.max_normalize`` is off."""
    if not cfg.max_normalize:
        return x
    if cfg.max_per_sample:
        return x / (torch.amax(x, dim=tuple(range(1, x.ndim)), keepdim=True) + 1e-12)
    return x / torch.max(x)


def cosine_decay(decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule's multiplier as a function of the update
    count (evaluated before the count increments, as optax does)."""
    def f(count: int) -> float:
        c = min(count, decay_steps)
        return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha
    return f


def _decay_lr_(opt: torch.optim.Optimizer, cfg: CNNConfig):
    """What ``LambdaLR(cosine_decay)`` does after an update, on the device:
    lr ← cfg.lr · cosine_decay(count), count being Adam's step count (the
    updates done), in float32."""
    group = opt.param_groups[0]
    c = torch.clamp(opt.state[group["params"][0]]["step"], max=float(cfg.lr_decay_steps))
    alpha = cfg.lr_min_frac
    f = (1.0 - alpha) * 0.5 * (1.0 + torch.cos(math.pi * c / cfg.lr_decay_steps)) + alpha
    group["lr"].copy_(cfg.lr * f)


@dataclass
class CNNState:
    model: nn.Module
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LRScheduler | None
    ema: dict | None = None       # EMA of parameters; None ⇒ equal to params
    step: int = 0


def init_cnn(gen: torch.Generator, model: nn.Module, cfg: CNNConfig, device) -> CNNState:
    """Initialise ``model`` (flax's lecun_normal from ``gen``, a CPU
    generator), move it to ``device`` and build its optimiser."""
    reset_module(model, gen).to(device)
    opt = adam(model.parameters(), cfg.lr, cfg.beta1)
    # on a card the decay is _decay_lr_, on the device
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(cfg.lr_decay_steps,
                                                                 cfg.lr_min_frac))
             if cfg.lr_decay_steps > 0 and not opt.defaults["capturable"] else None)
    return CNNState(model=model, opt=opt, sched=sched)


def draw_cnn_batch(gen: torch.Generator, bank: torch.Tensor, targets: torch.Tensor,
                   cfg: CNNConfig):
    """Gather a batch, augment it, then max-normalise it (when
    ``cfg.max_normalize``). Returns (x (B, n_pix, 1), y (B, npar))."""
    B = cfg.batch_size
    idx = torch.randint(0, bank.shape[0], (B,), generator=gen, device=gen.device).to(bank.device)
    x = bank[idx]
    y = targets[idx]
    # one noise scale per batch on the first noise_frac of the samples
    n_noisy = int(B * cfg.noise_frac)
    if n_noisy > 0:
        scale = cfg.noise_scale_max * torch.rand((), generator=gen, device=gen.device)
        noise = torch.randn((B, x.shape[1]), generator=gen, device=gen.device, dtype=x.dtype)
        mask = (torch.arange(B, device=x.device) < n_noisy).to(x.dtype)[:, None]
        x = x + mask * (scale * noise).to(x.device)
    return normalize_max(x, cfg)[..., None], y


def param_copy(model: nn.Module) -> dict:
    """Detached copies of ``model``'s parameters, by name (an EMA's start)."""
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def ema_update(ema: dict, model: nn.Module, decay: float):
    """ema ← decay·ema + (1 − decay)·params, in place."""
    live = dict(model.named_parameters())
    keys = list(ema)
    with torch.no_grad():
        torch._foreach_lerp_([ema[k] for k in keys], [live[k].detach() for k in keys],
                             1.0 - decay)


def cnn_update(state: CNNState, x: torch.Tensor, y: torch.Tensor, *, cfg: CNNConfig,
               gen: torch.Generator | None = None, mesh: DataMesh | None = None):
    """One MSE update on a materialised batch, in place; a model with
    dropout (``CombinedPE``) draws its mask from ``gen``; ``mesh``: this
    rank's batch is its share of a data-parallel step. Returns
    (state, {"pe_loss": 0-d tensor})."""
    model = state.model
    if cfg.ema_decay > 0.0 and state.ema is None:
        state.ema = param_copy(model)
    state.opt.zero_grad(set_to_none=True)
    loss = L.mse_multi_output(model(x, train=True, gen=gen), y)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        mesh.pmean_([p.grad for p in model.parameters()] + [loss])
    state.opt.step()
    if state.sched is not None:
        state.sched.step()
    elif cfg.lr_decay_steps > 0 and state.opt.defaults["capturable"]:
        _decay_lr_(state.opt, cfg)
    if mesh is not None:
        mesh.pmean_(running_stats(model))
    if cfg.ema_decay > 0.0:
        ema_update(state.ema, model, cfg.ema_decay)
    state.step += 1
    return state, {"pe_loss": loss}


def cnn_step(state: CNNState, bank: torch.Tensor, targets: torch.Tensor, gen: torch.Generator,
             *, cfg: CNNConfig, mesh: DataMesh | None = None):
    """One CNN PE iteration: draw a batch, then update. Under a ``mesh``,
    ``bank`` and ``targets`` are this rank's block of rows and ``gen`` its
    stream."""
    x, y = draw_cnn_batch(gen, bank, targets, cfg)
    return cnn_update(state, x, y, cfg=cfg, gen=gen, mesh=mesh)


def make_cnn_step(model: nn.Module, cfg: CNNConfig, mesh: DataMesh | None = None):
    """One CNN iteration as a step function (the JAX package's
    ``make_cnn_step``): ``step(state, bank, targets, gen) → (state,
    metrics)``. ``model`` is the state's module."""
    return lambda state, bank, targets, gen: cnn_step(state, bank, targets, gen, cfg=cfg,
                                                      mesh=mesh)


def state_tensors(state: CNNState) -> list:
    """Every tensor a CNN step keeps between iterations."""
    return (graphs.module_tensors(state.model) + graphs.optimizer_tensors(state.opt)
            + list((state.ema or {}).values()))


def make_cnn_step_scan(model: nn.Module, cfg: CNNConfig, n_steps: int,
                       mesh: DataMesh | None = None):
    """``n_steps`` CNN iterations as one call (the JAX package's
    ``make_cnn_step_scan``, a ``lax.scan`` of the step): ``step(state,
    bank, targets, gen) → (state, metrics stacked over the n_steps
    iterations)``. On a card the iterations are replays of one captured
    step (:class:`~gennet_tpu_torch.runtime.graphs.StepGraph`, exposed as
    ``step.graph``), elsewhere eager steps. Each call records a ``chunk``
    span (:mod:`~gennet_tpu_torch.runtime.trace`)."""
    device = next(model.parameters()).device
    graph = graphs.StepGraph("CNN step", graphs.graphable(device, mesh, "the CNN step"))

    def step(state, bank, targets, gen):
        with trace.span("chunk", graph=graph.name, n=n_steps):
            start = state.step
            m = graph.run(n_steps,
                          lambda: cnn_step(state, bank, targets, gen, cfg=cfg, mesh=mesh)[1],
                          lambda: state_tensors(state) + [bank, targets], (gen,))
            state.step = start + n_steps
        return state, m

    step.graph = graph
    return step


def predict(state: CNNState, x: torch.Tensor, gen: torch.Generator | None = None,
            chunk: int = 512, use_ema: bool = False):
    """Chunked inference (chunking bounds activation memory: the PE nets
    carry 1024-channel activations), with dropout off except in
    PermaDropout models, which draw their masks from ``gen`` and need it.
    ``use_ema`` evaluates the EMA parameters."""
    model = state.model
    x = x[..., None] if x.ndim == 2 else x
    params = state.ema if (use_ema and state.ema is not None) else None
    kwargs = {"train": False} if gen is None else {"train": False, "gen": gen}
    outs = []
    with torch.no_grad():
        for i in range(0, x.shape[0], chunk):
            xb = x[i : i + chunk]
            if params is None:
                outs.append(model(xb, **kwargs))
            else:
                outs.append(torch.func.functional_call(model, params, (xb,), kwargs))
    if not outs:
        return torch.zeros((0, 2), device=x.device)
    return torch.cat(outs)
