"""Building blocks matching flax's layers in parameters, numerics and init.

Layout: the networks keep the JAX package's public layouts ((B, L, C) in,
(B, L, C) out) and run (B, C, L) inside, which is what ``F.conv1d`` takes.
Parameter init follows flax: lecun_normal (a normal truncated at ±2σ,
variance 1/fan_in) for kernels, zeros for biases, drawn from an explicit
``torch.Generator``.

Reduced precision follows flax's policy through explicit casts (no
``torch.autocast``, whose op lists differ from flax's): a layer built with
``compute_dtype`` computes in it, while its parameters and running
statistics stay float32. :class:`Dense` and :class:`Conv1d` cast input,
weight and bias to the compute dtype and return it (flax
``promote_dtype``), adding the bias after the product is rounded to a
reduced dtype, as flax does; the norms reduce their statistics and
normalise in float32 and return the compute dtype (flax ``_normalize``
with ``force_float32_reductions``); :class:`PallasConv1d` always runs
the float32 kernel, as ``PallasConv1D`` does.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gennet_tpu_torch.ops import conv1d as conv1d_ops

# std of a unit normal truncated to [−2, 2]; flax divides by it so the
# truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator | None = None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return w


def _cast(dtype: torch.dtype, *tensors):
    return tuple(t.to(dtype) for t in tensors)


class Dense(nn.Linear):
    """``nn.Linear`` with flax's init (weight (out, in) = kernelᵀ), computing
    in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        return F.linear(x, w, b) if b.dtype == torch.float32 else F.linear(x, w) + b

    def reset_parameters(self, gen: torch.Generator | None = None):
        lecun_normal_(self.weight, self.in_features, gen)
        nn.init.zeros_(self.bias)


class Conv1d(nn.Module):
    """1-D convolution with flax padding semantics on (B, C, L) tensors.

    ``padding="SAME"`` pads ``pad_total = max((ceil(L/s)−1)·s + K − L, 0)``
    split low ``pad_total // 2``, high the rest (asymmetric at stride 2:
    (1, 2) for K = 5 and even L, where a symmetric ``padding=2`` would shift
    the output by one sample). ``"VALID"`` pads nothing. Weight layout
    (Cout, Cin, K) = flax kernel (K, Cin, Cout) transposed. Computes in
    ``compute_dtype``.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 1,
                 padding: str = "SAME", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters()

    def reset_parameters(self, gen: torch.Generator | None = None):
        lecun_normal_(self.weight, self.weight.shape[1] * self.kernel_size, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.padding == "SAME":
            L, K, s = x.shape[-1], self.kernel_size, self.stride
            out_len = -(-L // s)
            pad_total = max((out_len - 1) * s + K - L, 0)
            x = F.pad(x, (pad_total // 2, pad_total - pad_total // 2))
        x, w, b = _cast(self.compute_dtype, x, self.weight, self.bias)
        if b.dtype == torch.float32:
            return F.conv1d(x, w, b, stride=self.stride)
        return F.conv1d(x, w, stride=self.stride) + b[:, None]


class PallasConv1d(Conv1d):
    """SAME 1-D convolution through the port's conv1d kernel (port of
    ``PallasConv1D``): :class:`~gennet_tpu_torch.ops.conv1d.Conv1dTrain`
    at the layer's stride, which the kernel computes natively. Its
    parameters are :class:`Conv1d`'s (weight (Cout, Cin, K), bias), so
    converted weights and saved ``state_dict``s work under either
    implementation. Linear float32 output: the input is cast to float32, so
    the kernel runs float32 whatever the model's compute dtype (the JAX
    module's ``jnp.asarray(x, jnp.float32)``), and bf16 never reaches
    cuDNN."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding="SAME")

    def forward(self, x):
        return conv1d_ops.conv1d_train(x.float(), self.weight, self.bias, self.stride)


def conv1d_layer(impl: str, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32) -> Conv1d:
    """The conv implementation of the models' hot layers: ``"xla"`` →
    :class:`Conv1d` (cuDNN) in ``compute_dtype``, ``"pallas"`` →
    :class:`PallasConv1d` (the port's kernel, float32 whatever
    ``compute_dtype`` is). The names are the JAX package's ``conv_impl``
    values."""
    if impl == "pallas":
        return PallasConv1d(in_ch, out_ch, kernel_size, stride)
    if impl == "xla":
        return Conv1d(in_ch, out_ch, kernel_size, stride, compute_dtype=compute_dtype)
    raise ValueError(f"conv_impl must be 'xla' or 'pallas', got {impl!r}")


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` semantics.

    - In batch-statistics mode it normalises with the batch mean and the
      biased batch variance, reduced over every axis but ``channel_dim``.
    - The running averages take the BIASED variance with flax's
      ``momentum`` (0.99 here = torch momentum 0.01), and are updated only
      when the caller asks (``commit=True``): a forward pass in batch mode
      can be run without advancing the state, as the GAN's D step needs.
    - In running-average mode it normalises with the stored statistics.
    - It reduces and normalises in float32 and returns ``compute_dtype``.
    """

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5,
                 channel_dim: int = 1, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.channel_dim = momentum, eps, channel_dim
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(features))   # flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, gen: torch.Generator | None = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, batch_stats: bool, commit: bool = False):
        x = x.float()
        shape = [1] * x.ndim
        shape[self.channel_dim] = -1
        if batch_stats:
            dims = [d for d in range(x.ndim) if d != self.channel_dim]
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            if commit:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                    self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.compute_dtype)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm(group_size=16)``: groups of 16 consecutive
    channels (``channel_dim`` 1), epsilon 1e-6, scale and bias per channel
    (flax "scale" → ``weight``). Batch-independent, so it has no running
    statistics; :class:`BatchNorm`'s mode arguments are accepted and
    change nothing. Computes in float32, returns ``compute_dtype``."""

    def __init__(self, features: int, group_size: int = 16, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32):
        if features % group_size:
            raise ValueError(f"{features} channels do not split into groups of {group_size}")
        super().__init__(features // group_size, features, eps=eps)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, gen: torch.Generator | None = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x, batch_stats: bool = False, commit: bool = False):
        return super().forward(x.float()).to(self.compute_dtype)


class NoNorm(nn.Module):
    """The identity in a norm's place (``norm="none"``), with
    :class:`BatchNorm`'s call signature."""

    def forward(self, x, batch_stats: bool = False, commit: bool = False):
        return x


def norm_layer(kind: str, features: int, momentum: float,
               compute_dtype: torch.dtype = torch.float32) -> nn.Module:
    """The generator's normalisation: ``"batch"`` (:class:`BatchNorm`),
    ``"group"`` (:class:`GroupNorm`) or ``"none"``."""
    if kind == "batch":
        return BatchNorm(features, momentum, compute_dtype=compute_dtype)
    if kind == "group":
        return GroupNorm(features, compute_dtype=compute_dtype)
    if kind == "none":
        return NoNorm()
    raise ValueError(f"norm must be 'batch', 'group' or 'none', got {kind!r}")


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one scalar slope for all inputs, initialised to
    0.01 (torch's default is 0.25)."""

    def __init__(self, init: float = 0.01):
        super().__init__()
        self.init = init
        self.negative_slope = nn.Parameter(torch.tensor(init))

    def reset_parameters(self, gen: torch.Generator | None = None):
        with torch.no_grad():
            self.negative_slope.fill_(self.init)

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


def dropout(x: torch.Tensor, rate: float, active: bool, gen: torch.Generator | None):
    """flax ``nn.Dropout``: keep with probability 1 − rate and rescale, in
    x's dtype. The mask comes from ``gen`` (which must live on x's device)
    as float32 uniforms whatever x's dtype, as flax's does, so a seed
    reproduces the draw at every compute dtype."""
    if not active or rate == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout is active but no torch.Generator was given")
    if isinstance(gen, SharedMasks):
        keep = gen.keep(x.shape, x.device, rate)
    else:
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class GaussianDropout(nn.Module):
    """Keras ``GaussianDropout`` (port of ``models.layers.GaussianDropout``;
    ref: burstMahoGANy.py:174,181,188,195): multiplies by N(1, rate/(1 − rate))
    noise drawn from ``gen`` (on x's device) while training, and is the
    identity otherwise or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        if not train or self.rate == 0.0:
            return x
        if gen is None:
            raise ValueError("GaussianDropout is active but no torch.Generator was given")
        sigma = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + sigma * torch.randn(x.shape, generator=gen, device=x.device,
                                              dtype=x.dtype))


class PermaDropout(nn.Module):
    """Dropout that stays on at inference (port of
    ``models.layers.PermaDropout``; ref: ganymede.py:67-72): every call
    keeps each element with probability 1 − rate and rescales it by
    1/(1 − rate), with the mask drawn from ``gen``, in training and in
    evaluation alike. The MC-dropout PEs draw a posterior from repeated
    calls. It refuses to run without a generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, gen: torch.Generator | None):
        if gen is None:
            raise ValueError("PermaDropout is always active, and no torch.Generator was given")
        return dropout(x, self.rate, True, gen)


class SharedMasks:
    """The dropout masks of one set of passes through a network: the first
    pass draws each :func:`dropout` mask from ``gen`` and records it, and
    every later pass (see :func:`replay`) takes the recorded masks in the
    same order. So the generator advances once, by exactly what one pass
    draws, and nothing is rewound: a CUDA-graph capture records it as it
    runs eagerly."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self._masks = []
        self._next = 0

    def rewind(self) -> "SharedMasks":
        self._next = 0
        return self

    def keep(self, shape, device, rate: float) -> torch.Tensor:
        if self._next < len(self._masks):
            keep = self._masks[self._next]
            if keep.shape != shape:
                raise ValueError(f"a replayed pass asks for a mask of shape {tuple(shape)} where "
                                 f"the first pass drew {tuple(keep.shape)}")
        else:
            keep = torch.rand(shape, generator=self.gen, device=device) >= rate
            self._masks.append(keep)
        self._next += 1
        return keep


def replay(gen: torch.Generator | None):
    """A callable that starts one more pass on the same dropout masks: the
    first pass draws them from ``gen``, the later ones reuse them
    (:class:`SharedMasks`), as the reference drives several passes with one
    dropout key. ``None`` stays ``None``."""
    if gen is None:
        return lambda: None
    return SharedMasks(gen).rewind


class Conv2d(nn.Module):
    """2-D convolution at stride 1 with flax padding on (B, C, H, W)
    tensors: ``"SAME"`` pads K − 1 per axis, low (K − 1) // 2 and high the
    rest; ``"VALID"`` pads nothing. Weight (Cout, Cin, kh, kw) = flax's
    kernel (kh, kw, Cin, Cout) transposed; flax's lecun_normal with fan_in
    Cin·kh·kw."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.kernel_size, self.padding = kernel_size, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.reset_parameters()

    def reset_parameters(self, gen: torch.Generator | None = None):
        lecun_normal_(self.weight, self.weight.shape[1] * self.kernel_size**2, gen)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.padding == "SAME":
            lo = (self.kernel_size - 1) // 2
            hi = self.kernel_size - 1 - lo
            x = F.pad(x, (lo, hi, lo, hi))
        return F.conv2d(x, self.weight, self.bias)


def upsample1d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Keras UpSampling1D on (B, C, L): repeat each sample along L
    (ref: bbhMahoGANy.py:249,258)."""
    return torch.repeat_interleave(x, factor, dim=-1)


def upsample2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest upsampling of (B, C, H, W) on both axes: the image
    generator's ``jnp.repeat`` along H, then along W."""
    return torch.repeat_interleave(torch.repeat_interleave(x, factor, dim=-2), factor, dim=-1)


def activation(name: str):
    return {
        "tanh": torch.tanh,
        "relu": F.relu,
        "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.2),
        "linear": lambda x: x,
        "sigmoid": torch.sigmoid,
        "elu": F.elu,
    }[name]


def channels_last_flatten(x: torch.Tensor) -> torch.Tensor:
    """Flatten (B, C, L) or (B, C, H, W) in flax's channels-last order,
    index l·C + c or (h·W + w)·C + c, so a converted Dense kernel applies
    unchanged."""
    return x.movedim(1, -1).reshape(x.shape[0], -1)


def reset_module(module: nn.Module, gen: torch.Generator | None = None) -> nn.Module:
    """Re-initialise every layer of ``module`` from ``gen``, in the order
    the layers were registered."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return module
