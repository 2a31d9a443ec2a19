"""The layers of the plain networks, float32, and the benchmark's weights.

Each family's networks are in a file of its own (``reference/<family>.py``:
``generator``, ``discriminator``, ``pe`` and ``param_specs``), built from
these layers. Parameter names are the checkpoint names of the program's
modules (its ``state_dict`` keys), so one dict of weights made by the
benchmark loads into both sides. Layout: (B, L, C) in and out, (B, C, L)
inside.

Dropout keeps an element where a float32 uniform from the generator is at
least the rate; Gaussian dropout multiplies by 1 + σ·N(0, 1), σ² =
rate/(1 − rate). Masks and noise are drawn layer by layer in forward
order, so a pass draws what the program's pass draws.
"""

import math

import torch
import torch.nn.functional as F


def out_len(L: int, k: int, s: int, padding: str) -> int:
    return -(-L // s) if padding == "SAME" else (L - k) // s + 1


# ---------------------------------------------------------------- layers


def conv(x, w, b, stride=1, padding="SAME"):
    if padding == "SAME":
        L, K = x.shape[-1], w.shape[-1]
        total = max((-(-L // stride) - 1) * stride + K - L, 0)
        x = F.pad(x, (total // 2, total - total // 2))
    return F.conv1d(x, w, b, stride=stride)


def dense(x, P, name):
    return F.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def group_norm(x, P, name, group=16):
    """GroupNorm over groups of ``group`` channels, ε 1e-6."""
    return F.group_norm(x, x.shape[1] // group, P[f"{name}.weight"], P[f"{name}.bias"], 1e-6)


def dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    keep = gen(x.shape) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def gaussian_dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    return x * (1.0 + math.sqrt(rate / (1.0 - rate)) * gen(x.shape, normal=True))


def flat_cl(x):
    """(B, C, L) → (B, L·C), channels last."""
    return x.movedim(1, -1).reshape(x.shape[0], -1)


# ---------------------------------------------------------- parameter sets


def conv_spec(name, cin, cout, k=5):
    return [(f"{name}.weight", (cout, cin, k), cin * k), (f"{name}.bias", (cout,), 0)]


def dense_spec(name, fin, fout):
    return [(f"{name}.weight", (fout, fin), fin), (f"{name}.bias", (fout,), 0)]


def norm_spec(name, c):
    return [(f"{name}.weight", (c,), -1), (f"{name}.bias", (c,), 0)]


def make_weights(specs, gen: torch.Generator, device) -> dict:
    """Weights from ``gen`` in one draw: lecun-normal kernels (a normal of
    variance 1/fan_in clipped at ±2σ), zero biases, unit norm scales.
    ``specs``: [(name, shape, fan_in)]; fan_in > 0: a kernel; 0: zeros;
    −1: ones."""
    total = sum(math.prod(s) for _, s, f in specs if f > 0)
    buf = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape, fan_in in specs:
        if fan_in > 0:
            k = math.prod(shape)
            out[name] = (buf[at:at + k] * (1.0 / math.sqrt(fan_in))).view(shape)
            at += k
        else:
            out[name] = torch.full(shape, 1.0 if fan_in < 0 else 0.0, device=device)
    return out
