"""The ``bbh_bf16`` family's plain networks and GAN iteration: GenNet's own
BBH GAN (``reference/bbh_pair.py``) under ``--bf16``, with the roundings of
the JAX package's ``dtype=jnp.bfloat16`` modules (flax's dtype policy;
``gennet_tpu/models/generator.py``, ``discriminator.py``):

- G's Dense and Conv_0-4 and D's convs cast their input, weight and bias
  to bfloat16, multiply with float32 accumulation (the library's own, as
  XLA's and cuDNN's bfloat16 products do), round the product to bfloat16
  and add the bias to that rounded product, in bfloat16.
- The BatchNorms take bfloat16 in, reduce and normalise in float32 (the
  batch statistics, the running averages moved from them, scale and bias)
  and return bfloat16.
- tanh, the upsampling, dropout and LeakyReLU act on bfloat16 values;
  dropout's masks are float32 uniforms against the rate, whatever the
  dtype (``reference/nets.py``).
- G's output conv and D's Dense compute in float32 (their input cast up),
  so G's output and D's logits are float32; the pair (x, h − x), the
  instance noise, the losses, the gradients into the float32 parameters
  and Adam are float32.

The harness runs it with TF32 off (``benchmark/harness/loops.py::reference``:
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False), so its float32 parts are
float32.

Departures from the JAX definition:

- XLA may keep a fused intermediate in float32 (``xla_allow_excess_precision``,
  on by default): a conv's product before its bias add, an activation
  between two elementwise ops. This file rounds at every op, as eager
  PyTorch does; so does the program.
- The batch variance is taken in two passes (``reference/bbh_pair.py``);
  flax takes E[x²] − E[x]² and the program ``torch.var_mean``: the same
  quantity in float32, summed in other orders.

``GANRun(..., fault="float32")`` is the float32 switch: every layer computes
in float32, as ``reference/bbh_pair.py`` does, which is what a program that
dropped bf16 would compute (the calibration's control); ``"half_batch"`` is
``steps.GANRun``'s.
"""

from functools import partial
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import bbh_pair
from .bbh import reference_data  # noqa: F401  (the family's data)
from .bbh_pair import param_specs  # noqa: F401  (the family's parameter sets)
from .nets import dropout, flat_cl

BF16, F32 = torch.bfloat16, torch.float32


def conv(x, w, b, dtype, stride=1):
    """A SAME conv computing in ``dtype``: the input padded, then input,
    weight and bias cast; below float32 the bias is added to the rounded
    product."""
    L, K = x.shape[-1], w.shape[-1]
    total = max((-(-L // stride) - 1) * stride + K - L, 0)
    x, w, b = (t.to(dtype) for t in (F.pad(x, (total // 2, total - total // 2)), w, b))
    if dtype == F32:
        return F.conv1d(x, w, b, stride=stride)
    return F.conv1d(x, w, stride=stride) + b[:, None]


def dense(x, P, name, dtype):
    x, w, b = (t.to(dtype) for t in (x, P[f"{name}.weight"], P[f"{name}.bias"]))
    return F.linear(x, w, b) if dtype == F32 else F.linear(x, w) + b


def batch_norm(x, P, stats, name, commit, momentum, dtype):
    """``bbh_pair.batch_norm`` in float32, its result in ``dtype``."""
    return bbh_pair.batch_norm(x.to(F32), P, stats, name, commit, momentum).to(dtype)


def generator(net, P, z, n_pix, masks, stats, commit, dtype=BF16):
    """G(z) in train mode → (B, n_pix, 1) float32 (``bbh_pair.generator``
    computing in ``dtype``)."""
    B, m = z.shape[0], net["bn_momentum"]
    x = batch_norm(dense(z, P, "dense", dtype), P, stats, "norms.0", commit, m, dtype)
    x = dropout(torch.tanh(x), net["drate"], masks)
    x = x.view(B, n_pix // 2, 256).transpose(1, 2)
    for i in range(len(net["features"])):
        if i <= 1:
            x = torch.repeat_interleave(x, 2, dim=-1)
        x = conv(x, P[f"convs.{i}.weight"], P[f"convs.{i}.bias"], dtype, 2 if i == 0 else 1)
        x = batch_norm(x, P, stats, f"norms.{i + 1}", commit, m, dtype)
        x = dropout(torch.tanh(x), net["drate"], masks)
    return conv(x, P["out_conv.weight"], P["out_conv.bias"], F32).transpose(1, 2)


def discriminator(net, P, x, masks=None, dtype=BF16):
    """D(x (B, n_pix, in_ch) float32) → (B, 1) float32 logits, its convs in
    ``dtype``."""
    x = x.transpose(1, 2)
    for i in range(len(net["features"])):
        x = F.leaky_relu(conv(x, P[f"convs.{i}.weight"], P[f"convs.{i}.bias"], dtype, 2),
                         negative_slope=net["alpha"])
        x = dropout(x, net["drate"], masks)
    return dense(flat_cl(x), P, "dense", F32)


class GANRun(bbh_pair.GANRun):
    """``bbh_pair.GANRun`` over this file's networks, in bfloat16, or in
    float32 with ``fault="float32"``."""

    def __init__(self, net, cfg, weights, data, gen, fault=None):
        dtype = F32 if fault == "float32" else BF16
        super().__init__(net, cfg, weights, data, gen, None if fault == "float32" else fault)
        self.net = SimpleNamespace(generator=partial(generator, dtype=dtype),
                                   discriminator=partial(discriminator, dtype=dtype))
