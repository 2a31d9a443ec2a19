"""Flax parameter trees → PyTorch ``state_dict``s for G, D and the CNN PE,
of the flagship, of the burst ``smoke`` workload and of the variant
generations (the image models, the softmax, transpose and denoiser GANs,
the MC-dropout PE and the signal autoencoder).

Inputs are nested dicts of numpy arrays (as ``jax.device_get`` returns
them); outputs are ``{name: torch.Tensor}`` for ``load_state_dict``. The
layout rules:

- Dense kernel (in, out) → ``Linear.weight`` (out, in). The models flatten
  in flax's channels-last order, so the kernel needs no permutation.
- Conv kernel (K, Cin, Cout) → ``Conv1d.weight`` (Cout, Cin, K); 2-D
  kernel (kh, kw, Cin, Cout) → ``Conv2d.weight`` (Cout, Cin, kh, kw). A
  stride-1 SAME ``nn.ConvTranspose`` kernel converts as a conv kernel (see
  ``TransposeGenerator``).
- BatchNorm scale/bias → weight/bias; batch_stats mean/var →
  running_mean/running_var. GroupNorm scale/bias → weight/bias.
- PReLU negative_slope (a scalar) → negative_slope.
"""

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(np.asarray(a, np.float32)))


def _dense(p, prefix):
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T), f"{prefix}.bias": _t(p["bias"])}


def _conv(p, prefix):
    k = np.asarray(p["kernel"])
    return {f"{prefix}.weight": _t(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))),
            f"{prefix}.bias": _t(p["bias"])}


def _prefixed(sd: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _bn(p, s, prefix):
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"]),
            f"{prefix}.running_mean": _t(s["mean"]), f"{prefix}.running_var": _t(s["var"])}


def _gn(p, prefix):
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def flax_to_torch_generator(params, batch_stats=None) -> dict:
    """BBHGenerator: Dense_0, BatchNorm_0..n (``norm="batch"``) or
    GroupNorm_0..n (``"group"``) or no norm (``"none"``), Conv_0..n (the
    last is the 1-channel output conv)."""
    n_conv = sum(1 for k in params if k.startswith("Conv_"))
    sd = _dense(params["Dense_0"], "dense")
    for i in range(n_conv):
        if f"BatchNorm_{i}" in params:
            sd.update(_bn(params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"], f"norms.{i}"))
        elif f"GroupNorm_{i}" in params:
            sd.update(_gn(params[f"GroupNorm_{i}"], f"norms.{i}"))
    for i in range(n_conv - 1):
        sd.update(_conv(params[f"Conv_{i}"], f"convs.{i}"))
    sd.update(_conv(params[f"Conv_{n_conv - 1}"], "out_conv"))
    return sd


def flax_to_torch_discriminator(params, batch_stats=None) -> dict:
    """PairDiscriminator: Conv_0..n, Dense_0 (no batch stats)."""
    n_conv = sum(1 for k in params if k.startswith("Conv_"))
    sd = _dense(params["Dense_0"], "dense")
    for i in range(n_conv):
        sd.update(_conv(params[f"Conv_{i}"], f"convs.{i}"))
    return sd


def flax_to_torch_pe(params, batch_stats=None) -> dict:
    """DualBranchPE: Conv_0..3 + Dense_0 (mc branch), Conv_4..8 + Dense_1
    (q branch), in flax's creation order."""
    sd = _dense(params["Dense_0"], "mc_dense")
    sd.update(_dense(params["Dense_1"], "q_dense"))
    for i in range(4):
        sd.update(_conv(params[f"Conv_{i}"], f"mc_convs.{i}"))
    for i in range(5):
        sd.update(_conv(params[f"Conv_{4 + i}"], f"q_convs.{i}"))
    return sd


def flax_to_torch_combined_pe(params, batch_stats) -> dict:
    """CombinedPE: Conv_0..3, PReLU_0..3, BatchNorm_0..3 (one of each per
    block), Dense_0, PReLU_4, Dense_1."""
    sd = {**_dense(params["Dense_0"], "dense0"), **_dense(params["Dense_1"], "dense1"),
          "prelu_out.negative_slope": _t(params["PReLU_4"]["negative_slope"])}
    for i in range(4):
        sd.update(_conv(params[f"Conv_{i}"], f"convs.{i}"))
        sd[f"prelus.{i}.negative_slope"] = _t(params[f"PReLU_{i}"]["negative_slope"])
        sd.update(_bn(params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"], f"norms.{i}"))
    return sd


def flax_to_torch_burst_generator(params, batch_stats=None) -> dict:
    """BurstGenerator: Dense_0, Conv_0..n (the last is the 1-channel output
    conv); no batch stats."""
    n_conv = sum(1 for k in params if k.startswith("Conv_"))
    sd = _dense(params["Dense_0"], "dense")
    for i in range(n_conv - 1):
        sd.update(_conv(params[f"Conv_{i}"], f"convs.{i}"))
    sd.update(_conv(params[f"Conv_{n_conv - 1}"], "out_conv"))
    return sd


def flax_to_torch_burst_discriminator(params, batch_stats=None) -> dict:
    """BurstDiscriminator: Conv_0, Conv_1, Dense_0, Dense_1."""
    return {**_conv(params["Conv_0"], "conv0"), **_conv(params["Conv_1"], "conv1"),
            **_dense(params["Dense_0"], "dense0"), **_dense(params["Dense_1"], "dense1")}


def flax_to_torch_burst_pe(params, batch_stats=None) -> dict:
    """BurstPE: Conv_0, Conv_1, Dense_0, Dense_1 (the same names as
    BurstDiscriminator's)."""
    return flax_to_torch_burst_discriminator(params)


def flax_to_torch_image_discriminator(params, batch_stats=None) -> dict:
    """ImageDiscriminator, ImagePE and ImageMCDropoutPE (their 2-D convs)
    and MCDropoutPE (1-D): Conv_0, Conv_1, Dense_0, Dense_1, the names of
    BurstDiscriminator's."""
    return flax_to_torch_burst_discriminator(params)


flax_to_torch_image_pe = flax_to_torch_image_discriminator
flax_to_torch_image_mc_pe = flax_to_torch_image_discriminator
flax_to_torch_mc_dropout_pe = flax_to_torch_image_discriminator


def flax_to_torch_image_generator(params, batch_stats) -> dict:
    """ImageGenerator: Dense_0, Dense_1, BatchNorm_0 (on the flat Dense
    output), Conv_0, Conv_1."""
    return {**_dense(params["Dense_0"], "dense0"), **_dense(params["Dense_1"], "dense1"),
            **_bn(params["BatchNorm_0"], batch_stats["BatchNorm_0"], "bn"),
            **_conv(params["Conv_0"], "conv0"), **_conv(params["Conv_1"], "conv1")}


def flax_to_torch_flat_image_generator(params, batch_stats) -> dict:
    """FlatImageGenerator: the ImageGenerator_0 submodule."""
    return _prefixed(flax_to_torch_image_generator(params["ImageGenerator_0"],
                                                   batch_stats["ImageGenerator_0"]), "net")


def flax_to_torch_flat_image_discriminator(params, batch_stats=None) -> dict:
    """FlatImageDiscriminator: the ImageDiscriminator_0 submodule."""
    return _prefixed(flax_to_torch_image_discriminator(params["ImageDiscriminator_0"]), "net")


def flax_to_torch_dense_generator(params, batch_stats=None) -> dict:
    """DenseGenerator and DenoiserGenerator: Dense_0..2."""
    sd = {}
    for i in range(3):
        sd.update(_dense(params[f"Dense_{i}"], f"dense{i}"))
    return sd


flax_to_torch_denoiser_generator = flax_to_torch_dense_generator


def flax_to_torch_transpose_generator(params, batch_stats) -> dict:
    """TransposeGenerator: Dense_0, ConvTranspose_0..n (the last is the
    1-channel output layer), BatchNorm_0..n−1."""
    n = sum(1 for k in params if k.startswith("ConvTranspose_"))
    sd = _dense(params["Dense_0"], "dense")
    for i in range(n - 1):
        sd.update(_conv(params[f"ConvTranspose_{i}"], f"convs.{i}"))
        sd.update(_bn(params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"], f"norms.{i}"))
    sd.update(_conv(params[f"ConvTranspose_{n - 1}"], "out_conv"))
    return sd


def flax_to_torch_softmax_discriminator(params, batch_stats=None) -> dict:
    """SoftmaxDiscriminator: Conv_0, Dense_0, Dense_1."""
    return {**_conv(params["Conv_0"], "conv"), **_dense(params["Dense_0"], "dense0"),
            **_dense(params["Dense_1"], "dense1")}


def flax_to_torch_signal_autoencoder(params, batch_stats=None) -> dict:
    """SignalAutoencoder: encoder, decoder."""
    return {**_dense(params["encoder"], "encoder"), **_dense(params["decoder"], "decoder")}
