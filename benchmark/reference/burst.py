"""The ``burst`` family's plain networks, parameter sets and reference
data:

- G (ref: burstMahoGANy.py:127-251): Dense → relu → reshape → Up2 → a
  [Conv SAME → relu → Gaussian dropout] per feature → Conv(1) → tanh.
- D (ref: :295-402): Conv(64) SAME tanh → maxpool 2 → Conv(128) VALID tanh
  → maxpool 2 → Dense(1024) tanh → Dense(1).
- PE (ref: :263-293): Conv(64) s2 SAME relu → Conv(128) s2 VALID relu →
  Dense(1024) relu → Dense(2).
"""

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import burst_bank
from .nets import conv, conv_spec, dense, dense_spec, flat_cl, gaussian_dropout, out_len


def generator(net, P, z, n_pix, masks=None):
    """G(z) → (B, n_pix, 1); ``masks``: a ``Draws`` while dropout is on."""
    B = z.shape[0]
    x = F.relu(dense(z, P, "dense")).view(B, n_pix // 2, 256).transpose(1, 2)
    x = torch.repeat_interleave(x, 2, dim=-1)
    for i in range(len(net["features"])):
        x = gaussian_dropout(F.relu(conv(x, P[f"convs.{i}.weight"], P[f"convs.{i}.bias"])),
                             net["drate"], masks)
    return torch.tanh(conv(x, P["out_conv.weight"], P["out_conv.bias"])).transpose(1, 2)


def discriminator(net, P, x, masks=None):
    """D(x (B, n_pix, 1)) → (B, 1) logits."""
    x = x.transpose(1, 2)
    x = F.max_pool1d(torch.tanh(conv(x, P["conv0.weight"], P["conv0.bias"])), 2)
    x = F.max_pool1d(torch.tanh(conv(x, P["conv1.weight"], P["conv1.bias"], 1, "VALID")), 2)
    return dense(torch.tanh(dense(flat_cl(x), P, "dense0")), P, "dense1")


def pe(P, x):
    """PE(x (B, n_pix, 1)) → (B, 2)."""
    h = F.relu(conv(x.transpose(1, 2), P["conv0.weight"], P["conv0.bias"], 2))
    h = F.relu(conv(h, P["conv1.weight"], P["conv1.bias"], 2, "VALID"))
    return dense(F.relu(dense(flat_cl(h), P, "dense0")), P, "dense1")


def param_specs(cfg, which):
    """[(name, shape, fan_in)] of a network, in the program's registration
    order (``benchmark.reference.nets.make_weights``)."""
    n = cfg["n_pix"]
    if which == "generator":
        net = cfg["generator"]
        out, cin = dense_spec("dense", net["latent_dim"], 256 * (n // 2)), 256
        for i, f in enumerate(net["features"]):
            out += conv_spec(f"convs.{i}", cin, f, net["filt"])
            cin = f
        return out + conv_spec("out_conv", cin, 1, net["filt"])
    if which == "discriminator":
        L = (n // 2 - 4) // 2
        return conv_spec("conv0", 1, 64) + conv_spec("conv1", 64, 128) \
            + dense_spec("dense0", 128 * L, 1024) + dense_spec("dense1", 1024, 1)
    L = out_len(out_len(n, 5, 2, "SAME"), 5, 2, "VALID")
    return conv_spec("conv0", 1, 64) + conv_spec("conv1", 64, 128) \
        + dense_spec("dense0", 128 * L, 1024) + dense_spec("dense1", 1024, 2)


def reference_data(cfg: dict, inputs: dict):
    """The reference's own event, and the sine-Gaussian rows it makes for
    the indices a step draws."""
    pars, n = inputs["pars"], cfg["n_pix"]
    truth = torch.tensor([cfg["bank"]["truth"]], dtype=torch.float32, device=pars.device)
    signal = burst_bank.sine_gaussian(truth[:, 0], truth[:, 1], n)[0]
    return SimpleNamespace(rows=lambda i: burst_bank.sine_gaussian(pars[i, 0], pars[i, 1], n),
                           n_rows=pars.shape[0], targets=pars,
                           measured=signal + cfg["n_sig"] * inputs["noise"], n_sig=cfg["n_sig"])
