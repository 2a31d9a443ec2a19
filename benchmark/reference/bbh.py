"""The ``bbh`` family's plain networks, parameter sets and reference data,
described by a configuration's ``generator`` / ``discriminator`` sections
(``benchmark/configs/*.json``):

- G (ref: bbhMahoGANy.py:212-295): Dense(100 → 256·n/2) → norm → tanh →
  dropout → reshape (256, n/2) → [Up2 → Conv s2], [Up2 → Conv], Conv,
  Conv, Conv (K 5 SAME), each norm → tanh → dropout → Conv(1) linear.
  GroupNorm (groups of 16 channels, ε 1e-6) where the recipe says "group".
- D (ref: :408-498): Conv s2 → LeakyReLU → dropout, per feature, → Dense(1)
  on the channels-last flatten; ``in_ch`` 1, the raw series.
- PE, two branches (ref: :356-404): mc Conv 64 s2 SAME, 128/256/512 s2
  VALID → Dense(1) → relu; q Conv 64 SAME, 128/256 VALID, 512/1024 s2
  VALID → Dense(1) → sigmoid.
"""

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import bbh_bank
from .nets import (conv, conv_spec, dense, dense_spec, dropout, flat_cl, group_norm, norm_spec,
                   out_len)

PE_MC = ((64, 2, "SAME"), (128, 2, "VALID"), (256, 2, "VALID"), (512, 2, "VALID"))
PE_Q = ((64, 1, "SAME"), (128, 1, "VALID"), (256, 1, "VALID"), (512, 2, "VALID"),
        (1024, 2, "VALID"))


def generator(net, P, z, n_pix, masks=None):
    """G(z) → (B, n_pix, 1); ``masks``: a ``Draws`` while dropout is on."""
    B = z.shape[0]
    x = dense(z, P, "dense")
    if net["norm"] == "group":
        x = group_norm(x, P, "norms.0")
    x = dropout(torch.tanh(x), net["drate"], masks)
    x = x.view(B, n_pix // 2, 256).transpose(1, 2)
    for i in range(len(net["features"])):
        if i <= 1:
            x = torch.repeat_interleave(x, 2, dim=-1)
        x = conv(x, P[f"convs.{i}.weight"], P[f"convs.{i}.bias"], 2 if i == 0 else 1)
        if net["norm"] == "group":
            x = group_norm(x, P, f"norms.{i + 1}")
        x = dropout(torch.tanh(x), net["drate"], masks)
    return conv(x, P["out_conv.weight"], P["out_conv.bias"]).transpose(1, 2)


def discriminator(net, P, x, masks=None):
    """D(x (B, n_pix, 1)) → (B, 1) logits."""
    x = x.transpose(1, 2)
    for i in range(len(net["features"])):
        x = F.leaky_relu(conv(x, P[f"convs.{i}.weight"], P[f"convs.{i}.bias"], 2),
                         negative_slope=net["alpha"])
        x = dropout(x, net["drate"], masks)
    return dense(flat_cl(x), P, "dense")


def pe(P, x):
    """PE(x (B, n_pix, 1)) → (B, 2)."""
    x = x.transpose(1, 2)
    outs = []
    for br, spec, act in (("mc", PE_MC, F.relu), ("q", PE_Q, torch.sigmoid)):
        h = x
        for i, (_, s, pad) in enumerate(spec):
            h = F.relu(conv(h, P[f"{br}_convs.{i}.weight"], P[f"{br}_convs.{i}.bias"], s, pad))
        outs.append(act(dense(flat_cl(h), P, f"{br}_dense")))
    return torch.cat(outs, dim=-1)


def param_specs(cfg, which):
    """[(name, shape, fan_in)] of a network, in the program's registration
    order (``benchmark.reference.nets.make_weights``)."""
    n = cfg["n_pix"]
    if which == "generator":
        net = cfg["generator"]
        group = net["norm"] == "group"
        out = dense_spec("dense", net["latent_dim"], 256 * (n // 2))
        out += norm_spec("norms.0", 256 * (n // 2)) if group else []
        cin = 256
        for i, f in enumerate(net["features"]):
            out += conv_spec(f"convs.{i}", cin, f, net["filt"])
            out += norm_spec(f"norms.{i + 1}", f) if group else []
            cin = f
        return out + conv_spec("out_conv", cin, 1, net["filt"])
    if which == "discriminator":
        net = cfg["discriminator"]
        out, cin, L = [], net["in_ch"], n
        for i, f in enumerate(net["features"]):
            out += conv_spec(f"convs.{i}", cin, f, net["filt"])
            cin, L = f, -(-L // 2)
        return out + dense_spec("dense", cin * L, 1)
    # the program registers mc_convs, mc_dense, q_convs, q_dense
    out = []
    for br, spec in (("mc", PE_MC), ("q", PE_Q)):
        cin, L = 1, n
        for i, (f, s, pad) in enumerate(spec):
            out += conv_spec(f"{br}_convs.{i}", cin, f)
            cin, L = f, out_len(L, 5, s, pad)
        out += dense_spec(f"{br}_dense", cin * L, 1)
    return out


def reference_data(cfg: dict, inputs: dict):
    """The reference's own event and noise scale, and the template rows it
    synthesises for the indices a step draws."""
    b = cfg["bank"]
    psd = bbh_bank.psd(b, inputs["noise"].device)
    measured, norm = bbh_bank.event(b, inputs["noise"], psd)

    def rows(i):
        return bbh_bank.templates(b, inputs["m1"][i], inputs["m2"][i], inputs["idx"][i], psd, norm)

    return SimpleNamespace(rows=rows, n_rows=inputs["m1"].shape[0], targets=inputs["targets"],
                           measured=measured, n_sig=norm if cfg["n_sig_event"] else cfg["n_sig"])
