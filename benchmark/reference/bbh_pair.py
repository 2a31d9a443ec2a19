"""The ``bbh_pair`` family's plain networks and GAN iteration: GenNet's own
BBH GAN (hagabbar/GenNet ``BBH_version/bbhMahoGANy.py``), as the
configuration's ``generator`` / ``discriminator`` / ``gan`` sections
describe it (``benchmark/configs/bbh_default.json``):

- G (ref :212-295): ``reference/bbh.py``'s generator with BatchNorm in
  each norm's place, as flax computes it: the batch mean and the biased
  batch variance over every axis but the channel's, ε 1e-5, then scale
  and bias. BN_0 normalises the Dense's 256·n/2 features, so its
  statistics are over the batch alone. A pass that commits moves each
  running average r to m·r + (1 − m)·s, s the batch statistic (the biased
  variance), m the momentum.
- D (ref :408-498, in the repo's 1-D form, see the configuration's
  ``departures``): ``reference/bbh.py``'s discriminator over 2 input
  channels.
- The data-subtraction layer (ref :164-188): D sees a generated waveform x
  as the pair (x, measured − x), a bank template as (template, fresh
  N(0, n_sig²) noise); instance noise is added to both channels.

The iteration (:class:`GANRun`) is the program's default recipe: a gated D
step on a fake batch drawn in train mode without committing G's running
averages, then the adversarial G step, whose pass commits them. No
residual route.
"""

import torch

from . import steps
from .bbh import discriminator, pe, reference_data  # noqa: F401  (the family's D, PE, data)
from .bbh import param_specs as bbh_specs
from .nets import conv, conv_spec, dense, dense_spec, dropout, norm_spec

EPS = 1e-5  # flax nn.BatchNorm's epsilon
STATS = ("running_mean", "running_var")


def batch_norm(x, P, stats, name, commit, momentum):
    """BatchNorm of x (B, C) or (B, C, L) with its batch statistics;
    ``commit``: the running averages in ``stats`` moved from them."""
    shape = [1] * x.ndim
    shape[1] = -1
    dims = [d for d in range(x.ndim) if d != 1]
    mean = x.mean(dim=dims)
    var = ((x - mean.view(shape)) ** 2).mean(dim=dims)
    if commit:
        for key, s in zip(STATS, (mean, var)):
            k = f"{name}.{key}"
            stats[k] = momentum * stats[k] + (1.0 - momentum) * s.detach()
    return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS)
            * P[f"{name}.weight"].view(shape) + P[f"{name}.bias"].view(shape))


def generator(net, P, z, n_pix, masks, stats, commit):
    """G(z) in train mode → (B, n_pix, 1); ``masks``: a ``Draws``;
    ``stats``: the running averages, moved where ``commit``."""
    B, m = z.shape[0], net["bn_momentum"]
    x = batch_norm(dense(z, P, "dense"), P, stats, "norms.0", commit, m)
    x = dropout(torch.tanh(x), net["drate"], masks)
    x = x.view(B, n_pix // 2, 256).transpose(1, 2)
    for i in range(len(net["features"])):
        if i <= 1:
            x = torch.repeat_interleave(x, 2, dim=-1)
        x = conv(x, P[f"convs.{i}.weight"], P[f"convs.{i}.bias"], 2 if i == 0 else 1)
        x = batch_norm(x, P, stats, f"norms.{i + 1}", commit, m)
        x = dropout(torch.tanh(x), net["drate"], masks)
    return conv(x, P["out_conv.weight"], P["out_conv.bias"]).transpose(1, 2)


def _norm_spec(name, c):
    """A BatchNorm's scale and bias, then its running averages (0 and 1),
    as the program registers them."""
    return norm_spec(name, c) + [(f"{name}.running_mean", (c,), 0),
                                 (f"{name}.running_var", (c,), -1)]


def param_specs(cfg, which):
    """[(name, shape, fan_in)] of a network, in the program's registration
    order, BatchNorm's running averages included
    (``benchmark.reference.nets.make_weights``)."""
    if which != "generator":
        return bbh_specs(cfg, which)
    net, n = cfg["generator"], cfg["n_pix"]
    out = dense_spec("dense", net["latent_dim"], 256 * (n // 2)) + _norm_spec("norms.0",
                                                                              256 * (n // 2))
    cin = 256
    for i, f in enumerate(net["features"]):
        out += conv_spec(f"convs.{i}", cin, f, net["filt"]) + _norm_spec(f"norms.{i + 1}", f)
        cin = f
    return out + conv_spec("out_conv", cin, 1, net["filt"])


def pair(x, measured, other=None):
    """D's input (B, n_pix, 2): (x, measured − x), or (x, ``other``)."""
    return torch.stack([x, measured[None, :] - x if other is None else other], dim=-1)


class GANRun(steps.GANRun):
    """The default recipe's GAN iterations from ``weights``, with G's
    running averages apart from its trained leaves. ``fault`` as in
    :class:`steps.GANRun`: ``"half_batch"`` runs every pass, and so takes
    BatchNorm's statistics, over the half of each batch it keeps."""

    def __init__(self, net, cfg, weights, data, gen, fault=None):
        self.net, self.cfg, self.data, self.gen, self.fault = net, cfg, data, gen, fault
        g = cfg["gan"]
        for key in ("chi_loss", "residual_route", "r1_gamma", "g_ema_decay"):
            if g[key]:
                raise NotImplementedError(f"the pair reference does not run {key}={g[key]}")
        if not (g["pair_discriminator"] and g["d_sees_train_mode"]
                and cfg["generator"]["norm"] == "batch"):
            raise NotImplementedError("the pair reference runs the pair D, a BatchNorm G and "
                                      "the D step's fake batch in train mode")
        gw = weights["generator"]
        self.stats = {k: v.detach().clone() for k, v in gw.items() if k.endswith(STATS)}
        self.G = steps._leaves({k: v for k, v in gw.items() if k not in self.stats})
        self.D = steps._leaves(weights["discriminator"])
        self.d_opt = steps.Adam(self.D, g["lr"] * g["d_lr_scale"], g["beta1"])
        self.g_opt = steps.Adam(self.G, g["lr"], g["beta1"])

    def optimizers(self) -> dict:
        return {"d_opt": (self.d_opt, "discriminator"), "g_opt": (self.g_opt, "generator")}

    def params(self) -> dict:
        return {**super().params(), **{f"generator.{k}": v for k, v in self.stats.items()}}

    def step(self) -> dict:
        cfg, g, gen, dev = self.cfg, self.cfg["gan"], self.gen, self.gen.device
        net, n, Gn, Dn = self.net, cfg["n_pix"], cfg["generator"], cfg["discriminator"]
        measured = self.data.measured
        B = g["batch_size"] * g["n_noise_real"]
        S = max(1, g["g_steps_per_iter"])
        lat, lo, hi = g["latent_dim"], g["latent_low"], g["latent_high"]
        # ---- the iteration's draws, in the program's order
        z1 = self._u((B, lat), lo, hi)
        ridx = torch.randint(0, self.data.n_rows, (g["batch_size"],), generator=gen, device=dev)
        real = self.data.rows(ridx).repeat(g["n_noise_real"], 1)
        fresh = torch.randn(real.shape, generator=gen, device=dev) * self.data.n_sig
        inoise = g["d_instance_noise"]
        if inoise > 0.0:
            in_real = torch.randn((B, n, 2), generator=gen, device=dev)
            in_fake = torch.randn((B, n, 2), generator=gen, device=dev)
            in_g = torch.randn((S, B, n, 2), generator=gen, device=dev)
        if g["label_smoothing"]:
            y_real, y_fake = self._u((B,), 0.7, 1.0), self._u((B,), 0.0, 0.3)
        else:
            y_real, y_fake = torch.ones((B,), device=dev), torch.zeros((B,), device=dev)
        z3 = self._u((S, B, lat), lo, hi)
        if self.fault == "half_batch":
            h = B // 2
            B, z1, real, fresh, z3 = h, z1[:h], real[:h], fresh[:h], z3[:, :h]
            y_real, y_fake = y_real[:h], y_fake[:h]
            if inoise > 0.0:
                in_real, in_fake, in_g = in_real[:h], in_fake[:h], in_g[:, :h]
        gate = g["d_acc_gate"] if g["d_acc_gate"] > 0 else 2.0

        # ---- discriminator step on a fake batch from G in train mode,
        # committing nothing; held back while D's accuracy ≥ the gate
        with torch.no_grad():
            x_fake = net.generator(Gn, self.G, z1, n, steps.Draws(gen), self.stats,
                                   False).reshape(B, -1)
        fake_in, real_in = pair(x_fake, measured), pair(real, measured, fresh)
        if inoise > 0.0:
            real_in = real_in + inoise * in_real
            fake_in = fake_in + inoise * in_fake
        shared = steps.Draws(gen, shared=True)
        lr_ = net.discriminator(Dn, self.D, real_in, shared.rewind())
        lf_ = net.discriminator(Dn, self.D, fake_in, shared.rewind())
        d_loss = 0.5 * (steps.bce_with_logits(lr_, y_real) + steps.bce_with_logits(lf_, y_fake))
        d_acc = 0.5 * (steps.accuracy(lr_.detach(), 1.0) + steps.accuracy(lf_.detach(), 0.0))
        self.d_opt.step(steps._grads(d_loss, self.D), keep=bool(d_acc < gate))

        # ---- adversarial G step(s) against the updated D, each pass committing
        Dfix = {k: v.detach() for k, v in self.D.items()}
        for s in range(S):
            x = net.generator(Gn, self.G, z3[s], n, steps.Draws(gen), self.stats, True)
            xf = x.reshape(B, -1)
            d_in = pair(xf, measured)
            if inoise > 0.0:
                d_in = d_in + inoise * in_g[s]
            logits = net.discriminator(Dn, Dfix, d_in, steps.Draws(gen))
            g_loss = steps.bce_with_logits(logits, 1.0)
            h = B // 2
            if h >= 1:
                num = torch.mean(torch.abs(xf[:h] - xf[h:2 * h]))
                den = torch.mean(torch.abs(z3[s][:h] - z3[s][h:2 * h])) + 1e-8
                g_loss = g_loss + g["diversity_weight"] / (num / den + 1e-5)
            g_acc = steps.accuracy(logits.detach(), 1.0)
            self.g_opt.step(steps._grads(g_loss, self.G))
        return {"d_loss": d_loss.detach(), "d_acc": d_acc, "g_loss": g_loss.detach(),
                "g_acc": g_acc, "res_loss": torch.zeros((), device=dev)}
