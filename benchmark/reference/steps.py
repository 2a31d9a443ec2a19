"""The recipes' training iterations in plain PyTorch: the GAN iteration
(a gated discriminator step, the residual route, the adversarial generator
step, each with its own Adam state) and the PE iteration (noise
augmentation, multi-output MSE, Adam with cosine decay, an EMA of the
parameters). Adam is optax's (m̂/(√v̂ + 1e-8), b2 0.999) as PyTorch's own
``torch.optim.Adam`` computes it.

Every random number comes from one ``torch.Generator`` in a fixed order
(the batch's draws, then each pass's dropout layer by layer), so a seed
gives the draws that the program's iteration makes from the same seed on
the same device.

The networks are the family's (``net``: ``benchmark/reference/<family>.py``,
with ``generator``, ``discriminator`` and ``pe``). A family whose iteration
differs (a pair D, BatchNorm's running statistics) gives its own ``GANRun``
or ``PERun``, a subclass of these, in that file; the phase takes it from
there (``benchmark/phases/*.py``).

``fault`` plants a fault for the readings that set a limit's upper end:
``"half_batch"`` drops the second half of each batch after the draws and
takes every mean over the rest.
"""

import math

import torch

BETA2, EPS = 0.999, 1e-8


class Draws:
    """Dropout draws from ``gen``: uniforms (``normal`` False) or normals.
    ``shared``: the first pass records its draws and every pass after a
    :meth:`rewind` takes them again in order, as one dropout key drives
    several passes."""

    def __init__(self, gen, shared=False):
        self.gen, self.shared, self.kept, self.at = gen, shared, [], 0

    def rewind(self):
        self.at = 0
        return self

    def __call__(self, shape, normal=False):
        if self.shared and self.at < len(self.kept):
            u = self.kept[self.at]
        else:
            draw = torch.randn if normal else torch.rand
            u = draw(tuple(shape), generator=self.gen, device=self.gen.device)
            if self.shared:
                self.kept.append(u)
        self.at += 1
        return u


class Adam:
    """optax.adam (m̂/(√v̂ + 1e-8), b2 0.999) over a dict of leaf tensors, as
    PyTorch's ``torch.optim.Adam``: its capturable form, with ``lr`` a 0-d
    tensor, where the leaves live on a card, else its plain form."""

    def __init__(self, params: dict, lr: float, b1: float):
        self.params, self.b1 = params, b1
        on_card = next(iter(params.values())).is_cuda
        dev = next(iter(params.values())).device
        self.opt = torch.optim.Adam(list(params.values()),
                                    lr=torch.tensor(lr, device=dev) if on_card else lr,
                                    betas=(b1, BETA2), eps=EPS, capturable=on_card)

    def step(self, grads: dict, lr=None, keep=True):
        """One step from ``grads``; ``keep`` False: parameters, moments and
        count stay as they were (a held-back step)."""
        group = self.opt.param_groups[0]
        if lr is not None:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr
        if not keep:
            kept = ({k: p.detach().clone() for k, p in self.params.items()},
                    {p: {n: v.clone() for n, v in st.items()} for p, st in self.opt.state.items()})
        for k, p in self.params.items():
            p.grad = grads[k]
        self.opt.step()
        for p in self.params.values():
            p.grad = None
        if not keep:
            with torch.no_grad():
                for k, p in self.params.items():
                    p.copy_(kept[0][k])
            self.opt.state.clear()
            self.opt.state.update(kept[1])

    def first_grad(self) -> dict:
        """The gradient of the first step, read back from its moment."""
        return {k: (self.opt.state[p]["exp_avg"] / (1.0 - self.b1) if p in self.opt.state
                    else torch.zeros_like(p)) for k, p in self.params.items()}


def _grads(loss, params: dict) -> dict:
    keys = list(params)
    return dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))


def _leaves(weights: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}


def bce_with_logits(logits, labels):
    logits = logits.reshape(-1)
    labels = torch.full_like(logits, labels) if not torch.is_tensor(labels) else labels
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels
                      + torch.nn.functional.softplus(-torch.abs(logits)))


def accuracy(logits, label: float):
    pred = (logits.reshape(-1) > 0.0).to(logits.dtype)
    return torch.mean((pred == round(label)).to(logits.dtype))


def residual_moment_loss(r, n_sig):
    dims = tuple(range(1, r.ndim))
    m1, m2 = torch.mean(r, dim=dims), torch.mean(r**2, dim=dims)
    return torch.mean(0.5 * (m1**2 + (m2 - n_sig**2) ** 2))


def residual_spectral_loss(r, n_sig, n_bands):
    r = r.reshape(r.shape[0], -1)
    n = r.shape[-1]
    p = torch.abs(torch.fft.rfft(r, dim=-1)[:, 1:-1]) ** 2 / n
    nb = max(1, min(int(n_bands), p.shape[-1]))
    bins = p.shape[-1] - (p.shape[-1] % nb)
    bands = p[:, :bins].reshape(r.shape[0], nb, -1).mean(dim=-1)
    return torch.mean(torch.mean(r, dim=-1) ** 2) + torch.mean((bands - n_sig**2) ** 2)


class GANRun:
    """The GAN iterations of a configuration from ``weights``: ``data``
    gives ``rows(idx)``, ``n_rows``, ``measured`` and ``n_sig``."""

    def __init__(self, net, cfg, weights, data, gen, fault=None):
        self.net, self.cfg, self.data, self.gen, self.fault = net, cfg, data, gen, fault
        g = cfg["gan"]
        for key in ("chi_loss", "pair_discriminator", "r1_gamma", "g_ema_decay"):
            if g[key]:
                raise NotImplementedError(f"the reference does not run {key}={g[key]}")
        self.G, self.D = _leaves(weights["generator"]), _leaves(weights["discriminator"])
        self.d_opt = Adam(self.D, g["lr"] * g["d_lr_scale"], g["beta1"])
        self.g_res_opt = Adam(self.G, g["lr"], g["beta1"])
        self.g_opt = Adam(self.G, g["lr"], g["beta1"])

    def optimizers(self) -> dict:
        """name → (optimizer, the network whose leaves it holds)."""
        return {"d_opt": (self.d_opt, "discriminator"), "g_res_opt": (self.g_res_opt, "generator"),
                "g_opt": (self.g_opt, "generator")}

    def params(self) -> dict:
        return {**{f"generator.{k}": v.detach() for k, v in self.G.items()},
                **{f"discriminator.{k}": v.detach() for k, v in self.D.items()}}

    def _u(self, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen, device=self.gen.device)

    def step(self) -> dict:
        cfg, g, gen, dev = self.cfg, self.cfg["gan"], self.gen, self.gen.device
        net, n = self.net, cfg["n_pix"]
        Gn, Dn = cfg["generator"], cfg.get("discriminator")
        n_sig = self.data.n_sig
        B = g["batch_size"] * g["n_noise_real"]
        S = max(1, g["g_steps_per_iter"])
        lat, lo, hi = g["latent_dim"], g["latent_low"], g["latent_high"]
        # ---- the iteration's draws, in the program's order
        z1 = self._u((B, lat), lo, hi)
        ridx = torch.randint(0, self.data.n_rows, (g["batch_size"],), generator=gen, device=dev)
        real = self.data.rows(ridx).repeat(g["n_noise_real"], 1)
        fresh = torch.randn(real.shape, generator=gen, device=dev) * n_sig
        ch = 2 if g["pair_discriminator"] else 1
        inoise = g["d_instance_noise"]
        if inoise > 0.0:
            in_real = torch.randn((B, n, ch), generator=gen, device=dev)
            in_fake = torch.randn((B, n, ch), generator=gen, device=dev)
            in_g = torch.randn((S, B, n, ch), generator=gen, device=dev)
        if g["label_smoothing"]:
            y_real, y_fake = self._u((B,), 0.7, 1.0), self._u((B,), 0.0, 0.3)
        else:
            y_real, y_fake = torch.ones((B,), device=dev), torch.zeros((B,), device=dev)
        z2 = self._u((B, lat), lo, hi) if g["residual_route"] else None
        z3 = self._u((S, B, lat), lo, hi)
        if self.fault == "half_batch":
            h = B // 2
            B, z1, real, fresh, y_real, y_fake = h, z1[:h], real[:h], fresh[:h], y_real[:h], y_fake[:h]
            z2 = None if z2 is None else z2[:h]
            z3 = z3[:, :h]
            if inoise > 0.0:
                in_real, in_fake, in_g = in_real[:h], in_fake[:h], in_g[:, :h]
        gate = g["d_acc_gate"] if g["d_acc_gate"] > 0 else 2.0

        # ---- discriminator step, held back while D's accuracy ≥ the gate
        with torch.no_grad():
            masks = Draws(gen) if g["d_sees_train_mode"] else None
            x_fake = net.generator(Gn, self.G, z1, n, masks).reshape(B, -1)
        fake_in, real_in = x_fake[..., None], real[..., None]
        if inoise > 0.0:
            real_in = real_in + inoise * in_real
            fake_in = fake_in + inoise * in_fake
        D = self.D
        shared = Draws(gen, shared=True)
        lr_ = net.discriminator(Dn, D, real_in, shared.rewind())
        lf_ = net.discriminator(Dn, D, fake_in, shared.rewind())
        d_loss = 0.5 * (bce_with_logits(lr_, y_real) + bce_with_logits(lf_, y_fake))
        d_acc = 0.5 * (accuracy(lr_.detach(), 1.0) + accuracy(lf_.detach(), 0.0))
        gD = _grads(d_loss, D)
        self.d_opt.step(gD, keep=bool(d_acc < gate))

        # ---- residual route
        res_loss = torch.zeros((), device=dev)
        if g["residual_route"]:
            res_train = not g["res_eval_mode"]
            G = self.G
            x = net.generator(Gn, G, z2, n, Draws(gen) if res_train else None)
            resid = self.data.measured[None, :, None] - x
            if g["res_spectral_bands"] > 0:
                rl = residual_spectral_loss(resid, n_sig, g["res_spectral_bands"])
            else:
                rl = residual_moment_loss(resid, n_sig)
            res_loss = g["res_loss_weight"] * rl
            self.g_res_opt.step(_grads(res_loss, G))

        # ---- adversarial generator step(s) against the updated D
        Dfix = {k: v.detach() for k, v in self.D.items()}  # D frozen
        for s in range(S):
            G = self.G
            x = net.generator(Gn, G, z3[s], n, Draws(gen))
            xf = x.reshape(B, -1)
            d_in = x if inoise <= 0.0 else x + inoise * in_g[s]
            logits = net.discriminator(Dn, Dfix, d_in, Draws(gen))
            g_loss = bce_with_logits(logits, 1.0)
            h = B // 2
            if h >= 1:
                num = torch.mean(torch.abs(xf[:h] - xf[h:2 * h]))
                den = torch.mean(torch.abs(z3[s][:h] - z3[s][h:2 * h])) + 1e-8
                g_loss = g_loss + g["diversity_weight"] / (num / den + 1e-5)
            g_acc = accuracy(logits.detach(), 1.0)
            self.g_opt.step(_grads(g_loss, G))
        return {"d_loss": d_loss.detach(), "d_acc": d_acc, "g_loss": g_loss.detach(),
                "g_acc": g_acc, "res_loss": res_loss.detach()}


class PERun:
    """The PE iterations of a configuration from ``weights``: ``data``
    gives ``rows(idx)``, ``n_rows`` and ``targets``."""

    def __init__(self, net, cfg, weights, data, gen, fault=None):
        self.net, self.cfg, self.data, self.gen, self.fault = net, cfg, data, gen, fault
        p = cfg["pe"]
        self.P = _leaves(weights["pe"])
        self.opt = Adam(self.P, p["lr"], p["beta1"])
        self.ema, self.t = None, 0

    def optimizers(self) -> dict:
        return {"opt": (self.opt, "pe")}

    def params(self) -> dict:
        out = {f"pe.{k}": v.detach() for k, v in self.P.items()}
        if self.ema is not None:
            out.update({f"ema.{k}": v for k, v in self.ema.items()})
        return out

    def _lr(self):
        p = self.cfg["pe"]
        if p["lr_decay_steps"] <= 0:
            return p["lr"]
        c = min(self.t, p["lr_decay_steps"])
        a = p["lr_min_frac"]
        return p["lr"] * ((1.0 - a) * 0.5 * (1.0 + math.cos(math.pi * c / p["lr_decay_steps"])) + a)

    def step(self) -> dict:
        p, gen, dev = self.cfg["pe"], self.gen, self.gen.device
        B = p["batch_size"]
        idx = torch.randint(0, self.data.n_rows, (B,), generator=gen, device=dev)
        x, y = self.data.rows(idx), self.data.targets[idx]
        n_noisy = int(B * p["noise_frac"])
        if n_noisy > 0:
            scale = p["noise_scale_max"] * torch.rand((), generator=gen, device=dev)
            noise = torch.randn((B, x.shape[1]), generator=gen, device=dev)
            mask = (torch.arange(B, device=dev) < n_noisy).to(x.dtype)[:, None]
            x = x + mask * (scale * noise)
        if p["max_normalize"]:
            x = x / (torch.amax(x, dim=1, keepdim=True) + 1e-12) if p["max_per_sample"] \
                else x / torch.max(x)
        if self.fault == "half_batch":
            x, y = x[: B // 2], y[: B // 2]
        if p["ema_decay"] > 0.0 and self.ema is None:
            self.ema = {k: v.detach().clone() for k, v in self.P.items()}
        loss = torch.sum(torch.mean((self.net.pe(self.P, x[..., None]) - y) ** 2, dim=0))
        self.opt.step(_grads(loss, self.P), lr=self._lr())
        self.t += 1
        if p["ema_decay"] > 0.0:
            self.ema = {k: torch.lerp(e, self.P[k].detach(), 1.0 - p["ema_decay"])
                        for k, e in self.ema.items()}
        return {"pe_loss": loss.detach()}
