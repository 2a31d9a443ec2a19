"""The GAN phase: the chunk step of ``make_gan_step_scan`` called back to
back on the recipe's GAN config, with ``init_gan``'s three Adam states over
the benchmark's weights (``gennet_tpu_torch/train/gan.py``).

One iteration (a residual route, one generator step, a raw-series D), for
the operation counts: G forward ×3 (the D step's fake batch, the residual
route, the adversarial step), G backward ×2; D forward ×3 (real, fake,
adversarial), D backward with weight gradients ×2 (real and fake), and
once with the input gradient only (the adversarial step, D frozen).
"""

from benchmark.harness import flops
from benchmark.harness.loops import TrainLoop, numbers  # noqa: F401  (the phase's check)
from benchmark.reference import steps

NETS = ("generator", "discriminator")


class Loop(TrainLoop):
    loss_keys = ("d_loss", "g_loss", "res_loss")

    def __init__(self, cfg, data, models, loop_seed, chunk, device):
        from gennet_tpu_torch.runtime.optim import adam
        from gennet_tpu_torch.train.gan import GANConfig, GANState

        G, D = models["generator"], models["discriminator"]
        # the run's GAN config, as run_bbh / run_burst_smoke build it
        self.gan_cfg = c = GANConfig(n_pix=cfg["n_pix"], n_sig=data.n_sig, **cfg["gan"])
        # init_gan's three Adam states, over weights the benchmark made
        self.state = GANState(generator=G, discriminator=D,
                              g_opt=adam(G.parameters(), c.lr, c.beta1),
                              d_opt=adam(D.parameters(), c.lr * c.d_lr_scale, c.beta1),
                              g_res_opt=adam(G.parameters(), c.lr, c.beta1))
        super().__init__(cfg, data, models, loop_seed, chunk, device)

    def make_step(self, n):
        from gennet_tpu_torch.train.gan import make_gan_step_scan

        return make_gan_step_scan(self.state.generator, self.state.discriminator, self.gan_cfg, n)

    def call(self, step):
        return step(self.state, self.data.bank, self.data.measured, self.gen)[1]

    def tensors(self):
        from gennet_tpu_torch.train.gan import state_tensors

        return state_tensors(self.state)

    def first_grads(self):
        s = self.state
        G, D = self.named(s.generator, "generator"), self.named(s.discriminator, "discriminator")
        return {"d_opt": self._moments(s.d_opt, D), "g_res_opt": self._moments(s.g_res_opt, G),
                "g_opt": self._moments(s.g_opt, G)}

    def params(self):
        s = self.state
        return {k: p.detach().clone() for k, p in {**self.named(s.generator, "generator"),
                                                   **self.named(s.discriminator,
                                                                "discriminator")}.items()}


def calls(cfg: dict, nets: dict) -> list:
    """The conv and dense calls of one iteration (``benchmark.harness.flops``)."""
    g = cfg["gan"]
    G, D, B = nets["generator"], nets["discriminator"], g["batch_size"] * g["n_noise_real"]
    n_g = 3 if g["residual_route"] else 2
    out = flops.forward(G, B) * n_g + flops.backward(G, B) * (n_g - 1)
    return out + flops.forward(D, B) * 3 + flops.backward(D, B) * 2 \
        + flops.backward(D, B, params=False, input_grad=True)


def reference_run(net):
    """The reference's GAN iterations: the family's own where it gives one."""
    return getattr(net, "GANRun", steps.GANRun)
