"""The PE phase: the chunk step of ``make_cnn_step_scan`` called back to
back on the recipe's CNN config, with ``init_cnn``'s optimizer over the
benchmark's weights (``gennet_tpu_torch/train/cnn.py``): noise
augmentation, the multi-output MSE, Adam with cosine decay, an EMA.

One iteration, for the operation counts: one forward and one backward
with weight gradients.
"""

import torch

from benchmark.harness import flops
from benchmark.harness.loops import TrainLoop, numbers  # noqa: F401  (the phase's check)
from benchmark.reference import steps

NETS = ("pe",)


class Loop(TrainLoop):
    loss_keys = ("pe_loss",)

    def __init__(self, cfg, data, models, loop_seed, chunk, device):
        from gennet_tpu_torch.runtime.optim import adam
        from gennet_tpu_torch.train.cnn import CNNConfig, CNNState, cosine_decay

        model = models["pe"]
        self.cnn_cfg = c = CNNConfig(n_pix=cfg["n_pix"], **cfg["pe"])
        # init_cnn's optimizer (and, off the card, its decay schedule)
        opt = adam(model.parameters(), c.lr, c.beta1)
        sched = (torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(c.lr_decay_steps,
                                                                     c.lr_min_frac))
                 if c.lr_decay_steps > 0 and not opt.defaults["capturable"] else None)
        self.state = CNNState(model=model, opt=opt, sched=sched)
        super().__init__(cfg, data, models, loop_seed, chunk, device)

    def make_step(self, n):
        from gennet_tpu_torch.train.cnn import make_cnn_step_scan

        return make_cnn_step_scan(self.state.model, self.cnn_cfg, n)

    def call(self, step):
        return step(self.state, self.data.bank, self.data.targets, self.gen)[1]

    def tensors(self):
        from gennet_tpu_torch.train.cnn import state_tensors

        return state_tensors(self.state)

    def host_state(self):
        """The step count, and off the card the decay schedule and its lr."""
        s = self.state
        return (s.step, s.sched.state_dict() if s.sched else None,
                [g["lr"] for g in s.opt.param_groups])

    def set_host_state(self, kept):
        s = self.state
        s.step, sched, lrs = kept
        if s.sched:
            s.sched.load_state_dict(sched)
        for g, lr in zip(s.opt.param_groups, lrs):
            if not torch.is_tensor(lr):
                g["lr"] = lr

    def first_grads(self):
        return {"opt": self._moments(self.state.opt, self.named(self.state.model, "pe"))}

    def params(self):
        out = {k: p.detach().clone() for k, p in self.named(self.state.model, "pe").items()}
        for k, v in (self.state.ema or {}).items():
            out[f"ema.{k}"] = v.detach().clone()
        return out


def calls(cfg: dict, nets: dict) -> list:
    """The conv and dense calls of one iteration (``benchmark.harness.flops``)."""
    B = cfg["pe"]["batch_size"]
    return flops.forward(nets["pe"], B) + flops.backward(nets["pe"], B)


def reference_run(net):
    """The reference's PE iterations: the family's own where it gives one."""
    return getattr(net, "PERun", steps.PERun)
