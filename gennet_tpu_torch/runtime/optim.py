"""Adam as the reference's optax.adam, in the form a CUDA graph can record
on a card (:mod:`gennet_tpu_torch.runtime.graphs`); shared by the trainers
and by ``ml_recenter``'s refinement."""

import torch

from gennet_tpu_torch.runtime import trace


def adam(params, lr: float, beta1: float):
    """optax.adam: m̂/(√v̂ + 1e-8), b2 = 0.999. For parameters on a card it
    is the capturable form, with ``lr`` a 0-d tensor there, so that a CUDA
    graph can record its step; eager steps on the card take the same form,
    so that they round as the replays do. The CPU keeps the plain form."""
    params = list(params)
    with trace.span("optim.adam"):
        if params and params[0].is_cuda:
            lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
            return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8,
                                    capturable=True)
        return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8)


def init_adam_state(opt: torch.optim.Adam):
    """The state ``Adam`` makes at its first step (count 0, zero moments),
    made now for every parameter that has none: optax's state right after
    ``init``, which a held-back update (the GAN's balance gate) keeps."""
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            st["step"] = (torch.zeros((), dtype=scalar, device=p.device) if group["capturable"]
                          else torch.tensor(0.0, dtype=scalar))
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
