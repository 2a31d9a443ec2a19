"""Model introspection, the reference's ``model.summary()`` (port of
``gennet_tpu.utils.summary``; ref: bbhMahoGANy.py:1122-1126,
2_model_version/.../subtract_model.py:197)."""

import torch
from torch import nn


def param_count(module: nn.Module) -> int:
    """The number of trainable parameters: flax's ``params`` collection,
    so BatchNorm running statistics (buffers here, ``batch_stats`` there)
    are not counted."""
    return sum(p.numel() for p in module.parameters())


def _shape(out) -> str:
    if isinstance(out, torch.Tensor):
        return str(tuple(out.shape))
    if isinstance(out, (tuple, list)):
        return ", ".join(_shape(o) for o in out)
    return type(out).__name__


def model_summary(model: nn.Module, input_shape, train: bool = False) -> str:
    """A text table of every module a forward pass of one zero input
    (1, *input_shape) calls, in call order: name, type, output shape and
    the parameters it holds itself, then the total. The model is called as
    ``model(x, train=train, gen=...)``, the port's model convention, with a
    generator seeded 0 for its dropout."""
    device = next(model.parameters()).device
    rows, open_rows, hooks = [], [], []

    def enter(name, m):
        rows.append([name or "(model)", type(m).__name__, "",
                     sum(p.numel() for p in m.parameters(recurse=False))])
        open_rows.append(rows[-1])

    def leave(out):
        open_rows.pop()[2] = _shape(out)

    for name, m in model.named_modules():
        hooks.append(m.register_forward_pre_hook(lambda mod, args, name=name: enter(name, mod)))
        hooks.append(m.register_forward_hook(lambda mod, args, out: leave(out)))
    try:
        with torch.no_grad():
            model(torch.zeros((1, *input_shape), device=device), train=train,
                  gen=torch.Generator(device=device).manual_seed(0))
    finally:
        for h in hooks:
            h.remove()
    table = [("Layer", "Type", "Output shape", "Params")] + [tuple(map(str, r)) for r in rows]
    widths = [max(len(r[i]) for r in table) for i in range(4)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in table]
    lines.insert(1, "  ".join("-" * w for w in widths))
    lines.append(f"Total params: {param_count(model):,}")
    return "\n".join(lines)
