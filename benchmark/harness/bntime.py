"""Each distinct BatchNorm call of one iteration, timed alone with CUDA
events through the model's own ``BatchNorm`` layer, against the least time
its bytes take at the card's HBM rate (``costs.PEAK_BYTES``). The timing
is :mod:`benchmark.harness.convtime`'s: the call captured once in a CUDA
graph and replayed back to back between the events.

A call is one of:

- ``stats``: batch statistics, nothing committed, no gradient (the D
  step's fake pass);
- ``commit``: batch statistics with the running averages moved, the
  autograd graph recorded (the adversarial pass);
- ``bwd``: the gradients of the input, scale and bias (its backward).
"""

import math

from .costs import F32, PEAK_BYTES
from .convtime import _time_ms


def bn_bytes(kind: str, B: int, shape) -> int:
    """Bytes of one call on B rows of ``shape`` (C,) or (C, L), each tensor
    the call reads or writes counted once: x read and y written, the scale
    and bias read; ``commit`` also reads and writes the running averages;
    ``bwd`` reads x, dy and the scale, and writes dx and the scale's and
    bias's gradients."""
    n, c = B * math.prod(shape), shape[0]
    return F32 * {"stats": 2 * n + 2 * c, "commit": 2 * n + 6 * c, "bwd": 3 * n + 3 * c}[kind]


def bn_table(calls, model, device, gen) -> list:
    """[(layer, call, B, count, ms, bound ms)] over ``calls`` ([{"name",
    "shape", "call", "B", "count"}]); ``model``: the program's module
    that holds the layers. Its running averages are put back afterwards."""
    import torch

    kept = [(b, b.detach().clone()) for b in model.buffers()]
    rows = []
    for c in calls:
        layer, kind = model.get_submodule(c["name"]), c["call"]
        x = torch.randn((c["B"], *c["shape"]), generator=gen, device=device,
                        requires_grad=kind in ("commit", "bwd"))
        if kind == "stats":
            def make(layer=layer, x=x):
                def fwd():
                    with torch.no_grad():
                        return layer(x, True)
                return fwd
        elif kind == "commit":
            def make(layer=layer, x=x):
                return lambda: layer(x, True, True)
        else:
            def make(layer=layer, x=x):
                y = layer(x, True)
                gy = torch.randn(y.shape, generator=gen, device=device)
                return lambda: torch.autograd.grad(y, (x, layer.weight, layer.bias), gy,
                                                   retain_graph=True)
        ms = _time_ms(make)
        rows.append((f"generator.{c['name']}", kind, c["B"], c["count"], ms,
                     bn_bytes(kind, c["B"], c["shape"]) / PEAK_BYTES * 1e3))
    with torch.no_grad():
        for b, k in kept:
            b.copy_(k)
    return rows
