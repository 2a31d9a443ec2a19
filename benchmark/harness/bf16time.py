"""A bfloat16 cell's calls, each timed alone with CUDA events as
:mod:`benchmark.harness.convtime` times them (captured once in a CUDA
graph, replayed back to back between the events), on tensors in the dtypes
the step gives them, so that no timed call makes a cast the step does not
make:

- :func:`conv_table`: each distinct conv call of the layers that compute
  in bfloat16, through the model's own layer on bfloat16 inputs;
- :func:`bn_table`: each BatchNorm call (``bntime``'s ``stats``,
  ``commit`` and ``bwd``) on bfloat16 inputs, so bfloat16 in and out;
- :func:`cast_table`: each distinct dtype conversion.

Each returns rows ``(layer, call, B or shape, count, ms, bound ms)``, the
bounds from :mod:`benchmark.harness.costs_bf16`.
"""

from .convtime import _time_ms
from .costs import PEAK_BYTES
from .costs_bf16 import bn_bytes_bf16, bound_s_bf16, call_cost_bf16, cast_bytes


def conv_table(calls, modules: dict, dtypes: dict, device, gen) -> list:
    """Over the distinct conv calls of ``calls`` whose layer computes in a
    dtype below float32 (``dtypes``: module path → compute dtype);
    ``modules``: network name → the program's module."""
    import torch

    distinct = {}
    for c in calls:
        dt = dtypes[f"{c['net']}.{c['name']}"]
        if c["kind"] == "conv" and dt != torch.float32:
            distinct.setdefault((c["net"], c["name"], c["call"], c["B"], dt), [c, 0])[1] += 1
    rows = []
    for (net, name, kind, B, dt), (c, count) in distinct.items():
        layer = modules[net].get_submodule(name)
        x = torch.randn((B, c["cin"], c["L"]), generator=gen, device=device).to(dt)
        x.requires_grad_(kind == "dx")
        if kind == "fwd":
            def make(layer=layer, x=x):
                def fwd():
                    with torch.no_grad():
                        return layer(x)
                return fwd
        else:
            def make(layer=layer, x=x, kind=kind):
                y = layer(x)
                gy = torch.randn(y.shape, generator=gen, device=device).to(y.dtype)
                wrt = x if kind == "dx" else layer.weight
                return lambda: torch.autograd.grad(y, wrt, gy, retain_graph=True)
        ms = _time_ms(make)
        rows.append((f"{net}.{name}", kind, B, count, ms, bound_s_bf16(*call_cost_bf16(c)) * 1e3))
    return rows


def bn_table(calls, model, dtype, device, gen) -> list:
    """``bntime.bn_table`` on inputs in ``dtype`` (the layers' compute
    dtype): ``calls`` [{"name", "shape", "call", "B", "count"}];
    ``model``: the program's module that holds the layers. Its running
    averages are put back afterwards."""
    import torch

    kept = [(b, b.detach().clone()) for b in model.buffers()]
    rows = []
    for c in calls:
        layer, kind = model.get_submodule(c["name"]), c["call"]
        x = torch.randn((c["B"], *c["shape"]), generator=gen, device=device).to(dtype)
        x.requires_grad_(kind in ("commit", "bwd"))
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
                gy = torch.randn(y.shape, generator=gen, device=device).to(y.dtype)
                return lambda: torch.autograd.grad(y, (x, layer.weight, layer.bias), gy,
                                                   retain_graph=True)
        ms = _time_ms(make)
        rows.append((f"generator.{c['name']}", kind, c["B"], c["count"], ms,
                     bn_bytes_bf16(kind, c["B"], c["shape"]) / PEAK_BYTES * 1e3))
    with torch.no_grad():
        for b, k in kept:
            b.copy_(k)
    return rows


def cast_table(conversions, device, gen) -> list:
    """Over the distinct conversions (shape, source and target dtype) of
    ``conversions`` ([{"site", "call", "shape", "src", "dst", "count"}]),
    each a ``Tensor.to`` of a tensor of that shape: rows ``(sites, "src→dst",
    shape, count, ms, bound ms)``, bound by the bytes read and written."""
    import torch

    distinct = {}
    for c in conversions:
        key = (tuple(c["shape"]), c["src"], c["dst"])
        row = distinct.setdefault(key, [[], 0])
        row[0].append(c["site"])
        row[1] += c["count"]
    rows = []
    for (shape, src, dst), (sites, count) in distinct.items():
        t = torch.randn(shape, generator=gen, device=device).to(src)

        def make(t=t, dst=dst):
            return lambda: t.to(dst)
        ms = _time_ms(make)
        rows.append((",".join(sorted(set(sites))), f"{src}->{dst}".replace("torch.", ""), shape,
                     count, ms, cast_bytes(shape, src, dst) / PEAK_BYTES * 1e3))
    return rows
