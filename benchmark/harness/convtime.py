"""Each distinct convolution call of one iteration, timed alone with CUDA
events through the model's own conv layer (whatever implementation it
runs), against its bound (:mod:`benchmark.harness.costs`).

A call is captured once in a CUDA graph and replayed back to back between
the events, as the step's own calls are: timed as host launches, the short
calls would count the host's dispatch time (their sum over one BBH GAN
step read 34 ms against the step's 24 ms of device time)."""

import statistics

from .costs import bound_s
from .flops import cost

REPS, ROUNDS, WARMUP = 20, 5, 3


def _time_ms(make) -> float:
    """Median over rounds of one replay's device ms, ``REPS`` replays a
    round. ``make()`` returns the call; it runs on the capture's stream, so
    a backward call captures on the stream its forward ran on."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn = make()
        for _ in range(WARMUP):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    times = []
    for _ in range(ROUNDS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / REPS)
    return statistics.median(times)


def conv_table(calls, modules: dict, device, gen) -> list:
    """[(layer, call, B, count, ms, bound ms)] over the distinct conv calls
    of ``calls`` (``benchmark.harness.flops``); ``modules``: network name →
    the program's module."""
    import torch

    distinct = {}
    for c in calls:
        if c["kind"] == "conv":
            key = (c["net"], c["name"], c["call"], c["B"])
            distinct.setdefault(key, [c, 0])[1] += 1
    rows = []
    for (net, name, kind, B), (c, count) in distinct.items():
        layer = modules[net].get_submodule(name)
        x = torch.randn((B, c["cin"], c["L"]), generator=gen, device=device,
                        requires_grad=kind == "dx")
        if kind == "fwd":
            def make(layer=layer, x=x):
                def fwd():
                    with torch.no_grad():
                        return layer(x)
                return fwd
        else:
            def make(layer=layer, x=x, kind=kind):
                y = layer(x)
                gy = torch.randn(y.shape, generator=gen, device=device)
                wrt = x if kind == "dx" else layer.weight
                return lambda: torch.autograd.grad(y, wrt, gy, retain_graph=True)
        ms = _time_ms(make)
        flops, nbytes = cost(c)
        rows.append((f"{net}.{name}", kind, B, count, ms, bound_s(flops, nbytes) * 1e3))
    return rows
