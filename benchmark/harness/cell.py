"""One run of one cell: everything is found by name from ``BENCHMARK.json``
and the files under ``benchmark/``:

- ``configs/<config>.json``: the configuration as it is run; its
  ``family`` names ``families/<family>.py`` (the program's side: inputs,
  data, modules, layers) and ``reference/<family>.py`` (the plain side:
  networks, parameter sets, data);
- ``traffic/<traffic>.json``: the loop's ``phase``, which names
  ``phases/<phase>.py`` (the loop, its networks, the calls of one
  iteration, the reference's run and the check), and its ``chunk``;
- ``metrics/<metric>.py``: one reader per metric, end-to-end and
  per-layer, each ``read(run)``;
- ``limits/<workload>.json``: the limit of each number compared.

Set-up (counted in ``setup_s``, from the process's start): the inputs from
the seed, the program's data, the weights made on the card, the modules
built on the card, the checked iterations and one warm-up chunk of the
window's step (its CUDA graph captured). The window then calls that step
back to back for whole chunks until ``seconds`` have passed. A traced run
profiles the chunks of the window's second half, times each chunk with
CUDA events and, once the window has closed, each distinct conv call. Then
the window's step is held against the same iterations run eagerly, the
program's state is freed and the plain reference follows the checked
iterations.
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import time
from types import SimpleNamespace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks), else
    since ``fallback_t0`` on ``time.perf_counter``'s clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_t0


def sub_seed(seed: int, k: int) -> int:
    """The k-th stream of a run's seed (any whole number ≥ 0)."""
    return (int(seed) * 8 + k) % (2**63)


def cell_spec(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def reported(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones untraced (each
    in every cell, or in the cells its ``workloads`` lists), its per-layer
    ones traced (each in the cells its ``workloads`` lists)."""
    if trace:
        return [m for m in bench["per_layer"] if workload in m["workloads"]]
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]


def build(workload: str, seed: int, device: str, overrides: dict | None = None, stamp=None):
    """Set a cell up from its files: the inputs from the seed, the
    program's data, the weights on the device, the program's modules
    holding them and its loop. ``overrides`` (tests only): ``config``,
    ``traffic`` and ``limits`` entries that replace the files' values;
    ``stamp(name)`` marks the end of each stage."""
    stamp = stamp or (lambda name: None)
    import torch

    from benchmark.reference.nets import make_weights

    overrides = overrides or {}
    bench = load_json(ROOT, "BENCHMARK.json")
    spec = cell_spec(bench, workload)
    cfg = {**load_json(BENCH, "configs", spec["config"] + ".json"), **overrides.get("config", {})}
    traffic = {**load_json(BENCH, "traffic", spec["traffic"] + ".json"),
               **overrides.get("traffic", {})}
    limits = {**load_json(BENCH, "limits", workload + ".json"), **overrides.get("limits", {})}
    fam = cfg["family"]
    family = load_module(os.path.join(BENCH, "families", fam + ".py"), f"benchmark.families.{fam}")
    net = importlib.import_module(f"benchmark.reference.{fam}")
    phase = importlib.import_module(f"benchmark.phases.{traffic['phase']}")
    chunk = int(traffic["chunk"])

    from gennet_tpu_torch import runtime

    runtime.setup(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    stamp("device")
    data_gen = torch.Generator(device=dev)
    data_gen.manual_seed(sub_seed(seed, 0))
    inputs = family.make_inputs(cfg, data_gen)
    data = family.program_data(cfg, inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stamp("data")
    w_gen = torch.Generator(device=dev)
    w_gen.manual_seed(sub_seed(seed, 1))
    weights = {n: make_weights(net.param_specs(cfg, n), w_gen, dev) for n in phase.NETS}
    stamp("weights")
    with torch.device(dev):  # the constructors' own initialisation runs on the card
        modules = family.models(cfg, phase.NETS)
    stamp("modules")
    for n, mod in modules.items():
        mod.load_state_dict(weights[n], strict=True)
    loop_seed = sub_seed(seed, 2)
    loop = phase.Loop(cfg, data, modules, loop_seed, chunk, dev)
    return SimpleNamespace(bench=bench, spec=spec, cfg=cfg, traffic=traffic, limits=limits,
                           family=family, net=net, phase=phase, chunk=chunk, dev=dev,
                           inputs=inputs, data=data, weights=weights, modules=modules,
                           loop=loop, loop_seed=loop_seed)


def window(loop, seconds: float, spans, tracer=None, timed=False):
    """Whole chunks of ``loop``'s window step, back to back, each chunk's
    last metrics row fetched to the host, until ``seconds`` have passed.
    ``tracer``: profile the chunks that start in the second half; ``timed``:
    CUDA events around each chunk's call."""
    import torch

    out = SimpleNamespace(n_chunks=0, bad=0, chunk_ms=[], call_s=[], untraced_steps=0,
                          untraced_s=0.0)
    with contextlib.ExitStack() as stack:
        w0 = time.perf_counter()
        while True:
            if tracer is not None and tracer.t0 is None and time.perf_counter() - w0 >= seconds / 2:
                out.untraced_steps = out.n_chunks * loop.chunk
                out.untraced_s = time.perf_counter() - w0
                stack.enter_context(tracer.window())
            c0 = time.perf_counter()
            if timed:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            with spans.span("chunk_dispatch"):
                m = loop.call(loop.step)
            if timed:
                e1.record()
            with spans.span("metric_fetch"):
                vals = loop.fetch(m)
            out.call_s.append(time.perf_counter() - c0)
            if timed:
                out.chunk_ms.append(e0.elapsed_time(e1))
            out.n_chunks += 1
            out.bad += not all(math.isfinite(v) for v in vals.values())
            if time.perf_counter() - w0 >= seconds:
                break
    out.seconds = time.perf_counter() - w0
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: float | None = None, overrides: dict | None = None) -> dict:
    """Run a cell; return the result line's object."""
    import torch

    from benchmark.harness import env, flops
    from benchmark.harness.convtime import conv_table
    from benchmark.harness.spans import Spans

    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start": process_age_s(t0)}
    ctx = build(workload, seed, device, overrides,
                stamp=lambda name: phases.__setitem__(name, process_age_s(t0)))
    cfg, chunk, dev, loop = ctx.cfg, ctx.chunk, ctx.dev, ctx.loop
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    phases["built"] = process_age_s(t0)
    checked = loop.checked_steps()
    phases["checked"] = process_age_s(t0)
    loop.fetch(loop.call(loop.step))  # the warm-up chunk: the window step's capture
    if on_card:
        torch.cuda.synchronize()
    setup_s = phases["warm"] = process_age_s(t0)

    # ---- the window
    spans = Spans()
    tracer = loop.tracer(spans) if trace and on_card else None
    w = window(loop, seconds, spans, tracer, timed=trace and on_card)
    chips = ctx.spec["chips"]
    peak = loop.peak_bytes(chips) if on_card else 0

    # ---- what the metrics read, once the window has closed
    tagged = {n: [{**layer, "net": n} for layer in ctx.family.layers(cfg, n)]
              for n in ctx.phase.NETS}
    calls = ctx.phase.calls(cfg, tagged)
    run = SimpleNamespace(setup_s=setup_s, iterations=w.n_chunks * chunk, window_s=w.seconds,
                          call_s=w.call_s, chunk=chunk, chunk_ms=w.chunk_ms, trace=None,
                          untraced_rate=None, step_flops=flops.step_flops(calls), conv_rows=[])
    if tracer is not None and tracer.prof is not None:
        run.trace = tracer.reduce()
        if w.untraced_s > 0:
            run.untraced_rate = w.untraced_steps / w.untraced_s
        t_gen = torch.Generator(device=dev)
        t_gen.manual_seed(sub_seed(seed, 3))
        run.conv_rows = conv_table(calls, ctx.modules, dev, t_gen)
    loop.after_window(run, run.trace is not None)

    # ---- the window's step against its eager iterations; then, the
    # program's state freed, the plain reference
    numbers = loop.replay_check()
    ctx.loop = ctx.modules = ctx.data = loop = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers.update(ctx.phase.numbers(ctx, checked))
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in ctx.limits.items()}
    correct = w.bad == 0 and w.n_chunks > 0 and all(c["value"] <= c["limit"]
                                                    for c in checks.values())

    metrics = {}
    for m in reported(ctx.bench, workload, trace):
        reader = load_module(os.path.join(BENCH, "metrics", m["name"] + ".py"),
                             "benchmark.metrics." + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak),
                   "power_limit": env.power_limit() if on_card else None}
    result = {"correct": bool(correct), "attempted": w.n_chunks * chunk, "failed": w.bad * chunk,
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
        result["conv_calls"] = [list(r) for r in run.conv_rows]
    result["setup_phases_s"] = phases
    result["readings"] = numbers
    result["checks"] = checks
    return result
