"""The comparison that decides ``correct`` for a training cell.

The program's state is built from the benchmark's weights and driven
through its first iterations by the window's own step factory and feed
(:meth:`benchmark.harness.loops.TrainLoop.checked_steps`); the plain reference
follows the same iterations from the same weights, inputs and seed. The
readings below; a cell's limits file (``benchmark/limits/``) names the
ones it compares, each against its limit:

- ``loss``: the largest relative gap of a loss (``*_loss``) over the
  checked iterations; ``loss_first``: over the first iteration's losses;
  ``loss_pre``: over those of them taken before any update
  (:data:`PRE_UPDATE_LOSSES`; the adversarial loss is taken against D
  after D's first Adam step);
- ``grad``: the first gradient as each optimizer got it (its first moment
  after one iteration, over 1 − β1), by the worst leaf; ``grad_pre``: the
  same over the optimizers whose gradient precedes every update of the
  iteration (:data:`FIRST_STEPPED`); ``grad_median``: by the median leaf;
- ``change``: the change of the parameters over the checked iterations,
  by the worst leaf (``change_median``: the median leaf);
- ``ema``: the same of an EMA of the parameters, where the cell keeps one
  (the PE's); it moves a thousandth as far, so it is a number of its own.

A leaf's gap is the gap between the two sides' norms, not the norm of
their difference, over the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's (zero to rounding, so moved by Adam's
round-off alone) are left out of ``change``, by that rule and not by name.
"""

import statistics

import torch

NEGLIGIBLE = 1e-3
# the optimizers whose first gradient is taken before any parameter of the
# iteration has moved: D's, the residual route's (G has not stepped yet,
# and the route reads no D), the PE's. The adversarial G gradient is taken
# against D after D's first Adam step.
FIRST_STEPPED = ("d_opt", "g_res_opt", "opt")
# the losses taken before any parameter of the first iteration has moved
PRE_UPDATE_LOSSES = ("d_loss", "res_loss", "pe_loss")


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _leaf_gaps(prog: dict, ref: dict, keys) -> list:
    keys = list(keys)
    if not keys:
        return [0.0]
    pn = {k: _norm(prog[k]) for k in keys}
    rn = {k: _norm(ref[k]) for k in keys}
    med = statistics.median(rn.values())
    out = []
    for k in keys:
        scale = max(rn[k], med)
        gap = abs(pn[k] - rn[k])
        out.append(gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf")))
    return out


def kept_leaves(ref_grad1: dict) -> set:
    """Leaves whose reference first gradient (the largest over the
    optimizers that hold them) is at least a thousandth of the median's."""
    g = {}
    for grads in ref_grad1.values():
        for k, v in grads.items():
            g[k] = max(g.get(k, 0.0), _norm(v))
    med = statistics.median(g.values())
    return {k for k, v in g.items() if v >= NEGLIGIBLE * med}


def readings(prog: dict, ref: dict, init: dict) -> dict:
    """``prog``/``ref``: {"losses": {key: [per iteration]}, "grad1": {opt:
    {leaf: tensor}}, "params": {leaf: tensor}}; ``init``: the weights both
    started from, by leaf (an ``ema.`` leaf starts at its parameter's).
    Besides the numbers above, each leaf number's median-leaf form
    (``*_median``), the first iteration's loss gap (``loss_first``) and the
    loss gap of each iteration (``loss_by_iteration``)."""
    by_it, pre = [], 0.0
    for key in (k for k in prog["losses"] if k.endswith("_loss")):
        if key in PRE_UPDATE_LOSSES:
            p, r = prog["losses"][key][0], ref["losses"][key][0]
            pre = max(pre, abs(p - r) / max(abs(r), 1e-30))
        for i, (p, r) in enumerate(zip(prog["losses"][key], ref["losses"][key])):
            gap = abs(p - r) / max(abs(r), 1e-30)
            by_it = by_it + [0.0] * (i + 1 - len(by_it))
            by_it[i] = max(by_it[i], gap)
    kept = kept_leaves(ref["grad1"])
    grads = [_leaf_gaps(prog["grad1"][o], g, [k for k in g if k in kept])
             for o, g in ref["grad1"].items()]
    first = [g for o, g in zip(ref["grad1"], grads) if o in FIRST_STEPPED]
    out = {"loss": max(by_it), "loss_first": by_it[0], "loss_pre": pre,
           "loss_by_iteration": by_it,
           "grad": max(max(g) for g in grads), "grad_pre": max(max(g) for g in first),
           "grad_median": max(statistics.median(g) for g in grads)}

    def start(k):
        return init[k] if k in init else init["pe." + k.split(".", 1)[1]]

    def base(k):
        return k if k in kept else "pe." + k.split(".", 1)[1]

    # the parameters, and an EMA of them apart: its change is a thousandth
    # of theirs, so each is scaled by its own median leaf
    for name, group in (("change", [k for k in ref["params"] if not k.startswith("ema.")]),
                        ("ema", [k for k in ref["params"] if k.startswith("ema.")])):
        leaves = [k for k in group if base(k) in kept]
        if leaves:
            gaps = _leaf_gaps({k: prog["params"][k] - start(k) for k in leaves},
                              {k: ref["params"][k] - start(k) for k in leaves}, leaves)
            out[name], out[name + "_median"] = max(gaps), statistics.median(gaps)
    return out


def reference_run(run_cls, net, cfg, weights, data, loop_seed, n_steps, device,
                  fault=None) -> dict:
    """The reference's iterations (``run_cls`` over the family's networks
    ``net``): its losses, its optimizers' first gradients and its
    parameters after ``n_steps``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(loop_seed)
    run = run_cls(net, cfg, weights, data, gen, fault=fault)
    losses, grad1 = {}, None
    for _ in range(n_steps):
        m = run.step()
        for k, v in m.items():
            losses.setdefault(k, []).append(float(v))
        if grad1 is None:
            grad1 = {name: {f"{prefix}.{k}": v for k, v in opt.first_grad().items()}
                     for name, (opt, prefix) in run.optimizers().items()}
    return {"losses": losses, "grad1": grad1, "params": run.params()}
