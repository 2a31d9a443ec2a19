"""The GAN phase of a generator with BatchNorm (``benchmark/phases/gan.py``'s
loop, mix and operation counts), whose check and per-layer metrics cover
what BatchNorm adds: the running averages, which G's adversarial pass
commits inside the captured step, and the BatchNorm calls' time.

One iteration's BatchNorm calls, per layer: the D step's fake pass (batch
statistics, no gradient, nothing committed), and per G step the
adversarial pass (batch statistics, committed) and its backward.
"""

from benchmark.harness import loops
from benchmark.harness.compare import _leaf_gaps
from benchmark.harness.compare import readings as compare_readings
from benchmark.phases import gan
from benchmark.phases.gan import NETS, calls, reference_run  # noqa: F401  (the phase's own)
from benchmark.reference.bbh_pair import STATS


class Loop(gan.Loop):
    def params(self):
        G = self.state.generator
        return {**super().params(), **{f"generator.{k}": b.detach().clone()
                                       for k, b in G.named_buffers() if k.endswith(STATS)}}

    def after_window(self, run, traced: bool):
        """A traced run's ``bn_rows``: each BatchNorm call of one
        iteration timed alone (:func:`benchmark.harness.bntime.bn_table`)."""
        if not traced:
            return
        import importlib

        import torch

        from benchmark.harness.bntime import bn_table

        family = importlib.import_module(f"benchmark.families.{self.cfg['family']}")
        dev = self.gen.device
        t_gen = torch.Generator(device=dev)
        t_gen.manual_seed(self.gen.initial_seed() + 1)
        run.bn_rows = bn_table(bn_calls(self.cfg, family.norms(self.cfg)),
                               self.state.generator, dev, t_gen)


def bn_calls(cfg: dict, norms: list) -> list:
    """The BatchNorm calls of one iteration (:mod:`benchmark.harness.bntime`)."""
    g = cfg["gan"]
    B, S = g["batch_size"] * g["n_noise_real"], max(1, g["g_steps_per_iter"])
    return [{**nm, "call": kind, "B": B, "count": count} for nm in norms
            for kind, count in (("stats", 1), ("commit", S), ("bwd", S))]


def readings(prog: dict, ref: dict, init: dict) -> dict:
    """:func:`benchmark.harness.compare.readings`, with ``change`` also
    over G's running averages. These are no trained leaves, so they have
    no first gradient and ``compare`` leaves them out; here they are a
    group of their own, each gap scaled by the group's median leaf, as the
    EMA's are (``change_stats``), and ``change`` is the larger of the two."""
    out = compare_readings(prog, ref, init)
    stats = [k for k in ref["params"] if k.endswith(STATS)]
    out["change_stats"] = max(_leaf_gaps({k: prog["params"][k] - init[k] for k in stats},
                                         {k: ref["params"][k] - init[k] for k in stats}, stats))
    out["change"] = max(out["change"], out["change_stats"])
    return out


def numbers(ctx, checked: dict) -> dict:
    """The readings of the program's checked iterations against the plain
    reference, the running averages included (:func:`readings`)."""
    return readings(checked, loops.reference(ctx), loops.initial(ctx))
