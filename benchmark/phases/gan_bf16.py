"""The GAN phase of a BatchNorm generator on models that compute in a
reduced dtype (``benchmark/phases/gan_bn.py``'s loop, mix, check and
operation counts), whose check adds the dtype each layer computes in and
whose per-layer metrics time the conv, BatchNorm and conversion calls at
the cell's dtypes (:mod:`benchmark.harness.bf16time`).

The dtype check: while set-up runs the checked iterations, forward hooks
record the dtype of each listed layer's output (the family's
``compute_dtypes``: G's Dense, Conv_0-4 and norms, D's convs, G's output
conv and D's Dense); ``dtype`` counts the layers that computed in another
dtype than the configuration states, or not at all, and its limit is 0. A
tolerance cannot show that bf16 ran: bf16's error sits too close to
float32's.

One iteration's dtype conversions (:func:`conversions`): in each pass,
each layer casts its input where it arrives in another dtype, its weight
and bias where it computes below float32, and each norm makes a float32
round trip; autograd casts each such gradient back where the pass needs
it. The passes: the D step's fake batch (G, no gradient), D on the real
and the fake pairs (D's weights train, its input does not), and per G step
G (its weights train) into D (frozen, its input's gradient taken).
"""

import importlib

import torch

from benchmark.phases import gan_bn
from benchmark.phases.gan import NETS, calls, reference_run  # noqa: F401  (the phase's own)
from benchmark.phases.gan_bn import readings  # noqa: F401  (the phase's own)

F32 = torch.float32


class Loop(gan_bn.Loop):
    def checked_steps(self) -> dict:
        """``TrainLoop.checked_steps``, with the dtype of every listed
        layer's outputs recorded (``dtypes``: module path → the dtypes
        seen)."""
        family = importlib.import_module(f"benchmark.families.{self.cfg['family']}")
        nets = {"generator": self.state.generator, "discriminator": self.state.discriminator}
        seen, hooks = {}, []
        for path in family.compute_dtypes(self.cfg):
            net, name = path.split(".", 1)

            def hook(module, args, out, path=path):
                seen.setdefault(path, set()).add(out.dtype)
            hooks.append(nets[net].get_submodule(name).register_forward_hook(hook))
        try:
            out = super().checked_steps()
        finally:
            for h in hooks:
                h.remove()
        out["dtypes"] = seen
        return out

    def after_window(self, run, traced: bool):
        """A traced run's rows: ``bn_rows`` (each BatchNorm call at the
        layers' compute dtype, bf16 in and out), ``conv_rows_bf16`` (each
        distinct conv call of a bf16 layer on bf16 inputs) and
        ``cast_rows`` (each distinct dtype conversion), with
        ``casts_per_iteration``, the forward conversions one iteration
        makes, which the program's ``casts`` counter should read."""
        if not traced:
            return
        from benchmark.harness import bf16time

        family = importlib.import_module(f"benchmark.families.{self.cfg['family']}")
        dtypes = family.compute_dtypes(self.cfg)
        dev, s = self.gen.device, self.state
        t_gen = torch.Generator(device=dev)
        t_gen.manual_seed(self.gen.initial_seed() + 1)
        run.bn_rows = bf16time.bn_table(gan_bn.bn_calls(self.cfg, family.norms(self.cfg)),
                                        s.generator, dtypes["generator.norms.0"], dev, t_gen)
        tagged = {n: [{**layer, "net": n} for layer in family.layers(self.cfg, n)] for n in NETS}
        modules = {"generator": s.generator, "discriminator": s.discriminator}
        run.conv_rows_bf16 = bf16time.conv_table(calls(self.cfg, tagged), modules, dtypes, dev,
                                                 t_gen)
        conv = conversions(self.cfg, family.layers, family.norms(self.cfg), dtypes)
        run.cast_rows = bf16time.cast_table(conv, dev, t_gen)
        run.casts_per_iteration = sum(c["count"] for c in conv if c["call"] == "fwd")


def _walk(which, layers, norms, dtypes, B, params_grad, input_grad, in_dtype=F32) -> list:
    """One pass of a network: its conversions, forward and backward, each
    ``{"site", "call", "shape", "src", "dst"}``. ``params_grad``: its
    weights train; ``input_grad``: its input's gradient is taken."""
    out, cur, act_grad = [], in_dtype, input_grad

    def cast(site, shape, src, dst, grad):
        if src != dst:
            out.append({"site": site, "call": "fwd", "shape": shape, "src": src, "dst": dst})
            if grad:
                out.append({"site": site, "call": "bwd", "shape": shape, "src": dst, "dst": src})

    after = {"dense": "norms.0", **{f"convs.{i}": f"norms.{i + 1}" for i in range(len(norms))}}
    by_name = {nm["name"]: nm for nm in norms}
    for layer in layers:
        name, dt = layer["name"], dtypes[f"{which}.{layer['name']}"]
        if layer["kind"] == "conv":
            L, K, s = layer["L"], layer["K"], layer["stride"]
            pad = max((-(-L // s) - 1) * s + K - L, 0) if layer["padding"] == "SAME" else 0
            x, w, b = (B, layer["cin"], L + pad), (layer["cout"], layer["cin"], K), (layer["cout"],)
        else:
            x, w, b = (B, layer["fin"]), (layer["fout"], layer["fin"]), (layer["fout"],)
        cast(f"{which}.{name}.input", x, cur, dt, act_grad)
        cast(f"{which}.{name}.weight", w, F32, dt, params_grad)
        cast(f"{which}.{name}.bias", b, F32, dt, params_grad)
        cur, act_grad = dt, act_grad or params_grad
        norm = by_name.get(after.get(name)) if which == "generator" else None
        if norm is not None:
            nd, shape = dtypes[f"generator.{norm['name']}"], (B, *norm["shape"])
            cast(f"generator.{norm['name']}.input", shape, cur, F32, act_grad)
            act_grad = act_grad or params_grad
            cast(f"generator.{norm['name']}.output", shape, F32, nd, act_grad)
            cur = nd
    return out


def conversions(cfg: dict, layers, norms: list, dtypes: dict) -> list:
    """The dtype conversions of one iteration, each ``{"site", "call"
    ("fwd" or "bwd"), "shape", "src", "dst", "count"}``; ``layers(cfg,
    net)``, ``norms`` and ``dtypes`` are the family's."""
    g = cfg["gan"]
    B, S = g["batch_size"] * g["n_noise_real"], max(1, g["g_steps_per_iter"])
    G, D = layers(cfg, "generator"), layers(cfg, "discriminator")
    passes = [(_walk("generator", G, norms, dtypes, B, False, False), 1),    # D step's fake batch
              (_walk("discriminator", D, [], dtypes, B, True, False), 2),    # D on real and fake
              (_walk("generator", G, norms, dtypes, B, True, False), S),     # the G step(s)
              (_walk("discriminator", D, [], dtypes, B, False, True), S)]
    out = {}
    for convs, times in passes:
        for c in convs:
            key = (c["site"], c["call"], c["shape"], c["src"], c["dst"])
            out[key] = out.get(key, 0) + times
    return [{"site": k[0], "call": k[1], "shape": k[2], "src": k[3], "dst": k[4], "count": n}
            for k, n in out.items()]


def dtype_reading(cfg: dict, checked: dict) -> int:
    """The layers of the family's ``compute_dtypes`` that computed in
    another dtype than the configuration states, or not at all, in the
    checked iterations."""
    family = importlib.import_module(f"benchmark.families.{cfg['family']}")
    seen = checked["dtypes"]
    return sum(seen.get(path) != {dt} for path, dt in family.compute_dtypes(cfg).items())


def numbers(ctx, checked: dict) -> dict:
    """``gan_bn``'s readings, and ``dtype`` (:func:`dtype_reading`)."""
    return {**gan_bn.numbers(ctx, checked), "dtype": dtype_reading(ctx.cfg, checked)}
