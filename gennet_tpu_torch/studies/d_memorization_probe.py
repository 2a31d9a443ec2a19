"""Probe why the pair discriminator never loses (port of
``scripts/d_memorization_probe.py``).

The fake pair's channel 2 is ``measured − G(z)``, with ``measured`` one
fixed realization, while the real pair's channel 2 is fresh noise at each
draw. As G approaches the signal, the fake channel 2 converges to the
event's own noise vector, a constant D can memorize. The probe scores D on
seven pair families of 64 rows:

    A   real pairs          [bank row, fresh noise at n_sig]
    B   perfect-G pair      [signal, measured − signal]
    C   ch2-swapped perfect [signal, fresh noise at n_sig]
    C2  variance control    [signal, fresh noise at the event's noise std]
    C3  shuffled residual   [signal, permuted (measured − signal)]
    D   current fakes       [G(z), measured − G(z)]
    E   ch2-swapped fakes   [G(z), fresh noise at n_sig]

and prints each family's mean logit, P(real) and fraction of positive
logits, then the script's verdict: memorization when B < 0 < C2.

As in the script, the GAN state is the newest checkpoint: after a run with
evaluations that is the best-whiteness state parked at ``gan_iters + 1``,
not the last training state (ROADMAP queue 3; ``twin_cue_probe`` restores
the last one). The port prints the checkpoint index it restored beside
the state's step. G has the run's norm and D two channels, both in
float32; G's draws use its raw weights with dropout off and BatchNorm's
running statistics. Draws come from two ``torch.Generator`` streams
seeded 123 (rows, the three fresh-noise draws, the latents) and 7 (the
permutation, the fourth fresh-noise draw), the script's ``PRNGKey(123)``
and ``PRNGKey(7)``; the streams differ, and a test passes JAX's in.

Usage: python -m gennet_tpu_torch.studies.d_memorization_probe [RUN_DIR] [--device cuda]
       (RUN_DIR defaults to out/torch/bbh_sweeps/r4_r3probe_s0)
"""

import sys

import numpy as np
import torch

from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
from gennet_tpu_torch.studies import _run
from gennet_tpu_torch.train.gan import GANConfig, sample_generator

B = 64
FAMILIES = ("A real   [tmpl, fresh@n_sig]", "B perfect [sig, meas-sig]",
            "C swapped [sig, fresh@n_sig]", "C2 varctl [sig, fresh@true]",
            "C3 shuffl [sig, perm(meas-sig)]", "D fake    [G, meas-G]",
            "E swapped [G, fresh@n_sig]")


def families(G, state, gan_cfg, bank, signal, measured, n_sig: float, gen123, gen7,
             draws: dict | None = None) -> tuple:
    """The seven families' pairs (:67-107), by the script's labels, and the
    event's noise std. ``draws``: optional ``idx``, ``fresh1``-``fresh4``
    (unit normals), ``z`` (G's latents) and ``perm``."""
    d = draws or {}
    dev, n_pix = bank.device, signal.shape[-1]

    def normal(name, g, shape):
        x = d.get(name)
        x = torch.randn(shape, generator=g, device=g.device) if x is None else torch.as_tensor(x)
        return x.to(dev, torch.float32)

    idx = d.get("idx")
    if idx is None:
        idx = torch.randint(0, bank.shape[0], (B,), generator=gen123, device=gen123.device)
    tmpl = bank[torch.as_tensor(idx, device=dev)]
    fresh1 = normal("fresh1", gen123, tmpl.shape) * n_sig
    fresh2 = normal("fresh2", gen123, (B, n_pix)) * n_sig
    fresh3 = normal("fresh3", gen123, (B, n_pix)) * n_sig
    gz = sample_generator(G, state, gen123, B, gan_cfg, z=d.get("z")).reshape(B, -1)
    sig = signal.reshape(1, -1).expand(B, n_pix)
    meas = measured.reshape(1, -1).expand(B, n_pix)
    # the event noise in normalized units sits at std = norm, not n_sig:
    # the families below tell the memorized vector from its variance
    true_res = meas[0] - sig[0]
    true_std = float(true_res.cpu().numpy().std())
    perm = d.get("perm")
    if perm is None:
        perm = torch.randperm(n_pix, generator=gen7, device=gen7.device)
    shuf = true_res[torch.as_tensor(perm, device=dev)][None, :].expand(B, n_pix)
    fresh_true = normal("fresh4", gen7, (B, n_pix)) * true_std

    def pair(a, b):
        return torch.stack([a, b], dim=-1)

    xs = (pair(tmpl, fresh1), pair(sig, meas - sig), pair(sig, fresh2), pair(sig, fresh_true),
          pair(sig, shuf), pair(gz, meas - gz), pair(gz, fresh3))
    return dict(zip(FAMILIES, xs)), true_std


def family_stats(state, pairs: dict) -> dict:
    """label → (mean logit, mean P(real), fraction of logits > 0)."""
    out = {}
    with torch.no_grad():
        for name, x in pairs.items():
            logits = state.discriminator(x, train=False).reshape(-1).cpu().numpy()
            p = 1 / (1 + np.exp(-logits))
            out[name] = (float(logits.mean()), float(p.mean()), float((logits > 0).mean()))
    return out


def verdict(results: dict) -> str:
    """The script's reading of the family means (:120-132)."""
    if results["B"] < 0 and results["C"] > 0 and results["C2"] < 0:
        return ("VARIANCE CUE: B (true residual), C2 (fresh noise at the SAME std), and C "
                "(fresh at cfg.n_sig) differ only in ch2 distribution; D keys on the std "
                "mismatch cfg.n_sig vs the event's actual noise std (= norm). The pair game is "
                "unwinnable because the real pairs' fresh channel is drawn at the WRONG scale — "
                "fix n_sig, not the scheme.")
    if results["B"] < 0 and results["C2"] > 0:
        return ("MEMORIZATION CONFIRMED: fresh noise at the true std passes but the event's own "
                "noise vector fails — D memorized the fixed realization; no G can ever fool it.")
    return "Mixed cue: see per-family logits above."


def study(run_dir: str, device) -> dict:
    """The family table and verdict of one run; returns the mean logit by
    family (A, B, C, C2, C3, D, E), as the script does."""
    cfg = _run.load_bbh_config(run_dir)
    (bank, _, signal, measured, norm, _, _, _), _ = _run.bbh_event(cfg, device, skip_bank=False)
    gan_cfg = GANConfig(latent_dim=100, batch_size=cfg.batch_size, n_sig=cfg.n_sig, lr=cfg.lr,
                        label_smoothing=cfg.label_smoothing, d_instance_noise=cfg.instance_noise,
                        d_lr_scale=cfg.d_lr_scale, d_acc_gate=cfg.d_acc_gate,
                        residual_route=cfg.res_loss_weight > 0,
                        res_loss_weight=cfg.res_loss_weight, res_eval_mode=cfg.res_eval_mode)
    G = BBHGenerator(n_out=cfg.n_pix, conv_impl=cfg.conv_impl, norm=cfg.g_norm)
    D = PairDiscriminator(n_pix=cfg.n_pix, conv_impl=cfg.conv_impl)
    # the newest checkpoint, as the script restores it (see the module)
    state, index = _run.restore_gan(run_dir, G, D, gan_cfg, cfg.seed, device)
    print(f"restored GAN state at step {int(state.step)} (checkpoint index {index}; the run "
          f"trained {cfg.gan_iters} steps)")
    pairs, true_std = families(G, state, gan_cfg, bank, signal, measured, cfg.n_sig,
                               torch.Generator(device=device).manual_seed(123),
                               torch.Generator(device=device).manual_seed(7))
    print(f"cfg.n_sig={cfg.n_sig}  true residual std={true_std:.4f}  (norm={float(norm):.4f})")
    print(f"{'family':32s} {'mean logit':>10s} {'P(real)':>8s} {'frac>0':>7s}")
    results = {}
    for name, (mean, p, frac) in family_stats(state, pairs).items():
        results[name.split()[0]] = mean
        print(f"{name:32s} {mean:10.3f} {p:8.3f} {frac:7.2f}")
    print()
    print(verdict(results))
    return results


def main(argv=None) -> dict:
    args = _run.parse(argv, __doc__, ("run_dir", {"nargs": "?", "metavar": "RUN_DIR",
                                                  "default": f"{_run.BBH_OUT}/r4_r3probe_s0"}))
    return study(args.run_dir, torch.device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])
