#!/usr/bin/env python3
"""Time the port's CUDA kernels against plain PyTorch on one card.

    python3 kernel_times.py [--tree DIR] [--tag NAME] [--out FILE]

Imports ``gennet_tpu_torch`` from DIR (default: the checkout beside this
file), builds its kernels and times the kernel calls of ``chip_smoke.py``'s
phases 3 and 5: the phasor kernel at pass A and pass B on the bank's real
inputs (B 4096 and ``ml_recenter``'s 8), and the conv kernel at every call
of ``chip_smoke.conv_calls()``. The plain versions are defined here, so two
trees are held to the same plain code. CUDA events, the median of 20 after
3 warm-up calls, timed kernel, plain, kernel, plain; the better median of
each is kept.

With ``--steps`` it times the train-bbh default recipe's step rates instead
(GAN batch 8 at n_pix 1024 under ``conv_impl`` xla and pallas in the order
xla, pallas, pallas, xla, and the PE at batch 8; 50 warm steps each, host
clock around synchronised runs; random bank rows, as the rate does not
depend on them), then the wall time of one ``ml_recenter`` call at the
flagship geometry, as ``chip_smoke.py``'s throughput phase times it.

Each call appends one JSON line to --out. To compare two trees, run this on
both, one process after another on the same card, in the order parent,
change, change, parent: times move by several percent between machines.
"""

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE, help="checkout whose gennet_tpu_torch is timed")
    ap.add_argument("--tag", default="tree", help="label of the tree in the output")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "kernel_times.jsonl"))
    ap.add_argument("--steps", action="store_true", help="time train steps, not kernel calls")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    sys.path.insert(0, HERE)
    from chip_smoke import card_line, conv_calls, cuda_ms

    sys.path.insert(0, os.path.abspath(args.tree))
    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.ops import _build
    from gennet_tpu_torch.ops import conv1d as CV
    from gennet_tpu_torch.ops import phasor_dft as P
    from gennet_tpu_torch.physics import priors, psd as psd_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    _build.load()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "a")

    def record(kernel, call, flops, k1, k2, p1, p2):
        row = {"tag": args.tag, "kernel": kernel, "call": call, "ms": min(k1, k2),
               "plain_ms": min(p1, p2), "ms_both": [k1, k2], "plain_ms_both": [p1, p2],
               "tflops": flops / (min(k1, k2) * 1e-3) / 1e12, "card": card}
        out.write(json.dumps(row) + "\n")
        out.flush()
        print(f"[{args.tag}] {kernel} {call}: kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
              f"TFLOP/s), plain {row['plain_ms']:.4f} ms, ratio {row['ms'] / row['plain_ms']:.3f}")

    def timed(kernel, plain):
        return cuda_ms(kernel), cuda_ms(plain), cuda_ms(kernel), cuda_ms(plain)

    if args.steps:
        step_rates(args.tag, card, g, dev, out)
        out.close()
        return

    # ---- phasor: the bank's real inputs at n_pix 1024 (N 4096, K 2049)
    cfg = tb.BankConfig()
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device=dev)
    masses = priors.sample_masses(g, 4096, mdist=cfg.mdist)
    amp, phase, _ = tb.whitened_ampphase(masses["m1"], masses["m2"], psd, cfg)
    amp, phase = amp.contiguous(), phase.contiguous()
    tables = {"pass A": P.slice_tables(cfg.n_safe, *tb.pass_a_slice(cfg), None, dev),
              "pass B": P.slice_tables(cfg.n_safe, *tb.pass_b_slice(cfg), dev)}
    plain = lambda a, ph, C, S: (a * torch.cos(ph)) @ C + (a * torch.sin(ph)) @ S
    with torch.no_grad():
        for tag, (C, S) in tables.items():
            for n in (4096, 8):
                a, ph = amp[:n].contiguous(), phase[:n].contiguous()
                k1, p1, k2, p2 = timed(lambda: P.phasor_matmul(a, ph, C, S),
                                       lambda: plain(a, ph, C, S))
                record("phasor", f"{tag} B={n} K={a.shape[1]} T={C.shape[1]}",
                       4.0 * n * a.shape[1] * C.shape[1], k1, k2, p1, p2)

    # ---- conv: plain is F.conv1d at the stride with flax's SAME padding,
    # padded in the call where symmetric (as ops/conv1d.py::conv1d_ref)
    def conv_plain(x, w, b, s):
        L, K = x.shape[-1], w.shape[-1]
        total = max((-(-L // s) - 1) * s + K - L, 0)
        lo, hi = total // 2, total - total // 2
        if lo != hi:
            x, lo = F.pad(x, (lo, hi)), 0
        return F.conv1d(x, w, b, stride=s, padding=lo)

    for name, what, B, L, ci, co, s in conv_calls():
        x = torch.randn((B, ci, L), generator=g, device=dev)
        w = torch.randn((co, ci, 5), generator=g, device=dev) / math.sqrt(5 * ci)
        b = torch.randn((co,), generator=g, device=dev)
        call = f"{name} {what} B={B} L={L} Cin={ci} Cout={co} stride={s}"
        try:
            CV.conv1d(x, w, b, stride=s)
        except ValueError as e:  # a shape this tree's wrapper refuses
            out.write(json.dumps({"tag": args.tag, "kernel": "conv", "call": call,
                                  "refused": str(e)}) + "\n")
            print(f"[{args.tag}] conv {call}: refused ({e})")
            continue
        with torch.no_grad():
            k1, p1, k2, p2 = timed(lambda: CV.conv1d(x, w, b, stride=s),
                                   lambda: conv_plain(x, w, b, s))
        record("conv", call, 2.0 * B * -(-L // s) * 5 * ci * co, k1, k2, p1, p2)
        del x, w, b
    out.close()


def step_rates(tag, card, g, dev, out):
    """train-bbh's default-recipe GAN (xla, pallas, pallas, xla) and PE step
    rates at batch 8, n_pix 1024, and one ``ml_recenter`` call's wall time,
    on the imported tree."""
    import torch
    from chip_smoke import default_recipe_gans, ml_recenter_seconds, steps_per_s

    from gennet_tpu_torch.models import DualBranchPE
    from gennet_tpu_torch.train import cnn as tcnn
    from gennet_tpu_torch.train import gan as tgan

    n = 1024
    bank = torch.randn((4096, n), generator=g, device=dev)
    targets = torch.rand((4096, 2), generator=g, device=dev)
    measured = torch.randn(n, generator=g, device=dev)
    gan_cfg, gans = default_recipe_gans(n, dev)
    pe_cfg = tcnn.CNNConfig(n_pix=n, ema_decay=0.999, lr_decay_steps=1000)
    pe = tcnn.init_cnn(torch.Generator().manual_seed(1), DualBranchPE(n_pix=n), pe_cfg, dev)

    rates = {"xla": [], "pallas": []}
    for impl in ("xla", "pallas", "pallas", "xla"):
        rates[impl].append(steps_per_s(
            lambda: tgan.gan_step(gans[impl], bank, measured, g, cfg=gan_cfg)))
    rates["pe"] = [steps_per_s(lambda: tcnn.cnn_step(pe, bank, targets, g, cfg=pe_cfg))]
    for what, r in rates.items():
        out.write(json.dumps({"tag": tag, "steps": what, "steps_per_s": r, "card": card}) + "\n")
        print(f"[{tag}] {what} steps/s (batch 8, n_pix 1024): "
              + "/".join(f"{x:.2f}" for x in r))

    mlrc_s, _ = ml_recenter_seconds(g, dev)
    out.write(json.dumps({"tag": tag, "ml_recenter_s": mlrc_s, "card": card}) + "\n")
    print(f"[{tag}] ml_recenter (300 steps, 8 starts, n_pix 1024): {mlrc_s:.2f} s")


if __name__ == "__main__":
    main()
