#!/usr/bin/env python3
"""Drive the PyTorch port's flagship path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is non-zero:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions,
   the TF32 flags;
2. build: compile the port's CUDA kernels from ``gennet_tpu_torch/csrc/``;
3. kernel: the phasor → iDFT kernel against its plain PyTorch version on
   random inputs and at the bank's real pass-A and pass-B shapes
   (max|kernel − plain| / max|plain| ≤ 2e-5), with CUDA-event times;
4. slice: ``train-bbh`` through the CLI at n_pix 1024 with the full-width
   G, D and PE, 20 PE and 20 GAN steps, with the kernel's launch count
   read around the run;
5. throughput (information): bank templates/s, PE and GAN steps/s.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
repository beside this file, it exits non-zero and prints no result.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-5            # max|kernel − plain| / max|plain| (tests/test_pallas_ops.py:75-76)
N_TIMED = 20          # timed repetitions (median) after warm-up


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=N_TIMED, warmup=3) -> float:
    """Median of ``n`` CUDA-event timings of ``fn()`` after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(name, amp, phase, cos_t, sin_t, P):
    """Kernel vs plain on one input; returns (kernel out, plain out, abs err, rel err)."""
    import torch

    out = P.phasor_matmul(amp, phase, cos_t, sin_t)
    ref = P.phasor_matmul_ref(amp, phase, cos_t, sin_t)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{name}: kernel output not finite")
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    print(f"kernel {name}: B={amp.shape[0]} K={amp.shape[1]} T={cos_t.shape[1]} "
          f"max_abs_err={err:.3e} rel={rel:.3e} (limit {TOL:g})")
    if not rel <= TOL:
        fail(f"{name}: kernel disagrees with the plain version ({rel:.3e} > {TOL:g})")
    return out, ref, err, rel


def main():
    if not os.path.isdir(os.path.join(REPO, "gennet_tpu_torch")):
        fail(f"no gennet_tpu_torch package beside {__file__}: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, REPO)
    import numpy as np

    from gennet_tpu_torch import runtime
    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.ops import _build
    from gennet_tpu_torch.ops import phasor_dft as P
    from gennet_tpu_torch.physics import priors, psd as psd_mod

    # ---- 1. environment -------------------------------------------------
    card = card_line()
    info = runtime.setup("cuda")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    print("nvcc: " + ver.stdout.strip().splitlines()[-1])
    print(f"TF32: matmul={info['matmul_allow_tf32']} cudnn={info['cudnn_allow_tf32']}")
    dev = torch.device("cuda")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.BUILD_SECONDS:.1f} s)")
    print(_build.BUILD_LOG.strip())

    # ---- 3. kernel vs plain -----------------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (B, K, T) in (("random", (8, 256, 128)), ("ragged", (3907, 2049, 128))):
        amp = torch.rand((B, K), generator=g, device=dev)
        ph = 1e3 * torch.randn((B, K), generator=g, device=dev)
        C = torch.randn((K, T), generator=g, device=dev) / K
        S = torch.randn((K, T), generator=g, device=dev) / K
        compare(name, amp, ph, C, S, P)

    # the bank's real inputs: 4096 prior masses through the port's PhenomD
    # and whitening at the n_pix 1024 geometry (N = 4096, K = 2049)
    cfg = tb.BankConfig()
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device=dev)
    masses = priors.sample_masses(g, 4096, mdist=cfg.mdist)
    amp, phase, freqs = tb.whitened_ampphase(masses["m1"], masses["m2"], psd, cfg)
    N = cfg.n_safe
    a_start, a_width = tb.pass_a_slice(cfg)
    Ca, Sa = P.slice_tables(N, a_start, a_width, None, dev)
    h_k, h_p, err_a, _ = compare("pass A", amp, phase, Ca, Sa, P)
    phase_q = (phase + 0.5 * np.pi).contiguous()
    q_k, q_p, _, _ = compare("pass A quadrature", amp, phase_q, Ca, Sa, P)
    peak_k = torch.argmax(h_k * h_k + q_k * q_k, dim=-1)
    peak_p = torch.argmax(h_p * h_p + q_p * q_p, dim=-1)
    moved = float((peak_k != peak_p).float().mean())
    print(f"pass A peak index: kernel and plain disagree on {moved:.5f} of 4096 rows")
    idx = torch.randint(*cfg.beta_index_bounds(), (4096,), generator=g, device=dev)
    peak = peak_p.to(torch.int32) - a_width // 2  # offset from t = 0
    shift = (idx.to(torch.int32) - peak).to(torch.float32) / cfg.fs
    phase_b = (phase + 2.0 * np.pi * freqs * shift[:, None]).contiguous()
    b_start, b_width, b_weights = tb.pass_b_slice(cfg)
    Cb, Sb = P.slice_tables(N, b_start, b_width, b_weights, dev)
    _, _, err_b, rel_b = compare("pass B", amp, phase_b, Cb, Sb, P)

    amp = amp.contiguous()
    times = {}
    for tag, (ph, C, S) in (("pass A", (phase, Ca, Sa)), ("pass B", (phase_b, Cb, Sb))):
        k_ms = cuda_ms(lambda: P.phasor_matmul(amp, ph, C, S))
        p_ms = cuda_ms(lambda: P.phasor_matmul_ref(amp, ph, C, S))
        k2 = cuda_ms(lambda: P.phasor_matmul(amp, ph, C, S))
        p2 = cuda_ms(lambda: P.phasor_matmul_ref(amp, ph, C, S))
        times[tag] = (min(k_ms, k2), min(p_ms, p2))
        flops = 4.0 * amp.shape[0] * amp.shape[1] * C.shape[1]
        print(f"time {tag} (B=4096 K=2049 T={C.shape[1]}): kernel {k_ms:.3f}/{k2:.3f} ms, "
              f"plain {p_ms:.3f}/{p2:.3f} ms (median of {N_TIMED}, order kernel, plain, "
              f"kernel, plain); kernel {flops / (min(k_ms, k2) * 1e-3) / 1e12:.2f} TFLOP/s "
              f"[{card}]")

    # ---- 4. the slice: train-bbh through the CLI --------------------------
    from gennet_tpu_torch.cli.main import main as cli_main

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    n_pix, training_num, grain = 1024, 50_000, 95
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        argv = ["train-bbh", "--device", "cuda", "--n-pix", str(n_pix),
                "--training-num", str(training_num), "--pe-iters", "20", "--gan-iters", "20",
                "--cadence", "10", "--pe-cadence", "10", "--eval-cadence", "10",
                "--ckpt-every", "100000", "--plots", "false", "--out-dir", out_dir]
        P.LAUNCHES = 0
        t0 = time.perf_counter()
        out = cli_main(argv)
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
        launches = P.LAUNCHES
    # synthesis calls of the run: bank batches of 4096, the event template
    # (make_event) and its twin (make_bank), grid chunks of 4096, the sanity
    # set; each synthesis launches the kernel three times (pass A twice, B once)
    n_synth = math.ceil((training_num - 1) / 4096) + 2 + math.ceil(grain * grain / 4096) + 1
    print(f"slice: train-bbh finished in {slice_s:.1f} s; phasor kernel launches {launches} "
          f"(≥ {3 * n_synth} expected for {n_synth} syntheses)")
    if launches < 3 * n_synth:
        fail(f"the main path launched the kernel {launches} times, expected ≥ {3 * n_synth}")
    if out["final_step"] != 20:
        fail(f"final_step {out['final_step']} != 20")
    for key in ("beta", "grid_overlap"):
        v = out[key]
        if not isinstance(v, float) or not 0.0 <= v <= 1.0:
            fail(f"{key} = {v!r}, expected a float in [0, 1]")
    if out["cnn_sanity_beta"] is None:
        fail("cnn_sanity_beta is None")
    if not all(math.isfinite(x) for x in out["pe_rms"]):
        fail(f"pe_rms not finite: {out['pe_rms']}")
    print("slice summary: " + json.dumps({k: out[k] for k in (
        "final_step", "beta", "grid_overlap", "cnn_sanity_beta", "beta_sanity", "pe_rms",
        "pe_std")}))

    # ---- 5. throughput (information, warm, same process) -------------------
    from gennet_tpu_torch.models import BBHGenerator, DualBranchPE, PairDiscriminator
    from gennet_tpu_torch.train import cnn as tcnn
    from gennet_tpu_torch.train import gan as tgan

    bank, params = tb.make_bank(g, 4097, psd, cfg)  # warm-up at the batch size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank, params = tb.make_bank(g, 16385, psd, cfg)
    torch.cuda.synchronize()
    bank_rate = 16385 / (time.perf_counter() - t0)
    targets = torch.stack([params["mc"], params["q"]], -1).float()
    pe_cfg = tcnn.CNNConfig(n_pix=n_pix, ema_decay=0.999, lr_decay_steps=1000)
    pe = tcnn.init_cnn(torch.Generator().manual_seed(1), DualBranchPE(n_pix=n_pix), pe_cfg, dev)
    gan_cfg = tgan.GANConfig(n_pix=n_pix, label_smoothing=True, d_instance_noise=0.3,
                             d_lr_scale=0.5, d_acc_gate=0.9)
    gs = tgan.init_gan(torch.Generator().manual_seed(2), BBHGenerator(n_out=n_pix),
                       PairDiscriminator(n_pix=n_pix), gan_cfg, dev)
    measured = bank[-1] + torch.randn(n_pix, generator=g, device=dev)
    rates = {}
    for name, step in (("PE", lambda: tcnn.cnn_step(pe, bank, targets, g, cfg=pe_cfg)),
                       ("GAN", lambda: tgan.gan_step(gs, bank, measured, g, cfg=gan_cfg))):
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            step()
        torch.cuda.synchronize()
        rates[name] = 50 / (time.perf_counter() - t0)
    print(f"throughput: bank {bank_rate:.0f} templates/s (n_pix 1024, batches of 4096), "
          f"PE {rates['PE']:.1f} steps/s (batch 8), GAN {rates['GAN']:.1f} steps/s (batch 8) "
          f"[{card}]")

    k_ms, p_ms = times["pass B"]
    print(json.dumps({"kernels": [{
        "name": "phasor_irdft_f32", "route": "cuda",
        "source": "gennet_tpu_torch/csrc/phasor_irdft.cu",
        "replaces": "gennet_tpu/ops/phasor_dft.py:25",
        "launches": launches, "max_abs_err": max(err_a, err_b), "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
