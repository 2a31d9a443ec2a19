#!/usr/bin/env python3
"""Drive the PyTorch port's flagship paths once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is non-zero:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions,
   the TF32 flags;
2. build: compile the port's CUDA kernels from ``gennet_tpu_torch/csrc/``
   (one nvcc per source, started together);
3. phasor kernel: the phasor → iDFT kernel against its plain PyTorch
   version on random inputs and at the bank's real pass-A and pass-B
   shapes (max|kernel − plain| / max|plain| ≤ 2e-5), the pass-A peak
   index (≤ 1/64 of rows may move), both against float64 at pass B, two
   calls bitwise equal, with CUDA-event times (also at ``ml_recenter``'s
   B = 8);
4. phasor VJP: d_amp and d_phase through the kernel path's autograd
   Function against autograd through the plain version, at pass B and at
   B = 8 (≤ 1e-4·max);
5. conv kernel: the conv1d kernel against its plain version
   (``F.conv1d``, TF32 off; the strided layers through ``Conv1d``, flax
   padding) at the flagship's seven conv shapes, forward at batch 8 and
   256 (G Conv_0, D Conv_0 and D Conv_1 at their native stride 2) and dx
   at batch 8, every activation at G Conv_3's and G Conv_0's shapes, and
   Cin 2048 (≤ 1e-4·max against plain, ≤ 1e-5·max against float64), two
   calls bitwise equal, with CUDA-event times;
6. slice 1: ``train-bbh`` through the CLI at n_pix 1024 with the full-width
   G, D and PE, 20 PE and 20 GAN steps, default recipe, with the phasor
   kernel's launch count read around the run;
7. slice 2: the same with ``--conv-impl pallas`` and the posterior routes
   (ML recentering, likelihood resampling, ELBO library selection over two
   pooled snapshots), with both kernels' launch counts read around it;
8. throughput (information): bank templates/s, PE steps/s, and GAN steps/s
   with ``conv_impl`` xla and pallas in turns.

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
CONV_TOL = 1e-4       # conv kernel and phasor VJP: float32 sums of Cin·K terms in other orders
F64_TOL = 1e-5        # conv kernel against float64: 3xTF32 keeps float32-class accuracy
PEAK_TOL = 1 / 64     # pass-A peak rows that may move (tests/test_torch_bank.py's bound)
N_TIMED = 20          # timed repetitions (median) after warm-up
# (name, L in, Cin, Cout, stride) of the flagship's conv layers at n_pix 1024
CONV_LAYERS = [("G Conv_0", 1024, 256, 64, 2), ("G Conv_1", 1024, 64, 128, 1),
               ("G Conv_2", 1024, 128, 256, 1), ("G Conv_3", 1024, 256, 512, 1),
               ("G Conv_4", 1024, 512, 1024, 1), ("D Conv_0", 1024, 2, 256, 2),
               ("D Conv_1", 512, 256, 512, 2)]


def conv_calls() -> list:
    """(name, what, B, L, Cin, Cout, stride) of the conv kernel's timed
    calls: each layer's forward at batch 8 and 256 at its stride, its dx at
    batch 8 (stride 1, channels swapped), and one Cin 2048 forward."""
    calls = [(name, what, B, L, ci, co, s)
             for name, L, cin, cout, stride in CONV_LAYERS
             for what, B, ci, co, s in (("fwd", 8, cin, cout, stride),
                                        ("fwd", 256, cin, cout, stride), ("dx", 8, cout, cin, 1))]
    return calls + [("Cin 2048", "fwd", 8, 1024, 2048, 64, 1)]


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


def conv_compare(name, x, w, b, stride, act, C):
    """Conv kernel vs plain and both vs float64 on one input, and two kernel
    calls bitwise equal; returns (abs err, rel err, (kernel, plain) rel
    errors against float64)."""
    import torch

    out = C.conv1d(x, w, b, stride=stride, act=act)
    ref = C.conv1d_ref(x, w, b, stride=stride, act=act)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()) or out.shape != ref.shape:
        fail(f"conv {name}: kernel output not finite or of shape {tuple(out.shape)}")
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= CONV_TOL:
        fail(f"conv {name}: kernel disagrees with the plain version ({rel:.3e} > {CONV_TOL:g})")
    r64 = C.conv1d_ref(x.double(), w.double(), b.double(), stride=stride, act=act)
    e64 = tuple(float((y.double() - r64).abs().max() / r64.abs().max()) for y in (out, ref))
    if not e64[0] <= F64_TOL:
        fail(f"conv {name}: kernel off float64 by {e64[0]:.3e} of the maximum (> {F64_TOL:g})")
    if not torch.equal(out, C.conv1d(x, w, b, stride=stride, act=act)):
        fail(f"conv {name}: two calls on the same input differ")
    return err, rel, e64


def read_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


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
    from gennet_tpu_torch.ops import conv1d as CV
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

    # ---- 3. phasor kernel vs plain ----------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    for name, (B, K, T) in (("random", (8, 256, 128)), ("ragged", (3907, 2049, 128))):
        amp = torch.rand((B, K), generator=g, device=dev)
        ph = 1e3 * torch.randn((B, K), generator=g, device=dev)
        C = torch.randn((K, T), generator=g, device=dev) / K
        S = torch.randn((K, T), generator=g, device=dev) / K
        compare(name, amp, ph, C, S, P)
    # contiguous row views 4 and 8 bytes off 16-byte alignment (rows of 2049)
    compare("ragged row views", amp[1:-1], ph[2:], C, S, P)

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
    print(f"pass A peak index: kernel and plain disagree on {moved:.5f} of 4096 rows "
          f"(limit {PEAK_TOL:.5f})")
    if not moved <= PEAK_TOL:
        fail(f"pass A: the peak index moved on {moved:.5f} of the rows (> {PEAK_TOL:.5f})")
    idx = torch.randint(*cfg.beta_index_bounds(), (4096,), generator=g, device=dev)
    peak = peak_p.to(torch.int32) - a_width // 2  # offset from t = 0
    shift = (idx.to(torch.int32) - peak).to(torch.float32) / cfg.fs
    phase_b = (phase + 2.0 * np.pi * freqs * shift[:, None]).contiguous()
    b_start, b_width, b_weights = tb.pass_b_slice(cfg)
    Cb, Sb = P.slice_tables(N, b_start, b_width, b_weights, dev)
    out_b, ref_b, err_b, rel_b = compare("pass B", amp, phase_b, Cb, Sb, P)
    r64 = P.phasor_matmul_ref(amp.double(), phase_b.double(), Cb.double(), Sb.double())
    e64 = [float((y.double() - r64).abs().max() / r64.abs().max()) for y in (out_b, ref_b)]
    print(f"pass B against float64: kernel {e64[0]:.3e}, plain {e64[1]:.3e} (of the maximum)")
    del r64, out_b, ref_b
    for tag, ph, C, S in (("pass A", phase, Ca, Sa), ("pass B", phase_b, Cb, Sb)):
        if not torch.equal(P.phasor_matmul(amp, ph, C, S), P.phasor_matmul(amp, ph, C, S)):
            fail(f"phasor {tag}: two calls on the same input differ")
    print("phasor determinism: two calls bitwise equal at pass A and pass B")

    amp = amp.contiguous()
    times = {}
    for tag, n, (ph, C, S) in (("pass A", 4096, (phase, Ca, Sa)), ("pass B", 4096, (phase_b, Cb, Sb)),
                               ("pass A B=8", 8, (phase, Ca, Sa)), ("pass B B=8", 8, (phase_b, Cb, Sb))):
        a, ph = amp[:n].contiguous(), ph[:n].contiguous()
        k_ms = cuda_ms(lambda: P.phasor_matmul(a, ph, C, S))
        p_ms = cuda_ms(lambda: P.phasor_matmul_ref(a, ph, C, S))
        k2 = cuda_ms(lambda: P.phasor_matmul(a, ph, C, S))
        p2 = cuda_ms(lambda: P.phasor_matmul_ref(a, ph, C, S))
        times[tag] = (min(k_ms, k2), min(p_ms, p2))
        flops = 4.0 * n * a.shape[1] * C.shape[1]
        print(f"time {tag} (B={n} K=2049 T={C.shape[1]}): kernel {k_ms:.3f}/{k2:.3f} ms, "
              f"plain {p_ms:.3f}/{p2:.3f} ms (median of {N_TIMED}, order kernel, plain, "
              f"kernel, plain); kernel {flops / (min(k_ms, k2) * 1e-3) / 1e12:.2f} TFLOP/s "
              f"[{card}]")

    # ---- 4. phasor VJP: the kernel path's Function vs plain autograd ------
    vjp_err = 0.0
    for tag, n in (("pass B", amp.shape[0]), ("B = 8", 8)):
        a = amp[:n].detach().clone().requires_grad_()
        ph = phase_b[:n].detach().clone().requires_grad_()
        gy = torch.randn((n, Cb.shape[1]), generator=g, device=dev)
        got = torch.autograd.grad(P.phasor_matmul(a, ph, Cb, Sb), (a, ph), gy)
        ref = torch.autograd.grad(P.phasor_matmul_ref(a, ph, Cb, Sb), (a, ph), gy)
        torch.cuda.synchronize()
        for name, x, r in zip(("d_amp", "d_phase"), got, ref):
            err = float((x - r).abs().max())
            rel = err / float(r.abs().max())
            vjp_err = max(vjp_err, err)
            print(f"phasor VJP {tag} (B={n} K={a.shape[1]} T={Cb.shape[1]}) {name}: "
                  f"max_abs_err={err:.3e} rel={rel:.3e} (limit {CONV_TOL:g})")
            if not (bool(torch.isfinite(x).all()) and rel <= CONV_TOL):
                fail(f"phasor VJP {tag} {name}: kernel path disagrees with plain autograd")

    # ---- 5. conv kernel vs plain (F.conv1d through cuDNN, TF32 off) --------
    # forwards at the layer's stride (the strided layers against Conv1d's
    # flax-padded strided F.conv1d), dx at stride 1 on the zero-stuffed dy
    torch.backends.cudnn.allow_tf32 = False
    conv_err, conv_times = 0.0, {}
    calls = conv_calls()
    for name, what, B, L, ci, co, s in calls:
        x = torch.randn((B, ci, L), generator=g, device=dev)
        w = torch.randn((co, ci, 5), generator=g, device=dev) / math.sqrt(5 * ci)
        b = (torch.randn((co,), generator=g, device=dev) if what == "fwd"
             else torch.zeros((co,), device=dev))
        err, rel, e64 = conv_compare(f"{name} {what} B={B}", x, w, b, s, "none", CV)
        conv_err = max(conv_err, err)
        k1 = cuda_ms(lambda: CV.conv1d(x, w, b, stride=s))
        p1 = cuda_ms(lambda: CV.conv1d_ref(x, w, b, stride=s))
        k2 = cuda_ms(lambda: CV.conv1d(x, w, b, stride=s))
        p2 = cuda_ms(lambda: CV.conv1d_ref(x, w, b, stride=s))
        conv_times[(name, what, B)] = (min(k1, k2), min(p1, p2))
        flops = 2.0 * B * -(-L // s) * 5 * ci * co
        print(f"conv {name} {what} (B={B} L={L} Cin={ci} Cout={co} stride={s}): "
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit {CONV_TOL:g}); vs float64: kernel "
              f"{e64[0]:.2e} (limit {F64_TOL:g}), plain {e64[1]:.2e}; kernel {k1:.3f}/{k2:.3f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms (median of {N_TIMED}, order kernel, plain, kernel, "
              f"plain); kernel {flops / (min(k1, k2) * 1e-3) / 1e12:.2f} TFLOP/s, plain "
              f"{flops / (min(p1, p2) * 1e-3) / 1e12:.2f} TFLOP/s [{card}]")
        del x, w, b
    print(f"conv determinism: two calls bitwise equal at all {len(calls)} shapes")
    for name, _, cin, cout, _ in CONV_LAYERS:  # the weight pack kernel vs its torch version
        w = torch.randn((cout, cin, 5), generator=g, device=dev)
        for transposed in (False, True):
            if not torch.equal(CV._pack_on_card(w, transposed), CV.pack_weight(w, transposed)):
                fail(f"conv {name}: the pack kernel differs from pack_weight "
                     f"(transposed={transposed})")
    print("conv weight pack: the pack kernel equals pack_weight bit for bit at all 7 layers, "
          "forward and dx forms")
    for name, L, cin, cout, stride in (CONV_LAYERS[3], CONV_LAYERS[0]):  # every activation
        x = torch.randn((8, cin, L), generator=g, device=dev)
        w = torch.randn((cout, cin, 5), generator=g, device=dev) / math.sqrt(5 * cin)
        b = torch.randn((cout,), generator=g, device=dev)
        for act in ("none", "tanh", "leaky_relu", "relu"):
            err, rel, e64 = conv_compare(f"{name} act={act}", x, w, b, stride, act, CV)
            conv_err = max(conv_err, err)
            print(f"conv {name} act={act} (B=8 stride={stride}): max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (limit {CONV_TOL:g}); vs float64: kernel {e64[0]:.2e}, "
                  f"plain {e64[1]:.2e}")
        del x, w, b

    # ---- 6. slice 1: train-bbh through the CLI, default recipe -------------
    from gennet_tpu_torch.cli.main import main as cli_main

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    n_pix, training_num, grain = 1024, 50_000, 95
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        argv = ["train-bbh", "--device", "cuda", "--n-pix", str(n_pix),
                "--training-num", str(training_num), "--pe-iters", "20", "--gan-iters", "20",
                "--cadence", "10", "--pe-cadence", "10", "--eval-cadence", "10",
                "--ckpt-every", "100000", "--plots", "false", "--out-dir", out_dir]
        P.LAUNCHES = CV.LAUNCHES = 0
        t0 = time.perf_counter()
        out = cli_main(argv)
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - t0
        launches, conv_launches_1 = P.LAUNCHES, CV.LAUNCHES
    # synthesis calls of the run: bank batches of 4096, the event template
    # (make_event) and its twin (make_bank), grid chunks of 4096, the sanity
    # set; each synthesis launches the kernel three times (pass A twice, B once)
    n_synth = math.ceil((training_num - 1) / 4096) + 2 + math.ceil(grain * grain / 4096) + 1
    print(f"slice: train-bbh finished in {slice_s:.1f} s; phasor kernel launches {launches} "
          f"(≥ {3 * n_synth} expected for {n_synth} syntheses)")
    if launches < 3 * n_synth:
        fail(f"the main path launched the kernel {launches} times, expected ≥ {3 * n_synth}")
    if conv_launches_1 != 0:
        fail(f"conv_impl xla launched the conv kernel {conv_launches_1} times")
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

    # ---- 7. slice 2: --conv-impl pallas and the posterior routes ----------
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        argv = ["train-bbh", "--device", "cuda", "--n-pix", str(n_pix),
                "--training-num", str(training_num), "--pe-iters", "20", "--gan-iters", "20",
                "--cadence", "10", "--pe-cadence", "10", "--eval-cadence", "10",
                "--conv-impl", "pallas", "--pe-mlrc", "1", "--reweight-temper", "1.0",
                "--select-best", "elbo", "--n-snapshots", "2",
                "--ckpt-every", "100000", "--plots", "false", "--out-dir", out_dir]
        P.LAUNCHES = CV.LAUNCHES = 0
        t0 = time.perf_counter()
        out2 = cli_main(argv)
        torch.cuda.synchronize()
        slice2_s = time.perf_counter() - t0
        phasor_launches, conv_launches = P.LAUNCHES, CV.LAUNCHES
        rows = read_rows(os.path.join(out_dir, "bbh_metrics.jsonl"))
    # conv kernel: every GAN iteration runs G forward twice (D step, G step)
    # and D forward three times (real, fake, G step), 5 and 2 launches each
    # (their backwards add dx launches on top); posterior draws run G in
    # chunks of 256: 4000 draws at step 10, 2 snapshots × 2000 at step 20 and
    # again for the final library draw
    n_post = 4000
    draw_chunks = math.ceil(n_post / 256) + 2 * 2 * math.ceil(max(n_post // 2, 256) / 256)
    conv_expect = 20 * (2 * 5 + 3 * 2) + 5 * draw_chunks
    # phasor kernel: the syntheses of slice 1, plus ≥ 300 Adam steps × 3
    # launches in each of the 3 ml_recenter calls (two evals, the final draw)
    phasor_expect = 3 * n_synth + 3 * 3 * 300
    print(f"slice 2: train-bbh --conv-impl pallas with the posterior routes finished in "
          f"{slice2_s:.1f} s; conv kernel launches {conv_launches} (≥ {conv_expect} expected: "
          f"20 iterations × (2 G × 5 + 3 D × 2) forwards + {draw_chunks} draw chunks × 5), "
          f"phasor kernel launches {phasor_launches} (≥ {phasor_expect} expected: "
          f"3 × {n_synth} syntheses + 3 ml_recenter calls × 3 × 300)")
    if conv_launches < conv_expect:
        fail(f"slice 2 launched the conv kernel {conv_launches} times, expected ≥ {conv_expect}")
    if phasor_launches < phasor_expect:
        fail(f"slice 2 launched the phasor kernel {phasor_launches} times, "
             f"expected ≥ {phasor_expect}")
    if out2["final_step"] != 20:
        fail(f"slice 2: final_step {out2['final_step']} != 20")
    for key in ("beta", "grid_overlap"):
        v = out2[key]
        if not isinstance(v, float) or not 0.0 <= v <= 1.0:
            fail(f"slice 2: {key} = {v!r}, expected a float in [0, 1]")
    if not all(math.isfinite(x) for x in out2["pe_rms"]):
        fail(f"slice 2: pe_rms not finite: {out2['pe_rms']}")
    elbo_rows = [r for r in rows if "elbo" in r or "elbo_final" in r]
    if not elbo_rows:
        fail("slice 2: no elbo row in the metrics jsonl")
    if out2["selected_route"] is None:
        fail("slice 2: select_best=elbo selected no route")
    print("slice 2 summary: " + json.dumps({k: out2[k] for k in (
        "final_step", "beta", "grid_overlap", "beta_raw", "cnn_sanity_beta", "selected_route",
        "selected_at", "plateau_k", "pool_ess", "pe_rms")}) + " elbo rows: "
        + json.dumps(elbo_rows))

    # ---- 8. throughput (information, warm, same process) -------------------
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
    gans = {impl: tgan.init_gan(torch.Generator().manual_seed(2),
                                BBHGenerator(n_out=n_pix, conv_impl=impl),
                                PairDiscriminator(n_pix=n_pix, conv_impl=impl), gan_cfg, dev)
            for impl in ("xla", "pallas")}
    measured = bank[-1] + torch.randn(n_pix, generator=g, device=dev)

    def steps_per_s(step, n=50):
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    pe_rate = steps_per_s(lambda: tcnn.cnn_step(pe, bank, targets, g, cfg=pe_cfg))
    gan_rates = {"xla": [], "pallas": []}
    for impl in ("xla", "pallas", "pallas", "xla"):
        gan_rates[impl].append(steps_per_s(
            lambda: tgan.gan_step(gans[impl], bank, measured, g, cfg=gan_cfg)))
    # one ml_recenter call at the flagship geometry: 300 Adam steps through
    # the synthesis of 8 starts, 3 phasor launches and one VJP per step
    from gennet_tpu_torch.eval import posterior_post as pp

    def synth(sm):
        sm = torch.as_tensor(sm, dtype=torch.float32, device=dev)
        m1s, m2s = priors.mc_q_to_m1m2(torch.clamp(sm[:, 0], 5.0, 60.0),
                                       torch.clamp(sm[:, 1], 0.2, 1.0))
        return tb.make_templates_from_params(m1s, m2s, psd, cfg)

    rng = np.random.default_rng(0)
    event = synth([[28.1, 0.8]])[0] + torch.randn(cfg.n_out, generator=g, device=dev)
    cloud = np.column_stack([rng.normal(28.5, 0.5, 4000), rng.uniform(0.6, 0.95, 4000)])
    P.LAUNCHES = 0
    t0 = time.perf_counter()
    pp.ml_recenter(cloud, synth, event, g)
    torch.cuda.synchronize()
    mlrc_s, mlrc_launches = time.perf_counter() - t0, P.LAUNCHES
    fmt = lambda r: "/".join(f"{x:.1f}" for x in r)
    print(f"throughput: bank {bank_rate:.0f} templates/s (n_pix 1024, batches of 4096), "
          f"PE {pe_rate:.1f} steps/s (batch 8), GAN steps/s (batch 8, 50 steps each, order "
          f"xla, pallas, pallas, xla): xla {fmt(gan_rates['xla'])}, pallas "
          f"{fmt(gan_rates['pallas'])}; ml_recenter (300 steps, 8 starts, n_pix 1024) "
          f"{mlrc_s:.2f} s, {mlrc_launches} phasor launches [{card}]")

    def worst(table):
        """The timed shape with the largest kernel / plain ratio."""
        shape, (k, p) = max(table.items(), key=lambda kv: kv[1][0] / kv[1][1])
        return {"shape": " ".join(map(str, shape)) if isinstance(shape, tuple) else shape,
                "ms": k, "plain_ms": p, "ratio": k / p}

    # launches: slice 2, the path that runs both kernels; times: pass B and
    # G Conv_4's forward at batch 8, the largest call of each on the train path
    k_ms, p_ms = times["pass B"]
    ck_ms, cp_ms = conv_times[("G Conv_4", "fwd", 8)]
    print(json.dumps({"kernels": [{
        "name": "phasor_irdft_f32", "route": "cuda",
        "source": "gennet_tpu_torch/csrc/phasor_irdft.cu",
        "replaces": "gennet_tpu/ops/phasor_dft.py:25",
        "launches": phasor_launches, "max_abs_err": max(err_a, err_b), "ms": k_ms,
        "plain_ms": p_ms, "ms_worst_ratio": worst(times),
    }, {
        "name": "conv1d_same_f32", "route": "cuda",
        "source": "gennet_tpu_torch/csrc/conv1d_same.cu",
        "replaces": "gennet_tpu/ops/pallas_conv1d.py:50",
        "launches": conv_launches, "max_abs_err": conv_err, "ms": ck_ms, "plain_ms": cp_ms,
        "ms_worst_ratio": worst(conv_times),
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
