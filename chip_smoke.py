#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

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
   padding) at the flagship's eight conv shapes (D Conv_0 at Cin 2 and,
   for the raw-series D, Cin 1), forward at batch 8 and 256 (G Conv_0,
   D Conv_0 and D Conv_1 at their native stride 2) and dx at batch 8, every activation at G Conv_3's and G Conv_0's shapes, and
   Cin 2048 (≤ 1e-4·max against plain, ≤ 1e-5·max against float64), two
   calls bitwise equal, with CUDA-event times;
5b. stride-2 dx kernel (``ops/conv1d_dx.py``, :func:`conv_dx_check`): at
   each stride-2 layer whose dx the benchmark's cells route to it, the
   kernel against its plain version (≤ 1e-4·max), against float64 within
   twice cuDNN's FP32 dgrad's error on the same inputs, two calls bitwise
   equal, the pack kernel bit for bit, CUDA-event times beside cuDNN's
   dgrad; through ``Conv1d`` one dx launch, dw and db bitwise
   ``F.conv1d``'s, an eager backward bitwise equal to a captured replay;
   exactly 5 launches a ``DualBranchPE`` iteration and 1 a ``BurstPE``
   one, read at the chunk's capture;
5c. stride-2 dw kernel (``ops/conv1d_dw.py``, :func:`conv_dw_check`): at
   each stride-2 layer of the benchmark's cells (the narrow-input ones,
   Cin 1 and 2, included), the kernel against its plain version
   (≤ 1e-4·max), against float64 within twice cuDNN's FP32 wgrad's error
   on the same inputs, two calls bitwise equal, CUDA-event times beside
   cuDNN's wgrad; exactly 6 launches a ``DualBranchPE`` iteration and 2 a
   ``BurstPE`` one, read at the chunk's capture;
6. slice 1: ``train-bbh`` through the CLI at n_pix 1024 with the full-width
   G, D and PE, 20 PE and 20 GAN steps, default recipe, with the phasor
   kernel's launch count read around the run;
7. slice 2: the same with ``--conv-impl pallas`` and the posterior routes
   (ML recentering, likelihood resampling, ELBO library selection over two
   pooled snapshots), with both kernels' launch counts read around it;
8. slice 3: the same with ``--conv-impl pallas`` on the residual route (the
   spectral residual loss, D on the raw series at Cin 1, the diversity
   term, the terminal anneal, the early stop and the debug probes), with
   both kernels' launch counts against the count the code implies, every
   debug probe finite and D unmoved through the annealed half;
9. slice 4: ``smoke`` through the CLI at the reference widths (n_pix 512,
   50,000 signals, batch 64, grain 95, 4000 draws), 200 PE and 200 GAN
   steps with ELBO selection and the anneal (cuDNN convs, as the JAX
   burst models run ``nn.Conv``: neither kernel launches);
10. slice 5: the staged pipeline through the CLI at full width:
   ``make-bank`` of 50,000 templates at n_pix 1024 into a ``.gntb``
   (reopened with its checksum verified; shape, finite values, the prior's
   box, 3 phasor launches a synthesis), ``train-cnn`` on that file,
   ``train-gan --conv-impl pallas`` for 10 steps, then for 20, which must
   resume at step 10 (final step 20, the conv kernel launched for the 10
   new steps only, the restored state bitwise the saved one), and
   ``sample-posterior --conv-impl pallas --pe-mlrc 1`` (4000 finite draws,
   both kernels launched), with each stage's wall time;
11. slice 6: the reference's default flags, ``--bf16`` and the real-event
   route through the CLI at full width: ``train-bbh --bf16 true`` under
   ``--conv-impl`` xla and pallas (20 PE and 20 GAN steps and the final
   4000-draw eval; every logged loss finite, β and grid overlap in [0, 1],
   under pallas exactly 25 conv launches a GAN step and 80 for the draw);
   a product directory written by the port's ``write_synthetic_products``
   without the posterior file, its norm read back, ``make-bank
   --lalinf-dir`` on it and ``train-bbh --lalinf-dir --bank-file`` scored
   against the exact grid, with the phasor kernel's launches; and the plots:
   whether matplotlib imports here, then either a short ``train-bbh`` and
   ``smoke`` with plots on (their png names checked) or ``train-bbh`` with
   default flags refused before any work with an error naming matplotlib;
12. slice 7, data parallelism: ``make-bank --data-parallel`` of 50,000
   templates at world 1 over NCCL (one synthesis at B = 50,000: exactly 3
   phasor launches; the file reopened with its checksum verified, finite,
   in the prior's box; the kernel against its plain version at B = 50,000
   in passes A and B, on prior draws); ``train-bbh --data-parallel
   --conv-impl pallas --bank-file`` on it at world 1 against the same
   command without the flag (20 PE and 20 GAN steps and the final eval:
   bitwise-equal PE and GAN checkpoints, metric rows and summary, 580 conv
   launches each); a world of 2 over gloo with both ranks on this card,
   started with ``torch.multiprocessing`` (10 GAN steps under pallas at
   full width: G's output after the broadcast equal on both ranks, so no
   stale weight pack; exact checksums of weights, BN statistics and Adam
   states equal after every step; finite losses; 25 conv launches a step
   and no phasor launch per rank); and ``make-mdc -n 100`` (the XML read
   back, 200 ASCII files);
13. slice 8, the variant generations: whether cuDNN's backward of a 5 × 5
   2-D conv repeats bit for bit under its default algorithms (information)
   and under the deterministic ones ``runtime.setup`` pins (a check);
   ``blob-toy`` through the CLI at the reference's widths (n_pix 28,
   10,000 signals, batch 64, 1000 MC draws; 400 PE, 400 MC-dropout PE and
   400 GAN steps) and the same with ``--data-parallel`` at world 1
   (bitwise equal: summary and rows);
   ``image-gan`` (n_pix 32, batch 32, 200 steps) over the committed JPEGs
   when PIL imports, else the JPEG glob refused by name before any device
   work and a run over 16 seeded 64 × 64 P5 files; the softmax GAN (n_out
   512, batch 32; pretrain and 100 steps, with and without
   ``subtract_ht``), the denoiser GAN (n_out 50, 100 steps),
   ``train_autoencoder`` (100 epochs) and ``run_two_stage`` on the burst
   networks (n_pix 512, batch 64, 20 + 20 + 20), all losses finite;
   ``profile_trace`` around 5 image-GAN steps (a non-empty trace) and
   ``debug_nans`` raising on a NaN gradient; 0 launches of either kernel
   (the variant models are cuDNN and cuBLAS, as the reference's are
   ``nn.Conv``/``nn.Dense``); each stage's wall time and each loop's
   steps/s;
14. throughput (information): bank templates/s, PE steps/s, GAN steps/s
   with ``conv_impl`` xla and pallas in turns, each kernel's launches per
   GAN step and per synthesis, the burst PE and GAN steps/s, and (slice 6)
   GAN steps/s and the wall time of a 4000-draw posterior, bf16 against
   float32 under both implementations, in turns, three runs a side, with
   the conv kernel's launches per step and per draw in both dtypes, and
   the GAN steps/s of the flagship (``xla``), burst and image GANs under
   cuDNN's deterministic algorithms against its defaults, in turns, and
   ``ml_recenter`` as eager steps on slice 5's cloud;
15. slice 9, the fused step loops as CUDA-graph replays (n_pix 1024,
   batch 8, chunks of 100): a GAN chunk as replays against 100 eager steps
   under ``xla`` and ``pallas``, default recipe and residual route
   (parameters, Adam state, BN statistics, stacked metrics and generator
   bit for bit; 25 and 35 conv launches a replay, 25 a step confirmed by
   ``torch.profiler``'s kernel events over one chunk, with the idle share
   of a chunk each way); a 256-draw after the replays equal to the same
   draw with the weight-pack cache cleared; the balance gate at 0.9
   crossed both ways, D and its Adam state unchanged through every closed
   step; a PE chunk with the cosine decay; ``ml_recenter`` replayed
   against phase 14's eager call (bit for bit, 3 phasor launches a
   replay; a 10-step call's phasor kernel events under ``torch.profiler``
   equal to its counted launches and to those of the same call as eager
   steps); ``train-bbh --conv-impl pallas`` (200 PE and 200 GAN steps,
   cadence 100) and a ``--resume`` from its step 100, bit for bit, with
   the launch counts; then steps/s graph against eager in turns, three
   runs a side, for the PE and GAN loops at batch 8 and the burst GAN at
   batch 64, and the capture times (information);
16. slice 10, the names that closed the port's API gaps: ``rdft`` and
   ``irdft`` at B 4096, N 1024 against ``torch.fft`` (≤ 1e-5·max, with
   their times), their tables against numpy's bit for bit,
   ``sample_extrinsic`` on a CUDA generator (on the card, in range, the
   same draws twice from one seed), ``centered_tukey_window`` against its
   numpy form, the burst bank in bfloat16, ``overlap_tests`` on slice 5's
   cloud, the package-level imports (``from gennet_tpu_torch.train import
   GANConfig, init_gan``), and 0 launches of either kernel;
17. slice 11, the recipe runners (``gennet_tpu_torch.recipes``) at full
   width on short schedules, in a temporary directory:
   ``bbh_sweep.run_one("r4flag", ...)`` (100 PE and 200 GAN steps, an
   evaluation every 100, 1000 draws), ``burst_sweep.run_one("mlrc_sel",
   ...)`` (500 + 500 steps, an evaluation every 250) and ``run_flagship``
   to 100 steps, to 200 (resuming from step 100) and to 200 again (no step
   trained, no row appended); every row with the JAX runner's keys and its
   overlaps in [0, 1] or None where the JAX summary gives None; no conv
   launch, no phasor launch under ``mlrc_sel``, and under ``r4flag`` and
   each flagship run exactly the phasor launches that ``recipe_syntheses``
   counts from the code (2,844, 978, 1,011 and, for the run that trains
   nothing, the set-up's 57); each stage's wall;
18. slice 12, the post-run studies (``gennet_tpu_torch.studies``) at full
   width on slice 11's runs: ``bbh_postproc_eval``, ``elbo_stack_eval`` and
   ``twin_cue_probe`` on its ``r4flag`` run, ``bbh_sampler_calibration``
   refused there (its script restores the default G and the pair D);
   a short ``r4_r3probe`` run under ``--conv-impl pallas`` (100 PE and 100
   GAN steps, two evaluations), then ``d_memorization_probe`` and
   ``bbh_sampler_calibration`` on it (1000 draws a cell, not the study's
   4000: a cut of the study's depth; G still runs in chunks of 256 rows,
   so the kernels' shapes are those of 4000); ``burst_pool_study`` and
   ``burst_rescore_study`` on the ``mlrc_sel`` run; ``burst_debias_diag``;
   every row with the JAX script's keys and finite values (None where the
   script gives None), and each stage's phasor and conv launches exactly
   as the code implies; each stage's wall.

Every timed kernel call prints its bound: the larger of its operations
over 165 TFLOP/s (the 3xTF32 ceiling: 495 TFLOP/s of TF32 over three
products) and its bytes (each input read once, each output written once)
over 3.35 TB/s, with the one that bounds it. The line before the last is
the kernels' JSON summary; the last line is ``{"ok": true, "device":
{...}}``. Without a CUDA card, or without the repository beside this
file, it exits non-zero and prints no result.
"""

import functools
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
LIB_TOL = 1e-3        # the library call (irfft) against plain, of the maximum
N_TIMED = 20          # timed repetitions (median) after warm-up
PROFILE_MARGIN_S = 0.1  # idle host seconds at each end of a profiled chunk
PEAK_OPS = 165e12     # 3xTF32: the H100's 495 TFLOP/s of TF32 over three products
PEAK_BYTES = 3.35e12  # the H100's HBM3 rate, bytes/s
# (name, L in, Cin, Cout, stride) of the flagship's conv layers at n_pix 1024
# (D Conv_0 at Cin 1: the raw-series D of pair_d=False, slice 3)
CONV_LAYERS = [("G Conv_0", 1024, 256, 64, 2), ("G Conv_1", 1024, 64, 128, 1),
               ("G Conv_2", 1024, 128, 256, 1), ("G Conv_3", 1024, 256, 512, 1),
               ("G Conv_4", 1024, 512, 1024, 1), ("D Conv_0", 1024, 2, 256, 2),
               ("D Conv_1", 512, 256, 512, 2), ("D Conv_0 Cin 1", 1024, 1, 256, 2)]


def conv_calls() -> list:
    """(name, what, B, L, Cin, Cout, stride) of the conv kernel's timed
    calls: each layer's forward at batch 8 and 256 at its stride, its dx at
    batch 8 (stride 1, channels swapped), and one Cin 2048 forward."""
    calls = [(name, what, B, L, ci, co, s)
             for name, L, cin, cout, stride in CONV_LAYERS
             for what, B, ci, co, s in (("fwd", 8, cin, cout, stride),
                                        ("fwd", 256, cin, cout, stride), ("dx", 8, cout, cin, 1))]
    return calls + [("Cin 2048", "fwd", 8, 1024, 2048, 64, 1)]


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phasor_cost(B: int, K: int, T: int) -> tuple:
    """(flops, bytes) of one phasor call: two multiply-adds per (b, k, t);
    amp, phase and both tables read, the output written."""
    return 4.0 * B * K * T, 4.0 * (2 * B * K + 2 * K * T + B * T)


def conv_cost(B: int, L: int, cin: int, cout: int, stride: int, K: int = 5) -> tuple:
    """(flops, bytes) of one conv call: x, w, bias read, the output written."""
    L_out = -(-L // stride)
    return (2.0 * B * L_out * K * cin * cout,
            4.0 * (B * cin * L + cout * cin * K + cout + B * cout * L_out))


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


def graph_ms(fn, reps=N_TIMED, rounds=5) -> float:
    """Median over ``rounds`` of one replay's device ms, ``fn()`` captured
    once in a CUDA graph and replayed ``reps`` times a round: the kernel
    alone, without the host's launch time (which ``cuda_ms`` counts for a
    call shorter than its launch)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
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


# the stride-2 layers whose dx the conv1d_dx kernel computes in the
# benchmark's cells: (name, B, L in, Cin, Cout, padding)
DX_LAYERS = [("q_convs.3", 64, 1016, 256, 512, "VALID"), ("q_convs.4", 64, 506, 512, 1024, "VALID"),
             ("mc_convs.1", 64, 512, 64, 128, "VALID"), ("mc_convs.2", 64, 254, 128, 256, "VALID"),
             ("mc_convs.3", 64, 125, 256, 512, "VALID"),
             ("BurstPE conv1", 64, 256, 64, 128, "VALID"),
             ("G Conv_0", 8, 1024, 256, 64, "SAME"), ("D Conv_1", 8, 512, 256, 512, "SAME")]


def dx_cost(B: int, L: int, cin: int, cout: int, K: int = 5) -> tuple:
    """(flops, bytes) of one stride-2 dx over an input of length L: the
    forward's products; dy and w read, dx written."""
    Ly = (L - K) // 2 + 1
    return (2.0 * B * Ly * K * cin * cout,
            4.0 * (B * cout * Ly + cout * cin * K + B * cin * L))


def rel_max(a, b) -> float:
    """max |a − b| ÷ max |b|, in float64."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def s2_input(g, B: int, L_in: int, cin: int, padding: str):
    """A random input (B, cin, ·) on the card as a width-5 stride-2
    ``Conv1d`` hands it to ``F.conv1d``: padded by the flax SAME rule, or
    not (VALID)."""
    import torch
    import torch.nn.functional as F

    x = torch.randn((B, cin, L_in), generator=g, device="cuda")
    if padding == "SAME":
        total = max((-(-L_in // 2) - 1) * 2 + 5 - L_in, 0)
        x = F.pad(x, (total // 2, total - total // 2))
    return x


def pe_launches(ops, what: str, expect: dict, g, card) -> dict:
    """Launches of ``ops``' kernel (a wrapper with a ``LAUNCHES`` count) per
    PE iteration, read at the chunk's capture, and over a chunk of 5;
    ``expect`` gives each model's count an iteration."""
    import torch

    from gennet_tpu_torch import models
    from gennet_tpu_torch.train import cnn as tcnn

    dev = torch.device("cuda")
    launches = {}
    for name, n_pix in (("DualBranchPE", 1024), ("BurstPE", 512)):
        cfg = tcnn.CNNConfig(n_pix=n_pix, batch_size=64)
        st = tcnn.init_cnn(torch.Generator().manual_seed(1), getattr(models, name)(n_pix=n_pix),
                           cfg, dev)
        bank = torch.randn((4096, n_pix), generator=g, device=dev)
        targets = torch.rand((4096, 2), generator=g, device=dev)
        scan = tcnn.make_cnn_step_scan(st.model, cfg, 5)
        before = ops.LAUNCHES
        scan(st, bank, targets, torch.Generator(device=dev).manual_seed(2))
        per, total = scan.graph.launches.get(ops, 0), ops.LAUNCHES - before
        launches[name] = per
        print(f"{what} launches: {name} {per} an iteration at the capture, {total} over a "
              f"chunk of 5 (expected {expect[name]} and {5 * expect[name]}) [{card}]")
        if per != expect[name] or total != 5 * expect[name]:
            fail(f"{what}: {name} launched {per} an iteration, {total} a chunk")
    return launches


def conv_dx_check(S, card) -> dict:
    """The stride-2 dx kernel on the card (phase 5b); ``S`` is
    ``gennet_tpu_torch.ops.conv1d_dx``. Returns its rows by layer and its
    launches per PE iteration."""
    import torch
    import torch.nn.functional as F

    from gennet_tpu_torch.models.layers import Conv1d

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)

    rows = {}
    for name, B, L_in, cin, cout, padding in DX_LAYERS:
        x = s2_input(g, B, L_in, cin, padding)
        L = x.shape[-1]
        w = torch.randn((cout, cin, 5), generator=g, device=dev) / math.sqrt(5 * cin)
        dy = torch.randn((B, cout, (L - 5) // 2 + 1), generator=g, device=dev)
        got = S.conv1d_dx(dy, w, L)
        plain = S.conv1d_dx_ref(dy, w, L)

        def cudnn():
            return torch.nn.grad.conv1d_input(x.shape, w, dy, stride=2)

        n = min(B, 8)  # float64 on the card is slow: the first 8 rows, for both
        r64 = S.conv1d_dx_ref(dy[:n].double(), w.double(), L)
        err, e_k, e_c = rel_max(got, plain), rel_max(got[:n], r64), rel_max(cudnn()[:n], r64)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or not err <= CONV_TOL:
            fail(f"conv dx {name}: kernel off its plain version by {err:.3e} of the maximum")
        if not e_k <= 2 * e_c:
            fail(f"conv dx {name}: kernel off float64 by {e_k:.3e}, over twice cuDNN's {e_c:.3e}")
        if not torch.equal(got, S.conv1d_dx(dy, w, L)):
            fail(f"conv dx {name}: two calls on the same input differ")
        bn = S.tile_n(cin)
        if not torch.equal(S._pack_on_card(w, bn).view(torch.int32),
                           S.pack_weight(w, bn).view(torch.int32)):
            fail(f"conv dx {name}: the pack kernel differs from pack_weight")
        del r64, plain
        k1 = graph_ms(lambda: S.conv1d_dx(dy, w, L))
        c1 = graph_ms(cudnn)
        k2 = graph_ms(lambda: S.conv1d_dx(dy, w, L))
        c2 = graph_ms(cudnn)
        pack_ms = graph_ms(lambda: S._pack_on_card(w, bn))
        flops, nbytes = dx_cost(B, L, cin, cout)
        bms, bby = bound(flops, nbytes)
        k_ms, c_ms = min(k1, k2), min(c1, c2)
        rows[name] = {"B": B, "L": L, "cin": cin, "cout": cout, "kernel_ms": k_ms,
                      "cudnn_ms": c_ms, "pack_ms": pack_ms, "bound_ms": bms, "bound_by": bby,
                      "at": bms / k_ms, "cudnn_at": bms / c_ms, "rel_plain": err,
                      "f64_kernel": e_k, "f64_cudnn": e_c}
        print(f"conv dx {name} (B={B} L={L} Cin={cin} Cout={cout}): rel {err:.2e} against plain "
              f"(limit {CONV_TOL:g}); against float64 kernel {e_k:.2e}, cuDNN FP32 dgrad "
              f"{e_c:.2e}; kernel {k1:.4f}/{k2:.4f} ms, cuDNN dgrad {c1:.4f}/{c2:.4f} ms (graph "
              f"replays, order kernel, cuDNN, kernel, cuDNN), pack {pack_ms:.4f} ms; kernel "
              f"{flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s, cuDNN "
              f"{flops / (c_ms * 1e-3) / 1e12:.2f}; bound {bms:.4f} ms by {bby} "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at {bms / k_ms:.2f}, "
              f"cuDNN at {bms / c_ms:.3f} [{card}]")
        del x, w, dy, got

    # through the layer: one dx launch, dw and db bitwise F.conv1d's, and
    # an eager backward bitwise equal to a captured replay
    layer = Conv1d(512, 1024, 5, stride=2, padding="VALID").to(dev)
    x = torch.randn((64, 512, 506), generator=g, device=dev, requires_grad=True)
    params = (layer.weight, layer.bias)
    side = torch.cuda.Stream()  # the forward on the capture's stream, as its backward runs there
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = layer(x)
        dy = torch.randn(y.shape, generator=g, device=dev)
        before = S.LAUNCHES
        got = torch.autograd.grad(y, (x, *params), dy, retain_graph=True)
        launched = S.LAUNCHES - before
        want = torch.autograd.grad(F.conv1d(x, *params, stride=2), (x, *params), dy)
    torch.cuda.current_stream().wait_stream(side)
    if launched != 1 or not rel_max(got[0], want[0]) <= CONV_TOL:
        fail(f"conv dx layer: {launched} launches, dx off cuDNN's by "
             f"{rel_max(got[0], want[0]):.3e}")
    if not (rel_max(got[1], want[1]) <= CONV_TOL and torch.equal(got[2], want[2])):
        fail("conv dx layer: dw off cuDNN's (the dw kernel's), or db differs from F.conv1d's")
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        replayed = torch.autograd.grad(y, (x, *params), dy, retain_graph=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            replayed = torch.autograd.grad(y, (x, *params), dy, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    for t in replayed:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(replayed, got)):
        fail("conv dx layer: a captured replay differs from the eager backward")
    print(f"conv dx layer q_convs.4 through Conv1d: 1 dx launch; dw the dw kernel's, db bitwise "
          f"F.conv1d's; "
          f"an eager backward bitwise equal to a captured replay [{card}]")
    del layer, x, y, dy, got, want, replayed, graph

    launches = pe_launches(S, "conv dx", {"DualBranchPE": 5, "BurstPE": 1}, g, card)
    return {"rows": rows, "launches": launches}


# the stride-2 layers whose dw the conv1d_dw kernel computes in the
# benchmark's cells: (name, B, L in, Cin, Cout, padding)
DW_LAYERS = DX_LAYERS + [("mc_convs.0", 64, 1024, 1, 64, "SAME"),
                         ("BurstPE conv0", 64, 512, 1, 64, "SAME"),
                         ("D Conv_0 Cin 1", 8, 1024, 1, 256, "SAME"),
                         ("D Conv_0 Cin 2", 8, 1024, 2, 256, "SAME")]


def conv_dw_check(W, card) -> dict:
    """The stride-2 dw kernel on the card (phase 5c); ``W`` is
    ``gennet_tpu_torch.ops.conv1d_dw``. Returns its rows by layer and its
    launches per PE iteration."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)

    rows = {}
    for name, B, L_in, cin, cout, padding in DW_LAYERS:
        x = s2_input(g, B, L_in, cin, padding)
        L = x.shape[-1]
        dy = torch.randn((B, cout, (L - 5) // 2 + 1), generator=g, device=dev)
        got = W.conv1d_dw(dy, x, 5)
        plain = W.conv1d_dw_ref(dy, x, 5)

        def cudnn():
            return torch.nn.grad.conv1d_weight(x, (cout, cin, 5), dy, stride=2)

        r64 = W.conv1d_dw_ref(dy.double(), x.double(), 5)
        err, e_k, e_c = rel_max(got, plain), rel_max(got, r64), rel_max(cudnn(), r64)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or not err <= CONV_TOL:
            fail(f"conv dw {name}: kernel off its plain version by {err:.3e} of the maximum")
        if not e_k <= 2 * e_c:
            fail(f"conv dw {name}: kernel off float64 by {e_k:.3e}, over twice cuDNN's {e_c:.3e}")
        if not torch.equal(got, W.conv1d_dw(dy, x, 5)):
            fail(f"conv dw {name}: two calls on the same input differ")
        del r64, plain
        k1 = graph_ms(lambda: W.conv1d_dw(dy, x, 5))
        c1 = graph_ms(cudnn)
        k2 = graph_ms(lambda: W.conv1d_dw(dy, x, 5))
        c2 = graph_ms(cudnn)
        flops, nbytes = dx_cost(B, L, cin, cout)  # the same products and tensors as dx
        bms, bby = bound(flops, nbytes)
        k_ms, c_ms = min(k1, k2), min(c1, c2)
        plan = W.plan(B, dy.shape[-1], cin, cout, 5, torch.cuda.get_device_properties(dev)
                      .multi_processor_count)
        rows[name] = {"B": B, "L": L, "cin": cin, "cout": cout, "plan": plan, "kernel_ms": k_ms,
                      "cudnn_ms": c_ms, "bound_ms": bms, "bound_by": bby, "at": bms / k_ms,
                      "cudnn_at": bms / c_ms, "rel_plain": err, "f64_kernel": e_k,
                      "f64_cudnn": e_c}
        print(f"conv dw {name} (B={B} L={L} Cin={cin} Cout={cout}; BN, MT, splits {plan}): rel "
              f"{err:.2e} against plain (limit {CONV_TOL:g}); against float64 kernel {e_k:.2e}, "
              f"cuDNN FP32 wgrad {e_c:.2e}; kernel {k1:.4f}/{k2:.4f} ms, cuDNN wgrad "
              f"{c1:.4f}/{c2:.4f} ms (graph replays, order kernel, cuDNN, kernel, cuDNN); "
              f"kernel {flops / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s, cuDNN "
              f"{flops / (c_ms * 1e-3) / 1e12:.2f}; bound {bms:.4f} ms by {bby} "
              f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at {bms / k_ms:.3f}, "
              f"cuDNN at {bms / c_ms:.3f} [{card}]")
        del x, dy, got

    launches = pe_launches(W, "conv dw", {"DualBranchPE": 6, "BurstPE": 2}, g, card)
    return {"rows": rows, "launches": launches}


def read_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def steps_per_s(step, n=50) -> float:
    """The rate of ``step()`` over ``n`` calls after 5 warm-up calls: the
    host clock around synchronised runs."""
    import torch

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def default_recipe_gans(n_pix, dev) -> tuple:
    """(GANConfig, {conv_impl: GANState}): train-bbh's default recipe at
    batch 8 under ``conv_impl`` xla and pallas, from the same seed."""
    import torch

    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.train import gan as tgan

    gan_cfg = tgan.GANConfig(n_pix=n_pix, label_smoothing=True, d_instance_noise=0.3,
                             d_lr_scale=0.5, d_acc_gate=0.9)
    return gan_cfg, {impl: tgan.init_gan(torch.Generator().manual_seed(2),
                                         BBHGenerator(n_out=n_pix, conv_impl=impl),
                                         PairDiscriminator(n_pix=n_pix, conv_impl=impl),
                                         gan_cfg, dev)
                     for impl in ("xla", "pallas")}


def ml_recenter_seconds(g, dev, cloud=None, eager=False, steps=300, profile=False) -> dict:
    """One ``ml_recenter`` call at the flagship geometry: ``steps`` Adam
    steps through the synthesis of 8 starts, 3 phasor launches and one VJP
    a step, on ``cloud`` (4000, 2) (a synthetic one by default). ``eager``:
    its steps run eagerly on the card (``graphs.graphable`` refuses for the
    call); ``profile``: the call runs under :func:`_profiled_chunk`.
    Returns {"s": wall, "launches": phasor launches counted, "out":
    recentred cloud, "graph": the StepGraph the steps ran with, "profile":
    the profiler's reading or None}."""
    import numpy as np
    import torch

    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.eval import posterior_post as pp
    from gennet_tpu_torch.ops import phasor_dft as P
    from gennet_tpu_torch.physics import priors, psd as psd_mod
    from gennet_tpu_torch.runtime import graphs

    cfg = tb.BankConfig()
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device=dev)

    def synth(sm):
        sm = torch.as_tensor(sm, dtype=torch.float32, device=dev)
        m1s, m2s = priors.mc_q_to_m1m2(torch.clamp(sm[:, 0], 5.0, 60.0),
                                       torch.clamp(sm[:, 1], 0.2, 1.0))
        return tb.make_templates_from_params(m1s, m2s, psd, cfg)

    rng = np.random.default_rng(0)
    event = synth([[28.1, 0.8]])[0] + torch.randn(
        cfg.n_out, generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    if cloud is None:
        cloud = np.column_stack([rng.normal(28.5, 0.5, 4000), rng.uniform(0.6, 0.95, 4000)])
    made, res = [], {}

    class Kept(graphs.StepGraph):  # the call's own StepGraph, kept to be read
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    saved = graphs.StepGraph, graphs.graphable
    graphs.StepGraph = Kept
    if eager:
        graphs.graphable = lambda *a, **kw: False
    try:
        def call():
            res["out"] = pp.ml_recenter(cloud, synth, event, g, steps=steps)

        torch.cuda.synchronize()
        P.LAUNCHES = 0
        t0 = time.perf_counter()
        res["profile"] = _profiled_chunk(call, "phasor_kernel") if profile else call()
        torch.cuda.synchronize()
        res["s"] = time.perf_counter() - t0
    finally:
        graphs.StepGraph, graphs.graphable = saved
    return {**res, "launches": P.LAUNCHES, "graph": made[0]}


def same_tree(a, b, path="state") -> list:
    """Paths at which two nested state dicts differ (tensors bitwise)."""
    import torch

    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [path]
        return [p for k in a for p in same_tree(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in same_tree(x, y, f"{path}.{i}")]
    if torch.is_tensor(a):
        return [] if torch.equal(a.cpu(), b.cpu()) else [path]
    return [] if a == b else [path]


def slice5(cli_main, P, CV, build, card) -> tuple:
    """The staged pipeline through the CLI at full width: ``make-bank`` of
    50,000 templates at n_pix 1024 into a ``.gntb``, ``train-cnn`` on that
    file, ``train-gan --conv-impl pallas`` for 10 steps and again for 20
    (which resumes at step 10), then ``sample-posterior --conv-impl pallas
    --pe-mlrc 1``. Returns ({kernel: launches}, {stage: wall s}, the
    posterior samples (4000, 2))."""
    import numpy as np
    import torch

    from gennet_tpu_torch.data import bankstore
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.train import gan as tgan
    from gennet_tpu_torch.train.checkpoints import CheckpointManager, state_dict_of

    n_bank, n_pix = 50_000, 1024
    launches, stage_s = {"phasor": 0, "conv": 0}, {}

    def stage(name, argv):
        P.LAUNCHES = CV.LAUNCHES = 0
        t0 = time.perf_counter()
        out = cli_main(argv)
        torch.cuda.synchronize()
        stage_s[name] = time.perf_counter() - t0
        counts = (P.LAUNCHES, CV.LAUNCHES)
        launches["phasor"] += counts[0]
        launches["conv"] += counts[1]
        print(f"slice 5: {name} finished in {stage_s[name]:.1f} s; kernel launches phasor "
              f"{counts[0]}, conv {counts[1]} [{card}]")
        return out, counts

    with tempfile.TemporaryDirectory(dir=build) as work:
        bank = os.path.join(work, "bank.gntb")
        run = os.path.join(work, "run")
        _, (ph, cv) = stage("make-bank", ["make-bank", "--device", "cuda", "-N", str(n_bank),
                                          "-f", str(n_pix), "-b", bank])
        # batches of 4096 and the event twin, 3 launches a synthesis
        n_synth = math.ceil((n_bank - 1) / 4096) + 1
        if (ph, cv) != (3 * n_synth, 0):
            fail(f"slice 5: make-bank launched phasor {ph}, conv {cv}; expected "
                 f"{3 * n_synth} ({n_synth} syntheses) and 0")
        t0 = time.perf_counter()
        with bankstore.BankStore(bank, verify=True) as store:  # the checksum is verified on open
            open_s = time.perf_counter() - t0
            shape = (store.n, store.n_pix)
            templates, params = np.array(store.templates), np.array(store.params)
        finite = bool(np.isfinite(templates).all())
        mc, q = params[:, 0], params[:, 1]
        if shape != (n_bank, n_pix) or not finite:
            fail(f"slice 5: the bank file holds {shape}, finite {finite}")
        eps = 1e-4  # mc recomputed in float32 from (m1, m2) may cross the box by an ulp
        if not (mc.min() >= 20 - eps and mc.max() <= 35 + eps and q.min() >= 0.5 - eps
                and q.max() <= 1.0):
            fail(f"slice 5: (mc, q) outside the hunt_constrain box: mc [{mc.min()}, {mc.max()}], "
                 f"q [{q.min()}, {q.max()}]")
        t0 = time.perf_counter()  # the write alone (information): the same arrays again
        bankstore.write_bank(os.path.join(work, "again.gntb"), templates, params)
        write_s = time.perf_counter() - t0
        del templates, params
        print(f"slice 5: make-bank {n_bank} templates at n_pix {n_pix}: "
              f"{n_bank / stage_s['make-bank']:.0f} templates/s (the whole command: synthesis, "
              f"copy to the host, checksummed write, and the first use's g++ build of the bank "
              f"store, {bankstore.BUILD_SECONDS:.2f} s); the .gntb write alone {write_s:.2f} s, "
              f"its verified open {open_s:.2f} s [{card}]")

        common = ["--device", "cuda", "--n-pix", str(n_pix), "--bank-file", bank, "--out-dir", run,
                  "--cadence", "10", "--pe-cadence", "10", "--eval-cadence", "100000",
                  "--ckpt-every", "100000", "--plots", "false"]
        out, _ = stage("train-cnn", ["train-cnn", *common, "--pe-iters", "20"])
        if not all(math.isfinite(x) for x in out["pe_rms"]):
            fail(f"slice 5: train-cnn pe_rms {out['pe_rms']}")
        # conv kernel (train/gan.py::gan_update, default recipe): 25 a GAN
        # step, and 5 for each of the final draw's 16 chunks of 256
        per_call = 10 * 25 + 5 * math.ceil(4000 / 256)
        for gan_iters in (10, 20):
            out, (_, cv) = stage(f"train-gan --gan-iters {gan_iters}",
                                 ["train-gan", *common, "--conv-impl", "pallas",
                                  "--gan-iters", str(gan_iters)])
            if out["final_step"] != gan_iters:
                fail(f"slice 5: train-gan --gan-iters {gan_iters} ended at {out['final_step']}")
            if cv != per_call:
                fail(f"slice 5: train-gan --gan-iters {gan_iters} launched the conv kernel {cv} "
                     f"times; 10 steps after the restored one imply {per_call}")
            if gan_iters == 10:
                # what the second call restores: bitwise the saved state
                ckpt = os.path.join(run, "ckpt_gan")
                saved = torch.load(os.path.join(ckpt, "ckpt_10.pt"), map_location="cpu",
                                   weights_only=True)
                state = tgan.init_gan(torch.Generator().manual_seed(0),
                                      BBHGenerator(n_out=n_pix, conv_impl="pallas"),
                                      PairDiscriminator(n_pix=n_pix, conv_impl="pallas"),
                                      tgan.GANConfig(n_pix=n_pix), "cuda")
                CheckpointManager(ckpt).restore(state)
                diff = same_tree(state_dict_of(state), saved["state"])
                if state.step != 10 or diff:
                    fail(f"slice 5: the restored GAN state (step {state.step}) differs from the "
                         f"saved one at {diff[:5]}")
                del state, saved
                print("slice 5: the GAN state restored from step 10 equals the saved one bit "
                      "for bit (weights, BN statistics, three Adam states, step)")
        post = os.path.join(work, "posterior.npz")
        out, (ph, cv) = stage("sample-posterior",
                              ["sample-posterior", "--device", "cuda", "--n-pix", str(n_pix),
                               "--out-dir", run, "--conv-impl", "pallas", "--pe-mlrc", "1",
                               "--n-samples", "4000", "--out", post])
        data = np.load(post)
        samples, wf = data["samples"], data[out["waveforms_key"]]
        if samples.shape != (4000, 2) or not np.isfinite(samples).all() or wf.shape != (4000,
                                                                                        n_pix):
            fail(f"slice 5: sample-posterior wrote samples {samples.shape}, draws {wf.shape}")
        # 16 draw chunks × 5 convs; ml_recenter: 300 Adam steps × 3 phasor
        if cv < 5 * math.ceil(4000 / 256) or ph < 3 * 300:
            fail(f"slice 5: sample-posterior launched phasor {ph}, conv {cv}")
        print("slice 5 summary: " + json.dumps({
            "stage_s": stage_s, "launches": launches, "posterior_mean": samples.mean(0).tolist(),
            "posterior_std": samples.std(0).tolist()}))
    return launches, stage_s, samples


def slice6_bf16(cli_main, P, CV, build, card, n_synth) -> dict:
    """``train-bbh --bf16 true`` through the CLI with the default recipe at
    n_pix 1024 under ``--conv-impl`` xla and pallas: 20 PE and 20 GAN
    steps, then the final 4000-draw eval. Returns {impl: (phasor, conv)
    launches}."""
    import torch

    launches = {}
    for impl in ("xla", "pallas"):
        with tempfile.TemporaryDirectory(dir=build) as out_dir:
            argv = ["train-bbh", "--device", "cuda", "--bf16", "true", "--conv-impl", impl,
                    "--pe-iters", "20", "--gan-iters", "20", "--cadence", "10", "--pe-cadence",
                    "10", "--eval-cadence", "100000", "--ckpt-every", "100000", "--plots",
                    "false", "--out-dir", out_dir]
            P.LAUNCHES = CV.LAUNCHES = 0
            t0 = time.perf_counter()
            out = cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[impl] = (P.LAUNCHES, CV.LAUNCHES)
            rows = read_rows(os.path.join(out_dir, "bbh_metrics.jsonl"))
        losses = [(r["step"], k, r[k]) for r in rows for k in r if k.endswith("_loss")]
        n_gan = sum(1 for r in rows if "d_loss" in r)
        n_pe = sum(1 for r in rows if "pe_loss" in r)
        bad = [x for x in losses if not math.isfinite(x[2])]
        if bad or (n_pe, n_gan) != (2, 2):
            fail(f"slice 6 bf16 {impl}: non-finite losses {bad}, {n_pe} PE and {n_gan} GAN rows")
        for key in ("beta", "grid_overlap"):
            v = out[key]
            if not isinstance(v, float) or not 0.0 <= v <= 1.0:
                fail(f"slice 6 bf16 {impl}: {key} = {v!r}, expected a float in [0, 1]")
        # the float32 count (slice 5, and per step and per draw below): 25 a
        # GAN step, 16 draw chunks × 5 for the 4000-draw eval
        conv_expect = 20 * 25 + 5 * math.ceil(4000 / 256) if impl == "pallas" else 0
        ph, cv = launches[impl]
        print(f"slice 6: train-bbh --bf16 true --conv-impl {impl} finished in {wall:.1f} s; "
              f"kernel launches phasor {ph} (≥ {3 * n_synth} expected), conv {cv} "
              f"({conv_expect} expected); losses finite over {len(losses)} logged values; "
              f"beta {out['beta']:.4f}, grid overlap {out['grid_overlap']:.4f} [{card}]")
        if cv != conv_expect or ph < 3 * n_synth:
            fail(f"slice 6 bf16 {impl}: launches phasor {ph}, conv {cv}; expected "
                 f"≥ {3 * n_synth} and {conv_expect}")
    return launches


def slice6_products(cli_main, P, CV, build, card) -> dict:
    """The real-event route on a product directory the port writes itself
    (``write_synthetic_products(posterior=False)``: the card's machine has
    no h5py): its norm read back by the loader, ``make-bank --lalinf-dir``
    of 50,000 templates, and ``train-bbh --lalinf-dir --bank-file`` on that
    bank, scored against the exact grid (no posterior file). Returns
    {stage: (phasor, conv) launches}."""
    import torch

    from gennet_tpu_torch.data import lalinf_io, synth_products

    launches = {}
    with tempfile.TemporaryDirectory(dir=build) as work:
        prod = os.path.join(work, "products")
        t0 = time.perf_counter()
        written = synth_products.write_synthetic_products(prod, seed=0, posterior=False)
        write_s = time.perf_counter() - t0
        names = sorted(os.listdir(prod))
        if len(names) != 3 or not all(n.endswith(".dat") for n in names):
            fail(f"slice 6: the product directory holds {names}")
        norm = lalinf_io.load_event_products(prod)["norm_constant"]
        rel = abs(norm - written["norm_constant"]) / written["norm_constant"]
        print(f"slice 6: wrote {len(names)} product files in {write_s:.2f} s; norm_constant read "
              f"back {norm:.9g}, written {written['norm_constant']:.9g} (relative difference "
              f"{rel:.2e}, limit 1e-6) [{card}]")
        if not rel <= 1e-6:
            fail(f"slice 6: the loader's norm_constant {norm} is not the writer's "
                 f"{written['norm_constant']}")
        bank, run = os.path.join(work, "bank.gntb"), os.path.join(work, "run")
        for stage, argv in (
                ("make-bank", ["make-bank", "--device", "cuda", "--lalinf-dir", prod, "-b", bank]),
                ("train-bbh", ["train-bbh", "--device", "cuda", "--lalinf-dir", prod,
                               "--bank-file", bank, "--pe-iters", "20", "--gan-iters", "20",
                               "--cadence", "10", "--pe-cadence", "10", "--eval-cadence",
                               "100000", "--ckpt-every", "100000", "--plots", "false",
                               "--out-dir", run])):
            P.LAUNCHES = CV.LAUNCHES = 0
            t0 = time.perf_counter()
            out = cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[stage] = (P.LAUNCHES, CV.LAUNCHES)
            print(f"slice 6: {stage} --lalinf-dir finished in {wall:.1f} s; kernel launches "
                  f"phasor {P.LAUNCHES}, conv {CV.LAUNCHES} [{card}]")
    # make-bank: 13 batches of 4096 and the twin, 3 launches a synthesis;
    # train-bbh: no event or bank synthesis, the grid's 3 chunks of 4096
    # and the sanity set drawn from it
    expect = {"make-bank": (3 * (math.ceil(49_999 / 4096) + 1), 0),
              "train-bbh": (3 * (math.ceil(95 * 95 / 4096) + 1), 0)}
    if launches != expect:
        fail(f"slice 6: lalinf-dir launches {launches}, expected {expect}")
    go, beta = out["grid_overlap"], out["beta"]
    if not (isinstance(go, float) and 0.0 <= go <= 1.0 and isinstance(beta, float)
            and 0.0 <= beta <= 1.0):
        fail(f"slice 6: train-bbh --lalinf-dir scored grid overlap {go!r}, beta {beta!r}: "
             "without a posterior file it must score against the exact grid")
    print("slice 6 products summary: " + json.dumps({k: out[k] for k in (
        "final_step", "beta", "grid_overlap", "cnn_sanity_beta", "pe_rms")}))
    return launches


def slice6_plots(cli_main, build, card) -> str:
    """The plots with the reference's default flags: whether matplotlib
    imports here, then either a short ``train-bbh`` and ``smoke`` with
    plots on, their png names checked, or ``train-bbh`` with default flags
    refused before any work, with an error naming matplotlib. Returns the
    branch that ran."""
    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    print(f"slice 6: matplotlib imports on this machine: {have}")
    with tempfile.TemporaryDirectory(dir=build) as work:
        out_dir = os.path.join(work, "run")
        if not have:
            proc = subprocess.run([sys.executable, "-m", "gennet_tpu_torch.cli.main", "train-bbh",
                                   "--out-dir", out_dir], cwd=REPO, capture_output=True,
                                  text=True, timeout=300)
            last = (proc.stderr.strip().splitlines() or [""])[-1]
            print(f"slice 6: train-bbh with default flags exited {proc.returncode}: {last}")
            if proc.returncode == 0 or "matplotlib" not in last or os.path.exists(out_dir):
                fail("slice 6: without matplotlib, train-bbh with default flags must exit "
                     "non-zero before any work, naming matplotlib")
            return "refused without matplotlib"
        t0 = time.perf_counter()
        cli_main(["train-bbh", "--pe-iters", "20", "--gan-iters", "20", "--cadence", "10",
                  "--pe-cadence", "10", "--eval-cadence", "10", "--ckpt-every", "100000",
                  "--out-dir", out_dir])
        bbh_s = time.perf_counter() - t0
        want = {f"{f}{i:05d}.png" for i in (10, 20) for f in (
            "pe_accuracy", "waveform_results", "waveform_zoomed_results", "pe_samples")}
        want |= {"losses.png", "beta_hist.png", "waveform_final.png", "pe_samples_final.png",
                 "latest/pe_accuracy.png", "latest/most_recent_waveform.png",
                 "latest/most_recent_waveform_zoomed.png", "latest/pe_samples.png",
                 "latest/beta_hist.png"}
        got = {os.path.relpath(os.path.join(r, f), out_dir) for r, _, fs in os.walk(out_dir)
               for f in fs if f.endswith(".png")}
        if got != want:
            fail(f"slice 6: train-bbh wrote pngs {sorted(got)}, expected {sorted(want)}")
        smoke_dir = os.path.join(work, "smoke")
        t0 = time.perf_counter()
        cli_main(["smoke", "--pe-iters", "200", "--gan-iters", "200", "--cadence", "100",
                  "--out-dir", smoke_dir])
        smoke_s = time.perf_counter() - t0
        got_s = {os.path.relpath(os.path.join(r, f), smoke_dir)
                 for r, _, fs in os.walk(smoke_dir) for f in fs if f.endswith(".png")}
        need = {"losses.png", "waveform_final.png", "pe_samples_final.png",
                "latest/most_recent_waveform.png", "latest/pe_samples.png"}
        if not need <= got_s:
            fail(f"slice 6: smoke wrote pngs {sorted(got_s)}, expected at least {sorted(need)}")
        print(f"slice 6: with plots on, train-bbh ({bbh_s:.1f} s) wrote the {len(got)} expected "
              f"pngs, smoke ({smoke_s:.1f} s) {len(got_s)} [{card}]")
    return "plots written"


def _bits_sum(tensors):
    """An exact checksum of float32 tensors: the sum of their bit patterns
    as int64, on the host."""
    import torch

    return int(torch.stack([t.detach().reshape(-1).view(torch.int32).to(torch.int64).sum()
                            for t in tensors]).sum().cpu())


def _world2_rank(rank, store, n_pix, steps, queue):
    """One rank of slice 7's world of 2 over gloo on card 0: the default
    recipe's GAN under ``--conv-impl pallas`` at full width, ``steps`` data-
    parallel steps; puts (rank, "ok", result) or (rank, "error", text)."""
    import traceback
    from datetime import timedelta

    try:
        import torch
        import torch.distributed as dist

        from gennet_tpu_torch import runtime
        from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
        from gennet_tpu_torch.ops import conv1d as CV
        from gennet_tpu_torch.ops import phasor_dft as P
        from gennet_tpu_torch.train import gan as tgan
        from gennet_tpu_torch.train.mesh import init_data_mesh, rank_generator

        runtime.setup("cuda")
        mesh = init_data_mesh("cuda:0", backend="gloo", world=2, rank=rank,
                              init_method=f"file://{store}", timeout=timedelta(seconds=300))
        try:
            dev = mesh.device
            cfg = tgan.GANConfig(n_pix=n_pix, label_smoothing=True, d_instance_noise=0.3,
                                 d_lr_scale=0.5, d_acc_gate=0.9)
            G = BBHGenerator(n_out=n_pix, conv_impl="pallas")
            D = PairDiscriminator(n_pix=n_pix, conv_impl="pallas")
            # each rank starts from its own weights and packs them (a forward
            # fills the conv kernel's weight-pack cache); the broadcast must
            # renew the packs, or rank 1 would compute with its old weights
            state = tgan.init_gan(torch.Generator().manual_seed(2 + rank), G, D, cfg, dev)
            z = 2 * torch.rand((8, cfg.latent_dim), generator=torch.Generator(device=dev)
                               .manual_seed(5), device=dev) - 1
            with torch.no_grad():
                G(z)
            mesh.broadcast_modules_(G, D)
            with torch.no_grad():
                fwd = _bits_sum([G(z)])
            gen = rank_generator(0, rank, dev)
            bank = mesh.shard_rows(torch.randn((128, n_pix), generator=torch.Generator(
                device=dev).manual_seed(1), device=dev))
            measured = torch.randn(n_pix, generator=torch.Generator(device=dev).manual_seed(3),
                                   device=dev)

            def digest():
                opt = [v for o in (state.g_opt, state.d_opt, state.g_res_opt)
                       for st in o.state.values() for _, v in sorted(st.items())]
                bufs = [b for m in (G, D) for b in m.buffers() if b.is_floating_point()]
                return _bits_sum(list(G.parameters()) + list(D.parameters()) + bufs
                                 + [t.to(dev) for t in opt])

            torch.cuda.synchronize()
            P.LAUNCHES = CV.LAUNCHES = 0
            t0 = time.perf_counter()
            sums, losses = [], []
            for _ in range(steps):
                state, m = tgan.gan_step(state, bank, measured, gen, cfg=cfg, mesh=mesh)
                mine = torch.tensor([digest()], dtype=torch.int64)  # a host tensor
                both = [torch.zeros_like(mine) for _ in range(2)]
                dist.all_gather(both, mine)
                sums.append([int(b) for b in both])
                losses.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            queue.put((rank, "ok", {"fwd": mesh.gather_objects(fwd), "sums": sums,
                                    "losses": losses, "launches": (P.LAUNCHES, CV.LAUNCHES),
                                    "seconds": time.perf_counter() - t0}))
        finally:
            mesh.close()
    except BaseException as e:  # the parent fails the run with this text
        queue.put((rank, "error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def phasor_at_bank_size(n, P, card) -> float:
    """The phasor kernel against its plain version at the shapes that
    ``make-bank --data-parallel`` gives it (one synthesis of ``n`` rows):
    pass A in phase and in quadrature, the peak index, and pass B, on ``n``
    prior draws placed as ``_synthesize`` places them, with passes A and
    B's tolerances. Returns the largest abs error."""
    import numpy as np
    import torch

    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.physics import priors, psd as psd_mod

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    cfg = tb.BankConfig()
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device=dev)
    masses = priors.sample_masses(g, n, mdist=cfg.mdist)
    amp, phase, freqs = tb.whitened_ampphase(masses["m1"], masses["m2"], psd, cfg)
    N = cfg.n_safe
    a_start, a_width = tb.pass_a_slice(cfg)
    Ca, Sa = P.slice_tables(N, a_start, a_width, None, dev)
    h_k, h_p, err_a, _ = compare(f"pass A B={n}", amp, phase, Ca, Sa, P)
    q_k, q_p, err_q, _ = compare(f"pass A quadrature B={n}", amp,
                                 (phase + 0.5 * np.pi).contiguous(), Ca, Sa, P)
    peak_k = torch.argmax(h_k * h_k + q_k * q_k, dim=-1)
    peak_p = torch.argmax(h_p * h_p + q_p * q_p, dim=-1)
    moved = float((peak_k != peak_p).float().mean())
    if not moved <= PEAK_TOL:
        fail(f"pass A B={n}: the peak index moved on {moved:.5f} of the rows (> {PEAK_TOL:.5f})")
    idx = torch.randint(*cfg.beta_index_bounds(), (n,), generator=g, device=dev)
    shift = idx.to(torch.int32) + cfg.calibration_offset - (peak_p.to(torch.int32) - a_width // 2)
    phase_b = (phase + 2.0 * np.pi * freqs * (shift.to(torch.float32) / cfg.fs)[:, None])
    b_start, b_width, b_weights = tb.pass_b_slice(cfg)
    Cb, Sb = P.slice_tables(N, b_start, b_width, b_weights, dev)
    _, _, err_b, _ = compare(f"pass B B={n}", amp, phase_b.contiguous(), Cb, Sb, P)
    print(f"slice 7: the phasor kernel at the sharded bank's B = {n}: pass A peak index moved "
          f"on {moved:.5f} of the rows (limit {PEAK_TOL:.5f}) [{card}]")
    return max(err_a, err_q, err_b)


def slice7(cli_main, P, CV, build, card, make_bank_5_s) -> tuple:
    """Data parallelism (slice 7): ``make-bank --data-parallel`` of 50,000
    templates at world 1 over NCCL; ``train-bbh --data-parallel --conv-impl
    pallas --bank-file`` on that bank at world 1 against the same command
    without the flag (bitwise-equal final states and metric rows, equal
    conv launches); a world of 2 over gloo with both ranks on this card (10
    GAN steps under pallas, states bitwise in sync after every step, 25
    conv launches a step on each rank); and ``make-mdc -n 100``. The
    phasor kernel is held against its plain version at the bank's B =
    50,000. Returns ({phase: (phasor, conv) launches}, the largest abs
    error of the kernel at that B)."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from gennet_tpu_torch.data import bankstore
    from gennet_tpu_torch.data import mdc_xml

    n_bank, n_pix = 50_000, 1024
    launches = {}

    def stage(name, argv):
        P.LAUNCHES = CV.LAUNCHES = 0
        t0 = time.perf_counter()
        out = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = (P.LAUNCHES, CV.LAUNCHES)
        print(f"slice 7: {name} finished in {wall:.1f} s; kernel launches phasor "
              f"{launches[name][0]}, conv {launches[name][1]} [{card}]")
        return out, wall

    with tempfile.TemporaryDirectory(dir=build) as work:
        bank = os.path.join(work, "bank_dp.gntb")
        _, bank_s = stage("make-bank --data-parallel",
                          ["make-bank", "--device", "cuda", "-N", str(n_bank), "-f", str(n_pix),
                           "-b", bank, "--data-parallel"])
        # the reference's sharded bank: one make_template_batch of
        # n_total // world rows (the kernel at B = 50,000), no event twin
        if launches["make-bank --data-parallel"] != (3, 0):
            fail(f"slice 7: make-bank --data-parallel launched (phasor, conv) "
                 f"{launches['make-bank --data-parallel']}; expected (3, 0): one synthesis")
        with bankstore.BankStore(bank, verify=True) as store:
            shape = (store.n, store.n_pix)
            templates, params = np.array(store.templates), np.array(store.params)
        mc, q = params[:, 0], params[:, 1]
        eps = 1e-4
        if shape != (n_bank, n_pix) or not np.isfinite(templates).all():
            fail(f"slice 7: the sharded bank file holds {shape}, finite "
                 f"{bool(np.isfinite(templates).all())}")
        if not (mc.min() >= 20 - eps and mc.max() <= 35 + eps and q.min() >= 0.5 - eps
                and q.max() <= 1.0):
            fail(f"slice 7: (mc, q) outside the hunt_constrain box: mc [{mc.min()}, "
                 f"{mc.max()}], q [{q.min()}, {q.max()}]")
        del templates, params
        bank_err = phasor_at_bank_size(n_bank, P, card)
        print(f"slice 7: make-bank --data-parallel wrote {n_bank} finite templates in the prior's "
              f"box from one synthesis at B = {n_bank} in {bank_s:.1f} s (slice 5's make-bank, "
              f"13 batches of 4096 and the twin: {make_bank_5_s:.1f} s) [{card}]")

        runs, walls = {}, {}
        torch.backends.cudnn.deterministic = True  # the PE's cuDNN backward, bitwise repeatable
        try:
            for tag, extra in (("plain", []), ("data-parallel", ["--data-parallel"])):
                out_dir = os.path.join(work, tag)
                out, walls[tag] = stage(
                    f"train-bbh {tag}",
                    ["train-bbh", "--device", "cuda", "--n-pix", str(n_pix), "--bank-file", bank,
                     "--conv-impl", "pallas", "--pe-iters", "20", "--gan-iters", "20",
                     "--cadence", "10", "--pe-cadence", "10", "--eval-cadence", "100000",
                     "--ckpt-every", "100000", "--plots", "false", "--out-dir", out_dir, *extra])
                payloads = [torch.load(os.path.join(out_dir, ph, "ckpt_20.pt"), map_location="cpu",
                                       weights_only=True) for ph in ("ckpt_pe", "ckpt_gan")]
                with open(os.path.join(out_dir, "bbh_metrics.jsonl")) as f:
                    runs[tag] = (out, payloads, f.read())
        finally:
            torch.backends.cudnn.deterministic = False
        (o_a, p_a, r_a), (o_b, p_b, r_b) = runs["plain"], runs["data-parallel"]
        diff = same_tree(p_a, p_b)
        if diff or r_a != r_b or json.dumps(o_a) != json.dumps(o_b):
            fail(f"slice 7: train-bbh --data-parallel at world 1 differs from the plain run: "
                 f"checkpoints at {diff[:5]}, metric rows equal {r_a == r_b}, summaries "
                 f"{o_a} vs {o_b}")
        expect = 20 * 25 + 80  # 25 conv launches a GAN step, 80 for the 4000-draw eval
        conv = (launches["train-bbh plain"][1], launches["train-bbh data-parallel"][1])
        if conv != (expect, expect):
            fail(f"slice 7: train-bbh conv launches (plain, data-parallel) {conv}; "
                 f"expected {expect} each")
        print(f"slice 7: train-bbh --data-parallel at world 1 (NCCL) equals the plain run bit "
              f"for bit (PE and GAN checkpoints, {len(r_a.splitlines())} metric rows, the "
              f"summary); wall {walls['plain']:.1f} s plain, {walls['data-parallel']:.1f} s "
              f"data-parallel; conv launches {conv[0]} each [{card}]")

        # ---- a world of 2 over gloo, both ranks on this card ----------------
        steps = 10
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        store = os.path.join(work, "store")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_world2_rank, args=(r, store, n_pix, steps, queue))
                 for r in range(2)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            for _ in procs:
                rank, status, value = queue.get(timeout=400)
                (got.__setitem__(rank, value) if status == "ok" else errors.append(value))
        except Exception as e:  # queue.Empty: a rank hung or died
            errors.append(f"no answer from every rank ({e!r})")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        w2_s = time.perf_counter() - t0
        if errors:
            fail("slice 7 world 2: " + "\n".join(errors))
        r0, r1 = got[0], got[1]
        if len(set(r0["fwd"])) != 1:
            fail(f"slice 7 world 2: G's outputs after the broadcast differ across ranks "
                 f"({r0['fwd']}): a stale weight pack")
        for i, pair in enumerate(r0["sums"]):
            if pair[0] != pair[1] or r1["sums"][i] != pair:
                fail(f"slice 7 world 2: the ranks' states differ after step {i + 1}: {pair}")
        bad = [(r, i, k) for r, res in got.items() for i, m in enumerate(res["losses"])
               for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"slice 7 world 2: non-finite losses {bad[:5]}")
        per = (r0["launches"], r1["launches"])
        if per != ((0, 25 * steps), (0, 25 * steps)):
            fail(f"slice 7 world 2: (phasor, conv) launches per rank {per}; expected "
                 f"(0, {25 * steps}) each: GAN steps synthesize nothing")
        launches["world 2 gloo (rank 0)"] = r0["launches"]
        print(f"slice 7: a world of 2 over gloo on one card (a check of the reductions, not a "
              f"rate): {steps} GAN steps under pallas, states bitwise equal after every step, "
              f"G's output after the broadcast equal on both ranks, (phasor, conv) launches "
              f"per rank {per}; "
              f"{w2_s:.1f} s with both ranks' start, steps {r0['seconds']:.1f} s [{card}]")

        # ---- make-mdc ---------------------------------------------------------
        xml, render = os.path.join(work, "mdc", "set.xml.gz"), os.path.join(work, "mdc", "txt")
        out, mdc_s = stage("make-mdc", ["make-mdc", "-n", "100", "--xml", xml,
                                        "--render-dir", render])
        n_inj = len(mdc_xml.MDCSet.load_xml(xml).injections)
        n_files = len(os.listdir(render))
        if n_inj != 100 or n_files != 200 or out.get("files") != 200:
            fail(f"slice 7: make-mdc wrote {n_inj} injections and {n_files} files; expected "
                 f"100 and 200 (two detectors)")
        print(f"slice 7: make-mdc -n 100 wrote the sim_burst XML (100 injections read back) "
              f"and 200 ASCII files in {mdc_s:.1f} s")
    return launches, bank_err


def _write_pgm_set(d: str, n: int = 16, side: int = 64, seed: int = 0):
    """``n`` seeded side × side binary PGM (P5, 8-bit) images in ``d``:
    smooth blobs on noise, so the GAN has structure to learn."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] / side
    for i in range(n):
        cy, cx = rng.uniform(0.25, 0.75, 2)
        img = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.02)
        img = img + 0.2 * rng.uniform(size=(side, side))
        px = np.round(255 * img / img.max()).astype(np.uint8)
        with open(os.path.join(d, f"img{i:02d}.pgm"), "wb") as f:
            f.write(f"P5\n{side} {side}\n255\n".encode() + px.tobytes())


def slice8(cli_main, P, CV, build, card) -> tuple:
    """The variant generations at the reference's widths (slice 8):
    ``blob-toy`` through the CLI (n_pix 28, 10,000 signals, batch 64, 1000
    MC draws, 400 + 400 + 400 steps), then the same with
    ``--data-parallel`` at world 1, which must equal it bit for bit;
    ``image-gan`` (n_pix 32, batch 32, 200 steps) over the committed JPEGs
    when PIL imports, else the JPEG glob refused before any device work and
    a run over 16 seeded 64 × 64 P5 files; the softmax GAN (n_out 512,
    latent 10, batch 32: one ``pretrain_discriminator`` and 100 steps,
    with and without ``subtract_ht``), the denoiser GAN (n_out 50, batch
    32, 100 steps), ``train_autoencoder`` (100 epochs) and
    ``run_two_stage`` on the burst networks (n_pix 512, batch 64, 20 + 20 +
    20); ``profile_trace`` around 5 image-GAN steps and ``debug_nans`` on a
    NaN in a backward pass. Neither kernel may launch. Returns ((phasor,
    conv) launches, {stage: wall s}, {loop: steps/s})."""
    import dataclasses
    import glob
    import importlib.util

    import torch

    from gennet_tpu_torch.models import (BurstDiscriminator, BurstGenerator, DenseGenerator,
                                         SoftmaxDiscriminator)
    from gennet_tpu_torch.models.image_models import FlatImageDiscriminator, FlatImageGenerator
    from gennet_tpu_torch.physics import toys
    from gennet_tpu_torch.physics.burst import make_burst_bank
    from gennet_tpu_torch.train import denoise_variants as DV
    from gennet_tpu_torch.train import softmax_gan as SG
    from gennet_tpu_torch.train import two_stage as TS
    from gennet_tpu_torch.train.gan import GANConfig, gan_step, init_gan
    from gennet_tpu_torch.train.metrics import debug_nans, profile_trace

    dev = torch.device("cuda")
    walls, rates = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    def finite(what, metrics):
        vals = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"slice 8: {what}: non-finite losses {vals}")
        return vals

    # cuDNN's default backward of a 5 x 5 2-D conv (the image models' first
    # layer at batch 64) against its deterministic algorithms, which
    # runtime.setup pins: three calls each
    def conv2d_grads():
        x = torch.randn((64, 1, 28, 28), generator=torch.Generator(dev).manual_seed(0),
                        device=dev, requires_grad=True)
        w = torch.randn((64, 1, 5, 5), generator=torch.Generator(dev).manual_seed(1),
                        device=dev, requires_grad=True)
        y = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (2, 2, 2, 2)), w)
        return torch.autograd.grad(torch.tanh(y).sum(), (x, w))

    repeatable = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        runs = [conv2d_grads() for _ in range(3)]
        repeatable[det] = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(runs[0], r))
    print(f"slice 8: conv2d 1 -> 64 (5 x 5, 28 x 28, batch 64) backward bitwise repeatable over "
          f"3 calls: cuDNN's default algorithms {repeatable[False]}, deterministic ones "
          f"{repeatable[True]} [{card}]")
    if not repeatable[True]:
        fail("slice 8: cuDNN's deterministic conv2d backward differs between calls")

    P.LAUNCHES = CV.LAUNCHES = 0
    # ---- blob-toy, plain and --data-parallel at world 1 ---------------------
    blob = ["blob-toy", "--device", "cuda", "--pe-iters", "400", "--mc-pe-iters", "400",
            "--gan-iters", "400", "--cadence", "200", "--plots", "false"]
    runs = {}
    for tag, extra in (("plain", []), ("--data-parallel", ["--data-parallel"])):
        with tempfile.TemporaryDirectory(dir=build) as d:
            out = timed(f"blob-toy {tag}", lambda: cli_main(blob + ["--out-dir", d] + extra))
            runs[tag] = (out, read_rows(os.path.join(d, "blob_metrics.jsonl")))
    out, rows = runs["plain"]
    if not (all(math.isfinite(x) for x in out["pe_rms"]) and 0.0 <= out["mc_overlap"] <= 1.0
            and math.isfinite(out["gan_d_loss"])):
        fail(f"slice 8: blob-toy summary {out}")
    steps = {key: [r["step"] for r in rows if key in r] for key in ("pe_loss", "mc_pe_loss",
                                                                      "d_loss")}
    if steps != {"pe_loss": [200], "mc_pe_loss": [200], "d_loss": [200]}:
        fail(f"slice 8: blob-toy metric rows at steps {steps}, expected 200 for each phase")
    if runs["plain"] != runs["--data-parallel"]:
        fail(f"slice 8: blob-toy --data-parallel at world 1 differs from the plain run: "
             f"{runs['--data-parallel'][0]} against {out}")
    print(f"slice 8: blob-toy (n_pix 28, 10,000 signals, batch 64, 1000 MC draws, 400 PE, 400 "
          f"MC-dropout PE and 400 GAN steps) {walls['blob-toy plain']:.1f} s, with "
          f"--data-parallel at world 1 {walls['blob-toy --data-parallel']:.1f} s, bitwise equal "
          f"(summary and {len(rows)} rows): " + json.dumps(out) + f" [{card}]")

    # ---- image-gan ------------------------------------------------------------
    img = ["image-gan", "--device", "cuda", "--n-pix", "32", "--batch-size", "32",
           "--gan-iters", "200", "--cadence", "100", "--plots", "false"]
    jpegs = os.path.join(REPO, "tests", "data", "images", "*.jpg")
    with tempfile.TemporaryDirectory(dir=build) as d:
        if importlib.util.find_spec("PIL") is not None:
            reader, pattern = "PIL over the committed JPEGs", jpegs
        else:
            reader, pattern = "the numpy P5 reader over 16 seeded 64 x 64 PGM files", \
                os.path.join(d, "pgm", "*.pgm")
            refused_dir = os.path.join(d, "refused")
            mem = torch.cuda.memory_allocated()
            try:
                cli_main(img + ["--image-glob", jpegs, "--out-dir", refused_dir])
                fail("slice 8: image-gan read the JPEGs with neither PIL nor matplotlib")
            except ImportError as e:
                if "PIL" not in str(e):
                    fail(f"slice 8: image-gan's refusal does not name PIL: {e}")
                print(f"slice 8: without PIL, image-gan refuses the JPEG glob: {e}")
            if os.path.exists(refused_dir) or torch.cuda.memory_allocated() != mem:
                fail("slice 8: image-gan did device or file work before refusing the JPEGs")
            os.makedirs(os.path.dirname(pattern))
            _write_pgm_set(os.path.dirname(pattern))
        out = timed("image-gan", lambda: cli_main(img + ["--image-glob", pattern,
                                                        "--out-dir", os.path.join(d, "run")]))
        n_rows = len(read_rows(os.path.join(d, "run", "image_gan_metrics.jsonl")))
    if not (out["n_images"] == 32 and math.isfinite(out["gan_d_loss"])
            and math.isfinite(out["gan_g_loss"]) and -1.0 <= out["recovery_corr"] <= 1.0):
        fail(f"slice 8: image-gan summary {out}")
    print(f"slice 8: image-gan (n_pix 32, batch 32, 200 steps, {n_rows} rows) read by {reader}: "
          f"{walls['image-gan']:.1f} s, " + json.dumps(out) + f" [{card}]")

    # ---- the trainers at their reference widths --------------------------------
    g = torch.Generator(device=dev).manual_seed(8)
    sg_cfg = SG.SoftmaxGANConfig()
    measured = toys.gauss_pulse(g, 1)[0] + 0.1 * torch.randn(512, generator=g, device=dev)
    for sub in (False, True):
        cfg = dataclasses.replace(sg_cfg, subtract_ht=sub)
        tag = "softmax GAN" + (" subtract_ht" if sub else "")
        st = SG.init_softmax_gan(torch.Generator().manual_seed(0), DenseGenerator(),
                                 SoftmaxDiscriminator(), cfg, dev)
        st, m = SG.pretrain_discriminator(st, toys.gauss_pulse(g, 32), g, cfg=cfg,
                                          measured=measured)
        finite(f"{tag} pretrain", m)

        def loop():
            out = None
            for _ in range(100):
                out = SG.softmax_gan_step(st, toys.gauss_pulse(g, 32), g, cfg=cfg,
                                          measured=measured)[1]
            return out

        m = finite(tag, timed(tag, loop))
        rates[tag] = 100 / walls[tag]
        print(f"slice 8: {tag} (n_out 512, latent 10, batch 32): pretrain + 100 steps, "
              f"{rates[tag]:.1f} steps/s, last {m} [{card}]")
    dn_cfg = DV.DenoiserGANConfig()
    st = DV.init_denoiser_gan(torch.Generator().manual_seed(0), DV.DenoiserGenerator(),
                              SoftmaxDiscriminator(n_pix=50), dn_cfg, dev)

    def dn_loop():
        out = None
        for _ in range(100):
            out = DV.denoiser_gan_step(st, toys.sample_sinusoids(g, 32), g, cfg=dn_cfg)[1]
        return out

    m = finite("denoiser GAN", timed("denoiser GAN", dn_loop))
    rates["denoiser GAN"] = 100 / walls["denoiser GAN"]
    _, ae_loss = timed("train_autoencoder", lambda: DV.train_autoencoder(
        torch.Generator().manual_seed(1), DV.SignalAutoencoder(), toys.sample_sinusoids(g, 1024),
        epochs=100))
    finite("train_autoencoder", {"loss": ae_loss})
    rates["train_autoencoder"] = 100 / walls["train_autoencoder"]
    print(f"slice 8: denoiser GAN (n_out 50, batch 32) {rates['denoiser GAN']:.1f} steps/s, last "
          f"{m}; train_autoencoder 100 epochs {walls['train_autoencoder']:.2f} s, loss "
          f"{ae_loss:.4f} [{card}]")
    bank, _ = make_burst_bank(g, 4096, N=512)
    b_meas = bank[0] + 0.25 * torch.randn(512, generator=g, device=dev)
    st, m = timed("run_two_stage", lambda: TS.run_two_stage(
        0, BurstGenerator(), BurstDiscriminator(), bank, b_meas,
        GANConfig(n_pix=512, batch_size=64, pair_discriminator=False),
        stage1_iters=20, stage2_iters=20, stage3_iters=20))
    m = finite("run_two_stage", m)
    rates["run_two_stage"] = 60 / walls["run_two_stage"]
    print(f"slice 8: run_two_stage (BurstGenerator, BurstDiscriminator, n_pix 512, batch 64, "
          f"20 + 20 + 20) {walls['run_two_stage']:.1f} s, last {m} [{card}]")

    # ---- profile_trace and debug_nans -------------------------------------------
    i_cfg = GANConfig(n_pix=1024, batch_size=32, lr=2e-4, n_sig=0.3, pair_discriminator=False,
                      residual_route=True)
    i_state = init_gan(torch.Generator().manual_seed(1), FlatImageGenerator(32),
                       FlatImageDiscriminator(32), i_cfg, dev)
    i_bank = 2 * torch.rand((64, 1024), generator=g, device=dev) - 1
    with tempfile.TemporaryDirectory(dir=build) as d:
        with profile_trace(d):
            for _ in range(5):
                gan_step(i_state, i_bank, i_bank[0], g, cfg=i_cfg)
            torch.cuda.synchronize()
        traces = glob.glob(os.path.join(d, "trace_*.json"))
        if len(traces) != 1 or os.path.getsize(traces[0]) == 0:
            fail(f"slice 8: profile_trace wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f).get("traceEvents", [])
        n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"slice 8: profile_trace of 5 image-GAN steps wrote {os.path.getsize(traces[0])} "
              f"bytes, {len(events)} events, {n_kernels} of them CUDA kernels")
    x = torch.tensor([-1.0, 4.0], device=dev, requires_grad=True)
    debug_nans(True)
    try:
        torch.sqrt(x).sum().backward()
        fail("slice 8: debug_nans(True) let a NaN through a backward pass")
    except RuntimeError as e:
        if "nan" not in str(e):
            raise
        print(f"slice 8: debug_nans(True) raised on the NaN: {str(e).splitlines()[0]}")
    finally:
        debug_nans(False)

    launches = (P.LAUNCHES, CV.LAUNCHES)
    if launches != (0, 0):
        fail(f"slice 8 launched the kernels (phasor, conv) {launches} times; the variant "
             f"models run cuDNN and cuBLAS only")
    return launches, walls, rates


def _chunk_seconds(run) -> float:
    """Host seconds of ``run()`` (a chunk of steps), synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _profiled_chunk(run, kernel: str = "conv1d_kernel") -> dict:
    """``run()`` under ``torch.profiler``: its wall seconds, the device's
    busy seconds (the sum of kernel times), the idle share and the events
    of the kernel whose name holds ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the card's activity alone: the host's op events would cost more to
    # read back than the chunk takes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # kineto drops, as out of range, a record whose time, taken from
        # the card's clock to the host's, falls outside the profiler's
        # start and stop; that conversion can put a chunk's last kernels a
        # few milliseconds after the stop (H100, torch 2.11), and the chunk
        # then shows fewer kernel events than it ran. An idle margin at each
        # end keeps them in.
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    busy = events = 0
    # the raw records: building the profiler's event tree over a chunk's
    # ~10^5 kernels would take longer than the chunk
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy += e.duration_ns()
            events += kernel in e.name()
    busy *= 1e-9
    return {"wall_s": wall, "busy_s": busy, "idle": 1.0 - busy / wall, "events": events}


def slice9(cli_main, P, CV, build, card, cloud, mlrc_eager) -> dict:
    """The fused step loops as CUDA-graph replays (slice 9), at n_pix 1024,
    batch 8, chunks of 100: graph against eager steps of the port bit for
    bit (GAN under xla and pallas, default recipe and residual route; PE
    with the cosine decay; ``ml_recenter`` on slice 5's cloud), the
    replays' launch counts (25 and 35 conv a GAN step, 3 phasor an
    ``ml_recenter`` step) confirmed by ``torch.profiler`` for one GAN
    chunk and one short ``ml_recenter`` call, the balance gate crossed both ways, the weight packs after replays,
    ``train-bbh --conv-impl pallas`` through the CLI with a ``--resume``
    from step 100 against the uninterrupted run; then, as information,
    steps/s graph against eager in turns, the idle share of a chunk each
    way, capture times and ``ml_recenter``'s wall. ``mlrc_eager``: the
    throughput phase's eager ``ml_recenter`` on ``cloud``
    (:func:`ml_recenter_seconds`), which the graph run must reproduce.
    Returns its launches by path, {path: (phasor, conv)}."""
    import numpy as np
    import torch

    from gennet_tpu_torch.models import (BBHGenerator, BurstDiscriminator, BurstGenerator,
                                         DualBranchPE, PairDiscriminator)
    from gennet_tpu_torch.ops import tf32
    from gennet_tpu_torch.physics.burst import make_burst_bank
    from gennet_tpu_torch.train import cnn as tcnn
    from gennet_tpu_torch.train import gan as tgan
    from gennet_tpu_torch.runtime import graphs
    from gennet_tpu_torch.train.checkpoints import CheckpointManager

    t_slice = time.perf_counter()
    walls = {}

    def lap(name):  # each part's wall time, for the summary
        walls[name] = time.perf_counter() - t_slice - sum(walls.values())

    dev, n_pix, chunk = torch.device("cuda"), 1024, 100
    g = torch.Generator(device=dev).manual_seed(9)
    bank = torch.randn(4096, n_pix, generator=g, device=dev)
    targets = torch.rand(4096, 2, generator=g, device=dev)
    measured = torch.randn(n_pix, generator=g, device=dev)
    launches, info = {}, {"card": card}
    recipe = dict(n_pix=n_pix, label_smoothing=True, d_instance_noise=0.3, d_lr_scale=0.5,
                  d_acc_gate=0.9)
    recipes = {"default": (tgan.GANConfig(**recipe), 2, 25),
               "residual": (tgan.GANConfig(**recipe, pair_discriminator=False,
                                           residual_route=True, res_loss_weight=1.0,
                                           res_spectral_bands=16, diversity_weight=0.1), 1, 35)}

    def differ(a: list, b: list) -> int:
        return len(a) + len(b) if len(a) != len(b) else sum(
            not torch.equal(x, y) for x, y in zip(a, b))

    def stacked(rows):
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def gan_state(cfg, in_ch, impl):
        return tgan.init_gan(torch.Generator().manual_seed(2),
                             BBHGenerator(n_out=n_pix, conv_impl=impl),
                             PairDiscriminator(n_pix=n_pix, in_ch=in_ch, conv_impl=impl), cfg, dev)

    def eager_gan(st, cfg, gen, kt, n=chunk):
        return stacked([tgan.gan_step(st, bank, measured, gen, kt, cfg=cfg)[1]
                        for _ in range(n)])

    # ---- GAN: one chunk as replays against 100 eager steps -----------------
    keep = {}
    for impl in ("xla", "pallas"):
        for name, (cfg, in_ch, conv_per_step) in recipes.items():
            runs = []
            for use_graph in (True, False):
                st = gan_state(cfg, in_ch, impl)
                gen = torch.Generator(device=dev).manual_seed(11)
                P.LAUNCHES = CV.LAUNCHES = 0
                if use_graph:
                    scan = tgan.make_gan_step_scan(st.generator, st.discriminator, cfg, chunk)
                    st, m = scan(st, bank, measured, gen)
                else:
                    m = eager_gan(st, cfg, gen, tgan.knob_tensors(tgan.knobs_from_cfg(cfg), dev))
                torch.cuda.synchronize()
                runs.append((st, m, gen.get_state(), CV.LAUNCHES, gen))
            (a, ma, ga, la, a_gen), (b, mb, gb, lb, _) = runs
            bad = (differ(tgan.state_tensors(a), tgan.state_tensors(b))
                   + differ([ma[k] for k in sorted(ma)], [mb[k] for k in sorted(mb)])
                   + (not torch.equal(ga, gb)))
            per_replay = scan.graph.launches.get(CV, 0)
            want = conv_per_step if impl == "pallas" else 0
            print(f"slice 9: GAN {impl} {name}: a chunk of {chunk} as {scan.graph.replays} "
                  f"replays after {graphs.WARMUP} eager steps (capture "
                  f"{scan.graph.capture_s:.3f} s) against {chunk} eager steps: "
                  f"{'bitwise equal' if not bad else f'{bad} tensors differ'} (parameters, Adam "
                  f"state, BN statistics, stacked metrics, generator); conv launches "
                  f"{la} / {lb}, {per_replay} a replay [{card}]")
            if bad:
                fail(f"slice 9: GAN {impl} {name}: the replays differ from eager steps ({bad})")
            if per_replay != want or la != lb or la != want * chunk:
                fail(f"slice 9: GAN {impl} {name}: conv launches {la} (graph), {lb} (eager), "
                     f"{per_replay} a replay; expected {want} a step")
            launches[f"GAN {impl} {name}"] = (P.LAUNCHES, la)
            if name == "default":  # the graph is kept with the generator it registered
                keep[impl] = (a, scan, cfg, a_gen)
            del runs, a, b

    lap("GAN chunks")

    # ---- stale packs: eager draws after replays under pallas ----------------
    st, scan, cfg, gen = keep["pallas"]
    draws = []
    for clear in (False, True):
        if clear:
            tf32._PACKS.clear()
        draws.append(tgan.sample_generator(st.generator, st, torch.Generator(device=dev)
                                           .manual_seed(3), 256, cfg))
    if not torch.equal(*draws):
        fail("slice 9: a draw after replays differs from the same draw with the pack cache "
             "cleared: a stale weight pack was served")
    print("slice 9: a 256-draw after the pallas chunk's replays equals the same draw with the "
          "pack cache cleared, bit for bit")
    lap("packs")

    # ---- the profiler: conv events of one chunk, idle share each way --------
    kt = tgan.knob_tensors(tgan.knobs_from_cfg(cfg), dev)
    prof = {"graph": _profiled_chunk(lambda: scan(st, bank, measured, gen)),
            "eager": _profiled_chunk(lambda: eager_gan(st, cfg, g, kt))}
    print("slice 9: torch.profiler over one chunk of 100 GAN pallas steps (default recipe): "
          + "; ".join(f"{k}: wall {v['wall_s']:.3f} s, device busy {v['busy_s']:.3f} s, idle "
                      f"share {v['idle']:.3f}, conv kernel events {v['events']}"
                      for k, v in prof.items()) + f" [{card}]")
    if prof["graph"]["events"] != 25 * chunk:
        fail(f"slice 9: the profiler saw {prof['graph']['events']} conv kernel events in a "
             f"chunk of {chunk} replays; expected {25 * chunk}")
    info["profile_gan_pallas"] = prof
    lap("profiler")

    # ---- both sides of the gate ---------------------------------------------
    # D wins quickly without label smoothing and instance noise, then G
    # catches up: the gate at 0.9 closes and opens again
    gcfg = tgan.GANConfig(n_pix=n_pix, d_acc_gate=0.9, debug_probes=True)
    st_g = gan_state(gcfg, 2, "xla")
    st_e = gan_state(gcfg, 2, "xla")
    scan_g = tgan.make_gan_step_scan(st_g.generator, st_g.discriminator, gcfg, chunk)
    gen_g, gen_e = (torch.Generator(device=dev).manual_seed(13) for _ in range(2))
    kt = tgan.knob_tensors(tgan.knobs_from_cfg(gcfg), dev)
    closed = opened = bad = held = 0
    for _ in range(3):
        st_g, mg = scan_g(st_g, bank, measured, gen_g)
        rows = []
        for i in range(chunk):
            before = [t.clone() for t in graphs.optimizer_tensors(st_e.d_opt)
                      + list(st_e.discriminator.parameters())]
            rows.append(tgan.gan_step(st_e, bank, measured, gen_e, kt, cfg=gcfg)[1])
            after = (graphs.optimizer_tensors(st_e.d_opt)
                     + list(st_e.discriminator.parameters()))
            if float(rows[-1]["d_acc"]) >= 0.9:
                closed += 1
                held += differ(before, after) == 0
            else:
                opened += 1
        me = stacked(rows)
        bad += differ([mg[k] for k in sorted(mg)], [me[k] for k in sorted(me)])
        if closed and opened:
            break
    bad += differ(tgan.state_tensors(st_g), tgan.state_tensors(st_e))
    print(f"slice 9: the balance gate at 0.9 (no label smoothing, no instance noise): "
          f"{closed} closed and {opened} open steps; D and its Adam state unchanged through "
          f"{held} of the {closed} closed steps (eager, step by step); replays against eager "
          f"steps: {'bitwise equal' if not bad else f'{bad} differ'} [{card}]")
    if not (closed and opened) or held != closed or bad:
        fail(f"slice 9: the gate: {closed} closed, {opened} open, {held} held, {bad} differ")
    del st_g, st_e, scan_g
    lap("gate")

    # ---- PE: a chunk of 100 with the cosine decay ---------------------------
    pe_cfg = tcnn.CNNConfig(n_pix=n_pix, ema_decay=0.999, lr_decay_steps=500_000)
    pe_runs = []
    for use_graph in (True, False):
        pe = tcnn.init_cnn(torch.Generator().manual_seed(1), DualBranchPE(n_pix=n_pix), pe_cfg,
                           dev)
        gen = torch.Generator(device=dev).manual_seed(12)
        if use_graph:
            pe_scan = tcnn.make_cnn_step_scan(pe.model, pe_cfg, chunk)
            pe, m = pe_scan(pe, bank, targets, gen)
        else:
            m = stacked([tcnn.cnn_step(pe, bank, targets, gen, cfg=pe_cfg)[1]
                         for _ in range(chunk)])
        pe_runs.append((pe, m, gen.get_state(), gen))
    (a, ma, ga, pe_gen), (b, mb, gb, _) = pe_runs
    bad = (differ(tcnn.state_tensors(a), tcnn.state_tensors(b))
           + (not torch.equal(ma["pe_loss"], mb["pe_loss"])) + (not torch.equal(ga, gb)))
    print(f"slice 9: PE chunk of {chunk} with the cosine decay (capture "
          f"{pe_scan.graph.capture_s:.3f} s) against eager steps: "
          f"{'bitwise equal' if not bad else f'{bad} differ'}; lr after "
          f"{float(a.opt.param_groups[0]['lr']):.9g} [{card}]")
    if bad:
        fail(f"slice 9: the PE chunk differs from eager steps ({bad})")
    pe_state = a
    lap("PE chunk")

    # ---- ml_recenter on slice 5's cloud, against the throughput phase's
    # eager call (the same cloud, event and seed) ----------------------------
    gr_run = ml_recenter_seconds(torch.Generator(device=dev).manual_seed(14), dev, cloud=cloud)
    sg, lg, og, gr = (gr_run[k] for k in ("s", "launches", "out", "graph"))
    se, le, oe = (mlrc_eager[k] for k in ("s", "launches", "out"))
    per = gr.launches.get(P, 0)
    print(f"slice 9: ml_recenter (300 Adam steps, 8 starts) on slice 5's cloud: eager "
          f"{se:.2f} s, graph {sg:.2f} s (capture {gr.capture_s:.3f} s, {gr.replays} replays); "
          f"outputs {'bitwise equal' if np.array_equal(oe, og) else 'differ'}; phasor launches "
          f"{le} / {lg}, {per} a replay [{card}]")
    if not np.array_equal(oe, og) or per != 3 or le != lg:
        fail(f"slice 9: ml_recenter graph against eager: equal {np.array_equal(oe, og)}, "
             f"phasor {per} a replay, launches {le} / {lg}")
    # the replay accounting against the card's own record: a short call
    # under torch.profiler, whose phasor kernel events must be the
    # launches counted one by one in the same call as eager steps (3 a
    # step, and the syntheses around the loop), so 3 a replay plus the
    # warm-up's
    n_short, g_short = 10, lambda: torch.Generator(device=dev).manual_seed(15)
    short_e = ml_recenter_seconds(g_short(), dev, cloud=cloud, eager=True, steps=n_short)
    short_g = ml_recenter_seconds(g_short(), dev, cloud=cloud, steps=n_short, profile=True)
    ev, reps = short_g["profile"]["events"], short_g["graph"].replays
    print(f"slice 9: torch.profiler over one ml_recenter call of {n_short} steps as "
          f"{graphs.WARMUP} eager steps and {reps} replays: {ev} phasor kernel events; launches "
          f"counted {short_g['launches']} (replay accounting), {short_e['launches']} (the same "
          f"call as eager steps) [{card}]")
    if not ev == short_g["launches"] == short_e["launches"] or reps != n_short - graphs.WARMUP \
            or not np.array_equal(short_e["out"], short_g["out"]):
        fail(f"slice 9: ml_recenter of {n_short} steps: {ev} phasor kernel events, launches "
             f"{short_g['launches']} (graph) and {short_e['launches']} (eager), {reps} replays, "
             f"outputs equal {np.array_equal(short_e['out'], short_g['out'])}")
    launches["ml_recenter"] = (lg, 0)
    info["ml_recenter_s"] = {"eager": se, "graph": sg, "capture": gr.capture_s}
    info["profile_ml_recenter"] = {**short_g["profile"], "steps": n_short, "replays": reps}
    lap("ml_recenter")

    # ---- steps/s graph against eager, in turns, in chunks of 50 (information)
    rate_n = 50
    b_bank, _ = make_burst_bank(g, 50_000, N=512)
    b_meas = b_bank[0] + 0.25 * torch.randn(512, generator=g, device=dev)
    b_cfg = tgan.GANConfig(n_pix=512, batch_size=64, lr=2e-4, n_sig=0.25,
                           pair_discriminator=False, residual_route=True, res_loss_weight=10.0,
                           label_smoothing=True, d_lr_scale=0.5)
    b_gan = tgan.init_gan(torch.Generator().manual_seed(2), BurstGenerator(n_out=512),
                          BurstDiscriminator(n_pix=512), b_cfg, dev)
    b_kt = tgan.knob_tensors(tgan.knobs_from_cfg(b_cfg), dev)
    scans = {"burst GAN (batch 64)": tgan.make_gan_step_scan(b_gan.generator, b_gan.discriminator,
                                                             b_cfg, rate_n),
             "PE (batch 8)": tcnn.make_cnn_step_scan(pe_state.model, pe_cfg, rate_n)}
    loops = {}
    for impl in ("xla", "pallas"):
        st, _, cfg, gen = keep[impl]
        kt = tgan.knob_tensors(tgan.knobs_from_cfg(cfg), dev)
        k = f"GAN {impl} (batch 8)"
        scans[k] = tgan.make_gan_step_scan(st.generator, st.discriminator, cfg, rate_n)
        loops[k] = (lambda st=st, k=k, gen=gen: scans[k](st, bank, measured, gen),
                    lambda st=st, cfg=cfg, kt=kt: eager_gan(st, cfg, g, kt, rate_n))
    loops["PE (batch 8)"] = (
        lambda: scans["PE (batch 8)"](pe_state, bank, targets, pe_gen),
        lambda: [tcnn.cnn_step(pe_state, bank, targets, g, cfg=pe_cfg) for _ in range(rate_n)])
    loops["burst GAN (batch 64)"] = (
        lambda: scans["burst GAN (batch 64)"](b_gan, b_bank, b_meas, g),
        lambda: [tgan.gan_step(b_gan, b_bank, b_meas, g, b_kt, cfg=b_cfg)
                 for _ in range(rate_n)])
    for graph_run, _ in loops.values():
        graph_run()  # the capture
    rates = {k: {"graph": [], "eager": []} for k in loops}
    for side in ("eager", "graph", "graph", "eager", "eager", "graph"):
        for k, (graph_run, eager_run) in loops.items():
            run = graph_run if side == "graph" else eager_run
            rates[k][side].append(rate_n / _chunk_seconds(run))
    fmt = lambda r: "/".join(f"{x:.1f}" for x in r)
    print(f"slice 9: steps/s in chunks of {rate_n}, order eager, graph, graph, eager, eager, graph: "
          + "; ".join(f"{k} graph {fmt(v['graph'])}, eager {fmt(v['eager'])}"
                      for k, v in rates.items())
          + "; capture s: " + ", ".join(f"{k} {v.graph.capture_s:.3f}" for k, v in scans.items())
          + f" [{card}]")
    info["steps_per_s"] = rates
    info["capture_s"] = {k: v.graph.capture_s for k, v in scans.items()}
    del keep, b_gan, scans, loops, pe_state, pe_scan
    lap("steps/s")

    # ---- train-bbh through the CLI, and a resume from its step 100 -----------
    cli_s, outs = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as work:
        common = ["train-bbh", "--device", "cuda", "--n-pix", str(n_pix), "--training-num",
                  "4097", "--grid-grain", "11", "--n-posterior", "256", "--pe-iters", "200",
                  "--gan-iters", "200", "--cadence", "100", "--pe-cadence", "100",
                  "--eval-cadence", "200", "--ckpt-every", "100", "--conv-impl", "pallas",
                  "--plots", "false"]
        whole, split = os.path.join(work, "whole"), os.path.join(work, "split")
        for tag, extra in (("whole", ["--out-dir", whole]),
                           ("resumed", ["--out-dir", split, "--resume", "true"])):
            if tag == "resumed":
                # the uninterrupted run's checkpoints at its GAN step 100 (and
                # its trained PE) are where the resumed run starts
                for sub, step in (("ckpt_gan", 100), ("ckpt_pe", 200)):
                    os.makedirs(os.path.join(split, sub))
                    shutil.copy(os.path.join(whole, sub, f"ckpt_{step}.pt"),
                                os.path.join(split, sub))
            P.LAUNCHES = CV.LAUNCHES = 0
            t0 = time.perf_counter()
            outs[tag] = cli_main([*common, *extra])
            torch.cuda.synchronize()
            cli_s[tag] = time.perf_counter() - t0
            launches[f"train-bbh {tag}"] = (P.LAUNCHES, CV.LAUNCHES)
        a, b = (torch.load(os.path.join(d, "ckpt_gan", "ckpt_200.pt"), weights_only=True)
                for d in (whole, split))
        diff = same_tree(a, b)
        # the GAN phase's rows after step 100 (the resumed run trains no PE)
        rows = [[r for r in read_rows(os.path.join(d, "bbh_metrics.jsonl"))
                 if r["step"] > 100 and not {"pe_loss", "cnn_sanity_beta"} & set(r)]
                for d in (whole, split)]
    print(f"slice 9: train-bbh --conv-impl pallas (200 PE, 200 GAN steps, cadence 100, evals "
          f"at 200 and final) in {cli_s['whole']:.1f} s; --resume from its GAN step 100 "
          f"{cli_s['resumed']:.1f} s; launches (phasor, conv) "
          + json.dumps({k: v for k, v in launches.items() if k.startswith("train-bbh")})
          + f"; the resumed run's step-200 checkpoint and rows after step 100 against the "
          f"uninterrupted run's: "
          f"{'bitwise equal' if not diff and rows[0] == rows[1] else f'differ at {diff[:5]}'}"
          f" [{card}]")
    if diff or rows[0] != rows[1] or not rows[0]:
        fail(f"slice 9: the resumed train-bbh differs from the uninterrupted run: {diff[:5]}")
    if outs["whole"]["final_step"] != 200 or outs["resumed"]["final_step"] != 200:
        fail(f"slice 9: final steps {outs['whole']['final_step']}, {outs['resumed']['final_step']}")
    conv = {k: v[1] for k, v in launches.items() if k.startswith("train-bbh")}
    # 25 a GAN step and 5 a 256-draw eval (one chunk of 256 through G's 5 convs)
    want = {"train-bbh whole": 200 * 25 + 2 * 5, "train-bbh resumed": 100 * 25 + 2 * 5}
    if conv != want:
        fail(f"slice 9: train-bbh conv launches {conv}, expected {want}")
    lap("train-bbh")
    info["train_bbh_s"] = cli_s
    info["walls_s"] = walls
    info["seconds"] = time.perf_counter() - t_slice
    print(f"slice 9 finished in {info['seconds']:.1f} s [{card}]")
    print("slice 9 summary: " + json.dumps(info, default=str))
    return launches


def slice10(P, CV, card, cloud) -> tuple:
    """The names that closed the port's API gaps, on the card (slice 10):
    ``rdft`` and ``irdft`` at B 4096, N 1024 against ``torch.fft.rfft`` and
    ``irfft`` (≤ 1e-5·max), their tables against tables built here in
    numpy (bit for bit), ``sample_extrinsic`` on a CUDA generator (device,
    ranges, the same draws twice from one seed), ``centered_tukey_window``
    against its numpy form, ``overlap_tests`` on ``cloud`` (a (n, 2)
    posterior cloud: its two halves, and one half against itself), the
    burst bank in bfloat16, and the package-level imports. Neither kernel
    may launch. Returns ((phasor, conv) launches, wall s)."""
    import numpy as np
    import torch

    t_start = time.perf_counter()
    P.LAUNCHES = CV.LAUNCHES = 0
    import gennet_tpu_torch.data as data_pkg
    import gennet_tpu_torch.eval as eval_pkg
    import gennet_tpu_torch.ops as ops_pkg
    import gennet_tpu_torch.train as train_pkg
    from gennet_tpu_torch.physics import burst, priors, windows
    from gennet_tpu_torch.train import GANConfig, init_gan  # noqa: F401 (the package import)

    for pkg in (data_pkg, eval_pkg, ops_pkg, train_pkg):
        if not pkg.__all__ or any(getattr(pkg, n, None) is None for n in pkg.__all__):
            fail(f"slice 10: {pkg.__name__}.__all__ does not resolve: {pkg.__all__}")
    print("slice 10: package exports resolve: " + "; ".join(
        f"{p.__name__.split('.')[-1]} {len(p.__all__)}"
        for p in (data_pkg, eval_pkg, ops_pkg, train_pkg)))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    B, N = 4096, 1024
    x = torch.randn((B, N), generator=g, device=dev)
    re, im = ops_pkg.rdft(x)
    spec = torch.fft.rfft(x)
    h = ops_pkg.irdft(spec.real.contiguous(), spec.imag.contiguous(), N)
    h_ref = torch.fft.irfft(spec, n=N)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    errs = {"rdft re": rel(re, spec.real), "rdft im": rel(im, spec.imag), "irdft": rel(h, h_ref)}
    if not (re.device == h.device == x.device and re.shape == (B, N // 2 + 1)
            and h.shape == (B, N)):
        fail(f"slice 10: rdft/irdft shapes {tuple(re.shape)}, {tuple(h.shape)} on {h.device}")
    if not all(e <= 1e-5 for e in errs.values()):
        fail(f"slice 10: rdft/irdft against torch.fft, of the maximum: {errs}")
    re_s, im_s = spec.real.contiguous(), spec.imag.contiguous()
    ms = {"rdft": cuda_ms(lambda: ops_pkg.rdft(x)), "rfft": cuda_ms(lambda: torch.fft.rfft(x)),
          "irdft": cuda_ms(lambda: ops_pkg.irdft(re_s, im_s, N)),
          "irfft": cuda_ms(lambda: torch.fft.irfft(spec, n=N))}
    print(f"slice 10: rdft/irdft (B {B}, N {N}, float32 matmuls) against torch.fft, of the "
          f"maximum: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + "; ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" [{card}]")

    # the tables against numpy's own construction (gennet_tpu/ops/dft.py:29-49)
    Nf = N // 2 + 1
    k, n = np.arange(Nf)[:, None], np.arange(N)[None, :]
    w = np.where((k == 0) | ((N % 2 == 0) & (k == N // 2)), 1.0, 2.0)
    ang = 2.0 * np.pi * k * n / N
    ref_tables = {"irdft": ((w * np.cos(ang) / N).astype(np.float32),
                            (w * np.sin(ang) / N).astype(np.float32)),
                  "rdft": (np.cos(2.0 * np.pi * n.T * k.T / N).astype(np.float32),
                           np.sin(2.0 * np.pi * n.T * k.T / N).astype(np.float32))}
    for name, fn in (("irdft", ops_pkg.irdft_matrices), ("rdft", ops_pkg.rdft_matrices)):
        for t, r in zip(fn(N, device=dev), ref_tables[name]):
            if t.device.type != "cuda" or not np.array_equal(t.cpu().numpy(), r):
                fail(f"slice 10: {name}_matrices({N}) differ from numpy's tables")
    print(f"slice 10: irdft_matrices and rdft_matrices ({N}) on the card equal numpy's, bit "
          f"for bit")

    ext = priors.sample_extrinsic(torch.Generator(device=dev).manual_seed(3), 100_000)
    again = priors.sample_extrinsic(torch.Generator(device=dev).manual_seed(3), 100_000)
    two_pi = 2 * math.pi
    for name, lo, hi in (("iota", 0.0, math.pi), ("psi", 0.0, two_pi), ("phi", 0.0, two_pi),
                         ("ra", 0.0, two_pi), ("dec", -math.pi / 2, math.pi / 2)):
        v = ext[name]
        if not (v.device.type == "cuda" and v.shape == (100_000,)
                and lo <= float(v.min()) and float(v.max()) <= hi
                and torch.equal(v, again[name])):
            fail(f"slice 10: sample_extrinsic {name}: {v.device}, {tuple(v.shape)}, "
                 f"[{float(v.min())}, {float(v.max())}], repeat {torch.equal(v, again[name])}")
    print("slice 10: sample_extrinsic (100,000 on a CUDA generator): on the card, in range, "
          "the same draws twice from one seed")

    win = windows.centered_tukey_window(2048, device=dev)
    win_np = windows.centered_tukey_window_np(2048)
    win_err = float(np.abs(win.cpu().numpy() - win_np).max())
    if win.device.type != "cuda" or not win_err <= 1e-7:
        fail(f"slice 10: centered_tukey_window on {win.device}, {win_err:.2e} off numpy")

    bank, pars = burst.make_burst_bank(torch.Generator(device=dev).manual_seed(5), 4096,
                                       dtype=torch.bfloat16)
    if not (bank.dtype == pars.dtype == torch.bfloat16 and bank.device.type == "cuda"
            and bool(torch.isfinite(bank.float()).all())):
        fail(f"slice 10: burst bank in bf16: {bank.dtype}, {pars.dtype}, {bank.device}")

    cloud = np.asarray(cloud, np.float64)
    half = cloud.shape[0] // 2
    ks, ad, beta = eval_pkg.overlap_tests(cloud[:half], cloud[half:])
    _, _, beta_self = eval_pkg.overlap_tests(cloud[:half], cloud[:half])
    vals = [t.statistic for t in ks] + [t.pvalue for t in ks] + [t.statistic for t in ad]
    if not (len(ks) == len(ad) == cloud.shape[1] and all(np.isfinite(vals))
            and 0.0 <= beta <= 1.0 and abs(beta_self - 1.0) <= 1e-12):
        fail(f"slice 10: overlap_tests: ks {ks}, ad {ad}, beta {beta}, self {beta_self}")
    print(f"slice 10: overlap_tests on slice 5's cloud's halves ({half} + {half}): K-S "
          + ", ".join(f"{t.statistic:.4f} (p {t.pvalue:.3g})" for t in ks) + "; A-D "
          + ", ".join(f"{t.statistic:.3f}" for t in ad) + f"; beta {beta:.4f}, against itself "
          f"{beta_self:.12f}; centered_tukey_window {win_err:.1e} off numpy; burst bank bf16 "
          f"finite")

    launches = (P.LAUNCHES, CV.LAUNCHES)
    if launches != (0, 0):
        fail(f"slice 10 launched the kernels (phasor, conv) {launches} times; its functions "
             f"are torch.matmul and torch elementwise ops")
    return launches, time.perf_counter() - t_start


# the JAX runners' rows (scripts/bbh_sweep.py:256-269, run_flagship.py:52-65,
# burst_sweep.py:225-237): slice 11 holds the port's rows to these keys
BBH_ROW = ["variant", "seed", "iters", "beta", "beta_raw", "grid_overlap_raw", "beta_sanity",
           "cnn_sanity_beta", "grid_overlap", "whiteness", "frozen_at", "selected_route",
           "pool_ess", "plateau_k", "wall_s"]
FLAGSHIP_ROW = ["variant", "seed", "iters", "beta", "beta_raw", "grid_overlap_raw",
                "beta_sanity", "cnn_sanity_beta", "grid_overlap", "whiteness", "frozen_at",
                "selected_at", "out_dir", "wall_s"]
BURST_ROW = ["variant", "seed", "iters", "grid_overlap_final", "grid_overlap_best", "whiteness",
             "rms", "frozen_at", "selected_at", "selected_route", "pool_ess", "plateau_k",
             "wall_s"]


def _check_overlaps(where: str, row: dict, keys, nulls=(), nan_ok=(), sentinel=None):
    """Each overlap of ``row`` named in ``keys``: None where the JAX summary
    gives None (``nulls``), else a float in [0, 1]; NaN allowed for
    ``nan_ok`` (``beta_overlap``'s 0/0 when a cloud's KDE underflows, kept
    for parity: ROADMAP queue 3), and ``sentinel`` for the burst's best
    score when no state was scored."""
    for k in keys:
        v = row[k]
        if k in nulls:
            ok = v is None
        else:
            ok = isinstance(v, float) and (0.0 <= v <= 1.0 or (k in nan_ok and math.isnan(v))
                                           or v == sentinel)
        if not ok:
            fail(f"slice 11: {where} {k} = {v!r}, expected "
                 + ("None, as in the JAX summary" if k in nulls else "a float in [0, 1]"))


def run_stage(P, CV, launches: dict, walls: dict, name: str, fn):
    """``fn()`` with both kernels' launch counts set to 0 just before it:
    its launches (phasor, conv) and wall go under ``name``."""
    import torch

    P.LAUNCHES = CV.LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    launches[name] = (P.LAUNCHES, CV.LAUNCHES)
    return out


def recipe_syntheses(n_synth: int, n_evals: int, n_lib: int) -> int:
    """Syntheses (3 phasor launches each) of one ``run_bbh`` under the
    ``r4flag`` routes (``pe_mlrc`` 1, ``reweight_temper`` 1,
    ``select_best="elbo"``, no ``select_route``) with no collapsed cloud:

    - set-up, ``n_synth``: bank batches, the event and its twin, grid
      chunks, the sanity set;
    - ``ml_recenter``, 302: the cloud, 300 Adam steps, the refined starts;
    - each of the ``n_evals`` in-run evaluations, 305: the draw's
      ``ml_recenter``, its ESS and its resample, then the cloud's ELBO;
    - the final draw, 304: ``ml_recenter``, ESS, resample;
    - ``select_final_cloud`` over ``n_lib`` library clouds (the saved
      clouds of step ≤ ``gan_iters``): when ``n_lib`` > 0, one ELBO each,
      then ``plat_is``, ``pool_is``, ``kde_is`` (16,384 draws, one call) and
      the pool's ESS, and the ELBOs of the candidates ``argmax``,
      ``plateau``, ``plat_is``, ``pool``, ``pool_is`` and ``kde_is``; the
      ELBO of the ``final`` candidate always;
    - the final evaluation of the chosen cloud: its 256 waveforms and its
      ELBO.
    """
    library = n_lib + 4 + 6 if n_lib else 0
    return n_synth + n_evals * (302 + 3) + (302 + 2) + library + 1 + 2


def slice11(P, CV, card, n_synth, work) -> tuple:
    """The recipe runners (slice 11) at full width (n_pix 1024, the 50,000
    bank, the recipes' batch sizes) on short schedules, in the directory
    ``work``, which slice 12 reads after it (the runners write under
    ``out/torch/`` of the working directory):

    - ``bbh_sweep.run_one("r4flag", 0, 200)``: 100 PE and 200 GAN steps
      (cadence 100, the recipe's evaluation every 100 instead of 5000),
      1000 draws an evaluation;
    - ``burst_sweep.run_one("mlrc_sel", 0, 500)``: 500 PE and 500 GAN
      steps (cadence 250, an evaluation at each), 1000 draws;
    - ``run_flagship`` (``--plots false``: the card's machine has no
      matplotlib) to 100 steps, then to 200, which resumes from the
      step-100 checkpoint, then to 200 again, which trains nothing and
      appends no row.

    Each row has exactly the JAX runner's keys, with each overlap a float
    in [0, 1], or None where the JAX summary gives None. Launches, exactly
    as the code implies: no conv launch (the recipes keep
    ``conv_impl="xla"``); under ``r4flag`` and each flagship run, 3 phasor
    launches for each synthesis that :func:`recipe_syntheses` counts; under
    ``mlrc_sel`` none (its bank is the analytic sine-Gaussian, its nets
    cuDNN). Returns (launches by stage, walls by stage)."""
    import dataclasses

    from gennet_tpu_torch.recipes import bbh_sweep, burst_sweep, run_flagship

    launches, walls = {}, {}
    stage = functools.partial(run_stage, P, CV, launches, walls)
    saved = (bbh_sweep.BASE, bbh_sweep.VARIANTS["r4flag"], burst_sweep.BASE)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        bbh_sweep.BASE = dataclasses.replace(bbh_sweep.BASE, pe_iters=100, pe_cadence=100,
                                             n_posterior=1000)
        bbh_sweep.VARIANTS["r4flag"] = dict(saved[1], eval_cadence=100)
        burst_sweep.BASE = dataclasses.replace(burst_sweep.BASE, pe_iters=500, cadence=250,
                                               eval_every=1, n_posterior=1000)

        row = stage("r4flag", lambda: bbh_sweep.run_one("r4flag", 0, 200, device="cuda"))
        if list(row) != BBH_ROW or (row["variant"], row["seed"], row["iters"]) != (
                "r4flag", 0, 200):
            fail(f"slice 11: bbh_sweep row {row}")
        # select_best="elbo": the final cloud is library-selected, its
        # raw scores null, as in the JAX summary (ROADMAP queue 3)
        _check_overlaps("r4flag", row, BBH_ROW[3:9], nulls=("beta_raw", "grid_overlap_raw"),
                        nan_ok=("beta_sanity",))
        if row["selected_route"] is None:
            fail("slice 11: r4flag selected no library candidate")
        sweep_rows = read_rows(bbh_sweep.RESULTS)
        if [json.dumps(r) for r in sweep_rows] != [json.dumps(row)]:
            fail(f"slice 11: {bbh_sweep.RESULTS} holds {sweep_rows}")

        row_b = stage("mlrc_sel",
                      lambda: burst_sweep.run_one("mlrc_sel", 0, 500, device="cuda"))
        if list(row_b) != BURST_ROW or (row_b["variant"], row_b["seed"], row_b["iters"]) != (
                "mlrc_sel", 0, 500):
            fail(f"slice 11: burst_sweep row {row_b}")
        _check_overlaps("mlrc_sel", row_b, ("grid_overlap_final",))
        _check_overlaps("mlrc_sel", row_b, ("grid_overlap_best",), sentinel=-1.0)
        if row_b["selected_at"] not in (250, 500) or row_b["selected_route"] is None:
            fail(f"slice 11: mlrc_sel selected_at {row_b['selected_at']}, route "
                 f"{row_b['selected_route']}")
        if [json.dumps(r) for r in read_rows(burst_sweep.RESULTS)] != [json.dumps(row_b)]:
            fail(f"slice 11: {burst_sweep.RESULTS} does not hold the one burst row")

        flag = []
        for n in (100, 200, 200):
            flag.append(stage(f"flagship {n}" + (" again" if len(flag) == 2 else ""),
                              lambda n=n: run_flagship.main(
                                  ["r4flag", str(n), "--device", "cuda", "--plots", "false"])))
        first, second, third = flag
        for r, n in ((first, 100), (second, 200)):
            if r is None or list(r) != FLAGSHIP_ROW or r["iters"] != n:
                fail(f"slice 11: flagship row at {n}: {r}")
            _check_overlaps(f"flagship {n}", r, FLAGSHIP_ROW[3:9],
                            nulls=("beta_raw", "grid_overlap_raw"), nan_ok=("beta_sanity",))
        gan_steps = [r["step"] for r in read_rows(
            os.path.join(run_flagship.OUT_DIR, "bbh_metrics.jsonl")) if "d_loss" in r]
        if third is not None or gan_steps != [100, 200]:
            fail(f"slice 11: the flagship's resume: GAN rows at {gan_steps} (expected "
                 f"[100, 200]), the re-run returned {third}")
        if [json.dumps(r) for r in read_rows(bbh_sweep.RESULTS)[1:]] != [
                json.dumps(r) for r in (first, second)]:
            fail("slice 11: the flagship's re-run after completion appended a row")
    finally:
        os.chdir(cwd)
        bbh_sweep.BASE, bbh_sweep.VARIANTS["r4flag"], burst_sweep.BASE = saved

    # launches against what the code implies: the r4flag run evaluates at
    # 100 and 200 and its library holds those two clouds; the flagship has
    # no in-run evaluation (eval_cadence 10k), so its run to 100 has an
    # empty library and its run to 200 the first run's final cloud (saved
    # at step 101 ≤ 200); the re-run trains nothing and draws nothing
    expect = {"r4flag": 3 * recipe_syntheses(n_synth, n_evals=2, n_lib=2),
              "mlrc_sel": 0,
              "flagship 100": 3 * recipe_syntheses(n_synth, n_evals=0, n_lib=0),
              "flagship 200": 3 * recipe_syntheses(n_synth, n_evals=0, n_lib=1),
              "flagship 200 again": 3 * n_synth}
    for name, (ph, cv) in launches.items():
        if cv != 0:
            fail(f"slice 11: {name} launched the conv kernel {cv} times under conv_impl xla")
        if ph != expect[name]:
            fail(f"slice 11: {name} launched the phasor kernel {ph} times, expected exactly "
                 f"{expect[name]} (recipe_syntheses; 0 under mlrc_sel, whose bank is the "
                 "analytic sine-Gaussian)")
    print("slice 11: rows " + json.dumps({"r4flag": row, "mlrc_sel": row_b,
                                          "flagship": [first, second]}))
    print("slice 11: launches (phasor, conv) " + json.dumps(launches) + " (expected: conv 0, "
          f"phasor exactly {json.dumps(expect)})")
    print("slice 11: walls s " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f" [{card}]")
    return launches, walls


# the JAX scripts' rows (scripts/bbh_postproc_eval.py:161-200,
# elbo_stack_eval.py:122-125, twin_cue_probe.py:79-86,
# d_memorization_probe.py:115, bbh_sampler_calibration.py:94-101,
# burst_pool_study.py:83-89, burst_rescore_study.py:94-119): slice 12
# holds the port's rows to these keys
POSTPROC_ROUTE_ROW = ["run", "route", "beta", "grid_overlap", "elbo", "cloud"]
POSTPROC_LIBRARY_ROW = ["run", "route", "beta", "grid_overlap", "elbo", "chosen", "plateau_k",
                        "pool_ess", "kde_ess"]
STACK_ROW = ["run", "k", "steps", "beta", "grid_overlap", "elbo_pooled"]
TWIN_ROW = ["run", "step", "twin_boost", "logit_bank", "logit_signal", "logit_g", "twin_penalty"]
FAMILIES = ["A", "B", "C", "C2", "C3", "D", "E"]
SAMPLER_ROW = ["bn_mode", "dropout", "posterior_noise", "beta", "grid_overlap", "bias_mc",
               "disp_mc", "disp_q"]
POOL_ROW = ["run", "argmax_step", "plateau_k", "pool_ess", "kde_ess", "scores", "candidates",
            "chosen", "chosen_overlap"]
RESCORE_SCORES = ["elbo_g", "elbo_k", "mlogl", "white", "w_elbo"]


def _finite(where: str, values: dict, keys, nulls=(), nan_ok=()):
    """Each value of ``keys`` a finite float, or None for ``nulls`` (the
    script's None for a non-finite ELBO), or NaN for ``nan_ok``
    (``beta_overlap``'s 0/0 when a cloud's KDE underflows, kept for parity:
    ROADMAP queue 3)."""
    for k in keys:
        v = values[k]
        ok = ((v is None and k in nulls) or (isinstance(v, float) and (
            math.isfinite(v) or (k in nan_ok and math.isnan(v)))))
        if not ok:
            fail(f"slice 12: {where} {k} = {v!r}, expected a finite float"
                 + (" or None" if k in nulls else ""))


def slice12(P, CV, card, n_synth, work) -> tuple:
    """The post-run studies (``gennet_tpu_torch.studies``, slice 12) at
    full width, in ``work`` (the studies write under ``out/torch/`` of the
    working directory):

    - on slice 11's ``r4flag`` run (the ch1-only D, a CNN cache, clouds at
      steps 100, 200 and the final 201): ``bbh_postproc_eval`` (the raw
      cloud and 8 routes, then the library over the two in-run clouds),
      ``elbo_stack_eval``, ``twin_cue_probe``, and ``bbh_sampler_calibration``
      refused before any work (its script restores the default batch-norm
      G and the pair D, which this run does not have);
    - a new short run of the ``r4_r3probe`` recipe (the pair D) under
      ``conv_impl="pallas"`` without a CNN cache, so its PE is in
      ``ckpt_pe``: 100 PE and 100 GAN steps, cadence 50, an evaluation at
      50 and 100, 1000 draws; on it ``d_memorization_probe`` (its newest
      checkpoint: the best-whiteness state at step 101) and
      ``bbh_sampler_calibration`` (16 cells of 1000 draws, where the study
      takes 4000: a cut of its depth only, as G's chunks stay 256 rows);
    - on slice 11's ``mlrc_sel`` run: ``burst_pool_study`` and
      ``burst_rescore_study``; and ``burst_debias_diag`` at its own size.

    Each row has exactly the JAX script's keys, with every overlap, logit
    and ELBO finite, or None where the script gives None. Launches, exactly
    as the code implies (``recipe_syntheses`` for the run; 3 phasor
    launches a synthesis; 35 conv launches a GAN step, 5 a G chunk of 256,
    2 a D pass). Returns (launches by stage, walls by stage)."""
    import dataclasses

    from gennet_tpu_torch.cli.workloads import run_bbh
    from gennet_tpu_torch.recipes import bbh_sweep, burst_sweep
    from gennet_tpu_torch.studies import (bbh_postproc_eval, bbh_sampler_calibration,
                                          burst_debias_diag, burst_pool_study,
                                          burst_rescore_study, d_memorization_probe,
                                          elbo_stack_eval, twin_cue_probe)

    launches, walls = {}, {}
    stage = functools.partial(run_stage, P, CV, launches, walls)
    r4flag = os.path.join(bbh_sweep.ROOT, "r4flag_s0")
    probe = os.path.join(bbh_sweep.ROOT, "r4_r3probe_pallas_s0")
    mlrc = os.path.join(burst_sweep.ROOT, "mlrc_sel_s0")
    cuda = ["--device", "cuda"]

    def refused(run_dir):
        try:
            bbh_sampler_calibration.main([run_dir, *cuda])
        except ValueError as e:
            return str(e)
        fail(f"slice 12: bbh_sampler_calibration ran on {run_dir}, which its script cannot "
             "restore")

    cwd = os.getcwd()
    os.chdir(work)
    try:
        lib_steps = [int(p.rsplit("_", 1)[1].split(".")[0]) for p in os.listdir(
            os.path.join(r4flag, "GAN_posterior_samples"))]
        n_lib = sum(st <= 200 for st in lib_steps)
        post = stage("postproc r4flag", lambda: bbh_postproc_eval.main([r4flag, *cuda]))
        stack, _ = stage("stack r4flag", lambda: elbo_stack_eval.main([r4flag, *cuda]))
        twin = stage("twin r4flag", lambda: twin_cue_probe.main([r4flag, *cuda]))
        why = stage("sampler r4flag refused", lambda: refused(r4flag))
        cfg = dataclasses.replace(
            bbh_sweep.BASE, **bbh_sweep.VARIANTS["r4_r3probe"], conv_impl="pallas",
            cnn_cache=None, pe_iters=100, pe_cadence=100, gan_iters=100, cadence=50,
            eval_cadence=50, n_posterior=1000, out_dir=probe)
        run = stage("r4_r3probe pallas", lambda: run_bbh(cfg, device="cuda"))
        mem = stage("memorization r4_r3probe",
                    lambda: d_memorization_probe.main([probe, *cuda]))
        cells = stage("sampler r4_r3probe",
                      lambda: bbh_sampler_calibration.main([probe, "1000", *cuda]))
        pool = stage("pool mlrc_sel", lambda: burst_pool_study.main([mlrc, *cuda]))[0]
        rescore = stage("rescore mlrc_sel", lambda: burst_rescore_study.main([mlrc, *cuda]))[0]
        diag = stage("debias diag", lambda: burst_debias_diag.main(cuda))
        probe_rows = read_rows(os.path.join(probe, "bbh_metrics.jsonl"))
        probe_lib = sum(int(p.rsplit("_", 1)[1].split(".")[0]) <= cfg.gan_iters
                        for p in os.listdir(os.path.join(probe, "GAN_posterior_samples")))
    finally:
        os.chdir(cwd)

    # ---- the rows: the scripts' keys, finite values ----------------------------
    routes = ["raw", "debias1", "debias2", "bootcal", "debias1_bootcal", "mlrc",
              "mlrc_reweight1", "reweight1", "reweight05"]
    if [r["route"] for r in post[:9]] != routes or len(post) != 9 + 6:
        fail(f"slice 12: postproc routes {[r['route'] for r in post]}")
    for r in post:
        lib = r["route"].startswith("library:")
        keys = (POSTPROC_LIBRARY_ROW + [k for k in ("elbo_se", "tiebreak") if k in r] if lib
                else POSTPROC_ROUTE_ROW + (["ess"] if r["route"].startswith("reweight") else []))
        if list(r) != keys:
            fail(f"slice 12: postproc row keys {list(r)}, expected {keys}")
        _finite(f"postproc {r['route']}", r, ["beta", "grid_overlap", "elbo"]
                + (["pool_ess", "kde_ess"] if lib else []), nulls=("elbo",), nan_ok=("beta",))
    if sum(r.get("chosen", False) for r in post) != 1:
        fail("slice 12: postproc chose no library candidate, or more than one")
    if not stack or any(list(r) != STACK_ROW for r in stack):
        fail(f"slice 12: elbo_stack rows {stack}")
    for r in stack:
        _finite(f"stack k={r['k']}", r, ["beta", "grid_overlap", "elbo_pooled"],
                nulls=("elbo_pooled",), nan_ok=("beta",))
    if list(twin) != TWIN_ROW or twin["step"] != 200:
        fail(f"slice 12: twin_cue row {twin} (the last training state is step 200)")
    _finite("twin_cue", twin, TWIN_ROW[3:])
    if "g_norm='group'" not in why or "pair_d=False" not in why:
        fail(f"slice 12: the sampler calibration's refusal of r4flag: {why}")
    if list(mem) != FAMILIES:
        fail(f"slice 12: memorization families {list(mem)}")
    _finite("memorization", mem, FAMILIES)
    if [list(r) for r in cells] != [SAMPLER_ROW] * 16:
        fail(f"slice 12: sampler rows {cells}")
    for r in cells:
        _finite("sampler", r, SAMPLER_ROW[3:], nan_ok=("beta",))
    if pool is None or list(pool) != POOL_ROW:
        fail(f"slice 12: pool study row {pool}")
    _finite("pool study", pool, ["pool_ess", "kde_ess", "chosen_overlap"])
    keys = ["run", "n", *[k for k in RESCORE_SCORES if k in rescore], "best_overlap",
            "final_overlap"]
    if list(rescore) != keys or "elbo_g" not in rescore:
        fail(f"slice 12: rescore row {rescore}")
    _finite("rescore", rescore, ["best_overlap", "final_overlap"])
    _finite("debias diag", diag, ["ml_recenter", "raw"])

    # ---- launches against what the code implies --------------------------------
    # syntheses: the event 1, the bank's 13 batches and its twin 14, the
    # grid's 3 chunks of 4096; the route sweep 321 (self_calibrate 1 and 2,
    # bootstrap 1 and 1, ml_recenter 302, three resamples, two ESS, nine
    # ELBOs); the library n_lib + 10 (recipe_syntheses); one ELBO a stack.
    # conv (r4_r3probe under pallas): 35 a GAN step, 5 a G chunk of 256
    # (4 chunks a 1000-draw), 2 a D pass
    steps = run["final_step"]
    n_evals = sum("whiteness" in r for r in probe_rows)
    expect = {
        "postproc r4flag": (3 * (1 + 3 + 321 + n_lib + 10), 0),
        "stack r4flag": (3 * (1 + 3 + len(stack)), 0),
        "twin r4flag": (3 * 15, 0),
        "sampler r4flag refused": (0, 0),
        "r4_r3probe pallas": (3 * recipe_syntheses(n_synth, n_evals=n_evals, n_lib=probe_lib),
                              35 * steps + 5 * 4 * (n_evals + 1)),
        "memorization r4_r3probe": (3 * 15, 5 + 7 * 2),
        "sampler r4_r3probe": (3 * (15 + 3), 16 * 4 * 5),
        "pool mlrc_sel": (0, 0), "rescore mlrc_sel": (0, 0), "debias diag": (0, 0),
    }
    if launches != expect:
        fail("slice 12: launches (phasor, conv) " + json.dumps(launches) + ", expected "
             + json.dumps(expect))
    print("slice 12: rows " + json.dumps({
        "postproc": post, "stack": stack, "twin": twin, "sampler_refusal": why,
        "r4_r3probe": {k: run[k] for k in ("final_step", "frozen_at", "beta", "grid_overlap",
                                           "selected_route")},
        "memorization": mem, "verdict": d_memorization_probe.verdict(mem), "sampler": cells,
        "pool": pool, "rescore": rescore,
        "debias": {k: diag[k] for k in ("ml_recenter", "raw")}}, default=float))
    print("slice 12: launches (phasor, conv) " + json.dumps(launches) + " (as expected)")
    print("slice 12: walls s " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f" [{card}]")
    return launches, walls


def bf16_against_f32(pe, bank, measured, g, dev, card) -> dict:
    """GAN steps/s (default recipe, batch 8) and the wall time of a
    4000-draw posterior (G's draws in chunks of 256 through the PE), bf16
    against float32 under each ``conv_impl``, in turns f32, bf16, bf16, f32,
    f32, bf16; and the conv kernel's launches per GAN step and per draw
    under pallas in both dtypes. Returns the rates, times and launches."""
    import torch

    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.ops import conv1d as CV
    from gennet_tpu_torch.train import cnn as tcnn
    from gennet_tpu_torch.train import gan as tgan

    n_pix = bank.shape[1]
    gan_cfg = tgan.GANConfig(n_pix=n_pix, label_smoothing=True, d_instance_noise=0.3,
                             d_lr_scale=0.5, d_acc_gate=0.9)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    states = {(impl, name): tgan.init_gan(
        torch.Generator().manual_seed(2), BBHGenerator(n_out=n_pix, conv_impl=impl, dtype=dt),
        PairDiscriminator(n_pix=n_pix, conv_impl=impl, dtype=dt), gan_cfg, dev)
        for impl in ("xla", "pallas") for name, dt in dtypes.items()}

    def draw_s(st) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wf = tgan.sample_generator(st.generator, st, g, 4000, gan_cfg)
        tcnn.predict(pe, wf, use_ema=True).cpu()
        return time.perf_counter() - t0

    res = {"steps_per_s": {}, "draw_s": {}, "conv_per_step": {}, "conv_per_draw": {}}
    for impl in ("xla", "pallas"):
        for name in dtypes:
            draw_s(states[(impl, name)])  # warm-up
            res["steps_per_s"][f"{impl} {name}"], res["draw_s"][f"{impl} {name}"] = [], []
        for name in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):
            st = states[(impl, name)]
            res["steps_per_s"][f"{impl} {name}"].append(steps_per_s(
                lambda: tgan.gan_step(st, bank, measured, g, cfg=gan_cfg)))
            res["draw_s"][f"{impl} {name}"].append(draw_s(st))
    for name in dtypes:
        st = states[("pallas", name)]
        CV.LAUNCHES = 0
        for _ in range(4):
            tgan.gan_step(st, bank, measured, g, cfg=gan_cfg)
        res["conv_per_step"][name] = CV.LAUNCHES / 4
        CV.LAUNCHES = 0
        draw_s(st)
        res["conv_per_draw"][name] = CV.LAUNCHES
    fmt = lambda xs: "/".join(f"{x:.1f}" for x in xs)  # noqa: E731
    fms = lambda xs: "/".join(f"{1e3 * x:.0f}" for x in xs)  # noqa: E731
    for impl in ("xla", "pallas"):
        print(f"throughput bf16 vs float32, conv_impl {impl} (order f32, bf16, bf16, f32, f32, "
              f"bf16; 50 steps each): GAN steps/s f32 {fmt(res['steps_per_s'][impl + ' f32'])}, "
              f"bf16 {fmt(res['steps_per_s'][impl + ' bf16'])}; 4000-draw posterior ms f32 "
              f"{fms(res['draw_s'][impl + ' f32'])}, bf16 {fms(res['draw_s'][impl + ' bf16'])} "
              f"[{card}]")
    print(f"conv kernel launches under pallas: per GAN step f32 {res['conv_per_step']['f32']:g}, "
          f"bf16 {res['conv_per_step']['bf16']:g}; per 4000-draw posterior f32 "
          f"{res['conv_per_draw']['f32']}, bf16 {res['conv_per_draw']['bf16']}")
    if res["conv_per_step"]["bf16"] != res["conv_per_step"]["f32"] or \
            res["conv_per_draw"]["bf16"] != res["conv_per_draw"]["f32"]:
        fail("bf16 under pallas launched the conv kernel another number of times than float32")
    return res


def main():
    if not os.path.isdir(os.path.join(REPO, "gennet_tpu_torch")):
        fail(f"no gennet_tpu_torch package beside {__file__}: run from a checkout")
    import torch
    import torch.nn.functional as F

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
    print(f"build: {time.perf_counter() - t0:.1f} s")
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
    b_window = torch.tensor(b_weights, dtype=torch.float32, device=dev)

    def phasor_library(a, ph):
        """The same function as one library transform: irfft of the one-sided
        spectrum a·e^{−iΨ} (the tables' convention), pass B's window slice."""
        return torch.fft.irfft(torch.polar(a, -ph), n=N)[:, b_start:b_start + b_width] * b_window

    lib_out = phasor_library(amp, phase_b)
    lib_ref = P.phasor_matmul_ref(amp, phase_b, Cb, Sb)
    lib_rel = float((lib_out - lib_ref).abs().max() / lib_ref.abs().max())
    print(f"phasor library call (irfft of the spectrum, pass B slice): {lib_rel:.3e} of the "
          f"maximum off plain (limit {LIB_TOL:g})")
    if not lib_rel <= LIB_TOL:
        fail(f"the irfft library call disagrees with the phasor's plain version ({lib_rel:.3e})")
    del lib_out, lib_ref
    times, bounds, lib_ms = {}, {}, {}
    for tag, n, (ph, C, S) in (("pass A", 4096, (phase, Ca, Sa)), ("pass B", 4096, (phase_b, Cb, Sb)),
                               ("pass A B=8", 8, (phase, Ca, Sa)), ("pass B B=8", 8, (phase_b, Cb, Sb))):
        a, ph = amp[:n].contiguous(), ph[:n].contiguous()
        k_ms = cuda_ms(lambda: P.phasor_matmul(a, ph, C, S))
        p_ms = cuda_ms(lambda: P.phasor_matmul_ref(a, ph, C, S))
        k2 = cuda_ms(lambda: P.phasor_matmul(a, ph, C, S))
        p2 = cuda_ms(lambda: P.phasor_matmul_ref(a, ph, C, S))
        times[tag] = (min(k_ms, k2), min(p_ms, p2))
        flops, nbytes = phasor_cost(n, a.shape[1], C.shape[1])
        bounds[tag] = bound(flops, nbytes)
        extra = ""
        if tag.startswith("pass B"):
            lib_ms[tag] = cuda_ms(lambda: phasor_library(a, ph))
            extra = f", library (irfft) {lib_ms[tag]:.3f} ms"
        print(f"time {tag} (B={n} K=2049 T={C.shape[1]}): kernel {k_ms:.3f}/{k2:.3f} ms, "
              f"plain {p_ms:.3f}/{p2:.3f} ms (median of {N_TIMED}, order kernel, plain, "
              f"kernel, plain){extra}; kernel {flops / (min(k_ms, k2) * 1e-3) / 1e12:.2f} TFLOP/s; "
              f"bound {bounds[tag][0]:.4f} ms by {bounds[tag][1]} ({flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), kernel at {bounds[tag][0] / min(k_ms, k2):.2f} of it "
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
    conv_err, conv_times, conv_bounds = 0.0, {}, {}
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
        flops, nbytes = conv_cost(B, L, ci, co, s)
        conv_bounds[(name, what, B)] = bound(flops, nbytes)
        bms, bby = conv_bounds[(name, what, B)]
        if (name, what, B) == ("G Conv_4", "fwd", 8):
            # the library call: one cuDNN F.conv1d (SAME at stride 1 is symmetric)
            lib_ms["conv"] = cuda_ms(lambda: F.conv1d(x, w, b, padding=2))
        print(f"conv {name} {what} (B={B} L={L} Cin={ci} Cout={co} stride={s}): "
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit {CONV_TOL:g}); vs float64: kernel "
              f"{e64[0]:.2e} (limit {F64_TOL:g}), plain {e64[1]:.2e}; kernel {k1:.3f}/{k2:.3f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms (median of {N_TIMED}, order kernel, plain, kernel, "
              f"plain); kernel {flops / (min(k1, k2) * 1e-3) / 1e12:.2f} TFLOP/s, plain "
              f"{flops / (min(p1, p2) * 1e-3) / 1e12:.2f} TFLOP/s; bound {bms:.4f} ms by {bby} "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at "
              f"{bms / min(k1, k2):.2f} of it [{card}]")
        del x, w, b
    print(f"conv determinism: two calls bitwise equal at all {len(calls)} shapes")
    for name, _, cin, cout, _ in CONV_LAYERS:  # the weight pack kernel vs its torch version
        w = torch.randn((cout, cin, 5), generator=g, device=dev)
        for transposed in (False, True):
            if not torch.equal(CV._pack_on_card(w, transposed), CV.pack_weight(w, transposed)):
                fail(f"conv {name}: the pack kernel differs from pack_weight "
                     f"(transposed={transposed})")
    print(f"conv weight pack: the pack kernel equals pack_weight bit for bit at all "
          f"{len(CONV_LAYERS)} layers, forward and dx forms")
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

    # ---- 5b. the stride-2 dx kernel ------------------------------------------
    from gennet_tpu_torch.ops import conv1d_dx as S

    dx_summary = conv_dx_check(S, card)

    # ---- 5c. the stride-2 dw kernel ------------------------------------------
    from gennet_tpu_torch.ops import conv1d_dw as W

    dw_summary = conv_dw_check(W, card)

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

    # ---- 8. slice 3: --conv-impl pallas on the residual route ---------------
    probes = ("d_grad_norm", "g_grad_norm", "res_grad_norm", "g_param_norm", "d_param_norm",
              "x_fake_absmax", "d_logit_absmax", "bn_var_min")
    gan_iters3, cadence3, eval3, anneal3 = 20, 5, 10, 0.5
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        argv = ["train-bbh", "--device", "cuda", "--n-pix", str(n_pix),
                "--training-num", str(training_num), "--pe-iters", "20",
                "--gan-iters", str(gan_iters3), "--cadence", str(cadence3), "--pe-cadence", "10",
                "--eval-cadence", str(eval3), "--conv-impl", "pallas", "--res-loss-weight", "1.0",
                "--res-spectral-bands", "16", "--pair-d", "false", "--diversity-weight", "0.1",
                "--anneal-frac", str(anneal3), "--freeze-on-white", "0.99",
                "--freeze-on-res", "1e-3", "--debug-probes", "true",
                "--ckpt-every", "100000", "--plots", "false", "--out-dir", out_dir]
        P.LAUNCHES = CV.LAUNCHES = 0
        t0 = time.perf_counter()
        out3 = cli_main(argv)
        torch.cuda.synchronize()
        slice3_s = time.perf_counter() - t0
        phasor_launches_3, conv_launches_3 = P.LAUNCHES, CV.LAUNCHES
        rows3 = read_rows(os.path.join(out_dir, "bbh_metrics.jsonl"))
    # conv kernel, from the code (train/gan.py::gan_update): per iteration the
    # D step runs G (5 convs) without grad and D (2) on the real and on the
    # fake series, whose backward launches D Conv_1's dx twice (D Conv_0's
    # inputs need no grad); the residual route runs G forward (5) and back
    # (5 dx: G Conv_0's input carries the Dense's grad); the G step runs G (5)
    # and D (2) forward and 7 dx (D's 2, Conv_0's back to 1 channel; G's 5): 35. Each
    # eval and the final draw run G in 16 chunks of 256 (5 launches each).
    steps3 = out3["final_step"]
    n_draws3 = steps3 // eval3 + 1
    conv_expect3 = 35 * steps3 + 5 * math.ceil(4000 / 256) * n_draws3
    print(f"slice 3: train-bbh --conv-impl pallas on the residual route finished in "
          f"{slice3_s:.1f} s after {steps3} GAN steps (frozen_at {out3['frozen_at']}); conv "
          f"kernel launches {conv_launches_3} (≥ {conv_expect3} expected: {steps3} iterations "
          f"× 35 + {n_draws3} draws × 16 chunks × 5), phasor kernel launches "
          f"{phasor_launches_3} (≥ {3 * n_synth} expected) [{card}]")
    if conv_launches_3 < conv_expect3:
        fail(f"slice 3 launched the conv kernel {conv_launches_3} times, "
             f"expected ≥ {conv_expect3}")
    if phasor_launches_3 < 3 * n_synth:
        fail(f"slice 3 launched the phasor kernel {phasor_launches_3} times, "
             f"expected ≥ {3 * n_synth}")
    if not 0 < steps3 <= gan_iters3:
        fail(f"slice 3: final_step {steps3} outside (0, {gan_iters3}]")
    gan_rows3 = [r for r in rows3 if "res_loss" in r]
    if len(gan_rows3) != steps3 // cadence3:
        fail(f"slice 3: {len(gan_rows3)} GAN metric rows for {steps3} steps at cadence {cadence3}")
    for r in gan_rows3:
        bad = [k for k in probes if not (k in r and math.isfinite(r[k]))]
        if bad:
            fail(f"slice 3: debug probes absent or non-finite at step {r['step']}: {bad}")
        if not r["res_loss"] > 0:
            fail(f"slice 3: res_loss {r['res_loss']} at step {r['step']}")
    # D is frozen from the first annealed iteration on: its norm after the
    # last ordinary step (step anneal_start) holds through every later row
    anneal_start = int(gan_iters3 * (1.0 - anneal3))
    frozen_d = [(r["step"], r["d_param_norm"]) for r in gan_rows3 if r["step"] >= anneal_start]
    if len(frozen_d) > 1 and len({v for _, v in frozen_d}) != 1:
        fail(f"slice 3: D moved during the annealed half: d_param_norm {frozen_d}")
    for key in ("beta", "grid_overlap"):
        v = out3[key]
        if not isinstance(v, float) or not 0.0 <= v <= 1.0:
            fail(f"slice 3: {key} = {v!r}, expected a float in [0, 1]")
    print("slice 3 summary: " + json.dumps({k: out3[k] for k in (
        "final_step", "frozen_at", "beta", "grid_overlap", "cnn_sanity_beta", "pe_rms")})
        + " annealed d_param_norm: " + json.dumps(frozen_d)
        + " last GAN row: " + json.dumps(gan_rows3[-1]))

    # ---- 9. slice 4: smoke through the CLI at the reference widths ----------
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        argv = ["smoke", "--device", "cuda", "--pe-iters", "200", "--gan-iters", "200",
                "--cadence", "100", "--select-best", "elbo", "--anneal-frac", "0.25",
                "--plots", "false", "--out-dir", out_dir]
        P.LAUNCHES = CV.LAUNCHES = 0
        t0 = time.perf_counter()
        out4 = cli_main(argv)
        torch.cuda.synchronize()
        slice4_s = time.perf_counter() - t0
        launches_4 = (P.LAUNCHES, CV.LAUNCHES)
        rows4 = read_rows(os.path.join(out_dir, "burst_metrics.jsonl"))
    attempts4 = sum(1 for r in rows4 if r.get("step") == 200 and "res_loss" in r)
    print(f"slice 4: smoke (n_pix 512, 50,000 signals, batch 64, grain 95, 4000 draws, 200 PE "
          f"and 200 GAN steps, {attempts4} attempts) finished in {slice4_s:.1f} s; kernel "
          f"launches phasor {launches_4[0]}, conv {launches_4[1]} (0 expected: the burst "
          f"networks' convs are cuDNN) [{card}]")
    if launches_4 != (0, 0):
        fail(f"slice 4: the burst path launched the kernels {launches_4} times")
    go = out4["grid_overlap"]
    if not isinstance(go, float) or not 0.0 <= go <= 1.0:
        fail(f"slice 4: grid_overlap = {go!r}, expected a float in [0, 1]")
    if not all(math.isfinite(x) for x in out4["rms"]):
        fail(f"slice 4: rms not finite: {out4['rms']}")
    if not out4["whiteness"]:
        fail("slice 4: no whiteness in the summary")
    if out4["selected_route"] is None:
        fail("slice 4: select_best=elbo selected no route")
    print("slice 4 summary: " + json.dumps(out4))

    # ---- 10. slice 5: the staged pipeline through the CLI -------------------
    launches_5, stage_s_5, cloud_5 = slice5(cli_main, P, CV, build, card)

    # ---- 11. slice 6: --bf16, --lalinf-dir on the port's products, plots ---
    launches_6 = {f"bf16 {k}": v for k, v in slice6_bf16(cli_main, P, CV, build, card,
                                                          n_synth).items()}
    launches_6.update({f"lalinf {k}": v for k, v in slice6_products(cli_main, P, CV, build,
                                                                    card).items()})
    plots_branch = slice6_plots(cli_main, build, card)
    print(f"slice 6: plots branch that ran: {plots_branch}")
    print("slice 6 launches (phasor, conv): " + json.dumps(launches_6))

    # ---- 12. slice 7: data parallelism and make-mdc --------------------------
    t0 = time.perf_counter()
    launches_7, err_7 = slice7(cli_main, P, CV, build, card, stage_s_5["make-bank"])
    print(f"slice 7 finished in {time.perf_counter() - t0:.1f} s; launches (phasor, conv): "
          + json.dumps(launches_7))

    # ---- 13. slice 8: the variant generations ----------------------------------
    t0 = time.perf_counter()
    launches_8, walls_8, rates_8 = slice8(cli_main, P, CV, build, card)
    print(f"slice 8 finished in {time.perf_counter() - t0:.1f} s; launches (phasor, conv) "
          f"{launches_8}; walls s " + json.dumps({k: round(v, 2) for k, v in walls_8.items()})
          + "; steps/s " + json.dumps({k: round(v, 1) for k, v in rates_8.items()})
          + f" [{card}]")

    # ---- 14. throughput (information, warm, same process) -------------------
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
    gan_cfg, gans = default_recipe_gans(n_pix, dev)
    measured = bank[-1] + torch.randn(n_pix, generator=g, device=dev)

    pe_rate = steps_per_s(lambda: tcnn.cnn_step(pe, bank, targets, g, cfg=pe_cfg))
    gan_rates = {"xla": [], "pallas": []}
    for impl in ("xla", "pallas", "pallas", "xla"):
        gan_rates[impl].append(steps_per_s(
            lambda: tgan.gan_step(gans[impl], bank, measured, g, cfg=gan_cfg)))

    # each kernel's launches per GAN step under pallas (default recipe and
    # slice 3's residual route) and per synthesis
    res_cfg = tgan.GANConfig(n_pix=n_pix, pair_discriminator=False, residual_route=True,
                             res_loss_weight=1.0, res_spectral_bands=16, diversity_weight=0.1,
                             label_smoothing=True, d_instance_noise=0.3, d_lr_scale=0.5,
                             d_acc_gate=0.9)
    res_gan = tgan.init_gan(torch.Generator().manual_seed(2),
                            BBHGenerator(n_out=n_pix, conv_impl="pallas"),
                            PairDiscriminator(n_pix=n_pix, in_ch=1, conv_impl="pallas"),
                            res_cfg, dev)
    res_rate = steps_per_s(lambda: tgan.gan_step(res_gan, bank, measured, g, cfg=res_cfg))
    per_step = {}
    for tag, st, c in (("default", gans["pallas"], gan_cfg), ("residual", res_gan, res_cfg)):
        CV.LAUNCHES = 0
        for _ in range(4):
            tgan.gan_step(st, bank, measured, g, cfg=c)
        per_step[tag] = CV.LAUNCHES / 4
    P.LAUNCHES = 0
    m8 = priors.sample_masses(g, 8, mdist=cfg.mdist)
    tb.make_templates_from_params(m8["m1"], m8["m2"], psd, cfg)
    per_synth = P.LAUNCHES

    # the burst networks at the smoke workload's widths (n_pix 512, batch 64)
    from gennet_tpu_torch.models import BurstDiscriminator, BurstGenerator, BurstPE
    from gennet_tpu_torch.physics.burst import make_burst_bank

    b_bank, b_pars = make_burst_bank(g, 50_000, N=512)
    b_meas = b_bank[0] + 0.25 * torch.randn(512, generator=g, device=dev)
    b_pe_cfg = tcnn.CNNConfig(n_pix=512, batch_size=64, lr=2e-4, noise_frac=0.5,
                              noise_scale_max=0.5)
    b_pe = tcnn.init_cnn(torch.Generator().manual_seed(1), BurstPE(n_pix=512), b_pe_cfg, dev)
    b_gan_cfg = tgan.GANConfig(n_pix=512, batch_size=64, lr=2e-4, n_sig=0.25,
                               pair_discriminator=False, residual_route=True,
                               res_loss_weight=10.0, label_smoothing=True, d_lr_scale=0.5)
    b_gan = tgan.init_gan(torch.Generator().manual_seed(2), BurstGenerator(n_out=512),
                          BurstDiscriminator(n_pix=512), b_gan_cfg, dev)
    burst_pe_rate = steps_per_s(lambda: tcnn.cnn_step(b_pe, b_bank, b_pars, g, cfg=b_pe_cfg))
    burst_gan_rates = [steps_per_s(lambda: tgan.gan_step(b_gan, b_bank, b_meas, g, cfg=b_gan_cfg))
                       for _ in range(2)]
    bf16_res = bf16_against_f32(pe, bank, measured, g, dev, card)
    # eager steps on slice 5's cloud (the number earlier PRs reported);
    # slice 9 replays the same call as a CUDA graph and must reproduce it
    mlrc_eager = ml_recenter_seconds(torch.Generator(device=dev).manual_seed(14), dev,
                                     cloud=cloud_5, eager=True)
    mlrc_s, mlrc_launches = mlrc_eager["s"], mlrc_eager["launches"]
    fmt =lambda r: "/".join(f"{x:.1f}" for x in r)
    print(f"throughput: bank {bank_rate:.0f} templates/s (n_pix 1024, batches of 4096), "
          f"PE {pe_rate:.1f} steps/s (batch 8), GAN steps/s (batch 8, 50 steps each, order "
          f"xla, pallas, pallas, xla): xla {fmt(gan_rates['xla'])}, pallas "
          f"{fmt(gan_rates['pallas'])}; ml_recenter as eager steps (300 steps, 8 starts, n_pix 1024) "
          f"{mlrc_s:.2f} s, {mlrc_launches} phasor launches [{card}]")
    print(f"throughput: GAN pallas on slice 3's residual route {res_rate:.1f} steps/s (batch 8); "
          f"conv kernel launches per GAN step under pallas: default recipe "
          f"{per_step['default']:g}, residual route {per_step['residual']:g}; phasor kernel "
          f"launches per synthesis {per_synth} [{card}]")
    print(f"throughput: burst PE {burst_pe_rate:.1f} steps/s, burst GAN "
          f"{fmt(burst_gan_rates)} steps/s (n_pix 512, batch 64, residual route, cuDNN convs, "
          f"50 steps each) [{card}]")

    # cuDNN's deterministic algorithms, which runtime.setup pins, against
    # its defaults, in turns, on the GAN steps whose backward runs cuDNN:
    # the flagship's under xla and the burst's (1-D), the image GAN's (2-D)
    from gennet_tpu_torch.models.image_models import FlatImageDiscriminator, FlatImageGenerator
    from gennet_tpu_torch.physics.blobs import make_blob_bank

    i_bank = make_blob_bank(g, 10_000, 28)[0].reshape(10_000, -1)
    i_meas = i_bank[0] + 0.3 * torch.randn(784, generator=g, device=dev)
    i_cfg = tgan.GANConfig(n_pix=784, batch_size=64, lr=2e-4, n_sig=0.3,
                           pair_discriminator=False, residual_route=True)
    i_gan = tgan.init_gan(torch.Generator().manual_seed(3), FlatImageGenerator(28),
                          FlatImageDiscriminator(28), i_cfg, dev)
    det_loops = {
        "GAN xla (batch 8)": lambda: tgan.gan_step(gans["xla"], bank, measured, g, cfg=gan_cfg),
        "burst GAN (batch 64)": lambda: tgan.gan_step(b_gan, b_bank, b_meas, g, cfg=b_gan_cfg),
        "image GAN (n_pix 28, batch 64)": lambda: tgan.gan_step(i_gan, i_bank, i_meas, g,
                                                                cfg=i_cfg)}
    det_rates = {k: {True: [], False: []} for k in det_loops}
    for det in (True, False, False, True):
        torch.backends.cudnn.deterministic = det
        for k, step in det_loops.items():
            det_rates[k][det].append(steps_per_s(step, n=30))
    torch.backends.cudnn.deterministic = True
    print("throughput: GAN steps/s with cuDNN's deterministic algorithms (on) against its "
          "defaults (off), order on, off, off, on, 30 steps each: "
          + "; ".join(f"{k} on {fmt(v[True])}, off {fmt(v[False])}" for k, v in det_rates.items())
          + f" [{card}]")

    # ---- 15. slice 9: the fused step loops as CUDA-graph replays -------------
    launches_9 = slice9(cli_main, P, CV, build, card, cloud_5, mlrc_eager)

    # ---- 16. slice 10: the names that closed the API gaps ---------------------
    launches_10, wall_10 = slice10(P, CV, card, cloud_5)
    print(f"slice 10 finished in {wall_10:.1f} s; launches (phasor, conv) {launches_10} [{card}]")

    # ---- 17-18. slices 11 and 12: the recipe runners, then the studies on their runs
    with tempfile.TemporaryDirectory(dir=build) as work:
        launches_11, walls_11 = slice11(P, CV, card, n_synth, work)
        print(f"slice 11 finished in {sum(walls_11.values()):.1f} s [{card}]")
        launches_12, walls_12 = slice12(P, CV, card, n_synth, work)
        print(f"slice 12 finished in {sum(walls_12.values()):.1f} s [{card}]")

    def worst(table):
        """The timed shape with the largest kernel / plain ratio."""
        shape, (k, p) = max(table.items(), key=lambda kv: kv[1][0] / kv[1][1])
        return {"shape": " ".join(map(str, shape)) if isinstance(shape, tuple) else shape,
                "ms": k, "plain_ms": p, "ratio": k / p}

    # launches: slice 7's data-parallel path at world 1 (make-bank and
    # train-bbh --data-parallel, which run both kernels; every path's count
    # under launches_by_path); times and bounds: pass B and G Conv_4's
    # forward at batch 8, the largest call of each on the train path
    print("slice 6 bf16 vs float32 summary: " + json.dumps(bf16_res))
    dp_launches = [sum(launches_7[k][i] for k in ("make-bank --data-parallel",
                                                   "train-bbh data-parallel")) for i in (0, 1)]
    k_ms, p_ms = times["pass B"]
    ck_ms, cp_ms = conv_times[("G Conv_4", "fwd", 8)]
    (pb_ms, pb_by), (cb_ms, cb_by) = bounds["pass B"], conv_bounds[("G Conv_4", "fwd", 8)]
    print(json.dumps({"kernels": [{
        "name": "phasor_irdft_f32", "route": "cuda",
        "source": "gennet_tpu_torch/csrc/phasor_irdft.cu",
        "replaces": "gennet_tpu/ops/phasor_dft.py:25",
        "launches": dp_launches[0], "max_abs_err": max(err_a, err_b, err_7),
        "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": pb_ms, "bound_by": pb_by, "library_ms": lib_ms["pass B"],
        "ms_worst_ratio": worst(times),
        "launches_by_path": {"slice 1": launches, "slice 2": phasor_launches,
                             "slice 3": phasor_launches_3, "slice 4": launches_4[0],
                             "slice 5": launches_5["phasor"],
                             **{f"slice 6 {k}": v[0] for k, v in launches_6.items()},
                             **{f"slice 7 {k}": v[0] for k, v in launches_7.items()},
                             "slice 8": launches_8[0],
                             **{f"slice 9 {k}": v[0] for k, v in launches_9.items()},
                             "slice 10": launches_10[0],
                             **{f"slice 11 {k}": v[0] for k, v in launches_11.items()},
                             **{f"slice 12 {k}": v[0] for k, v in launches_12.items()}},
    }, {
        "name": "conv1d_same_f32", "route": "cuda",
        "source": "gennet_tpu_torch/csrc/conv1d_same.cu",
        "replaces": "gennet_tpu/ops/pallas_conv1d.py:50",
        "launches": dp_launches[1], "max_abs_err": conv_err, "ms": ck_ms,
        "plain_ms": cp_ms,
        "bound_ms": cb_ms, "bound_by": cb_by, "library_ms": lib_ms["conv"],
        "ms_worst_ratio": worst(conv_times),
        "launches_by_path": {"slice 1": conv_launches_1, "slice 2": conv_launches,
                             "slice 3": conv_launches_3, "slice 4": launches_4[1],
                             "slice 5": launches_5["conv"],
                             **{f"slice 6 {k}": v[1] for k, v in launches_6.items()},
                             **{f"slice 7 {k}": v[1] for k, v in launches_7.items()},
                             "slice 8": launches_8[1],
                             **{f"slice 9 {k}": v[1] for k, v in launches_9.items()},
                             "slice 10": launches_10[1],
                             **{f"slice 11 {k}": v[1] for k, v in launches_11.items()},
                             **{f"slice 12 {k}": v[1] for k, v in launches_12.items()}},
    }, {
        "name": "conv1d_dx_s2_f32", "route": "cuda",
        "source": "gennet_tpu_torch/csrc/conv1d_dx_s2.cu",
        "replaces": None, "library": "cuDNN FP32 dgrad (deterministic)",
        "launches_per_iteration": dx_summary["launches"], "rows": dx_summary["rows"],
    }, {
        "name": "conv1d_dw_s2_f32", "route": "cuda",
        "source": "gennet_tpu_torch/csrc/conv1d_dw_s2.cu",
        "replaces": None, "library": "cuDNN FP32 wgrad (deterministic)",
        "launches_per_iteration": dw_summary["launches"], "rows": dw_summary["rows"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
