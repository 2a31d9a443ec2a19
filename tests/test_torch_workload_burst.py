"""The burst ``smoke`` workload and ``train-bbh``'s residual-route options as
whole runs of the port on the CPU.

- Tiny ``run_burst_smoke`` runs with the counts of
  tests/test_workloads.py:16-58 (n_pix 128, 512 signals, ≤ 10 steps): the
  default recipe, the bootstrap sampler with the terminal anneal, and the
  ELBO library selection; the early stop after a random restart, which
  clears the abandoned attempt's posterior clouds from disk.
- The reference's ValueErrors, ``plots=True`` without matplotlib,
  ``BurstSmokeConfig``'s fields and defaults, and the ``smoke`` CLI's
  refusals.
- Tiny ``run_bbh`` runs with the residual-route options under
  ``conv_impl`` xla and pallas (the conv op's plain version on the CPU),
  with the early stop firing and holding.
- On a card (``-m gpu``): one residual-route GAN step with the pair-free D
  under ``pallas`` against ``xla`` in the port: forward values 1e-4·max,
  losses rtol 1e-4, weights within 2·lr per Adam state that stepped them.

JAX is imported inside the one comparison that needs it, so on the card
(no JAX there) the file runs with ``pytest --noconftest -m gpu``.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.ops import conv1d as conv_ops
from gennet_tpu_torch.ops import phasor_dft

BURST_SUMMARY = {"rms", "pe_std", "grid_overlap", "grid_overlap_best", "frozen_at", "selected_at",
                 "selected_route", "pool_ess", "plateau_k", "whiteness"}
PROBES = {"d_grad_norm", "g_grad_norm", "res_grad_norm", "g_param_norm", "d_param_norm",
          "x_fake_absmax", "d_logit_absmax", "bn_var_min"}


def _tiny_burst(tmp_path, **kw):
    base = dict(n_pix=128, n_signals=512, gan_iters=6, pe_iters=6, cadence=5, batch_size=8,
                n_posterior=32, pe_grain=21, out_dir=str(tmp_path / "burst"), plots=False)
    return twl.BurstSmokeConfig(**{**base, **kw})


def _check_burst(out):
    assert set(out) == BURST_SUMMARY
    assert np.isfinite(out["rms"]).all() and np.isfinite(out["pe_std"]).all()
    assert 0.0 <= out["grid_overlap"] <= 1.0
    assert set(out["whiteness"]) >= {"mean_pass", "var_pass", "ljung_box_pass", "overall"}


@pytest.mark.parametrize("recipe", ["default", "bootstrap_anneal"])
def test_burst_smoke_tiny(tmp_path, recipe):
    kw = {} if recipe == "default" else dict(pe_noise_frac=0.5, posterior_noise=1.0,
                                             anneal_frac=0.5, res_loss_weight=10.0)
    cfg = _tiny_burst(tmp_path, **kw)
    launches = (conv_ops.LAUNCHES, phasor_dft.LAUNCHES)
    out = twl.run_burst_smoke(cfg, device="cpu")
    assert (conv_ops.LAUNCHES, phasor_dft.LAUNCHES) == launches
    _check_burst(out)
    rows = [json.loads(line) for line in (tmp_path / "burst" / "burst_metrics.jsonl").open()]
    # cadence rows (PE and GAN), eval diagnostics and the final score
    assert any("pe_loss" in r for r in rows) and any("res_loss" in r for r in rows)
    diag = [r for r in rows if "wf_corr" in r]
    assert diag and all({"bias_t0", "bias_tau", "disp_t0", "disp_tau", "whiteness"} <= set(r)
                        for r in diag)
    assert rows[-1].keys() == {"grid_overlap_final", "step"}
    snaps = sorted((tmp_path / "burst" / "GAN_posterior_samples").glob("*.npz"))
    assert snaps[-1].name == "posterior_samples_00007.npz"          # the final cloud, +1
    assert np.load(snaps[-1])["samples"].shape == (32, 2)


def test_burst_smoke_library_selection(tmp_path):
    cfg = _tiny_burst(tmp_path, gan_iters=10, cadence=2, select_best="elbo")
    out = twl.run_burst_smoke(cfg, device="cpu")
    _check_burst(out)
    assert out["selected_route"] in {"final", "argmax", "plateau", "pool", "pool_is", "plat_is",
                                     "kde_is"}, out
    if out["selected_route"] != "final":
        assert out["pool_ess"] is None or out["pool_ess"] >= 0.0


def _whiteness_after(n_failing):
    """A stand-in for ``posterior_whiteness`` whose first ``n_failing``
    calls score 0 and the rest 1."""
    calls = {"n": 0}

    def fake(measured, draws, n_sig=1.0, n_lags=20):
        calls["n"] += 1
        v = 0.0 if calls["n"] <= n_failing else 1.0
        score = {"mean_pass": v, "var_pass": v, "ljung_box_pass": v, "overall": v}
        return {**score, "draws": dict(score)}

    return fake


def test_burst_smoke_freezes_after_a_restart_and_clears_the_abandoned_clouds(
        tmp_path, monkeypatch):
    # attempt 0 evaluates at steps 2, 4 and 6 and never turns white; the
    # restart clears those clouds; attempt 1 freezes at its first eval
    monkeypatch.setattr(twl, "posterior_whiteness", _whiteness_after(3))
    cfg = _tiny_burst(tmp_path, cadence=2, freeze_on_res=0.0, gan_restarts=2)
    out = twl.run_burst_smoke(cfg, device="cpu")
    _check_burst(out)
    assert out["frozen_at"] == 2
    names = sorted(p.name for p in (tmp_path / "burst" / "GAN_posterior_samples").glob("*.npz"))
    assert names == ["posterior_samples_00002.npz", "posterior_samples_00007.npz"]


@pytest.mark.parametrize("field,value", [
    ("select_best", "ELBO"), ("select_route", "best"), ("freeze_on_white", 0.0),
])
def test_burst_smoke_refuses_what_the_reference_refuses(tmp_path, field, value):
    # freeze_on_white 0 with the default freeze_on_res > 0 (ref :259-263)
    cfg = dataclasses.replace(_tiny_burst(tmp_path), **{field: value})
    with pytest.raises(ValueError, match="freeze_on_res" if field == "freeze_on_white" else field):
        twl.run_burst_smoke(cfg, device="cpu")
    assert not (tmp_path / "burst").exists()


@pytest.mark.parametrize("field,value", [("plots", True)])
def test_burst_smoke_unported_options_raise(tmp_path, monkeypatch, field, value):
    # plots are ported (tests/test_torch_plots.py), but refused before any
    # work where matplotlib cannot be imported
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = dataclasses.replace(_tiny_burst(tmp_path), **{field: value})
    with pytest.raises(ImportError, match="matplotlib"):
        twl.run_burst_smoke(cfg, device="cpu")
    assert not (tmp_path / "burst").exists()


def test_burst_config_keeps_every_reference_field_and_default():
    pytest.importorskip("jax")
    from gennet_tpu.cli import workloads as jwl

    ref = [(f.name, f.default) for f in dataclasses.fields(jwl.BurstSmokeConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(twl.BurstSmokeConfig)]
    assert port == ref


@pytest.mark.parametrize("argv,exc,match", [
    (["smoke", "--plots", "false", "--device", "cuda"], RuntimeError, "cuda"),
    # --data-parallel runs (at a world of 1); the case keeps the id it had
    # while the flag was refused
    pytest.param(["smoke", "--plots", "false", "--device", "cpu", "--data-parallel"], None, None,
                 id="argv1-NotImplementedError-queue 1 #11"),
])
def test_smoke_cli_refuses(tmp_path, argv, exc, match):
    if "cuda" in argv and torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    from gennet_tpu_torch.cli.main import main

    if exc is None:
        _smoke_data_parallel_at_world1_equals_the_plain_run(main, tmp_path)
        return
    with pytest.raises(exc, match=match):
        main(argv)


def _smoke_data_parallel_at_world1_equals_the_plain_run(main, tmp_path):
    # one process, no torchrun: a world of 1, bit for bit the run without
    # the flag (tests/test_torch_workload_dp.py runs a world of 2)
    argv = ["smoke", "--plots", "false", "--device", "cpu", "--n-pix", "128", "--n-signals",
            "512", "--gan-iters", "2", "--pe-iters", "2", "--cadence", "1", "--batch-size", "8",
            "--n-posterior", "32", "--pe-grain", "21", "--gan-restarts", "0"]
    outs = [main([*argv, "--out-dir", str(tmp_path / d), *extra])
            for d, extra in (("plain", []), ("dp", ["--data-parallel"]))]
    assert json.dumps(outs[0]) == json.dumps(outs[1])
    rows = [(tmp_path / d / "burst_metrics.jsonl").read_text() for d in ("plain", "dp")]
    assert rows[0] == rows[1] and rows[0]


# ------------------------------------------------------- train-bbh options

RES_OPTS = dict(res_loss_weight=1.0, res_spectral_bands=16, pair_d=False, diversity_weight=0.1,
                anneal_frac=0.5, freeze_on_white=0.99, debug_probes=True)


@pytest.mark.parametrize("name,opts,gate", [
    # the gate fires (whiteness stubbed to pass, any finite raw res_loss
    # below 1e9), with R1 and the residual route in train mode
    ("xla_r1_train_mode", dict(RES_OPTS, r1_gamma=1.0, res_eval_mode=False, freeze_on_res=1e9),
     "fires"),
    # the gate holds (no raw res_loss is below 1e-12); without the grid, to
    # keep the run short
    ("pallas", dict(RES_OPTS, conv_impl="pallas", freeze_on_res=1e-12, grid_grain=0,
                    eval_cadence=4), "holds"),
])
def test_port_run_bbh_residual_options(tmp_path, monkeypatch, name, opts, gate):
    calls = {"conv": 0}
    conv_same = conv_ops.conv1d_same

    def counting_conv(*a, **k):
        calls["conv"] += 1
        return conv_same(*a, **k)

    monkeypatch.setattr(conv_ops, "conv1d_same", counting_conv)
    if gate == "fires":
        monkeypatch.setattr(twl, "posterior_whiteness", _whiteness_after(0))
    base = dict(n_pix=256, training_num=24, pe_iters=1, gan_iters=4, cadence=1, pe_cadence=10,
                eval_cadence=2, n_posterior=8, grid_grain=5, ckpt_every=10_000,
                out_dir=str(tmp_path / "bbh"), plots=False)
    cfg = twl.BBHConfig(**{**base, **opts})
    launches = conv_ops.LAUNCHES
    out = twl.run_bbh(cfg, device="cpu")
    assert conv_ops.LAUNCHES == launches
    assert (calls["conv"] > 0) == (opts.get("conv_impl") == "pallas")
    assert out["frozen_at"] == (2 if gate == "fires" else None)
    assert out["final_step"] == (2 if gate == "fires" else 4)
    assert all(np.isfinite(out["pe_rms"]))
    if cfg.grid_grain > 0:
        assert 0.0 <= out["beta"] <= 1.0
    rows = [json.loads(line) for line in (tmp_path / "bbh" / "bbh_metrics.jsonl").open()]
    gan_rows = [r for r in rows if "res_loss" in r]
    assert len(gan_rows) == out["final_step"]
    assert all(r["res_loss"] > 0 for r in gan_rows)
    assert all(PROBES <= set(r) and all(np.isfinite(r[k]) for k in PROBES) for r in gan_rows)
    if gate == "fires":
        assert (tmp_path / "bbh" / "ckpt_gan" / "ckpt_2.pt").exists()
    else:
        # the annealed half (steps 3 and 4) leaves D where step 2 left it
        norms = {r["step"]: r["d_param_norm"] for r in gan_rows}
        assert norms[2] == norms[3] == norms[4] and norms[1] != norms[2]


@pytest.mark.parametrize("field,value,match", [
    ("freeze_on_res", 1e-3, "freeze_on_res"), ("pair_d", False, "pair_d"),
])
def test_run_bbh_refuses_what_the_reference_refuses(tmp_path, field, value, match):
    # freeze_on_res without freeze_on_white; pair_d=False without the
    # residual route (ref :1241-1250)
    cfg = twl.BBHConfig(plots=False, out_dir=str(tmp_path / "x"))
    with pytest.raises(ValueError, match=match):
        twl.run_bbh(dataclasses.replace(cfg, **{field: value}), device="cpu")
    assert not (tmp_path / "x").exists()


def test_train_bbh_cli_refuses_r1_under_pallas(tmp_path):
    from gennet_tpu_torch.cli.main import main

    with pytest.raises(ValueError, match="r1_gamma"):
        main(["train-bbh", "--device", "cpu", "--plots", "false", "--r1-gamma", "1",
              "--conv-impl", "pallas", "--out-dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


@pytest.mark.gpu
def test_residual_gan_step_pallas_matches_xla_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1d kernel has no CPU mode")
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.train import gan as tgan

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, dev = 1024, torch.device("cuda")
    cfg = tgan.GANConfig(n_pix=n, pair_discriminator=False, residual_route=True,
                         res_loss_weight=1.0, res_spectral_bands=16, diversity_weight=0.1,
                         label_smoothing=True, d_instance_noise=0.3, d_lr_scale=0.5,
                         d_acc_gate=0.9, debug_probes=True)
    states = {impl: tgan.init_gan(torch.Generator().manual_seed(3),
                                  BBHGenerator(n_out=n, drate=0.0, conv_impl=impl),
                                  PairDiscriminator(n_pix=n, in_ch=1, drate=0.0, conv_impl=impl),
                                  cfg, dev) for impl in ("xla", "pallas")}
    g = torch.Generator(device=dev).manual_seed(4)
    bank = torch.randn(64, n, generator=g, device=dev)
    measured = torch.randn(n, generator=g, device=dev)
    z = torch.rand(8, 100, generator=g, device=dev) * 2 - 1
    with torch.no_grad():
        outs = {impl: st.generator(z) for impl, st in states.items()}
        ref = outs["xla"]
        assert float((outs["pallas"] - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
        x1 = bank[:8, :, None]
        d = {impl: st.discriminator(x1) for impl, st in states.items()}
        assert float((d["pallas"] - d["xla"]).abs().max()) <= 1e-4 * float(d["xla"].abs().max())
    metrics = {}
    before = conv_ops.LAUNCHES
    for impl, st in states.items():
        batch = tgan.draw_gan_batch(torch.Generator(device=dev).manual_seed(8), bank, cfg)
        _, metrics[impl] = tgan.gan_update(st, batch, measured, cfg=cfg)
    torch.cuda.synchronize()
    # forwards: D step G 5 + D 2 + 2, residual G 5, G step G 5 + D 2; dx: D
    # step 2, residual 5, G step 7
    assert conv_ops.LAUNCHES - before == 35
    for key in ("d_loss", "g_loss", "res_loss", "d_param_norm", "g_param_norm"):
        np.testing.assert_allclose(float(metrics["pallas"][key]), float(metrics["xla"][key]),
                                   rtol=1e-4, err_msg=key)
    for (name, a), b in zip(states["xla"].generator.named_parameters(),
                            states["pallas"].generator.parameters()):
        assert float((a - b).detach().abs().max()) <= 2 * 2 * cfg.lr + 1e-6, name
