"""The slice as a whole.

(a) One deterministic chain through both packages from the same numpy
    inputs and converted weights, at narrow G/D widths and the n_pix 256
    geometry: event → bank → one CNN update → one GAN update → eval-mode
    draws → CNN predict → β against a fixed reference cloud. Each
    intermediate is compared; the final β to 1e-3 absolute.
(b) The port's own ``run_bbh`` on the CPU with the counts of
    tests/test_workloads.py::test_bbh_workload_tiny; and, in both packages
    at narrow widths, a run whose raw posterior cloud is constant with a
    post-processing route on: both write the same jsonl rows (steps and
    keys), with no ``beta_raw`` row.
(c) What the port refuses: ``plots=True`` without matplotlib, a bank too
    small for the PE-accuracy plot's draw, and the values the reference
    refuses. The options beyond the default recipe are driven in
    tests/test_torch_workload_routes.py, (the residual-route family)
    tests/test_torch_workload_burst.py, (resume, the CNN cache, bank files,
    lalinference products, ``comb_pe_model``, ``g_norm``)
    tests/test_torch_workload_staged.py, (plots) tests/test_torch_plots.py
    and (``bf16``) tests/test_torch_bf16.py.

Tolerances as in the per-module tests: templates 1e-4·max (the event 3e-4,
see tests/test_torch_bank.py), forward values 1e-4·max, losses rtol 1e-4,
weights after one Adam step within lr.
"""

import dataclasses
import json
import sys
from functools import partial

import gennet_tpu.models
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.cli import workloads as jwl
from gennet_tpu.data import template_bank as jtb
from gennet_tpu.eval import overlap as jov
from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import CombinedPE as JCPE
from gennet_tpu.models import DualBranchPE as JPE
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.physics import psd as jpsd
from gennet_tpu.train import cnn as jcnn
from gennet_tpu.train import gan as jgan
from gennet_tpu_torch import convert
from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.data import template_bank as ttb
from gennet_tpu_torch.eval import overlap as tov
from gennet_tpu_torch.models import BBHGenerator, CombinedPE, DualBranchPE, PairDiscriminator
from gennet_tpu_torch.physics import psd as tpsd
from gennet_tpu_torch.train import cnn as tcnn
from gennet_tpu_torch.train import gan as tgan

FS = 256
G_FEAT, D_FEAT = (16, 16, 32, 32, 64), (16, 32)


def _close(out, ref, tol, what):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{what}: {err:.3g} > {tol:g}"


def test_chain_matches_reference():
    rng = np.random.default_rng(0)
    jcfg, tcfg = jtb.BankConfig(fs=FS), ttb.BankConfig(fs=FS)
    jp = jpsd.analytic_advligo_psd(FS, 4)
    tp = tpsd.analytic_advligo_psd(FS, 4)

    # ---- event: template + one fixed noise draw, normalised -------------
    noise = rng.normal(size=FS).astype(np.float32)
    j_ev = np.asarray(jtb.make_event_template(jp, jcfg))
    t_ev = ttb.make_event_template(tp, tcfg)
    _close(t_ev, j_ev, 3e-4, "event template")
    j_meas = (j_ev + noise) / np.std(j_ev + noise)
    j_norm = float(1.0 / np.std(j_ev + noise))
    t_norm = 1.0 / torch.std(t_ev + torch.tensor(noise), correction=0)
    t_meas = (t_ev + torch.tensor(noise)) * t_norm
    _close(t_meas, j_meas, 3e-4, "measured")

    # ---- a 32-template bank from fixed masses ----------------------------
    m1 = rng.uniform(28, 50, 32).astype(np.float32)
    m2 = (m1 * rng.uniform(0.55, 1.0, 32)).astype(np.float32)
    idx = rng.integers(*jcfg.beta_index_bounds(), 32).astype(np.int32)
    j_bank = np.asarray(jtb.make_templates_from_params(jnp.asarray(m1), jnp.asarray(m2), jp, jcfg,
                                                       j_norm, jnp.asarray(idx)))
    t_bank = ttb.make_templates_from_params(torch.tensor(m1), torch.tensor(m2), tp, tcfg,
                                            float(t_norm), torch.tensor(idx))
    moved = np.argmax(np.abs(t_bank.numpy()), 1) != np.argmax(np.abs(j_bank), 1)
    assert moved.sum() <= 1
    _close(t_bank.numpy()[~moved], j_bank[~moved], 1e-4 + 3e-4, "bank")  # + the norm's share
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
    targets = np.stack([mc, m2 / m1], -1).astype(np.float32)

    # ---- one CNN update on the first 8 templates -------------------------
    pe_j = JPE()
    jcnn_cfg = jcnn.CNNConfig(n_pix=FS, ema_decay=0.999, lr_decay_steps=10)
    js = jcnn.init_cnn(jax.random.PRNGKey(1), pe_j, jcnn_cfg)
    params = jax.device_get(js.params)
    params["Dense_0"]["bias"] = np.full((1,), 28.0, np.float32)  # mc head near the prior
    js = js.replace(params=params, ema=params)
    # jitted: the reference's eager flax apply compiles op by op on the CPU
    js, jm = jax.jit(partial(jcnn.cnn_update, model=pe_j, cfg=jcnn_cfg))(
        js, jnp.asarray(j_bank[:8, :, None]), jnp.asarray(targets[:8]), jax.random.PRNGKey(2))
    tcnn_cfg = tcnn.CNNConfig(n_pix=FS, ema_decay=0.999, lr_decay_steps=10)
    ts = tcnn.init_cnn(torch.Generator().manual_seed(1), DualBranchPE(n_pix=FS), tcnn_cfg, "cpu")
    ts.model.load_state_dict(convert.flax_to_torch_pe(params))
    ts, tm = tcnn.cnn_update(ts, t_bank[:8, :, None], torch.tensor(targets[:8]), cfg=tcnn_cfg)
    np.testing.assert_allclose(float(tm["pe_loss"]), float(jm["pe_loss"]), rtol=1e-4)

    # ---- one GAN update --------------------------------------------------
    kw = dict(n_pix=FS, batch_size=4, label_smoothing=True, d_instance_noise=0.3,
              d_lr_scale=0.5, d_acc_gate=0.9, n_sig=j_norm)
    jgc, tgc = jgan.GANConfig(**kw), tgan.GANConfig(**kw)
    jG, jD = JG(n_out=FS, features=G_FEAT, drate=0.0), JD(features=D_FEAT, drate=0.0)
    jg = jgan.init_gan(jax.random.PRNGKey(3), jG, jD, jgc)
    tG = BBHGenerator(n_out=FS, features=G_FEAT, drate=0.0)
    tD = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=FS)
    tg = tgan.init_gan(torch.Generator().manual_seed(3), tG, tD, tgc, "cpu")
    tG.load_state_dict(convert.flax_to_torch_generator(jax.device_get(jg.g_params),
                                                       jax.device_get(jg.g_stats)))
    tD.load_state_dict(convert.flax_to_torch_discriminator(jax.device_get(jg.d_params)))
    ridx = rng.integers(0, 32, 4)
    nb = {"z1": rng.uniform(-1, 1, (4, 100)), "fresh": rng.normal(size=(4, FS)) * j_norm,
          "in_real": rng.normal(size=(4, FS, 2)), "in_fake": rng.normal(size=(4, FS, 2)),
          "in_g": rng.normal(size=(1, 4, FS, 2)), "y_real": rng.uniform(0.7, 1.0, 4),
          "y_fake": rng.uniform(0.0, 0.3, 4), "z3": rng.uniform(-1, 1, (1, 4, 100))}
    nb = {k: v.astype(np.float32) for k, v in nb.items()}
    k = jax.random.PRNGKey(4)
    jb = jgan.GANBatch(real=jnp.asarray(j_bank[ridx]), z2=None, kfake=k, kd=k, kres=k,
                       kg=jax.random.split(k, 2).reshape(1, 2, 2), **nb)
    jg, jgm = jax.jit(partial(jgan.gan_update, generator=jG, discriminator=jD, cfg=jgc))(
        jg, jb, jnp.asarray(j_meas))
    tb = tgan.GANBatch(real=t_bank[torch.tensor(ridx)],
                       **{k_: torch.tensor(v) for k_, v in nb.items()})
    tg, tgm = tgan.gan_update(tg, tb, t_meas, cfg=tgc)
    for key in ("d_loss", "d_acc", "g_loss", "g_acc"):
        np.testing.assert_allclose(float(tgm[key]), float(jgm[key]), rtol=1e-4, err_msg=key)

    # ---- eval-mode draws with fixed latents → CNN ------------------------
    z = rng.uniform(-1, 1, (64, 100)).astype(np.float32)
    j_wf = np.asarray(jG.apply({"params": jg.g_params, "batch_stats": jg.g_stats},
                               jnp.asarray(z), train=False)).reshape(64, FS)
    with torch.no_grad():
        t_wf = tG(torch.tensor(z), train=False).reshape(64, FS)
    # G's weights took one Adam step of ≤ lr in each package
    _close(t_wf, j_wf, 1e-3, "draws")
    j_s = np.asarray(jcnn.predict(pe_j, js, jnp.asarray(j_wf), chunk=64, use_ema=True))
    t_s = tcnn.predict(ts, t_wf, use_ema=True).numpy()
    _close(t_s, j_s, 1e-3, "CNN estimates")

    # ---- β against a fixed reference cloud --------------------------------
    ref = np.stack([rng.normal(j_s[:, 0].mean(), 0.5, 400),
                    rng.normal(j_s[:, 1].mean(), 0.05, 400)], -1)
    assert t_s[:, 0].var() > 0 and t_s[:, 1].var() > 0
    b_t, b_j = tov.beta_overlap(t_s, ref), jov.beta_overlap(j_s, ref)
    assert 0.0 < b_t <= 1.0
    assert abs(b_t - b_j) <= 1e-3, (b_t, b_j)


def test_port_run_bbh_tiny(tmp_path):
    from gennet_tpu_torch.ops import phasor_dft

    cfg = twl.BBHConfig(
        n_pix=256, training_num=24, pe_iters=2, gan_iters=2, cadence=1,
        pe_cadence=1, eval_cadence=1, n_posterior=8, grid_grain=11,
        ckpt_every=10_000, out_dir=str(tmp_path / "bbh"), plots=False,
    )
    launches = phasor_dft.LAUNCHES
    out = twl.run_bbh(cfg, device="cpu")
    assert phasor_dft.LAUNCHES == launches  # CPU tensors take the plain version
    assert out["final_step"] >= 2
    assert out["beta"] is not None and 0.0 <= out["beta"] <= 1.0
    assert out["grid_overlap"] is not None and 0.0 <= out["grid_overlap"] <= 1.0
    assert out["cnn_sanity_beta"] is not None
    assert all(np.isfinite(out["pe_rms"]))
    assert (tmp_path / "bbh" / "bbh_metrics.jsonl").exists()
    snaps = sorted((tmp_path / "bbh" / "GAN_posterior_samples").glob("*.npz"))
    assert len(snaps) == 3 and np.load(snaps[-1])["samples"].shape == (8, 2)


def test_constant_raw_cloud_logs_the_reference_rows(tmp_path, monkeypatch):
    # eval_posterior logs beta_raw inside the raw cloud's variance guard, as
    # the reference does (workloads.py:1531-1536): a constant CNN makes the
    # raw cloud constant, and likelihood resampling is the route
    pe_feat = (8, 8, 16, 16)
    monkeypatch.setattr(jwl, "BBHGenerator", partial(JG, features=G_FEAT))
    monkeypatch.setattr(jwl, "PairDiscriminator", partial(JD, features=D_FEAT))
    monkeypatch.setattr(gennet_tpu.models, "CombinedPE", partial(JCPE, features=pe_feat))
    monkeypatch.setattr(twl, "BBHGenerator", partial(BBHGenerator, features=G_FEAT))
    monkeypatch.setattr(twl, "PairDiscriminator", partial(PairDiscriminator, features=D_FEAT))
    monkeypatch.setattr(twl, "CombinedPE", partial(CombinedPE, features=pe_feat))
    point = np.array([[28.0, 0.8]], np.float32)
    monkeypatch.setattr(jwl, "cnn_predict",
                        lambda model, state, x, **k: jnp.tile(point, (x.shape[0], 1)))
    monkeypatch.setattr(twl, "cnn_predict",
                        lambda state, x, **k: torch.tensor(point).expand(x.shape[0], 2))
    kw = dict(n_pix=256, training_num=24, pe_iters=1, gan_iters=2, cadence=2, pe_cadence=10,
              eval_cadence=2, n_posterior=8, grid_grain=5, ckpt_every=10_000,
              reweight_temper=1.0, comb_pe_model=True, plots=False)
    jwl.run_bbh(jwl.BBHConfig(**kw, out_dir=str(tmp_path / "j")))
    twl.run_bbh(twl.BBHConfig(**kw, out_dir=str(tmp_path / "t")), device="cpu")
    rows = {}
    for tag in ("j", "t"):
        with open(tmp_path / tag / "bbh_metrics.jsonl") as f:
            rows[tag] = [(r["step"], sorted(r)) for r in map(json.loads, f)]
    assert rows["t"] == rows["j"]
    assert all(len(keys) > 1 for _, keys in rows["t"])  # no bare {"step": N} row
    assert not any("beta_raw" in keys for _, keys in rows["t"])


@pytest.mark.parametrize("field,value", [("plots", True), ("training_num", 24)])
def test_unported_options_raise(tmp_path, monkeypatch, field, value):
    # plots=True without matplotlib is refused before any work; plots=True
    # with a bank under the PE-accuracy draw's 4000 rows before PE training
    # (the reference fails there with numpy's error: tests/test_torch_plots.py)
    cfg = twl.BBHConfig(n_pix=256, training_num=4001, pe_iters=2, pe_cadence=1, gan_iters=0,
                        grid_grain=0, out_dir=str(tmp_path / "x"))
    if field == "plots":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            twl.run_bbh(dataclasses.replace(cfg, plots=value), device="cpu")
        assert not (tmp_path / "x").exists()
    else:
        def no_training(*a, **k):
            raise AssertionError("PE training began")

        monkeypatch.setattr(twl, "cnn_step", no_training)
        with pytest.raises(ValueError, match="4000 bank rows without replacement"):
            twl.run_bbh(dataclasses.replace(cfg, **{field: value}), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("conv_impl", "cudnn"), ("select_best", "ELBO"), ("select_route", "best"),
])
def test_bad_option_values_raise(tmp_path, field, value):
    # as the reference does (workloads.py:1233-1240): a typo must not fall
    # back to the default semantics
    cfg = twl.BBHConfig(plots=False, out_dir=str(tmp_path / "x"))
    with pytest.raises(ValueError, match=field):
        twl.run_bbh(dataclasses.replace(cfg, **{field: value}), device="cpu")
    assert not (tmp_path / "x").exists()


def test_config_keeps_every_reference_field_and_default():
    ref = [(f.name, f.default) for f in dataclasses.fields(jwl.BBHConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(twl.BBHConfig)]
    assert port == ref


def test_cli_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    from gennet_tpu_torch.cli.main import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["train-bbh", "--plots", "false", "--device", "cuda"])
