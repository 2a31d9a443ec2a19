"""The port's plots (``gennet_tpu_torch.eval.plots``) and the workloads'
plot call sites against the JAX package's.

- Every plot function, on the inputs of tests/test_eval.py's plot-suite
  test, writes the same file names in both packages, and
  ``plot_pe_samples`` returns the same β (rtol 1e-10: numpy on both
  sides).
- ``MetricLogger.arrays()`` equals the JAX logger's after the same calls.
- The plots module imports matplotlib only at first use, and
  ``require_matplotlib`` names it when it is missing (the workloads' own
  refusals: tests/test_torch_workload.py and _workload_burst.py).
- The reference's PE-accuracy draw fails on a bank under 4000 rows, on the
  config the port refuses before PE training.
- Tiny ``run_bbh`` (lalinference products, a 4000-row bank file, the
  single-net PE) and ``run_burst_smoke`` runs with plots on, at narrow
  widths, write the same png names in both packages, at cadences that
  divide the schedules (the JAX loops run in chunks of a cadence there and
  label steps as the port does). At cadence 1 the JAX loops label every
  step one lower (ROADMAP queue 3): the port writes the same names plus
  those of the last step. ``truth`` is the same in both packages, on the
  synthetic event and on the products.
"""

import dataclasses
import functools
import importlib
import os
import shutil
import sys

import gennet_tpu.models
import jax
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.cli import workloads as jwl
from gennet_tpu.eval import plots as JP
from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import BurstGenerator as JBG
from gennet_tpu.models import CombinedPE as JCPE
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.train.metrics import MetricLogger as JLog
from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.eval import plots as TP
from gennet_tpu_torch.models import BBHGenerator, BurstGenerator, CombinedPE, PairDiscriminator
from gennet_tpu_torch.train.metrics import MetricLogger

G_FEAT, D_FEAT, PE_FEAT = (16, 16, 32, 32, 64), (16, 32), (8, 8, 16, 16)
BURST_G_FEAT = (16, 16, 32, 32)


def _pngs(d) -> set:
    return {os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
            for f in fs if f.endswith(".png")}


def _plot_suite(P, out):
    """tests/test_eval.py::test_plot_suite_writes_files's calls; returns β."""
    rng = np.random.default_rng(0)
    hist = {"d_loss": rng.random(50), "g_loss": rng.random(50),
            "d_acc": rng.random(50), "g_acc": rng.random(50)}
    P.plot_losses(hist, out)
    true_p = rng.uniform(0, 1, (100, 2))
    P.plot_pe_accuracy(true_p, true_p + 0.01 * rng.standard_normal((100, 2)), out)
    samples = rng.standard_normal((200, 2)) * 0.1 + [0.5, 0.5]
    ref = rng.standard_normal((200, 2)) * 0.1 + [0.52, 0.48]
    grid = (rng.random((21, 21)), np.linspace(0, 1, 21), np.linspace(0, 1, 21))
    beta = P.plot_pe_samples(samples, (0.5, 0.5), out, 7, ref_samples=ref, pe_std=(0.05, 0.05),
                             grid=grid)
    P.plot_pe_samples(samples, None, out, fname="no_ref.png")  # no reference: β None
    sig = np.sin(np.linspace(0, 20, 256))
    meas = sig + 0.1 * rng.standard_normal(256)
    gen = sig[None, :] + 0.05 * rng.standard_normal((30, 256))
    P.plot_waveform_est(sig, meas, gen, out, 3)
    P.plot_waveform_est(sig, meas, gen, out, 3, zoom=(100, 150))
    P.plot_waveform_est(sig, meas, gen, out, fname="final.png")
    P.plot_beta_history([0.1, 0.3, 0.5], [100, 200, 300], out)
    return beta


def test_plot_functions_write_the_reference_files(tmp_path):
    b_t = _plot_suite(TP, str(tmp_path / "t"))
    b_j = _plot_suite(JP, str(tmp_path / "j"))
    names = _pngs(tmp_path / "t")
    assert names == _pngs(tmp_path / "j")
    assert {"losses.png", "pe_accuracy.png", "latest/pe_accuracy.png", "pe_samples00007.png",
            "latest/pe_samples.png", "no_ref.png", "waveform_results00003.png",
            "waveform_zoomed_results00003.png", "latest/most_recent_waveform.png",
            "latest/most_recent_waveform_zoomed.png", "final.png", "beta_hist.png",
            "latest/beta_hist.png"} == names
    assert b_t is not None and 0.0 <= b_t <= 1.0
    np.testing.assert_allclose(b_t, b_j, rtol=1e-10)


def test_metric_logger_arrays_match_reference(tmp_path):
    rows = [(1, {"d_loss": 0.5, "d_acc": 0.75}), (2, {"d_loss": 0.25, "g_loss": 1.5}),
            (2, {"beta": 0.125})]
    loggers = [MetricLogger(str(tmp_path / "t"), "bbh"), JLog(str(tmp_path / "j"), "bbh")]
    for log in loggers:
        for step, m in rows:
            log.log(step, m)
        log.close()
    got, want = (log.arrays() for log in loggers)
    assert got.keys() == want.keys() == {"d_loss", "d_acc", "g_loss", "beta", "step"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["step"].tolist() == [1, 2, 2]


def test_matplotlib_is_imported_at_first_use_only(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    importlib.reload(TP)  # the module imports without matplotlib
    with pytest.raises(ImportError, match="matplotlib"):
        TP.require_matplotlib()
    with pytest.raises(ImportError):
        TP.plot_beta_history([0.5], [1], "unused")
    monkeypatch.undo()
    importlib.reload(TP)
    TP.require_matplotlib()


# ------------------------------------------------------------- workloads


@pytest.fixture(autouse=True)
def narrow_models(monkeypatch):
    monkeypatch.setattr(jwl, "BBHGenerator", functools.partial(JG, features=G_FEAT))
    monkeypatch.setattr(jwl, "PairDiscriminator", functools.partial(JD, features=D_FEAT))
    monkeypatch.setattr(jwl, "BurstGenerator", functools.partial(JBG, features=BURST_G_FEAT))
    # run_bbh imports CombinedPE from the package when it builds the PE
    monkeypatch.setattr(gennet_tpu.models, "CombinedPE", functools.partial(JCPE, features=PE_FEAT))
    monkeypatch.setattr(twl, "CombinedPE", functools.partial(CombinedPE, features=PE_FEAT))
    monkeypatch.setattr(twl, "BBHGenerator", functools.partial(BBHGenerator, features=G_FEAT))
    monkeypatch.setattr(twl, "PairDiscriminator",
                        functools.partial(PairDiscriminator, features=D_FEAT))
    monkeypatch.setattr(twl, "BurstGenerator",
                        functools.partial(BurstGenerator, features=BURST_G_FEAT))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """lalinference products at fs 256 (300 posterior rows) and a bank file
    of 4000 rows, enough for the PE-accuracy draw."""
    from gennet_tpu.data import synth_products as sp
    from gennet_tpu.data import template_bank as jtb

    d = tmp_path_factory.mktemp("plot_inputs")
    sp.write_synthetic_products(str(d / "prod"), seed=0, n_posterior=300, grid_grain=12,
                                cfg=jtb.BankConfig(fs=256))
    rng = np.random.default_rng(0)
    np.savez(d / "bank.npz", templates=rng.normal(size=(4000, 256)).astype(np.float32),
             mc=rng.uniform(20, 35, 4000).astype(np.float32),
             q=rng.uniform(0.5, 1.0, 4000).astype(np.float32))
    yield str(d / "prod"), str(d / "bank.npz")
    shutil.rmtree(d, ignore_errors=True)


def _bbh_kw(out_dir, **kw):
    return dict(dict(n_pix=256, pe_iters=2, gan_iters=2, cadence=2, pe_cadence=2,
                     eval_cadence=2, n_posterior=64, ckpt_every=10_000, comb_pe_model=True,
                     out_dir=str(out_dir)),
                **kw)


def _both(runner_j, runner_t, cfg_j, cfg_t):
    runner_j(cfg_j)
    runner_t(cfg_t, device="cpu")
    return _pngs(cfg_t.out_dir), _pngs(cfg_j.out_dir)


@pytest.mark.parametrize("cadence", [2, 1], ids=["chunked", "unchunked"])
def test_run_bbh_writes_the_reference_pngs(tmp_path, inputs, cadence):
    prod, bank = inputs
    kw = dict(lalinf_dir=prod, bank_file=bank)
    if cadence == 1:
        kw.update(cadence=1, pe_cadence=1, eval_cadence=1)
    got, want = _both(jwl.run_bbh, twl.run_bbh,
                      jwl.BBHConfig(**_bbh_kw(tmp_path / "j", **kw)),
                      twl.BBHConfig(**_bbh_kw(tmp_path / "t", **kw)))
    last = 2
    steps = range(cadence, last + 1, cadence)
    names = {f"{f}{i:05d}.png" for i in steps for f in (
        "pe_accuracy", "waveform_results", "waveform_zoomed_results", "pe_samples")}
    names |= {"losses.png", "beta_hist.png", "waveform_final.png", "pe_samples_final.png",
              "latest/pe_accuracy.png", "latest/most_recent_waveform.png",
              "latest/most_recent_waveform_zoomed.png", "latest/pe_samples.png",
              "latest/beta_hist.png"}
    assert got == names
    if cadence == 2:
        assert want == got
    else:
        # the JAX loops label step i + 1 as i and skip the label 0, so they
        # write no file for the last step (ROADMAP queue 3)
        assert want == {n for n in got if f"{last:05d}" not in n}
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_run_burst_smoke_writes_the_reference_pngs(tmp_path):
    kw = dict(n_pix=128, n_signals=512, gan_iters=4, pe_iters=4, cadence=2, batch_size=8,
              n_posterior=64, pe_grain=21, freeze_on_white=0.0, freeze_on_res=0.0)
    got, want = _both(jwl.run_burst_smoke, twl.run_burst_smoke,
                      jwl.BurstSmokeConfig(**kw, out_dir=str(tmp_path / "j")),
                      twl.BurstSmokeConfig(**kw, out_dir=str(tmp_path / "t")))
    assert got == want == {
        "waveform_results00002.png", "waveform_results00004.png", "pe_samples00002.png",
        "pe_samples00004.png", "losses.png", "waveform_final.png", "pe_samples_final.png",
        "latest/most_recent_waveform.png", "latest/pe_samples.png"}
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("source", ["synthetic", "products"])
def test_truth_matches_reference(inputs, source):
    kw = dict(n_pix=256, lalinf_dir=inputs[0] if source == "products" else None)
    jtruth = jwl._prepare_bbh_data(jwl.BBHConfig(**kw), jax.random.PRNGKey(0), skip_bank=True)[6]
    ttruth = twl._prepare_bbh_data(twl.BBHConfig(**kw), torch.Generator().manual_seed(0), "cpu",
                                   skip_bank=True)[6]
    assert ttruth == jtruth
    if source == "products":
        assert ttruth == (30.0, 0.79)


def test_reference_pe_accuracy_draw_fails_on_a_small_bank(tmp_path):
    # tests/test_torch_workload.py::test_unported_options_raise[training_num-24]
    # refuses this config (there with the two-branch PE) before PE training
    cfg = jwl.BBHConfig(n_pix=256, training_num=24, pe_iters=2, pe_cadence=1, gan_iters=0,
                        grid_grain=0, comb_pe_model=True, out_dir=str(tmp_path / "j"))
    with pytest.raises(ValueError, match="larger sample than population"):
        jwl.run_bbh(cfg)
    tcfg = twl.BBHConfig(**dataclasses.asdict(cfg))
    with pytest.raises(ValueError, match="4000 bank rows without replacement"):
        twl.run_bbh(dataclasses.replace(tcfg, out_dir=str(tmp_path / "t")), device="cpu")
    shutil.rmtree(tmp_path, ignore_errors=True)
