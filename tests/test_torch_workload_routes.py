"""The port's ``run_bbh`` with the options this port brings beyond the
default recipe: here ``conv_impl="pallas"`` and the posterior
post-processing routes (``pe_debias``, ``pe_bootcal``, ``pe_mlrc``,
``reweight_temper``); tests/test_torch_workload_select.py drives
``select_route``, snapshot pooling (``n_snapshots``) and the ELBO library
selection (``select_best``) through :func:`run_option_case`.

Each case is a tiny CPU run at the n_pix 256 geometry that must finish and
write the reference's schema: every eval row of ``bbh_metrics.jsonl`` has
one of the shapes ``gennet_tpu.cli.workloads.run_bbh`` logs
(workloads.py:1528-1587), and the summary has its keys (:1757-1774). Each
case also shows that the option took its path: the conv op ran under
``"pallas"`` only, and the phasor op's VJP ran under the ML routes only.
ML recentering runs ``ML_STEPS`` Adam steps here instead of the
reference's 300, to keep the runs short: these tests check the wiring,
and tests/test_torch_posterior_post.py holds ``ml_recenter`` itself
against JAX.
"""

import functools
import json

import numpy as np
import pytest
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.eval import posterior_post as tpp
from gennet_tpu_torch.ops import conv1d as conv_ops
from gennet_tpu_torch.ops import phasor_dft

# the reference's eval-row shapes and summary keys
EVAL_MAIN = {"whiteness", "beta", "beta_sanity", "grid_overlap", "elbo"}
EVAL_DIAG = {"bias_mc", "bias_q", "disp_mc", "disp_q"}
EVAL_RAW = {"beta_raw", "grid_overlap_raw"}
SUMMARY = {"beta", "beta_raw", "grid_overlap_raw", "beta_sanity", "beta_hist_last",
           "grid_overlap", "cnn_sanity_beta", "final_step", "frozen_at", "selected_at",
           "selected_route", "pool_ess", "plateau_k", "whiteness", "pe_rms", "pe_std"}

ML_STEPS = 30

CASES = {
    "conv_pallas": {"conv_impl": "pallas"},
    "mlrc": {"pe_mlrc": 1},
    "debias_bootcal": {"pe_debias": 1, "pe_bootcal": 1},
    "reweight": {"reweight_temper": 1.0},
}


def _eval_rows(path):
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    out = []
    for row in rows:
        keys = set(row) - {"step"}
        base = {k.removesuffix("_final") for k in keys}
        if base & (EVAL_MAIN | EVAL_DIAG | EVAL_RAW):
            out.append((row["step"], keys))
    return out


def run_option_case(tmp_path, monkeypatch, opts: dict):
    """A tiny CPU ``run_bbh`` with ``opts``, checked as the module says."""
    calls = {"conv": 0, "vjp": 0}
    conv_same, vjp = conv_ops.conv1d_same, phasor_dft.PhasorMatmul.backward

    def counting_conv(*a, **k):
        calls["conv"] += 1
        return conv_same(*a, **k)

    def counting_vjp(ctx, g):
        calls["vjp"] += 1
        return vjp(ctx, g)

    monkeypatch.setattr(conv_ops, "conv1d_same", counting_conv)
    monkeypatch.setattr(phasor_dft.PhasorMatmul, "backward", staticmethod(counting_vjp))
    monkeypatch.setattr(tpp, "ml_recenter", functools.partial(tpp.ml_recenter, steps=ML_STEPS))
    snap = opts.get("n_snapshots", 1) > 1
    cfg = twl.BBHConfig(n_pix=256, training_num=24, pe_iters=1, gan_iters=2, cadence=1,
                        pe_cadence=10, eval_cadence=1 if snap else 2, n_posterior=8,
                        grid_grain=5, ckpt_every=10_000, out_dir=str(tmp_path / "bbh"),
                        plots=False, **opts)
    launches = (conv_ops.LAUNCHES, phasor_dft.LAUNCHES)
    out = twl.run_bbh(cfg, device="cpu")

    assert (conv_ops.LAUNCHES, phasor_dft.LAUNCHES) == launches  # CPU: the plain versions
    assert (calls["conv"] > 0) == (opts.get("conv_impl") == "pallas")
    ml = opts.get("pe_mlrc", 0) > 0 or opts.get("select_route") == "elbo"
    assert (calls["vjp"] > 0) == ml
    if ml:
        assert calls["vjp"] >= ML_STEPS  # one VJP per Adam step of each ml_recenter call

    assert set(out) == SUMMARY and out["final_step"] == 2
    assert out["beta"] is not None and 0.0 <= out["beta"] <= 1.0
    assert all(np.isfinite(out["pe_rms"]))
    select = opts.get("select_best") == "elbo"
    assert (out["selected_route"] is not None) == select
    assert (out["plateau_k"] is not None) == select and (out["pool_ess"] is not None) == select

    rows = _eval_rows(tmp_path / "bbh" / "bbh_metrics.jsonl")
    post = any(opts.get(k) for k in ("pe_debias", "pe_bootcal", "pe_mlrc", "reweight_temper",
                                     "select_route"))
    finals = [keys for _, keys in rows if any(k.endswith("_final") for k in keys)]
    assert len(finals) == 1 and {k.removesuffix("_final") for k in finals[0]} <= EVAL_MAIN
    for step, keys in rows:
        assert (keys in (EVAL_DIAG, EVAL_RAW, {"beta_raw"}) or keys == finals[0]
                or ({"whiteness", "beta"} <= keys <= EVAL_MAIN)), (step, keys)
    main = [keys for _, keys in rows if "whiteness" in keys]
    assert len(main) == (2 if snap else 1)
    # the in-run ELBO is logged under select_best="elbo" only
    assert any("elbo" in keys for keys in main) == select
    assert any(keys == EVAL_RAW for _, keys in rows) == post
    # a library-selected final cloud is its own raw cloud: beta_raw stays
    # null, as in the reference (ROADMAP queue 3, reproduced)
    if select:
        assert out["beta_raw"] is None and out["grid_overlap_raw"] is None
    elif post:
        assert out["beta_raw"] is not None and out["grid_overlap_raw"] is not None

    snaps = sorted((tmp_path / "bbh" / "GAN_posterior_samples").glob("*.npz"))
    assert len(snaps) == len(main) + 1
    if not select:  # the final cloud is a draw: 256 per pooled state, or n_posterior
        assert np.load(snaps[-1])["samples"].shape == (2 * 256 if snap else 8, 2)


@pytest.mark.parametrize("case", list(CASES))
def test_port_run_bbh_option(tmp_path, monkeypatch, case):
    run_option_case(tmp_path, monkeypatch, CASES[case])
