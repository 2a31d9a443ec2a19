"""Evaluation of the port against the JAX package.

The overlap, whiteness and grid-sampling code is numpy on both sides and
must agree to float64 rounding (rtol 1e-10). The grid posterior runs the
template pipeline (the phasor op included) at fs 256 and grain 5: its
log-likelihood is held to 1e-3 absolute (templates agree to ~2e-5·max;
−½Σ((d−h)/σ)² over 256 samples amplifies that to ~1e-4), and L itself,
normalised to max 1, to atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennet_tpu.data import template_bank as jtb
from gennet_tpu.eval import grid_posterior as jgp
from gennet_tpu.eval import overlap as jov
from gennet_tpu.eval import whiteness as jwh
from gennet_tpu.physics import psd as jpsd
from gennet_tpu_torch.data import template_bank as ttb
from gennet_tpu_torch.eval import grid_posterior as tgp
from gennet_tpu_torch.eval import overlap as tov
from gennet_tpu_torch.eval import whiteness as twh
from gennet_tpu_torch.physics import psd as tpsd

FS = 256


def _clouds(seed=0):
    rng = np.random.default_rng(seed)
    a = np.stack([rng.normal(28, 1.0, 500), rng.normal(0.8, 0.05, 500)], -1)
    b = np.stack([rng.normal(28.5, 1.2, 400), rng.normal(0.78, 0.06, 400)], -1)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_beta_overlap_matches(seed):
    a, b = _clouds(seed)
    out = tov.beta_overlap(a, b)
    assert 0.0 <= out <= 1.0
    np.testing.assert_allclose(out, jov.beta_overlap(a, b), rtol=1e-10)


def test_posterior_whiteness_matches():
    rng = np.random.default_rng(2)
    measured = rng.normal(size=FS)
    draws = measured[None] * 0.3 + rng.normal(size=(16, FS)) * 0.1
    out, ref = twh.posterior_whiteness(measured, draws, 0.9), jwh.posterior_whiteness(measured, draws, 0.9)
    assert out.keys() == ref.keys()
    for k in ("mean_pass", "var_pass", "ljung_box_pass", "overall"):
        assert out[k] == ref[k] and out["draws"][k] == ref["draws"][k]


@pytest.fixture(scope="module")
def grids():
    jc, tc = jtb.BankConfig(fs=FS), ttb.BankConfig(fs=FS)
    jpsd_ = jpsd.analytic_advligo_psd(FS, 4)
    tpsd_ = tpsd.analytic_advligo_psd(FS, 4)
    # one measured series for both: the reference event template + noise
    ev = np.asarray(jtb.make_event_template(jpsd_, jc))
    measured = (ev + np.random.default_rng(0).normal(size=FS)).astype(np.float32)
    jL, jmc, jq = jgp.bbh_grid_posterior(jnp.asarray(measured), jpsd_, jc, 1.0, 1.0, grain=5)
    tL, tmc, tq = tgp.bbh_grid_posterior(torch.tensor(measured), tpsd_, tc, 1.0, 1.0, grain=5)
    return (np.asarray(jL, np.float64), jmc, jq), (tL, tmc, tq)


def test_bbh_grid_posterior_matches(grids):
    (jL, jmc, jq), (tL, tmc, tq) = grids
    np.testing.assert_array_equal(tmc, jmc)
    np.testing.assert_array_equal(tq, jq)
    assert tL.shape == (5, 5) and tL.max() == 1.0
    np.testing.assert_allclose(tL, jL, rtol=0, atol=1e-3)
    floor = 1e-30  # compare log-likelihoods where both are representable
    ok = (tL > floor) & (jL > floor)
    np.testing.assert_allclose(np.log(tL[ok]), np.log(jL[ok]), rtol=0, atol=1e-3)


def test_grid_scores_match(grids):
    (jL, jmc, jq), _ = grids
    rng = np.random.default_rng(3)
    samples = np.stack([rng.uniform(20, 35, 300), rng.uniform(0.5, 1.0, 300)], -1)
    np.testing.assert_allclose(tgp.grid_overlap_score(samples, jL, jmc, jq),
                               jgp.grid_overlap_score(samples, jL, jmc, jq), rtol=1e-10)
    np.testing.assert_allclose(tgp.grid_moments(jL, jmc, jq), jgp.grid_moments(jL, jmc, jq),
                               rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_grid_posterior_matches(grids, seed):
    (jL, jmc, jq), _ = grids
    np.testing.assert_array_equal(tgp.sample_grid_posterior(jL, jmc, jq, 3907, seed=seed),
                                  jgp.sample_grid_posterior(jL, jmc, jq, 3907, seed=seed))
