"""Physics of the port against the JAX package, on the same inputs.

Tolerances: deterministic float32 pipelines are held to float32 rounding
(rtol 1e-5); host float64 geometry to 1e-12; PhenomD to amplitude rtol 1e-4
of the peak and phase atol 1e-3·max(1, |Ψ|), because float32
transcendentals and summation orders differ between the two libraries;
the float64 PhenomD path to the golden file's own tolerances.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from gennet_tpu.physics import detector as jdet
from gennet_tpu.physics import priors as jpri
from gennet_tpu.physics import psd as jpsd
from gennet_tpu.physics import waveform as jwf
from gennet_tpu.physics import whiten as jwh
from gennet_tpu.physics import windows as jwin
from gennet_tpu_torch.physics import detector as tdet
from gennet_tpu_torch.physics import priors as tpri
from gennet_tpu_torch.physics import psd as tpsd
from gennet_tpu_torch.physics import waveform as twf
from gennet_tpu_torch.physics import whiten as twh
from gennet_tpu_torch.physics import windows as twin

GOLDENS = json.load(open(os.path.join(os.path.dirname(__file__), "goldens",
                                      "phenomd_goldens.json")))


@pytest.mark.parametrize("M,alpha", [(64, 0.5), (1024, 1.0 / 8.0), (37, 0.3)])
def test_windows_match(M, alpha):
    np.testing.assert_array_equal(twin.tukey_np(M, alpha), jwin.tukey_np(M, alpha))
    np.testing.assert_array_equal(twin.centered_tukey_window_np(M, 2),
                                  jwin.centered_tukey_window_np(M, 2))


@pytest.mark.parametrize("op", ["AdvDesign", "AdvEarlyLow", "aLIGOZDHP"])
def test_psd_matches(op):
    # the port evaluates in float64 and rounds once; JAX in float32
    ref = np.asarray(jpsd.analytic_advligo_psd(256, 4, op=op))
    out = tpsd.analytic_advligo_psd(256, 4, op=op).numpy()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6 * ref.max())


def test_whitening_gain_matches():
    psd = np.asarray(jpsd.analytic_advligo_psd(256, 4))
    ref = np.asarray(jwh.whitening_gain(jnp.asarray(psd), 256))
    out = twh.whitening_gain(torch.tensor(psd), 256).numpy()
    assert out[0] == 0.0 and np.all(out[psd == 0] == 0.0)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_mass_conversions_match():
    rng = np.random.default_rng(0)
    m1 = rng.uniform(20, 60, 64).astype(np.float32)
    m2 = (m1 * rng.uniform(0.3, 1.0, 64)).astype(np.float32)
    mc_j, eta_j = jpri.chirp_mass_eta(jnp.asarray(m1), jnp.asarray(m2))
    mc_t, eta_t = tpri.chirp_mass_eta(torch.tensor(m1), torch.tensor(m2))
    np.testing.assert_allclose(mc_t.numpy(), np.asarray(mc_j), rtol=1e-6)
    np.testing.assert_allclose(eta_t.numpy(), np.asarray(eta_j), rtol=1e-6)
    q = m2 / m1
    a_j, b_j = jpri.mc_q_to_m1m2(jnp.asarray(mc_t.numpy()), jnp.asarray(q))
    a_t, b_t = tpri.mc_q_to_m1m2(mc_t, torch.tensor(q))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-6)
    np.testing.assert_allclose(a_t.numpy(), m1, rtol=1e-4)  # the inversion round-trips


@pytest.mark.parametrize("det", ["H1", "L1", "V1"])
def test_detector_matches(det):
    rng = np.random.default_rng(1)
    gps = 1126259462.0 + rng.uniform(0, 3e7, 16)
    ra, dec, psi = rng.uniform(0, 6.28, 16), rng.uniform(-1.5, 1.5, 16), rng.uniform(0, 6.28, 16)
    for a, b in zip(tdet.antenna_response(gps, ra, dec, psi, det),
                    jdet.antenna_response(gps, ra, dec, psi, det)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tdet.time_delay_from_earth_center(gps, ra, dec, det),
                               jdet.time_delay_from_earth_center(gps, ra, dec, det),
                               rtol=1e-12, atol=1e-16)


# six (m1, m2) pairs across the hunt_constrain prior (mc 20-35, q ≥ 0.5)
PAIRS = [(36.0, 29.0), (25.0, 23.0), (45.0, 30.0), (28.0, 27.5), (50.0, 26.0), (60.0, 33.0)]


@pytest.mark.parametrize("m1,m2", PAIRS)
def test_phenomd_matches_jax(m1, m2):
    f = np.arange(256 * 4 // 2 + 1) / 4.0   # the fs = 256 safe grid
    a_j, p_j = jwf.imrphenomd_ampphase(jnp.asarray(f, jnp.float32), m1, m2, f_high=128.0)
    a_t, p_t = twf.imrphenomd_ampphase(torch.tensor(f, dtype=torch.float32), m1, m2, f_high=128.0)
    a_j, p_j = np.asarray(a_j), np.asarray(p_j)
    assert a_t.dtype == torch.float32 and a_t.shape == (f.size,)
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0, atol=1e-4 * np.abs(a_j).max())
    assert np.all(np.abs(p_t.numpy() - p_j) <= 1e-3 * np.maximum(1.0, np.abs(p_j)))


def test_phenomd_batched_equals_per_template():
    f = torch.tensor(np.arange(513) / 4.0, dtype=torch.float32)
    m1 = torch.tensor([p[0] for p in PAIRS])
    m2 = torch.tensor([p[1] for p in PAIRS])
    a, p = twf.imrphenomd_ampphase(f, m1, m2, f_high=128.0)
    assert a.shape == (len(PAIRS), 513)
    for i, (x, y) in enumerate(PAIRS):
        ai, pi = twf.imrphenomd_ampphase(f, x, y, f_high=128.0)
        np.testing.assert_array_equal(a[i].numpy(), ai.numpy())
        np.testing.assert_array_equal(p[i].numpy(), pi.numpy())


@pytest.mark.parametrize("row", range(len(GOLDENS["rows"])))
def test_phenomd_float64_matches_goldens(row):
    # the tolerances of tests/test_phenomd_goldens.py: a 4th-significant-
    # digit error in one fit constant fails them
    r = GOLDENS["rows"][row]
    a, p = twf.imrphenomd_ampphase(torch.tensor(r["freqs"], dtype=torch.float64), r["m1"], r["m2"])
    np.testing.assert_allclose(a.numpy(), r["amp"], rtol=1e-8)
    np.testing.assert_allclose(p.numpy(), r["phase"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mdist", ["astro", "hunt_constrain", "gh", "metric"])
def test_sample_masses_constraints_and_distribution(mdist):
    import jax

    n = 4096
    gen = torch.Generator().manual_seed(0)
    t = tpri.sample_masses(gen, n, mdist=mdist)
    j = jpri.sample_masses(jax.random.PRNGKey(0), n, mdist=mdist)
    m1, m2 = t["m1"].numpy(), t["m2"].numpy()
    assert bool(t["valid"].all())
    assert np.all(m1 >= m2) and np.all(m2 > 0)
    if mdist in ("astro", "hunt_constrain"):
        assert np.all(m1 + m2 < 100.0) and np.all(m2 > 5.0)
    if mdist == "hunt_constrain":
        mc = t["mc"].numpy()
        assert np.all(m2 / m1 >= 0.5) and np.all((mc >= 20.0) & (mc <= 35.0))
    np.testing.assert_allclose(t["M"].numpy(), m1 + m2, rtol=1e-6)
    # the port's generator gives other numbers than jax.random: compare the
    # marginals' distributions (two-sample KS, n = 4096 each)
    for key in ("m1", "m2", "mc"):
        assert ks_2samp(t[key].numpy(), np.asarray(j[key])).pvalue > 1e-3, key


def test_sample_masses_reproducible_from_seed():
    a = tpri.sample_masses(torch.Generator().manual_seed(5), 64, "hunt_constrain")
    b = tpri.sample_masses(torch.Generator().manual_seed(5), 64, "hunt_constrain")
    np.testing.assert_array_equal(a["m1"].numpy(), b["m1"].numpy())
