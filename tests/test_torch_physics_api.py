"""The physics and bank API of the port against the JAX package: library
functions the reference's tests call and no workload calls.

Mirrors tests/test_physics.py:66-110,335-348,425-428,
tests/test_waveform_anchors.py and tests/test_template_bank.py:113-126.

Tolerances (PERF.md §6's parity table): PSD curves rtol 1e-5 of float32
(the port evaluates in float64 and rounds once, JAX in float32); whitening
rtol 2e-6 against the numpy formula, as the JAX test; TaylorF2 and PhenomD
(h̃+, h̃×) in float64 to 1e-9 of the peak (float64 transcendentals of two
libraries), and in float32 their moduli to 1e-4 of the peak. Where a draw
is random the statistic is stated with the JAX test's bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gennet_tpu.physics as jphys
import gennet_tpu_torch.physics as tphys
from gennet_tpu.data import template_bank as jtb
from gennet_tpu.physics import detector as jdet
from gennet_tpu.physics import psd as jpsd
from gennet_tpu.physics import snr as jsnr
from gennet_tpu.physics import waveform as jwf
from gennet_tpu.physics import whiten as jwh
from gennet_tpu_torch.data import template_bank as ttb
from gennet_tpu_torch.physics import constants, noise, snr
from gennet_tpu_torch.physics import detector as tdet
from gennet_tpu_torch.physics import psd as tpsd
from gennet_tpu_torch.physics import waveform as twf
from gennet_tpu_torch.physics import whiten as twh

PAIRS = [(36.0, 29.0), (25.0, 23.0), (50.0, 26.0)]


def test_physics_exports_mirror_the_reference():
    assert sorted(tphys.__all__) == sorted(jphys.__all__)
    for name in tphys.__all__:
        assert getattr(tphys, name) is not None, name


@pytest.mark.parametrize("curve", ["aligo_zdhp_psd", "advirgo_psd"])
def test_psd_curves_match(curve):
    f = np.arange(1024 * 4 // 2 + 1) / 4.0
    ref = np.asarray(getattr(jpsd, curve)(jnp.asarray(f, jnp.float32)))
    out = getattr(tpsd, curve)(torch.tensor(f, dtype=torch.float32))
    assert out.dtype == torch.float32 and out[0] == 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6 * ref.max())
    # the dtype follows the frequencies'
    assert getattr(tpsd, curve)(torch.tensor(f)).dtype == torch.float64


def test_regularize_psd_matches():
    rng = np.random.default_rng(0)
    p = rng.normal(size=1024 * 2 // 2 + 1).astype(np.float32)
    p[7], p[300] = np.nan, np.inf
    ref = np.asarray(jpsd.regularize_psd(jnp.asarray(p), 1024, 2, f_low=20.0))
    out = tpsd.regularize_psd(torch.tensor(p), 1024, 2, f_low=20.0).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[:40] == 0).all() and out[300] == 0.0 and np.isfinite(out).all()


def test_whiten_fd_matches_the_formula_and_jax():
    rng = np.random.default_rng(0)
    fs, T = 1024, 2
    Nf = fs * T // 2 + 1
    data = rng.normal(size=Nf) + 1j * rng.normal(size=Nf)
    p = np.abs(rng.normal(size=Nf)) + 0.1
    p[5] = 0.0  # undefined bin
    out = twh.whiten_fd(torch.tensor(data), torch.tensor(p), fs).numpy()
    ref = data * np.sqrt(2.0 * np.where(p > 0, 1 / np.where(p > 0, p, 1), 0) / fs)
    ref[0] = 0.0
    np.testing.assert_allclose(out, ref, rtol=2e-6)
    assert out[5] == 0.0
    j = np.asarray(jwh.whiten_fd(jnp.asarray(data.astype(np.complex64)),
                                 jnp.asarray(p, jnp.float32), fs))
    t = twh.whiten_fd(torch.tensor(data.astype(np.complex64)), torch.tensor(p, dtype=torch.float32),
                      fs).numpy()
    np.testing.assert_allclose(t, j, rtol=2e-6, atol=1e-7)


def test_whiten_td_matches_jax():
    rng = np.random.default_rng(1)
    fs, T = 256, 4
    x = rng.normal(size=(3, fs * T)).astype(np.float32)
    p = np.asarray(jpsd.analytic_advligo_psd(fs, T))
    ref = np.asarray(jwh.whiten_td(jnp.asarray(x), jnp.asarray(p), fs))
    out = twh.whiten_td(torch.tensor(x), torch.tensor(p), fs).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_whitened_colored_noise_is_unit_variance():
    # the GAN's core assumption: whitened noise has σ = 1 (the JAX test's
    # bound, 0.05, over 64 realisations of the interior samples)
    fs, T = 1024, 4
    p = tpsd.analytic_advligo_psd(fs, T)
    x = noise.colored_noise(torch.Generator().manual_seed(1), p, T, fs, batch_shape=(64,))
    w = twh.whiten_td(x, p, fs)
    assert x.shape == (64, fs * T) and x.dtype == torch.float32
    assert abs(float(w[:, fs : 3 * fs].std()) - 1.0) < 0.05


def test_colored_noise_psd_recovery():
    # the periodogram averages to the target PSD (the JAX test's rtol 0.25
    # over 256 realisations)
    fs, T = 256, 4
    Nf = fs * T // 2 + 1
    p = np.ones(Nf)
    p[:8] = 0.0
    x = noise.colored_noise(torch.Generator().manual_seed(0), torch.tensor(p, dtype=torch.float32),
                            T, fs, batch_shape=(256,))
    xf = np.fft.rfft(x.numpy(), axis=-1)
    est = 2 * np.mean(np.abs(xf) ** 2, axis=0) / (fs * fs * T)
    np.testing.assert_allclose(est[8:-1], p[8:-1], rtol=0.25)
    assert np.abs(xf[:, :8]).max() < 1e-3  # DC and zero-PSD bins carry nothing


def test_colored_noise_on_given_draws_matches_jax_formula():
    # the same normal draws through both formulas: N · irfft(amp·(re + i·im)) · df
    fs, T = 128, 2
    p = np.asarray(jpsd.analytic_advligo_psd(fs, T))
    g = torch.Generator().manual_seed(3)
    out = noise.colored_noise(g, torch.tensor(p), T, fs)
    g = torch.Generator().manual_seed(3)
    Nf = fs * T // 2 + 1
    re, im = (torch.randn((Nf,), generator=g).numpy() for _ in range(2))
    amp = np.where(p == 0, 0.0, np.sqrt(0.25 * T * p))
    spec = amp * re + 1j * amp * im
    spec[0] = 0.0
    ref = fs * T * np.fft.irfft(spec, fs * T) / T
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_white_noise():
    x = noise.white_noise(torch.Generator().manual_seed(0), (4096,), sigma=2.0)
    assert abs(float(x.std()) - 2.0) < 0.1 and x.dtype == torch.float32


@pytest.mark.parametrize("m1,m2", PAIRS)
@pytest.mark.parametrize("model", ["taylorf2_htilde", "imrphenomd_htilde"])
def test_htilde_matches_jax_float64(x64, model, m1, m2):
    f = np.arange(1024 * 4 // 2 + 1) / 4.0
    kw = dict(inclination=2.5, phi_ref=0.3)
    jp, jc = getattr(jwf, model)(jnp.asarray(f), m1, m2, **kw)
    tp, tc = getattr(twf, model)(torch.tensor(f), m1, m2, **kw)
    assert tp.dtype == torch.complex128 and tp.shape == (f.size,)
    for t, j in ((tp, jp), (tc, jc)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-9 * np.abs(j).max())


@pytest.mark.parametrize("model", ["taylorf2_htilde", "imrphenomd_htilde"])
def test_htilde_float32_moduli_match_jax(model):
    f = np.arange(256 * 4 // 2 + 1) / 4.0
    jp, _ = getattr(jwf, model)(jnp.asarray(f, jnp.float32), 36.0, 29.0)
    tp, _ = getattr(twf, model)(torch.tensor(f, dtype=torch.float32), 36.0, 29.0)
    assert tp.dtype == torch.complex64
    a = np.abs(np.asarray(jp))
    np.testing.assert_allclose(np.abs(tp.numpy()), a, rtol=0, atol=1e-4 * a.max())


def test_htilde_batched_equals_per_template():
    f = torch.tensor(np.arange(513) / 4.0, dtype=torch.float32)
    m1, m2 = torch.tensor([p[0] for p in PAIRS]), torch.tensor([p[1] for p in PAIRS])
    for model in (twf.taylorf2_htilde, twf.imrphenomd_htilde):
        hp, hc = model(f, m1, m2)
        assert hp.shape == hc.shape == (len(PAIRS), 513)
        for i, (x, y) in enumerate(PAIRS):
            np.testing.assert_array_equal(hp[i].numpy(), model(f, x, y)[0].numpy())


def test_phenomd_peak_strain_physical_scale():
    # GW150914 at 410 Mpc: a time-domain peak strain of ~1e-21
    fs, T = 1024, 4
    f = torch.tensor(np.arange(T * fs // 2 + 1) / T)
    hp, _ = twf.imrphenomd_htilde(f, 36.0, 29.0, inclination=2.5)
    ht = np.fft.irfft(hp.numpy(), T * fs) * fs / constants.STRAIN_SCALE
    assert 5e-22 < np.abs(ht).max() < 5e-21 and not np.isnan(ht).any()


def test_phenomd_taylorf2_low_freq_consistency():
    # PhenomD's inspiral is TaylorF2 up to (t_c, φ_c) and small terms: the
    # phase difference is nearly linear at low frequency, the moduli within 5 %
    fs, T = 1024, 4
    f = torch.tensor(np.arange(T * fs // 2 + 1) / T)
    hp_d, _ = twf.imrphenomd_htilde(f, 36.0, 29.0)
    hp_t, _ = twf.taylorf2_htilde(f, 36.0, 29.0)
    i0, i1 = int(40 * T), int(55 * T)
    a, b = hp_d[i0:i1].numpy(), hp_t[i0:i1].numpy()
    dphi = np.unwrap(np.angle(a)) - np.unwrap(np.angle(b))
    assert np.abs(np.diff(dphi, 2)).max() < 5e-3
    ratio = np.abs(a) / np.abs(b)
    assert np.all((ratio > 0.95) & (ratio < 1.05))


def test_taylorf2_stops_at_the_isco():
    f = torch.tensor(np.arange(2049) / 4.0)
    hp, hc = twf.taylorf2_htilde(f, 36.0, 29.0, inclination=0.0)
    f_isco = 1.0 / (6.0**1.5 * np.pi * (65.0 * constants.MTSUN_SI))
    assert (hp.numpy()[f.numpy() > f_isco] == 0).all() and (hp.numpy()[f.numpy() < 10] == 0).all()
    # face-on: h× = −i h+
    np.testing.assert_allclose(hc.numpy(), -1j * hp.numpy(), rtol=1e-12, atol=1e-30)


def test_snr_matches_jax_and_fd_equals_td():
    cfg = ttb.BankConfig()
    p = tpsd.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe)
    f = torch.tensor(cfg.freqs(), dtype=torch.float32)
    amp, _ = twf.imrphenomd_ampphase(f, 36.0, 29.0, f_high=cfg.fs / 2)
    K = ttb._antenna_projection(cfg)[0]
    rho_fd = float(snr.optimal_snr_fd(amp, p, cfg.T_obs * cfg.safe)) * K
    rho_td = float(snr.whitened_snr(ttb.make_event_template(p, cfg)))
    # the JAX test's bounds: a GW150914-like SNR, FD and TD within 15 %
    assert 20 < rho_fd < 150 and abs(rho_td - rho_fd) / rho_fd < 0.15
    j_fd = float(jsnr.optimal_snr_fd(jnp.asarray(amp.numpy()), jnp.asarray(p.numpy()),
                                     cfg.T_obs * cfg.safe))
    np.testing.assert_allclose(rho_fd / K, j_fd, rtol=1e-5)
    w = np.random.default_rng(0).normal(size=(3, 64)).astype(np.float32)
    np.testing.assert_allclose(snr.whitened_snr(torch.tensor(w)).numpy(),
                               np.asarray(jsnr.whitened_snr(jnp.asarray(w))), rtol=1e-6)


def test_fd_time_shifts_match_jax():
    rng = np.random.default_rng(2)
    h = (rng.normal(size=(2, 129)) + 1j * rng.normal(size=(2, 129))).astype(np.complex64)
    dt = np.array([0.01, -0.03])
    ref = np.asarray(jdet.fd_time_shift(jnp.asarray(h), jnp.asarray(dt), 2.0))
    out = tdet.fd_time_shift(torch.tensor(h), torch.tensor(dt), 2.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    ph = rng.uniform(0, 6, size=(2, 129)).astype(np.float32)
    ref = np.asarray(jdet.fd_time_shift_phase(jnp.asarray(ph), jnp.asarray(dt, jnp.float32), 2.0))
    out = tdet.fd_time_shift_phase(torch.tensor(ph), torch.tensor(dt), 2.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def bank_setup():
    cfg = ttb.BankConfig(fs=256)
    return cfg, tpsd.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe)


def test_noisy_bank_nnoise_semantics(bank_setup):
    # n_noise = 0 is a clean bank (ref Nnoise=0, gw_template_maker.py:685-692),
    # equal to the plain bank from the same seed; n_noise = 1 adds one N(0, 1)
    # realisation to the same templates (the JAX test's std bound 0.8-1.2)
    cfg, psd = bank_setup
    clean, p0 = ttb.make_noisy_template_batch(torch.Generator().manual_seed(3), 4, psd, cfg,
                                              n_noise=0)
    noisy, p1 = ttb.make_noisy_template_batch(torch.Generator().manual_seed(3), 4, psd, cfg,
                                              n_noise=1)
    assert clean.shape == noisy.shape == (4, cfg.fs)
    np.testing.assert_array_equal(p0["mc"].numpy(), p1["mc"].numpy())
    assert 0.8 < float((noisy - clean).std()) < 1.2
    base, _ = ttb.make_template_batch(torch.Generator().manual_seed(3), 4, psd, cfg)
    np.testing.assert_array_equal(clean.numpy(), base.numpy())
    two, p2 = ttb.make_noisy_template_batch(torch.Generator().manual_seed(3), 4, psd, cfg,
                                            n_noise=2)
    assert two.shape == (8, cfg.fs) and set(p2) == {"m1", "m2", "mc", "q", "idx"}
    np.testing.assert_array_equal(p2["m1"].numpy(), np.tile(p0["m1"].numpy(), 2))


def test_noisy_bank_time_grid_matches_jax_layout(bank_setup):
    cfg, psd = bank_setup
    t, p = ttb.make_noisy_template_batch(torch.Generator().manual_seed(0), 3, psd, cfg,
                                         n_noise=2, time_grid=2)
    jt, jp = jtb.make_noisy_template_batch(__import__("jax").random.PRNGKey(0), 3,
                                           jnp.asarray(psd.numpy()), jtb.BankConfig(fs=256),
                                           n_noise=2, time_grid=2)
    assert t.shape == jt.shape == (12, 256)
    assert set(p) == set(jp) and all(p[k].shape == jp[k].shape for k in p)
    # each mass draw repeats time_grid times, then the set repeats per noise copy
    m1 = p["m1"].numpy()
    np.testing.assert_array_equal(m1[:6], np.repeat(m1[:6:2], 2))
    np.testing.assert_array_equal(m1[6:], m1[:6])
    lo, hi = cfg.beta_index_bounds()
    assert ((p["idx"].numpy() >= lo) & (p["idx"].numpy() < hi)).all()
