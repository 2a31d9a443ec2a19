"""Posterior post-processing (``eval/posterior_post.py``): every function
of the port against its JAX counterpart on the same inputs and the same
random draws (JAX's draws, made from its keys as the reference splits
them, are passed into the port), and the template gradient that
``ml_recenter`` runs through the phasor op's VJP.

Forward models: the reference test's sine-Gaussian, written once in JAX
and once in torch (float32 both), a linear model, and the BBH template
synthesis at n_pix 256 (the JAX package's dense path on the CPU).

Tolerances (float32 sums in other orders on the two sides):
- clouds out of the deterministic routes (self/bootstrap calibration):
  1e-5·max|cloud|; ml_recenter: 1e-4 of the cloud's std per parameter
  after a few Adam steps (2e-3 for the BBH model, whose gradients carry
  PhenomD's float32 error);
- resampled clouds: the same rows (the systematic resampler's indices
  agree) to 1e-5 relative, the KDE resample's float64 draws to 1e-6;
- ELBO and ESS: rtol 1e-4 (a sum of 10^2-10^3 float32 terms);
- d(template)/d(mc, q): 2e-3·max (PhenomD float32 fits, see
  tests/test_torch_physics.py, differentiated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennet_tpu.eval import posterior_post as jpp
from gennet_tpu.physics.burst import sine_gaussian
from gennet_tpu_torch.eval import posterior_post as tpp

N_PIX = 128
DT = 1.0 / 512
TGRID = np.arange(N_PIX) * DT
TRUTH = np.array([0.125, 0.03])


def j_synth(s):
    s = jnp.asarray(s)
    return sine_gaussian(s[:, 0], s[:, 1], N=N_PIX)


def t_synth(s):
    s = torch.as_tensor(s, dtype=torch.float32)
    t0, tau = s[:, 0:1], s[:, 1:2]
    x = (DT * torch.arange(N_PIX, dtype=torch.float32)) - t0
    return torch.sin(2.0 * np.pi * 100.0 * x + 2.0 * np.pi) * torch.exp(-(x**2) / tau**2)


def moment_estimator(bias):
    """tests/test_posterior_post.py's closed-form (t0, τ) estimator."""
    b = np.asarray(bias)

    def est(w):
        w2 = np.asarray(w, np.float64) ** 2
        p = w2 / (w2.sum(axis=1, keepdims=True) + 1e-30)
        t0 = p @ TGRID
        m2 = (p * (TGRID[None, :] - t0[:, None]) ** 2).sum(axis=1)
        tau = 2.0 * np.sqrt(np.maximum(m2, 1e-12))
        return np.column_stack([t0, tau]) + b[None, :]

    return est


def _event(n_sig, seed):
    rng = np.random.default_rng(seed)
    measured = np.asarray(j_synth(TRUTH[None, :])[0]) + n_sig * rng.normal(size=N_PIX)
    return measured.astype(np.float32), rng


def _close_cloud(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max(axis=0) / np.maximum(ref.std(axis=0), 1e-30)
    assert np.all(err <= tol), err


def _same_rows(out, ref, rtol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _uniform(key):
    return float(jax.random.uniform(key, ()))


def test_self_calibrate_matches():
    rng = np.random.default_rng(0)
    true = np.column_stack([rng.uniform(0.10, 0.15, 256), rng.uniform(0.02, 0.04, 256)])
    est = moment_estimator([0.004, -0.003])
    samples = est(np.asarray(j_synth(true))).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ref = jpp.self_calibrate(samples, j_synth, est, key, n_sig=0.005, rounds=2)
    noise = []
    for _ in range(2):
        key, kn = jax.random.split(key)
        noise.append(_normal(kn, (256, N_PIX)))
    out = tpp.self_calibrate(samples, t_synth, est, None, n_sig=0.005, rounds=2,
                             noise=np.stack(noise))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shrink", [True, False])
def test_bootstrap_calibrate_matches(shrink):
    rng = np.random.default_rng(5)
    est = moment_estimator([0.004, -0.003])
    cloud = est(np.asarray(j_synth(TRUTH[None, :] + rng.normal(0, [0.003, 0.002], (500, 2))))
                + 0.02 * rng.standard_normal((500, N_PIX))).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = jpp.bootstrap_calibrate(cloud, j_synth, est, key, n_sig=0.02, shrink=shrink)
    out = tpp.bootstrap_calibrate(cloud, t_synth, est, None, n_sig=0.02, shrink=shrink,
                                  noise=_normal(key, (500, N_PIX)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_ml_recenter_matches():
    measured, rng = _event(0.01, 1)
    cloud = (TRUTH[None, :] + np.array([0.002, -0.004])[None, :]
             + rng.normal(0, [0.002, 0.001], size=(512, 2))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jpp.ml_recenter(cloud, j_synth, measured, key, steps=25)
    out = tpp.ml_recenter(cloud, t_synth, measured, None, steps=25,
                          jitter=_normal(key, (4, 2)))
    _close_cloud(out, ref, 1e-4)
    assert not np.allclose(out.mean(0), cloud.mean(0))   # it moved
    np.testing.assert_allclose(out.std(0), cloud.std(0), rtol=1e-5)   # dispersion untouched


def test_ml_recenter_survives_nan_forward_model_like_reference():
    measured, rng = _event(0.0, 7)
    cloud = (TRUTH[None, :] + rng.normal(0, [0.002, 0.001], size=(256, 2))).astype(np.float32)

    def bad_rows(s0, s1):
        return (abs(s0 - 0.125) > 0.003) | (s1 < 0.028)

    def j_nan(s):
        s = jnp.asarray(s)
        return jnp.where(bad_rows(s[:, 0], s[:, 1])[:, None], jnp.nan, j_synth(s))

    def t_nan(s):
        s = torch.as_tensor(s, dtype=torch.float32)
        wf = t_synth(s)
        return torch.where(bad_rows(s[:, 0], s[:, 1])[:, None], torch.nan, wf)

    key = jax.random.PRNGKey(8)
    ref = jpp.ml_recenter(cloud, j_nan, measured, key, steps=25)
    out = tpp.ml_recenter(cloud, t_nan, measured, None, steps=25, jitter=_normal(key, (4, 2)))
    assert np.isfinite(out).all()
    _close_cloud(out, ref, 1e-4)
    all_nan = lambda s: torch.full((len(s), N_PIX), torch.nan)
    np.testing.assert_allclose(tpp.ml_recenter(cloud, all_nan, measured, None, steps=3,
                                               jitter=np.zeros((4, 2))), cloud)


@pytest.mark.parametrize("temper", [1.0, 0.3])
def test_likelihood_resample_and_ess_match(temper):
    n_sig = 0.1
    measured, rng = _event(n_sig, 2)
    cloud = (TRUTH[None, :] + rng.normal(0, [0.01, 0.008], size=(2000, 2))).astype(np.float32)
    cloud[:, 1] = np.clip(cloud[:, 1], 0.005, 0.08)
    key = jax.random.PRNGKey(3)
    ref = jpp.likelihood_resample(cloud, j_synth, measured, n_sig, key, temper=temper)
    out = tpp.likelihood_resample(cloud, t_synth, measured, n_sig, None, temper=temper,
                                  u0=_uniform(key))
    _same_rows(out, ref)
    np.testing.assert_allclose(
        tpp.effective_sample_size(cloud, t_synth, measured, n_sig, temper),
        jpp.effective_sample_size(cloud, j_synth, measured, n_sig, temper), rtol=1e-4)
    all_nan = lambda s: torch.full((len(s), N_PIX), torch.nan)
    np.testing.assert_array_equal(tpp.likelihood_resample(cloud, all_nan, measured, n_sig, None,
                                                          u0=0.5), cloud)
    assert tpp.effective_sample_size(cloud, all_nan, measured, n_sig) == 0.0


def _smoothed_draws(key, n_out, p=2):
    kr, kj = jax.random.split(key)
    return {"u0": _uniform(kr), "jitter": _normal(kj, (n_out, p))}


def test_smoothed_resample_matches():
    n_sig = 0.05
    measured, rng = _event(n_sig, 3)
    base = TRUTH[None, :] + np.array([0.0, 0.008]) + rng.normal(0, [0.004, 0.006], (512, 2))
    proposal = np.tile(base, (4, 1)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ref = jpp.smoothed_resample(proposal, j_synth, measured, n_sig, key, n_out=2000)
    out = tpp.smoothed_resample(proposal, t_synth, measured, n_sig, None, n_out=2000,
                                **_smoothed_draws(key, 2000))
    assert out.shape == (2000, 2)
    _same_rows(out, ref, 1e-4)   # + the kernel's bandwidth, from float32 weighted moments


def _kde_draws(key, n, n_draw, p=2):
    ki, kj, kr = jax.random.split(key, 3)
    return {"idx": np.asarray(jax.random.randint(ki, (n_draw,), 0, n)),
            "normal": _normal(kj, (n_draw, p)), "u0": _uniform(kr)}


@pytest.mark.parametrize("bounds", [None, ((0.0, 0.25), (0.02, 0.1))])
def test_kde_is_resample_matches(bounds):
    n_sig = 0.05
    measured, rng = _event(n_sig, 4)
    pool = (TRUTH[None, :] + rng.normal(0, [0.0015, 0.002], (600, 2))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref, ref_ess = jpp.kde_is_resample(pool, j_synth, measured, n_sig, key, bounds=bounds,
                                       n_draw=3000, n_out=1000)
    out, ess = tpp.kde_is_resample(pool, t_synth, measured, n_sig, None, bounds=bounds,
                                   n_draw=3000, n_out=1000, **_kde_draws(key, 600, 3000))
    np.testing.assert_allclose(ess, ref_ess, rtol=1e-4)
    _same_rows(out, ref, 1e-6)


def test_plateau_pool_matches():
    clouds = {a: np.full((10, 2), float(a)) for a in (1, 2, 3, 4)}
    for scores in ({1: -5.0, 2: -0.05, 3: 0.0, 4: float("-inf")},
                   {k: float("nan") for k in clouds}):
        pool, members = tpp.plateau_pool(clouds, scores, delta=0.1)
        ref_pool, ref_members = jpp.plateau_pool(clouds, scores, delta=0.1)
        assert members == ref_members
        assert (pool is None and ref_pool is None) or np.array_equal(pool, ref_pool)


def _linear_problem():
    rng = np.random.default_rng(3)
    n_sig = 0.1
    A = rng.normal(size=(64, 2)).astype(np.float32)
    d = (A @ np.array([0.3, -0.7]) + n_sig * rng.normal(size=64)).astype(np.float32)
    mu = np.linalg.solve(A.T @ A, A.T @ d)
    L = np.linalg.cholesky(n_sig**2 * np.linalg.inv(A.T @ A))
    z = rng.normal(size=(2048, 2))
    clouds = {"correct": mu + z @ L.T, "biased": mu + z @ L.T + 3.0 * np.sqrt(np.diag(L @ L.T)),
              "collapsed": mu + 0.05 * (z @ L.T), "wide": mu + 8.0 * (z @ L.T)}
    clouds = {k: v.astype(np.float32) for k, v in clouds.items()}
    j_lin = lambda s: jnp.asarray(s) @ jnp.asarray(A).T
    t_lin = lambda s: torch.as_tensor(s, dtype=torch.float32) @ torch.tensor(A).T
    return clouds, j_lin, t_lin, d, n_sig


@pytest.mark.parametrize("entropy", ["gauss", "knn"])
def test_elbo_score_matches(entropy):
    clouds, j_lin, t_lin, d, n_sig = _linear_problem()
    for name, c in clouds.items():
        ref = jpp.elbo_score(c, j_lin, d, n_sig, entropy=entropy)
        out = tpp.elbo_score(c, t_lin, d, n_sig, entropy=entropy)
        np.testing.assert_allclose(out, ref, rtol=1e-4, err_msg=name)
    got = {k: tpp.elbo_score(c, t_lin, d, n_sig, entropy=entropy) for k, c in clouds.items()}
    assert max(got, key=got.get) == "correct"
    s, se = tpp.elbo_score(clouds["correct"], t_lin, d, n_sig, return_se=True)
    rs, rse = jpp.elbo_score(clouds["correct"], j_lin, d, n_sig, return_se=True)
    np.testing.assert_allclose([s, se], [rs, rse], rtol=1e-4)
    nan_synth = lambda s: torch.full((len(s), 16), torch.nan)
    assert tpp.elbo_score(clouds["wide"], nan_synth, np.zeros(16), n_sig) == float("-inf")


def test_select_route_matches():
    n_sig = 0.05
    measured, rng = _event(n_sig, 2)
    est = moment_estimator([0.0, 0.0])
    cloud = (TRUTH[None, :] + np.array([0.0, 0.008]) + rng.normal(0, [0.002, 0.003], (256, 2))
             ).astype(np.float32)
    key = jax.random.PRNGKey(0)
    r_route, r_out, r_scores = jpp.select_route(cloud, j_synth, est, measured, n_sig, key)
    kb, km, kmb, kr, kmr = jax.random.split(key, 5)
    draws = {"bootcal": {"noise": _normal(kb, (256, N_PIX))},
             "mlrc": {"jitter": _normal(km, (4, 2))},
             "mlrc_bootcal": {"jitter": _normal(kmb, (4, 2))},
             "reweight": {"u0": _uniform(kr)}, "mlrc_reweight": {"u0": _uniform(kmr)}}
    route, out, scores = tpp.select_route(cloud, t_synth, est, measured, n_sig, None,
                                          draws=draws)
    assert set(scores) == set(r_scores) and route == r_route
    for name in scores:
        np.testing.assert_allclose(scores[name], r_scores[name], rtol=1e-4, err_msg=name)
    _same_rows(out, r_out)


def test_select_final_cloud_matches():
    n_sig = 0.05
    measured, rng = _event(n_sig, 4)
    lib = {step: (TRUTH[None, :] + rng.normal(0, [0.0015, 0.0008], (800, 2))).astype(np.float32)
           for step in (1000, 2000, 3000)}
    final = (TRUTH[None, :] + rng.normal(0, 0.002, (300, 2))).astype(np.float32)
    bounds = ((0.0, 0.25), (0.005, 0.1))
    key = jax.random.PRNGKey(2)
    r_name, r_cloud, r_info = jpp.select_final_cloud(lib, j_synth, measured, n_sig, key,
                                                     extra={"final": final}, n_out=2000,
                                                     bounds=bounds)
    k1, k2, _ = jax.random.split(key, 3)
    _, kk = jax.random.split(key)
    draws = {"plat_is": _smoothed_draws(k2, 2000), "pool_is": _smoothed_draws(k1, 2000),
             "kde_is": _kde_draws(kk, 2400, 16384)}
    name, cloud, info = tpp.select_final_cloud(lib, t_synth, measured, n_sig, None,
                                               extra={"final": final}, n_out=2000,
                                               bounds=bounds, draws=draws)
    assert name == r_name
    assert info["argmax_step"] == r_info["argmax_step"]
    assert info["plateau_members"] == r_info["plateau_members"]
    assert set(info["scores"]) == set(r_info["scores"]) == {
        "final", "argmax", "plateau", "plat_is", "pool", "pool_is", "kde_is"}
    for key_ in ("pool_ess", "kde_ess"):
        np.testing.assert_allclose(info[key_], r_info[key_], rtol=1e-4, err_msg=key_)
    for cand in info["scores"]:
        np.testing.assert_allclose(info["scores"][cand], r_info["scores"][cand], rtol=1e-4,
                                   err_msg=cand)
    assert ("tiebreak" in info) == ("tiebreak" in r_info)
    _same_rows(cloud, r_cloud, 1e-4)
    # an empty library falls back to the extra candidates, then to nothing
    assert tpp.select_final_cloud({}, t_synth, measured, n_sig, None,
                                  extra={"final": final})[0] == "final"
    assert tpp.select_final_cloud({}, t_synth, measured, n_sig, None)[:2] == (None, None)


def test_draws_come_from_the_generator_when_not_given():
    n_sig = 0.05
    measured, rng = _event(n_sig, 6)
    cloud = (TRUTH[None, :] + rng.normal(0, [0.002, 0.002], (300, 2))).astype(np.float32)
    runs = [tpp.smoothed_resample(cloud, t_synth, measured, n_sig,
                                  torch.Generator().manual_seed(seed), n_out=500)
            for seed in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


# ---- the BBH forward model at n_pix 256: gradients through the phasor op ----

FS = 256


@pytest.fixture(scope="module")
def bbh_models():
    from gennet_tpu.data import template_bank as jtb
    from gennet_tpu.physics import priors as jpr
    from gennet_tpu.physics import psd as jpsd
    from gennet_tpu_torch.data import template_bank as ttb
    from gennet_tpu_torch.physics import priors as tpr
    from gennet_tpu_torch.physics import psd as tpsd

    jcfg, tcfg = jtb.BankConfig(fs=FS), ttb.BankConfig(fs=FS)
    jp, tp = jpsd.analytic_advligo_psd(FS, 4), tpsd.analytic_advligo_psd(FS, 4)

    def j_bbh(sm):   # run_bbh's clipped synth
        sm = jnp.asarray(sm)
        m1, m2 = jpr.mc_q_to_m1m2(jnp.clip(sm[:, 0], 5.0, 60.0), jnp.clip(sm[:, 1], 0.2, 1.0))
        return jtb.make_templates_from_params(m1, m2, jp, jcfg)

    def t_bbh(sm):
        sm = torch.as_tensor(sm, dtype=torch.float32)
        m1, m2 = tpr.mc_q_to_m1m2(torch.clamp(sm[:, 0], 5.0, 60.0),
                                  torch.clamp(sm[:, 1], 0.2, 1.0))
        return ttb.make_templates_from_params(m1, m2, tp, tcfg)

    return j_bbh, t_bbh


def test_template_gradient_matches_jax(bbh_models):
    from gennet_tpu_torch.ops import phasor_dft

    j_bbh, t_bbh = bbh_models
    theta = np.array([[28.1, 0.8], [30.0, 0.65], [25.5, 0.92]], np.float32)
    wgt = np.random.default_rng(0).normal(size=(3, FS)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda th: jnp.sum(j_bbh(th) * wgt))(jnp.asarray(theta)))
    th = torch.tensor(theta, requires_grad=True)
    tmpl = t_bbh(th)
    assert type(tmpl.grad_fn).__name__ == "MulBackward0"
    assert "PhasorMatmulBackward" in str(tmpl.grad_fn.next_functions)
    launches = phasor_dft.LAUNCHES
    torch.sum(tmpl * torch.tensor(wgt)).backward()
    assert phasor_dft.LAUNCHES == launches
    np.testing.assert_allclose(th.grad.numpy(), ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())


def test_ml_recenter_through_templates_matches_jax(bbh_models):
    j_bbh, t_bbh = bbh_models
    rng = np.random.default_rng(1)
    measured = (np.asarray(j_bbh(np.array([[28.1, 0.8]], np.float32)))[0]
                + 0.3 * rng.normal(size=FS)).astype(np.float32)
    cloud = (np.array([28.6, 0.75]) + rng.normal(0, [0.3, 0.04], (16, 2))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jpp.ml_recenter(cloud, j_bbh, measured, key, steps=4, n_starts=4)
    out = tpp.ml_recenter(cloud, t_bbh, measured, None, steps=4, n_starts=4,
                          jitter=_normal(key, (2, 2)))
    _close_cloud(out, ref, 2e-3)
