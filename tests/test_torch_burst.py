"""The burst ``smoke`` workload's modules against the JAX package, on the
same numpy-made inputs and converted weights.

Tolerances:
- ``sine_gaussian`` / ``make_burst_bank``: atol 2e-4. Both sides evaluate
  sin in float32 at arguments up to 2π·100·1 + 2π ≈ 635 rad, whose float32
  rounding (ulp 6.1e-5) shifts the sine by up to ~3e-5; the two libraries'
  float32 sin and exp differ in the last bits on top. Each side is also
  held to the float64 formula at 2e-4 (the errors are printed).
- ``burst_grid_posterior``: rtol 1e-10 (float64 numpy on both sides).
- The three burst networks' forward passes: 1e-4·max (float32 convolutions
  summed in other orders).
- ``GaussianDropout``: the mean and std of the multiplier within 4σ of
  their sampling error.
- Residual losses: rtol 1e-5, the spectral one 1e-4 (an FFT in each
  library).
- ``normalize_max``: rtol 1e-6 (one max and one division).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennet_tpu.eval import grid_posterior as jgp
from gennet_tpu.models import BurstDiscriminator as JBD
from gennet_tpu.models import BurstGenerator as JBG
from gennet_tpu.models import BurstPE as JBPE
from gennet_tpu.physics import burst as jburst
from gennet_tpu.train import cnn as jcnn
from gennet_tpu.train import losses as jL
from gennet_tpu_torch import convert
from gennet_tpu_torch.eval import grid_posterior as tgp
from gennet_tpu_torch.models import BurstDiscriminator, BurstGenerator, BurstPE
from gennet_tpu_torch.models.layers import GaussianDropout
from gennet_tpu_torch.physics import burst as tburst
from gennet_tpu_torch.train import cnn as tcnn
from gennet_tpu_torch.train import losses as tL

BG_FEAT = (8, 8, 16, 16)


def _close(out, ref, tol=1e-4):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def _sg64(t0, tau, N):
    t = np.arange(N) / 512.0
    x = t[None, :] - np.asarray(t0, np.float64)[:, None]
    return np.sin(2 * np.pi * 100 * x + 2 * np.pi) * np.exp(-(x**2) / np.asarray(tau, np.float64)[:, None] ** 2)


@pytest.mark.parametrize("N", [128, 512])
def test_sine_gaussian_matches_reference(N):
    rng = np.random.default_rng(N)
    t0 = rng.uniform(0.25, 0.75, 64).astype(np.float32)
    tau = rng.uniform(1 / 60, 1 / 15, 64).astype(np.float32)
    out = tburst.sine_gaussian(torch.tensor(t0), torch.tensor(tau), N=N).numpy()
    ref = np.asarray(jburst.sine_gaussian(jnp.asarray(t0), jnp.asarray(tau), N=N))
    assert out.shape == ref.shape == (64, N) and out.dtype == np.float32
    f64 = _sg64(t0, tau, N)
    e_port, e_ref = np.abs(out - f64).max(), np.abs(ref - f64).max()
    print(f"N={N}: float64 error port {e_port:.2e}, JAX {e_ref:.2e}; port vs JAX "
          f"{np.abs(out - ref).max():.2e}")
    assert e_port <= 2e-4 and e_ref <= 2e-4
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)
    # scalar arguments give one row, dt stays 1/512 at any N
    one = tburst.sine_gaussian(0.5, 1 / 25, N=N)
    np.testing.assert_allclose(one.numpy(), np.asarray(jburst.sine_gaussian(0.5, 1 / 25, N=N)),
                               rtol=0, atol=2e-4)


def test_make_burst_bank_prior_and_templates():
    gen = torch.Generator().manual_seed(0)
    bank, pars = tburst.make_burst_bank(gen, 4096, N=128)
    assert bank.shape == (4096, 128) and pars.shape == (4096, 2)
    assert bank.dtype == pars.dtype == torch.float32
    p = pars.numpy()
    assert 0.25 <= p[:, 0].min() and p[:, 0].max() <= 0.75
    assert 1 / 60 <= p[:, 1].min() and p[:, 1].max() <= 1 / 15
    # uniform: the mean within 4σ of the sampling error
    for k, (lo, hi) in enumerate(((0.25, 0.75), (1 / 60, 1 / 15))):
        assert abs(p[:, k].mean() - 0.5 * (lo + hi)) <= 4 * (hi - lo) / math.sqrt(12 * 4096)
    # the bank's rows are the reference's sine_gaussian at the same (t0, τ)
    ref = np.asarray(jburst.sine_gaussian(jnp.asarray(p[:256, 0]), jnp.asarray(p[:256, 1]), N=128))
    np.testing.assert_allclose(bank[:256].numpy(), ref, rtol=0, atol=2e-4)
    # reproducible from the seed
    bank2, _ = tburst.make_burst_bank(torch.Generator().manual_seed(0), 4096, N=128)
    assert torch.equal(bank, bank2)


def test_burst_grid_posterior_matches_reference(x64):
    # x64: the JAX function returns its float64 grid as a jnp array, which
    # is float32 unless 64-bit mode is on
    rng = np.random.default_rng(1)
    signal = np.asarray(jburst.sine_gaussian(0.5, 1 / 25, N=128))
    measured = (signal + 0.25 * rng.normal(size=128)).astype(np.float32)
    L, t0, tau = tgp.burst_grid_posterior(torch.tensor(measured), 0.25, 21)
    Lj, t0j, tauj = jgp.burst_grid_posterior(jnp.asarray(measured), 0.25, 21)
    assert L.dtype == np.float64 and Lj.dtype == jnp.float64
    assert L.shape == (21, 21) and L.max() == 1.0
    np.testing.assert_allclose(L, np.asarray(Lj), rtol=1e-10, atol=0)
    np.testing.assert_array_equal(t0, t0j)
    np.testing.assert_array_equal(tau, tauj)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.normal(size=np.shape(x)).astype(np.float32), tree)


@pytest.mark.parametrize("name", ["generator", "discriminator", "pe"])
def test_burst_networks_match_reference(name):
    N, B = 128, 5
    rng = np.random.default_rng(2)
    if name == "generator":
        jm, tm = JBG(n_out=N, features=BG_FEAT), BurstGenerator(n_out=N, features=BG_FEAT)
        x = rng.uniform(-1, 1, (B, 100)).astype(np.float32)
        conv = convert.flax_to_torch_burst_generator
    else:
        jm, tm = ((JBD(), BurstDiscriminator(n_pix=N)) if name == "discriminator"
                  else (JBPE(), BurstPE(n_pix=N)))
        x = rng.normal(size=(B, N, 1)).astype(np.float32)
        conv = (convert.flax_to_torch_burst_discriminator if name == "discriminator"
                else convert.flax_to_torch_burst_pe)
    params = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    tm.load_state_dict(conv(params))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.tensor(x))
    _close(out, ref)
    assert out.shape == {"generator": (B, N, 1), "discriminator": (B, 1), "pe": (B, 2)}[name]


def test_burst_flatten_widths_at_n_pix_512():
    # 512 → 256 → 252 → 126 positions of 128 channels in both networks
    assert BurstDiscriminator(n_pix=512).dense0.in_features == 126 * 128
    assert BurstPE(n_pix=512).dense0.in_features == 126 * 128


def test_gaussian_dropout_statistics():
    rate, n = 0.3, 200_000
    layer = GaussianDropout(rate)
    x = torch.ones(n)
    assert torch.equal(layer(x, train=False), x)            # identity when not training
    assert torch.equal(GaussianDropout(0.0)(x, train=True), x)
    with pytest.raises(ValueError, match="Generator"):
        layer(x, train=True)
    y = layer(x, train=True, gen=torch.Generator().manual_seed(0)).double()
    sigma = math.sqrt(rate / (1 - rate))
    assert abs(float(y.mean()) - 1.0) <= 4 * sigma / math.sqrt(n)
    # std of the sample std of a normal: σ/√(2n)
    assert abs(float(y.std()) - sigma) <= 4 * sigma / math.sqrt(2 * n)
    y2 = layer(x, train=True, gen=torch.Generator().manual_seed(0))
    assert torch.equal(y.float(), y2)                        # the caller's generator decides


@pytest.mark.parametrize("n_pix,bands", [(128, 0), (128, 8), (128, 1000), (8, 16), (6, 4)])
def test_residual_losses_match_reference(n_pix, bands):
    # (8, 16) and (6, 4): more bands than the 3 or 2 retained bins, so the
    # band count clamps to them; (128, 1000) clamps to 63
    rng = np.random.default_rng(n_pix + bands)
    r = (0.3 + 0.5 * rng.normal(size=(4, n_pix, 1))).astype(np.float32)
    if bands == 0:
        out = tL.residual_moment_loss(torch.tensor(r), 0.5)
        ref = jL.residual_moment_loss(jnp.asarray(r), 0.5)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)
    else:
        out = tL.residual_spectral_loss(torch.tensor(r), 0.5, bands)
        ref = jL.residual_spectral_loss(jnp.asarray(r), 0.5, bands)
        assert np.isfinite(float(out))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


@pytest.mark.parametrize("mode", ["off", "batch", "per_sample"])
def test_normalize_max_matches_reference(mode):
    kw = {"off": {}, "batch": {"max_normalize": True},
          "per_sample": {"max_normalize": True, "max_per_sample": True}}[mode]
    x = np.random.default_rng(3).normal(size=(6, 32, 1)).astype(np.float32)
    out = tcnn.normalize_max(torch.tensor(x), tcnn.CNNConfig(**kw))
    ref = jcnn.normalize_max(jnp.asarray(x), jcnn.CNNConfig(**kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_draw_cnn_batch_normalises_after_the_noise():
    # the batch max is taken over the noisy batch (ref: cnn.py:120-121)
    bank = torch.ones((32, 16))
    cfg = tcnn.CNNConfig(n_pix=16, batch_size=8, noise_frac=0.5, max_normalize=True)
    x, _ = tcnn.draw_cnn_batch(torch.Generator().manual_seed(0), bank, torch.zeros(32, 2), cfg)
    assert float(x.max()) == 1.0
    assert float(x[4:].max()) < 1.0          # clean rows scaled by the noisy max
