"""The variant generations of the port against the JAX package, on the CPU:
the blob and toy signals, the image and dense model zoo, the softmax,
denoiser and two-stage GAN trainers, the image readers, ``param_count``
and ``model_summary``, and the observability helpers.

The same numpy-made inputs, and JAX's random draws, go through both
packages; weights are converted from the flax trees. Tolerances:

- blob images: rtol 1e-5 (atol 1e-6, for entries near zero); the grid
  posterior L: rtol 1e-4 (atol 1e-6). L is the exp of a float32 sum of
  n_pix² terms, ~n_pix²/2 near the peak, which two libraries round in
  other orders: L's relative error is the sum's absolute error, up to
  3.0e-5 measured at n_pix 16;
- toy signals on the same draws: 1e-6 of the maximum;
- every model's forward with converted weights: 1e-4 of the maximum, and
  BatchNorm running statistics rtol 1e-5; ``PermaDropout`` and dropout at
  rate 0 (its keep fraction and scale at rate 0.5 on their own);
- one ``softmax_gan_step``, one ``pretrain_discriminator`` and one
  ``denoiser_gan_step`` (dropout rate 0): losses rtol 1e-4, SGD weights
  rtol 1e-4, Adam weights within lr and Adam's first moments 1e-3 of their
  maximum (a gradient's tolerance);
- one image-GAN ``gan_update`` against ``make_gan_step`` on the same
  draws: tests/test_torch_residual.py's tolerances, with the running mean
  of the BatchNorm behind the Dense bias (whose gradient is exactly zero,
  so its Adam step may flip) within (1 − momentum)·2·lr of it;
- the image readers: atol 1e-6 on the committed JPEGs (PIL on both
  sides), exact on P5 files at their own size and on MNIST IDX files.
"""

import dataclasses
import glob
import gzip
import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu import models as JM
from gennet_tpu.data import images as JI
from gennet_tpu.models import image_models as JIM
from gennet_tpu.physics import blobs as JB
from gennet_tpu.physics import toys as JT
from gennet_tpu.train import denoise_variants as JDV
from gennet_tpu.train import gan as jgan
from gennet_tpu.train import softmax_gan as JSG
from gennet_tpu.utils import param_count as j_param_count
from gennet_tpu_torch import convert, models as TM, runtime
from gennet_tpu_torch.data import images as TI
from gennet_tpu_torch.models import image_models as TIM
from gennet_tpu_torch.models.layers import PermaDropout
from gennet_tpu_torch.physics import blobs as TB
from gennet_tpu_torch.physics import toys as TT
from gennet_tpu_torch.train import denoise_variants as TDV
from gennet_tpu_torch.train import gan as tgan
from gennet_tpu_torch.train import softmax_gan as TSG
from gennet_tpu_torch.train import two_stage as TS
from gennet_tpu_torch.train.metrics import debug_nans, profile_trace
from gennet_tpu_torch.utils import model_summary, param_count

K = jax.random.PRNGKey(0)
IMAGES = os.path.join(os.path.dirname(__file__), "data", "images", "*.jpg")


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, scale=1e-4, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * np.abs(want).max(), err_msg=what)


# ------------------------------------------------------------------ blobs
def test_blob_images_match_the_reference():
    means = np.random.default_rng(0).uniform(size=(2, 3, 2)).astype(np.float32)
    want = np.asarray(JB.gauss_blob_images(jnp.asarray(means), n_pix=16, blob_scale=0.15))
    got = TB.gauss_blob_images(_t(means), n_pix=16, blob_scale=0.15).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got.shape == (2, 3, 16, 16) and got.min() == -1.0 and got.max() == 1.0


def test_make_blob_bank_is_the_images_of_its_means():
    bank, means = TB.make_blob_bank(torch.Generator().manual_seed(0), 64, n_pix=12)
    assert bank.shape == (64, 12, 12) and means.shape == (64, 2)
    assert 0.0 <= float(means.min()) and float(means.max()) < 1.0
    torch.testing.assert_close(bank, TB.gauss_blob_images(means, 12), rtol=0, atol=0)
    # means[..., 0] is the row: the peak sits at the scaled mean
    r, c = np.unravel_index(int(torch.argmax(bank[0])), (12, 12))
    assert abs(r - 12 * float(means[0, 0])) <= 1 and abs(c - 12 * float(means[0, 1])) <= 1


@pytest.mark.parametrize("n_sig", [0.3, 1.0])
def test_blob_grid_posterior_matches_the_reference(n_sig):
    img = np.asarray(JB.gauss_blob_images(jnp.asarray([[0.3, 0.7]]), 16))[0]
    measured = (img + n_sig * np.random.default_rng(1).normal(size=img.shape)).astype(np.float32)
    L, gx, gy = JB.blob_grid_posterior(jnp.asarray(measured), n_sig, grain=16)
    tL, tx, ty = TB.blob_grid_posterior(_t(measured), n_sig, grain=16)
    np.testing.assert_allclose(tL.numpy(), np.asarray(L), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx), rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(gy), rtol=1e-5)
    assert float(tL.max()) == 1.0


# ------------------------------------------------------------------- toys
@pytest.mark.parametrize("n", [16, 300])
def test_toys_match_the_reference_on_its_draws(n):
    key = jax.random.PRNGKey(n)
    k1, k2 = jax.random.split(key)
    offset = jax.random.uniform(k1, (n, 1), maxval=100.0)
    mul = jax.random.uniform(k2, (n, 1), minval=1.0, maxval=2.0)
    want = np.asarray(JT.sample_sinusoids(key, n))
    _close(TT.sinusoids(_t(offset), _t(mul)).numpy(), want, 1e-6, "sinusoids")
    t0 = jax.random.uniform(key, (n, 1), minval=0.3, maxval=0.7)
    _close(TT.gauss_pulses(_t(t0)).numpy(), np.asarray(JT.gauss_pulse(key, n)), 1e-6, "pulses")


def test_toy_samplers_draw_the_reference_priors():
    gen = torch.Generator().manual_seed(0)
    x = TT.sample_sinusoids(gen, 4096)
    assert x.shape == (4096, 50) and 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    p = TT.gauss_pulse(gen, 4096)
    assert p.shape == (4096, 512) and abs(float(p.abs().max()) - 1.0) < 0.05
    # the pulse's peak is its t0 ~ U(0.3, 0.7)
    peaks = p.argmax(dim=1).float() / 511
    assert 0.3 - 2e-3 <= float(peaks.min()) and float(peaks.max()) <= 0.7 + 2e-3
    gen.manual_seed(1)
    x2 = TT.sample_sinusoids(gen, 8, max_offset=1.0, mul_range=(3.0, 3.0))
    gen.manual_seed(1)
    off = torch.rand((8, 1), generator=gen)
    torch.testing.assert_close(x2, TT.sinusoids(off, torch.full((8, 1), 3.0)))


# ----------------------------------------------------------------- models
def _jinit(jm, x, **kw):
    v = jm.init({"params": K, "dropout": K}, x, **kw)
    return jax.device_get(v["params"]), jax.device_get(v.get("batch_stats", {}))


def _moved(stats, seed=5):
    """Running statistics away from their init, so eval mode differs from
    batch mode."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: np.asarray(s) + 0.2 * np.abs(rng.normal(size=np.shape(s))).astype(np.float32),
        stats)


_IMG = np.random.default_rng(2).normal(size=(4, 16, 16, 1)).astype(np.float32)
_Z = np.random.default_rng(3).uniform(-1, 1, (4, 100)).astype(np.float32)
_SER = np.random.default_rng(4).normal(size=(4, 32, 1)).astype(np.float32)
_SIG = np.random.default_rng(5).uniform(size=(4, 50)).astype(np.float32)

# name → (JAX module, port module, converter, input, batch-statistics mode)
MODELS = {
    "image_generator_eval": (lambda: JIM.ImageGenerator(n_pix=16), lambda: TIM.ImageGenerator(16),
                             convert.flax_to_torch_image_generator, _Z, False),
    "image_generator_batch": (lambda: JIM.ImageGenerator(n_pix=16),
                              lambda: TIM.ImageGenerator(16),
                              convert.flax_to_torch_image_generator, _Z, True),
    "flat_image_generator": (lambda: JIM.FlatImageGenerator(n_pix=16),
                             lambda: TIM.FlatImageGenerator(16),
                             convert.flax_to_torch_flat_image_generator, _Z, True),
    "image_discriminator": (JIM.ImageDiscriminator, lambda: TIM.ImageDiscriminator(16),
                            convert.flax_to_torch_image_discriminator, _IMG, False),
    "flat_image_discriminator": (lambda: JIM.FlatImageDiscriminator(n_pix=16),
                                 lambda: TIM.FlatImageDiscriminator(16),
                                 convert.flax_to_torch_flat_image_discriminator,
                                 _IMG.reshape(4, 256, 1), False),
    "image_pe": (JIM.ImagePE, lambda: TIM.ImagePE(16), convert.flax_to_torch_image_pe, _IMG,
                 False),
    "image_mc_pe": (lambda: JIM.ImageMCDropoutPE(rate=0.0),
                    lambda: TIM.ImageMCDropoutPE(16, rate=0.0), convert.flax_to_torch_image_mc_pe,
                    _IMG, False),
    "dense_generator": (lambda: JM.DenseGenerator(n_out=32),
                        lambda: TM.DenseGenerator(n_out=32),
                        convert.flax_to_torch_dense_generator, _Z[:, :10], False),
    "transpose_generator_eval": (lambda: JM.TransposeGenerator(n_out=32, features=(8, 16)),
                                 lambda: TM.TransposeGenerator(n_out=32, features=(8, 16)),
                                 convert.flax_to_torch_transpose_generator, _Z[:, :1] * 5, False),
    "transpose_generator_batch": (lambda: JM.TransposeGenerator(n_out=32, features=(8, 16)),
                                  lambda: TM.TransposeGenerator(n_out=32, features=(8, 16)),
                                  convert.flax_to_torch_transpose_generator, _Z[:, :1] * 5, True),
    "softmax_discriminator": (lambda: JM.SoftmaxDiscriminator(drate=0.0),
                              lambda: TM.SoftmaxDiscriminator(n_pix=32, drate=0.0),
                              convert.flax_to_torch_softmax_discriminator, _SER[..., 0], False),
    "mc_dropout_pe": (lambda: JM.MCDropoutPE(rate=0.0), lambda: TM.MCDropoutPE(32, rate=0.0),
                      convert.flax_to_torch_mc_dropout_pe, _SER, False),
    "signal_autoencoder": (JDV.SignalAutoencoder, TDV.SignalAutoencoder,
                           convert.flax_to_torch_signal_autoencoder, _SIG, False),
    "denoiser_generator": (JDV.DenoiserGenerator, TDV.DenoiserGenerator,
                           convert.flax_to_torch_denoiser_generator, _SIG, False),
}


def _train_kw(jm):
    """The JAX module's mode argument (SignalAutoencoder takes none)."""
    return {} if isinstance(jm, JDV.SignalAutoencoder) else {"train": False}


def _forward(name):
    jf, tf, conv, x, batch_mode = MODELS[name]
    jm, tm = jf(), tf()
    params, stats = _jinit(jm, jnp.asarray(x), **_train_kw(jm))
    if stats:
        stats = _moved(stats)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    rngs = {"dropout": K}
    if batch_mode:
        jout, mut = jm.apply(variables, jnp.asarray(x), train=True, rngs=rngs,
                             mutable=["batch_stats"])
        new_stats = jax.device_get(mut["batch_stats"])
    else:
        jout, new_stats = jm.apply(variables, jnp.asarray(x), rngs=rngs, **_train_kw(jm)), None
    tm.load_state_dict(conv(params, stats))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if isinstance(tm, TDV.SignalAutoencoder):
            tout = tm(_t(x))
        elif batch_mode:
            tout = tm(_t(x), train=True, gen=gen, commit_stats=True)
        elif isinstance(tm, TM.SoftmaxDiscriminator):
            tout = tm(_t(x), train=True, gen=gen)  # dropout on, at rate 0
        else:
            tout = tm(_t(x), gen=gen)
    return jout, tout, tm, conv, params, new_stats


@pytest.mark.parametrize("name", list(MODELS))
def test_model_forward_matches_the_reference(name):
    jout, tout, tm, conv, params, new_stats = _forward(name)
    pairs = list(zip(jout, tout)) if isinstance(tout, tuple) else [(jout, tout)]
    for j, t in pairs:
        _close(t.numpy(), np.asarray(j), 1e-4, name)
    if new_stats is not None:
        got, want = tm.state_dict(), conv(params, new_stats)
        stats = [k for k in want if "running" in k]
        assert stats
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_transpose_generator_taps_are_not_flipped():
    # flax's stride-1 SAME ConvTranspose is nn.Conv with the taps as stored:
    # the same forward with flipped taps misses the reference by far
    jout, tout, tm, conv, params, _ = _forward("transpose_generator_eval")
    kernels = [np.asarray(params[f"ConvTranspose_{i}"]["kernel"]) for i in range(3)]
    assert all(not np.allclose(k, k[::-1]) for k in kernels)  # asymmetric taps
    with torch.no_grad():
        for m in list(tm.convs) + [tm.out_conv]:
            m.weight.copy_(m.weight.flip(-1))
        flipped = tm(_t(MODELS["transpose_generator_eval"][3])).numpy()
    want = np.asarray(jout)
    assert np.abs(flipped - want).max() > 100 * 1e-4 * np.abs(want).max()
    _close(tout.numpy(), want)


def test_image_generator_normalises_the_flat_dense_output_before_the_reshape():
    tm = TIM.ImageGenerator(16)
    assert tm.bn.weight.shape == (128 * 4 * 4,)
    with torch.no_grad():
        out = tm(torch.rand(3, 100), train=True, commit_stats=True)
    assert out.shape == (3, 16, 16, 1) and float(out.abs().max()) <= 1.0
    assert float(tm.bn.running_mean.abs().max()) > 0  # momentum 0.9 moved it


def test_perma_dropout_is_on_always_and_needs_a_generator():
    x = torch.ones(200_000)
    y = PermaDropout(0.5)(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 5e-3
    assert torch.all(y[kept] == 2.0)
    with pytest.raises(ValueError, match="Generator"):
        PermaDropout(0.5)(x, None)
    with pytest.raises(ValueError, match="Generator"):
        TIM.ImageMCDropoutPE(16)(torch.zeros(1, 16, 16, 1))
    # a batch of copies of one image is a batch of independent draws
    mc = TIM.ImageMCDropoutPE(16)
    with torch.no_grad():
        draws = mc(torch.ones(8, 16, 16, 1), gen=torch.Generator().manual_seed(1))
    assert len({tuple(r.tolist()) for r in draws}) == 8


# name → (JAX module and init input, port module)
COUNTED = {
    "BBHGenerator": (lambda: JM.BBHGenerator(n_out=64), (1, 100), lambda: TM.BBHGenerator(64)),
    "PairDiscriminator": (JM.PairDiscriminator, (1, 64, 2),
                          lambda: TM.PairDiscriminator(n_pix=64)),
    "DualBranchPE": (JM.DualBranchPE, (1, 64, 1), lambda: TM.DualBranchPE(64)),
    "CombinedPE": (JM.CombinedPE, (1, 64, 1), lambda: TM.CombinedPE(64)),
    "BurstGenerator": (lambda: JM.BurstGenerator(n_out=64), (1, 100),
                       lambda: TM.BurstGenerator(64)),
    "BurstDiscriminator": (JM.BurstDiscriminator, (1, 64, 1),
                           lambda: TM.BurstDiscriminator(64)),
    "BurstPE": (JM.BurstPE, (1, 64, 1), lambda: TM.BurstPE(64)),
    "ImageGenerator": (JIM.ImageGenerator, (1, 100), lambda: TIM.ImageGenerator()),
    "FlatImageGenerator": (JIM.FlatImageGenerator, (1, 100), lambda: TIM.FlatImageGenerator()),
    "ImageDiscriminator": (JIM.ImageDiscriminator, (1, 28, 28, 1),
                           lambda: TIM.ImageDiscriminator()),
    "FlatImageDiscriminator": (JIM.FlatImageDiscriminator, (1, 784, 1),
                               lambda: TIM.FlatImageDiscriminator()),
    "ImagePE": (JIM.ImagePE, (1, 28, 28, 1), lambda: TIM.ImagePE()),
    "ImageMCDropoutPE": (JIM.ImageMCDropoutPE, (1, 28, 28, 1), lambda: TIM.ImageMCDropoutPE()),
    "DenseGenerator": (JM.DenseGenerator, (1, 10), lambda: TM.DenseGenerator()),
    "TransposeGenerator": (JM.TransposeGenerator, (1, 1), lambda: TM.TransposeGenerator()),
    "SoftmaxDiscriminator": (JM.SoftmaxDiscriminator, (1, 512),
                             lambda: TM.SoftmaxDiscriminator()),
    "MCDropoutPE": (JM.MCDropoutPE, (1, 512, 1), lambda: TM.MCDropoutPE()),
    "SignalAutoencoder": (JDV.SignalAutoencoder, (1, 50), lambda: TDV.SignalAutoencoder()),
    "DenoiserGenerator": (JDV.DenoiserGenerator, (1, 50), lambda: TDV.DenoiserGenerator()),
}


@pytest.mark.parametrize("name", list(COUNTED))
def test_param_count_equals_the_reference(name):
    jf, shape, tf = COUNTED[name]
    jm = jf()
    shapes = jax.eval_shape(lambda: jm.init({"params": K, "dropout": K},
                                            jnp.zeros(shape), **_train_kw(jm)))
    assert param_count(tf()) == j_param_count(shapes["params"])


def test_model_summary_lists_the_layers_and_the_total():
    pe = TIM.ImageMCDropoutPE(28)
    text = model_summary(pe, (28, 28, 1))
    assert "conv1" in text and "(1, 128, 10, 10)" in text and "PermaDropout" in text
    assert text.splitlines()[-1] == f"Total params: {param_count(pe):,}"
    g = TIM.FlatImageGenerator(16)
    text = model_summary(g, (100,), train=True)
    assert "net.bn" in text and "(1, 256, 1)" in text
    assert float(g.net.bn.running_mean.abs().max()) == 0.0  # the summary commits nothing


# ------------------------------------------------------------ softmax GAN
def _adam_mu(opt_state):
    return jax.device_get(opt_state[0].mu)


def _check_adam(module, opt, before, want_params, want_mu, conv, lr):
    got = module.state_dict()
    for k, v in conv(want_params).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=lr, err_msg=k)
        assert not torch.equal(got[k], before[k]), k
    mu = conv(want_mu)
    for name, p in module.named_parameters():
        _close(opt.state[p]["exp_avg"].numpy(), mu[name].numpy(), 1e-3, name)


def _softmax_pair(subtract_ht):
    cfg = dict(n_out=32, latent_dim=10, batch_size=8, subtract_ht=subtract_ht)
    jcfg, tcfg = JSG.SoftmaxGANConfig(**cfg), TSG.SoftmaxGANConfig(**cfg)
    jG, jD = JM.DenseGenerator(n_out=32), JM.SoftmaxDiscriminator(drate=0.0)
    js = JSG.init_softmax_gan(K, jG, jD, jcfg)
    tG, tD = TM.DenseGenerator(n_out=32), TM.SoftmaxDiscriminator(n_pix=32, drate=0.0)
    ts = TSG.init_softmax_gan(torch.Generator().manual_seed(0), tG, tD, tcfg, "cpu")
    tG.load_state_dict(convert.flax_to_torch_dense_generator(jax.device_get(js.g_params)))
    tD.load_state_dict(convert.flax_to_torch_softmax_discriminator(jax.device_get(js.d_params)))
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(8, 32)).astype(np.float32)
    ht = rng.normal(size=32).astype(np.float32)
    return jcfg, tcfg, jG, jD, js, ts, x, ht


@pytest.mark.parametrize("subtract_ht", [False, True])
def test_softmax_gan_step_matches_the_reference(subtract_ht):
    jcfg, tcfg, jG, jD, js, ts, x, ht = _softmax_pair(subtract_ht)
    key = jax.random.PRNGKey(11)
    jnew, jm = jax.jit(lambda s, xr, k: JSG.softmax_gan_step(
        s, xr, k, generator=jG, discriminator=jD, cfg=jcfg, measured=jnp.asarray(ht)))(
        js, jnp.asarray(x), key)
    kz1, kz2, _ = jax.random.split(key, 3)
    z, z2 = (jax.random.uniform(k, (8, 10)) for k in (kz1, kz2))
    g_before = {k: v.clone() for k, v in ts.generator.state_dict().items()}
    d_before = {k: v.clone() for k, v in ts.discriminator.state_dict().items()}
    ts, tm = TSG.softmax_gan_update(ts, _t(x), _t(z), _t(z2), None, cfg=tcfg, measured=_t(ht))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    got = ts.generator.state_dict()
    for k, v in convert.flax_to_torch_dense_generator(jax.device_get(jnew.g_params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-7, err_msg=k)
        assert not torch.equal(got[k], g_before[k]), k
    _check_adam(ts.discriminator, ts.d_opt, d_before, jax.device_get(jnew.d_params),
                _adam_mu(jnew.d_opt), convert.flax_to_torch_softmax_discriminator, tcfg.d_lr)
    assert ts.step == 1 and isinstance(ts.g_opt, torch.optim.SGD)


def test_pretrain_discriminator_matches_the_reference():
    jcfg, tcfg, jG, jD, js, ts, x, ht = _softmax_pair(False)
    key = jax.random.PRNGKey(12)
    jnew, jm = JSG.pretrain_discriminator(js, jnp.asarray(x), key, generator=jG,
                                          discriminator=jD, cfg=jcfg)
    z = jax.random.uniform(jax.random.split(key)[0], (8, 10))
    g_before = {k: v.clone() for k, v in ts.generator.state_dict().items()}
    d_before = {k: v.clone() for k, v in ts.discriminator.state_dict().items()}
    ts, tm = TSG.pretrain_update(ts, _t(x), _t(z), None, cfg=tcfg)
    np.testing.assert_allclose(float(tm["d_loss"]), float(jm["d_loss"]), rtol=1e-4)
    _check_adam(ts.discriminator, ts.d_opt, d_before, jax.device_get(jnew.d_params),
                _adam_mu(jnew.d_opt), convert.flax_to_torch_softmax_discriminator, tcfg.d_lr)
    for k, v in ts.generator.state_dict().items():  # G untouched
        assert torch.equal(v, g_before[k]), k
    # the drawing wrapper: the same update on latents drawn from the generator
    _, _, _, _, _, ts2, _, _ = _softmax_pair(False)
    gen = torch.Generator().manual_seed(3)
    ts2, m2 = TSG.pretrain_discriminator(ts2, _t(x), gen, cfg=tcfg)
    z2 = torch.rand((8, 10), generator=torch.Generator().manual_seed(3))
    _, _, _, _, _, ts3, _, _ = _softmax_pair(False)
    ts3, m3 = TSG.pretrain_update(ts3, _t(x), z2, None, cfg=tcfg)
    assert float(m2["d_loss"]) == float(m3["d_loss"])


@pytest.mark.parametrize("trainer", ["softmax", "denoiser"])
def test_the_three_d_passes_of_a_step_share_one_mask(trainer, monkeypatch):
    from gennet_tpu_torch.models import discriminator as tdisc
    from gennet_tpu_torch.models import layers as tlayers

    calls, masks, states = [], [], []
    real_dropout, real_keep = tdisc.dropout, tlayers.SharedMasks.keep

    def spy(x, rate, active, gen):
        calls.append(gen)
        return real_dropout(x, rate, active, gen)

    def spy_keep(self, shape, device, rate):
        # the stream's state when the pass reached its mask, and the whole
        # mask the pass was given
        states.append(self.gen.get_state().clone())
        keep = real_keep(self, shape, device, rate)
        masks.append(keep)
        return keep

    monkeypatch.setattr(tdisc, "dropout", spy)
    monkeypatch.setattr(tlayers.SharedMasks, "keep", spy_keep)
    gen = torch.Generator().manual_seed(4)
    x = TT.sample_sinusoids(torch.Generator().manual_seed(5), 8, n_out=32)
    D = TM.SoftmaxDiscriminator(n_pix=32)
    if trainer == "softmax":
        cfg = TSG.SoftmaxGANConfig(n_out=32, batch_size=8)
        st = TSG.init_softmax_gan(torch.Generator().manual_seed(0), TM.DenseGenerator(32), D,
                                  cfg, "cpu")
        st, m = TSG.softmax_gan_step(st, x, gen, cfg=cfg)
    else:
        cfg = TDV.DenoiserGANConfig(n_out=32, batch_size=8)
        st = TDV.init_denoiser_gan(torch.Generator().manual_seed(0), TDV.DenoiserGenerator(32),
                                   D, cfg, "cpu")
        st, m = TDV.denoiser_gan_step(st, x, gen, cfg=cfg)
    assert len(calls) == 3  # real, fake, and G's pass through the updated D
    assert len(masks) == 3  # every pass took its mask from the shared set
    assert bool(masks[0].any()) and not bool(masks[0].all())  # a real mask
    # passes 2 and 3 get pass 1's mask itself, in full
    assert all(mk is masks[0] and torch.equal(mk, masks[0]) for mk in masks[1:])
    # the stream goes on past the masks: the next draw is not a replay
    assert not torch.equal(gen.get_state(), states[0])
    assert all(np.isfinite(float(v)) for v in m.values())


def test_softmax_gan_step_with_a_world1_mesh_equals_the_plain_step():
    # the mesh path (one pmean of D's gradients and loss, one of G's) at a
    # world of one process: the reference's axis_name pmean, bit for bit
    from gennet_tpu_torch.train.mesh import init_data_mesh

    runs = []
    for use_mesh in (False, True):
        mesh = init_data_mesh("cpu") if use_mesh else None
        try:
            cfg = TSG.SoftmaxGANConfig(n_out=32, batch_size=8, subtract_ht=True)
            st = TSG.init_softmax_gan(torch.Generator().manual_seed(0), TM.DenseGenerator(32),
                                      TM.SoftmaxDiscriminator(n_pix=32), cfg, "cpu")
            gen = torch.Generator().manual_seed(1)
            x = TT.sample_sinusoids(torch.Generator().manual_seed(2), 8, n_out=32)
            for _ in range(2):
                st, m = TSG.softmax_gan_step(st, x, gen, cfg=cfg, measured=x[0], mesh=mesh)
            runs.append(({k: float(v) for k, v in m.items()},
                         {**st.generator.state_dict(), **st.discriminator.state_dict()}))
        finally:
            if mesh is not None:
                mesh.close()
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


# -------------------------------------------------------------- denoiser
def test_denoiser_gan_step_matches_the_reference():
    jcfg, tcfg = JDV.DenoiserGANConfig(batch_size=8), TDV.DenoiserGANConfig(batch_size=8)
    jG, jD = JDV.DenoiserGenerator(), JM.SoftmaxDiscriminator(drate=0.0)
    js = JDV.init_denoiser_gan(K, jG, jD, jcfg)
    tG, tD = TDV.DenoiserGenerator(), TM.SoftmaxDiscriminator(n_pix=50, drate=0.0)
    ts = TDV.init_denoiser_gan(torch.Generator().manual_seed(0), tG, tD, tcfg, "cpu")
    tG.load_state_dict(convert.flax_to_torch_denoiser_generator(jax.device_get(js.g_params)))
    tD.load_state_dict(convert.flax_to_torch_softmax_discriminator(jax.device_get(js.d_params)))
    x = _SIG[:, :50].repeat(2, axis=0)
    key = jax.random.PRNGKey(13)
    jnew, jm = jax.jit(lambda s, xr, k: JDV.denoiser_gan_step(
        s, xr, k, generator=jG, discriminator=jD, cfg=jcfg))(js, jnp.asarray(x), key)
    kn, _, kn2 = jax.random.split(key, 3)
    noisy, noisy2 = (x + np.asarray(jax.random.uniform(k, x.shape, minval=-0.2, maxval=0.2))
                     for k in (kn, kn2))
    g_before = {k: v.clone() for k, v in tG.state_dict().items()}
    d_before = {k: v.clone() for k, v in tD.state_dict().items()}
    ts, tm = TDV.denoiser_gan_update(ts, _t(x), _t(noisy), _t(noisy2), None, cfg=tcfg)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    _check_adam(tG, ts.g_opt, g_before, jax.device_get(jnew.g_params), _adam_mu(jnew.g_opt),
                convert.flax_to_torch_denoiser_generator, tcfg.g_lr)
    _check_adam(tD, ts.d_opt, d_before, jax.device_get(jnew.d_params), _adam_mu(jnew.d_opt),
                convert.flax_to_torch_softmax_discriminator, tcfg.d_lr)


def test_train_autoencoder_is_seeded_and_learns():
    x = TT.sample_sinusoids(torch.Generator().manual_seed(0), 128)
    runs = [TDV.train_autoencoder(torch.Generator().manual_seed(1), TDV.SignalAutoencoder(), x,
                                  epochs=e) for e in (1, 60, 60)]
    (_, first), (ae, last), (ae2, last2) = runs
    assert np.isfinite(last) and last < first and last == last2
    for k, v in ae.state_dict().items():
        assert torch.equal(v, ae2.state_dict()[k]), k
    recon, code = ae(x[:4])
    assert recon.shape == (4, 50) and code.shape == (4, 10)
    torch.testing.assert_close(ae.encode(x[:4]), code)


# --------------------------------------------------------------- two-stage
def test_combine_pretrained_transplants_exactly():
    cfg = tgan.GANConfig(n_pix=64, batch_size=4, latent_dim=1, pair_discriminator=False,
                         latent_low=-5.0, latent_high=5.0)
    gen = torch.Generator().manual_seed(0)
    bank = torch.randn(16, 64, generator=torch.Generator().manual_seed(1))

    def nets():
        return TM.TransposeGenerator(n_out=64, features=(8, 8)), TM.BurstDiscriminator(64)

    d_pre, _ = TS.pretrain_discriminator_on_noise(torch.Generator().manual_seed(2), gen,
                                                  *nets(), cfg, 2)
    g_pre, _ = TS.pretrain_generator(torch.Generator().manual_seed(3), gen, *nets(), cfg, bank,
                                     bank[0], 2)
    G, D = nets()
    st = TS.combine_pretrained(torch.Generator().manual_seed(4), G, D, cfg, g_pre, d_pre, "cpu")
    for got, want in ((G, g_pre.generator), (D, d_pre.discriminator)):
        want_sd = want.state_dict()
        assert got.state_dict().keys() == want_sd.keys()
        for k, v in got.state_dict().items():
            assert torch.equal(v, want_sd[k]), k
    assert float(G.norms[0].running_mean.abs().max()) > 0  # trained BN statistics came along
    assert all(len(o.state) == 0 for o in (st.g_opt, st.d_opt, st.g_res_opt))  # fresh Adam
    assert st.generator is G and st.discriminator is D


def test_run_two_stage_tiny():
    bank = torch.randn(16, 64, generator=torch.Generator().manual_seed(0))
    cfg = tgan.GANConfig(n_pix=64, batch_size=4, pair_discriminator=False, latent_dim=8)
    G, D = TM.BurstGenerator(n_out=64, latent_dim=8), TM.BurstDiscriminator(64)
    st, m = TS.run_two_stage(0, G, D, bank, bank[0], cfg, stage1_iters=2, stage2_iters=2,
                             stage3_iters=2)
    assert st.generator is G and st.step == 2
    assert np.isfinite(float(m["d_loss"])) and float(m["res_loss"]) > 0.0


# ------------------------------------------------------- image GAN update
def test_image_gan_update_matches_make_gan_step():
    n = 16
    cfg = dict(n_pix=n * n, batch_size=4, lr=2e-4, n_sig=0.3, pair_discriminator=False,
               residual_route=True)
    jcfg, tcfg = jgan.GANConfig(**cfg), tgan.GANConfig(**cfg)
    jG, jD = JIM.FlatImageGenerator(n_pix=n), JIM.FlatImageDiscriminator(n_pix=n)
    js = jgan.init_gan(K, jG, jD, jcfg)
    js = js.replace(g_stats=_moved(jax.device_get(js.g_stats)))
    rng = np.random.default_rng(8)
    bank = np.asarray(JB.gauss_blob_images(jnp.asarray(rng.uniform(size=(12, 2)), jnp.float32),
                                           n)).reshape(12, -1)
    measured = (bank[0] + 0.3 * rng.normal(size=n * n)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    jnew, jm = jgan.make_gan_step(jG, jD, jcfg)(js, jnp.asarray(bank), jnp.asarray(measured), key)
    jb = jax.device_get(jgan.draw_gan_batch(key, jnp.asarray(bank), jcfg))

    tG, tD = TIM.FlatImageGenerator(n), TIM.FlatImageDiscriminator(n)
    ts = tgan.init_gan(torch.Generator().manual_seed(0), tG, tD, tcfg, "cpu")
    tG.load_state_dict(convert.flax_to_torch_flat_image_generator(
        jax.device_get(js.g_params), js.g_stats))
    tD.load_state_dict(convert.flax_to_torch_flat_image_discriminator(
        jax.device_get(js.d_params)))
    d_before = {k: v.clone() for k, v in tD.state_dict().items()}
    tb = tgan.GANBatch(z1=_t(jb.z1), real=_t(jb.real), fresh=_t(jb.fresh), in_real=None,
                       in_fake=None, in_g=None, y_real=_t(jb.y_real), y_fake=_t(jb.y_fake),
                       z3=_t(jb.z3), z2=_t(jb.z2))
    ts, tm = tgan.gan_update(ts, tb, _t(measured), cfg=tcfg)

    for k in ("d_loss", "d_acc", "g_loss", "g_acc", "res_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    got = tD.state_dict()
    for k, v in convert.flax_to_torch_flat_image_discriminator(
            jax.device_get(jnew.d_params)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=tcfg.lr, err_msg=k)
    assert any(not torch.equal(v, d_before[k]) for k, v in got.items())
    # two Adam states step G (the residual route, then the adversarial
    # step), both in batch-statistics mode: 2·lr, and 2·lr per step for the
    # bias before the BatchNorm, whose gradient is exactly zero. That bias
    # enters the batch mean the adversarial pass commits, after the
    # residual step may have moved it the other way: the running mean
    # takes (1 − momentum)·2·lr of it on top of rtol 1e-5
    want = convert.flax_to_torch_flat_image_generator(jax.device_get(jnew.g_params),
                                                      jax.device_get(jnew.g_stats))
    got = tG.state_dict()
    for k, v in want.items():
        if "running" in k:
            atol = 1e-6 + (0.1 * 2 * tcfg.lr if k == "net.bn.running_mean" else 0.0)
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=atol,
                                       err_msg=k)
        else:
            tol = (4 if k == "net.dense1.bias" else 2) * tcfg.lr
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=tol, err_msg=k)


# ------------------------------------------------------------------ images
def _write_p5(path, img, comment=True):
    h, w = img.shape
    head = b"P5\n" + (b"# written by the test\n" if comment else b"") + f"{w} {h}\n255\n".encode()
    with open(path, "wb") as f:
        f.write(head + img.astype(np.uint8).tobytes())


def test_load_image_dir_matches_the_reference_on_the_committed_jpegs():
    want = JI.load_image_dir(IMAGES, n_pix=24, flip=True)
    got = TI.load_image_dir(IMAGES, n_pix=24, flip=True)
    assert got.shape == (32, 24, 24, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], got[0][:, ::-1])
    assert TI.load_image_dir(IMAGES, n_pix=24, flip=False, limit=5).shape == (5, 24, 24, 1)
    with pytest.raises(FileNotFoundError):
        TI.load_image_dir("/nonexistent/*.jpg")


def test_p5_files_read_exactly_as_the_reference_reads_them(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    for i in range(3):
        _write_p5(tmp_path / f"im{i}.pgm", rng.integers(0, 256, (20, 20)), comment=i != 1)
    pattern = str(tmp_path / "*.pgm")
    want = JI.load_image_dir(pattern, n_pix=20)  # through PIL
    np.testing.assert_array_equal(TI.load_image_dir(pattern, n_pix=20), want)
    # with PIL and matplotlib hidden from the port: the numpy P5 reader
    for name in ("PIL", "matplotlib", "matplotlib.image"):
        monkeypatch.setitem(sys.modules, name, None)
    np.testing.assert_array_equal(TI.load_image_dir(pattern, n_pix=20), want)
    # its nearest-neighbour resize is the matplotlib fallback's
    small = TI.load_image_dir(pattern, n_pix=8, flip=False)
    idx = np.linspace(0, 19, 8).astype(int)
    for k, path in enumerate(sorted(glob.glob(pattern))):
        raw = np.frombuffer(open(path, "rb").read()[-400:], np.uint8).reshape(20, 20)
        sub = raw[np.ix_(idx, idx)].astype(np.float32)
        lo, hi = sub.min(), sub.max()
        np.testing.assert_array_equal(small[k, ..., 0], 2 * (sub - lo) / max(hi - lo, 1e-9) - 1)
    with pytest.raises(ImportError, match="PIL.*matplotlib"):
        TI.load_image_dir(IMAGES, n_pix=8)


def test_mnist_idx_round_trip(tmp_path):
    imgs = np.random.default_rng(5).integers(0, 256, (7, 28, 28), dtype=np.uint8)
    payload = struct.pack(">IIII", 0x803, 7, 28, 28) + imgs.tobytes()
    plain, gz = tmp_path / "train-images-idx3-ubyte", tmp_path / "train-images-idx3-ubyte.gz"
    plain.write_bytes(payload)
    with gzip.open(gz, "wb") as fh:
        fh.write(payload)
    out = TI.load_mnist_idx(str(plain))
    np.testing.assert_allclose(out[..., 0], imgs / 127.5 - 1.0, atol=1e-6)
    np.testing.assert_array_equal(out, JI.load_mnist_idx(str(plain)))
    small = TI.load_mnist_idx(str(gz), n_pix=14, limit=3)
    assert small.shape == (3, 14, 14, 1)
    np.testing.assert_array_equal(small, JI.load_mnist_idx(str(gz), n_pix=14, limit=3))
    bad = tmp_path / "bad"
    bad.write_bytes(struct.pack(">IIII", 0x1234, 1, 2, 2) + b"\x00" * 4)
    with pytest.raises(ValueError, match="IDX3"):
        TI.load_mnist_idx(str(bad))


# ------------------------------------------------------------ observability
def test_profile_trace_writes_a_chrome_trace(tmp_path):
    G = TIM.FlatImageGenerator(16)
    with profile_trace(str(tmp_path / "trace")):
        G(torch.rand(2, 100), train=True).sum().backward()
    files = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert json.load(open(files[0]))["traceEvents"]


def test_debug_nans_raises_on_a_nan_in_a_backward_pass():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    torch.sqrt(x).sum().backward()  # off: a NaN gradient passes silently
    assert bool(torch.isnan(x.grad).any())
    try:
        debug_nans(True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
        debug_nans(False)
        runtime.setup("cpu", debug_nans=True)
        assert torch.is_anomaly_enabled()
    finally:
        debug_nans(False)
    assert not torch.is_anomaly_enabled()
    info = runtime.setup("cpu")
    assert not torch.is_anomaly_enabled()
    # the determinism policy: cuDNN's deterministic algorithms (the image
    # models' 2-D conv backward is not repeatable on the card without them)
    assert info["cudnn_deterministic"] and torch.backends.cudnn.deterministic


def test_variant_config_defaults_are_the_references():
    for j, t in ((JSG.SoftmaxGANConfig, TSG.SoftmaxGANConfig),
                 (JDV.DenoiserGANConfig, TDV.DenoiserGANConfig)):
        assert dataclasses.asdict(j()) == dataclasses.asdict(t())
