"""bf16 compute (``--bf16``) of the port's flagship G and D against the
flax modules at ``dtype=jnp.bfloat16``, with converted weights.

Sizes as tests/test_torch_models.py: G at n_out 256 with features
(16, 16, 32, 32, 64), D with features (16, 32), batch 6, every weight and
BN statistic perturbed away from its init. Both packages round to bfloat16
after every layer, but not always to the same neighbour: XLA and PyTorch
compute rsqrt and sum the float32 products of a convolution in other
orders, so a few elements land one bf16 ulp (2⁻⁸ relative) apart, and each
later layer spreads such flips. Measured on the CPU: G 2.0-4.6e-3·max (one
bf16 ulp is 3.9e-3), D 1.1e-3·max under ``xla``; under ``pallas`` D runs
float32 throughout (its convs run the float32 kernel) and agrees at
3.4e-7·max. Tolerances: G 1e-2·max, D 3e-3·max (``xla``) and 1e-4·max
(``pallas``). bf16 itself moves G's output by ~3e-3·max from float32, so
the dtype checks below, not the tolerance, show that bf16 ran.

One GAN step at bf16 (``xla``, the random draws passed in) against the JAX
``gan_update``: losses at rtol 1e-2 (measured 6.7e-4); accuracies within
one sample (a logit within bf16 rounding of 0 may change side); G and D
weights within 2·lr (+ one float32 ulp) of their Adam state's step, since a
gradient that differs by rounding near zero flips that step's sign, and
at least 95% of them within lr/2 (measured 98.5% of G's, 99.7% of D's); BN
running statistics at 1e-2·max (measured 4.5e-3: batch means of bf16
activations).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.train import gan as jgan
from gennet_tpu_torch import convert
from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
from gennet_tpu_torch.train import gan as tgan

N, B = 256, 6
G_FEAT, D_FEAT = (16, 16, 32, 32, 64), (16, 32)
G_TOL, D_TOL = 1e-2, {"xla": 3e-3, "pallas": 1e-4}


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.normal(size=np.shape(x)).astype(np.float32), tree)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _generators(impl):
    jg = JG(n_out=N, features=G_FEAT, drate=0.0, dtype=jnp.bfloat16, conv_impl=impl)
    v = jg.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 100)), train=False)
    params = _perturb(v["params"], 1)
    stats = jax.tree_util.tree_map(lambda x: np.abs(x) + 0.5, _perturb(v["batch_stats"], 2, 0.3))
    tg = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0, conv_impl=impl, dtype=torch.bfloat16)
    tg.load_state_dict(convert.flax_to_torch_generator(params, stats))
    return jg, params, stats, tg


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["eval", "batch_stats"])
def test_generator_bf16_matches(impl, mode):
    jg, params, stats, tg = _generators(impl)
    z = np.random.default_rng(3).uniform(-1, 1, (B, 100)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    if mode == "eval":
        ref = jg.apply(variables, jnp.asarray(z), train=False)
        with torch.no_grad():
            out = tg(torch.tensor(z), train=False)
    else:
        ref, upd = jg.apply(variables, jnp.asarray(z), train=False, bn_train=True,
                            mutable=["batch_stats"])
        with torch.no_grad():
            out = tg(torch.tensor(z), train=False, bn_train=True, commit_stats=True)
        want = convert.flax_to_torch_generator(params, jax.device_get(upd["batch_stats"]))
        for k, v in tg.state_dict().items():
            if "running" in k:
                assert v.dtype == torch.float32, k
                assert _rel(v, want[k]) <= 1e-5, k  # float32 reductions of the same bf16 inputs
    assert out.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    assert _rel(out, ref) <= G_TOL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_discriminator_bf16_matches(impl):
    jd = JD(features=D_FEAT, drate=0.0, dtype=jnp.bfloat16, conv_impl=impl)
    v = jd.init(jax.random.PRNGKey(4), jnp.zeros((1, N, 2)))
    params = _perturb(v["params"], 5)
    x = np.random.default_rng(6).normal(size=(B, N, 2)).astype(np.float32)
    ref = jd.apply({"params": params}, jnp.asarray(x))
    td = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=N, conv_impl=impl,
                           dtype=torch.bfloat16)
    td.load_state_dict(convert.flax_to_torch_discriminator(params))
    with torch.no_grad():
        out = td(torch.tensor(x))
    assert out.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    assert _rel(out, ref) <= D_TOL[impl]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_dtypes(impl):
    """Parameters and BN statistics float32; the hidden layers compute in
    bf16 (the conv layers under ``pallas`` in float32, as in the JAX
    modules); G's output and D's logits float32."""
    tg = BBHGenerator(n_out=N, features=G_FEAT, conv_impl=impl, dtype=torch.bfloat16)
    td = PairDiscriminator(features=D_FEAT, n_pix=N, conv_impl=impl, dtype=torch.bfloat16)
    for m in (tg, td):
        assert all(t.dtype == torch.float32 for t in m.state_dict().values())
    seen = {}
    for name, mod in [*tg.named_modules(prefix="G"), *td.named_modules(prefix="D")]:
        if name.count(".") == 2 or name in ("G.dense", "G.out_conv", "D.dense"):
            mod.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    with torch.no_grad():
        x = tg(torch.rand(4, 100) * 2 - 1, train=True, gen=torch.Generator().manual_seed(0))
        logits = td(torch.cat([x, x], -1), train=True, gen=torch.Generator().manual_seed(1))
    conv = torch.float32 if impl == "pallas" else torch.bfloat16
    assert x.dtype == logits.dtype == torch.float32
    assert seen["G.dense"] == torch.bfloat16 and seen["G.out_conv"] == torch.float32
    assert seen["D.dense"] == torch.float32
    assert all(seen[f"G.norms.{i}"] == torch.bfloat16 for i in range(6))
    assert all(seen[f"G.convs.{i}"] == conv for i in range(5))
    assert all(seen[f"D.convs.{i}"] == conv for i in range(2))


# ------------------------------------------------------------- GAN step


def _gan_batch(b, seed=0):
    rng = np.random.default_rng(seed)
    nb = {"z1": rng.uniform(-1, 1, (b, 100)), "real": rng.normal(size=(b, N)),
          "fresh": rng.normal(size=(b, N)) * 0.5, "in_real": rng.normal(size=(b, N, 2)),
          "in_fake": rng.normal(size=(b, N, 2)), "in_g": rng.normal(size=(1, b, N, 2)),
          "y_real": rng.uniform(0.7, 1.0, b), "y_fake": rng.uniform(0.0, 0.3, b),
          "z3": rng.uniform(-1, 1, (1, b, 100)), "measured": rng.normal(size=N)}
    return {k: v.astype(np.float32) for k, v in nb.items()}


@pytest.fixture(scope="module")
def gan_case():
    kw = dict(n_pix=N, batch_size=4, label_smoothing=True, d_instance_noise=0.3,
              d_lr_scale=0.5, d_acc_gate=0.9)
    jcfg, tcfg = jgan.GANConfig(**kw), tgan.GANConfig(**kw)
    jG = JG(n_out=N, features=G_FEAT, drate=0.0, dtype=jnp.bfloat16)
    jD = JD(features=D_FEAT, drate=0.0, dtype=jnp.bfloat16)
    jstate = jgan.init_gan(jax.random.PRNGKey(0), jG, jD, jcfg)
    nb = _gan_batch(4)
    k = jax.random.PRNGKey(9)
    jb = jgan.GANBatch(z1=nb["z1"], real=nb["real"], fresh=nb["fresh"], in_real=nb["in_real"],
                       in_fake=nb["in_fake"], in_g=nb["in_g"], y_real=nb["y_real"],
                       y_fake=nb["y_fake"], z2=None, z3=nb["z3"], kfake=k, kd=k, kres=k,
                       kg=jax.random.split(k, 2).reshape(1, 2, 2))
    jnew, jm = jax.jit(partial(jgan.gan_update, generator=jG, discriminator=jD, cfg=jcfg))(
        jstate, jb, jnp.asarray(nb["measured"]))

    tG = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0, dtype=torch.bfloat16)
    tD = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=N, dtype=torch.bfloat16)
    tstate = tgan.init_gan(torch.Generator().manual_seed(0), tG, tD, tcfg, "cpu")
    tG.load_state_dict(convert.flax_to_torch_generator(jax.device_get(jstate.g_params),
                                                       jax.device_get(jstate.g_stats)))
    tD.load_state_dict(convert.flax_to_torch_discriminator(jax.device_get(jstate.d_params)))
    t = {k: torch.tensor(v) for k, v in nb.items()}
    tb = tgan.GANBatch(z1=t["z1"], real=t["real"], fresh=t["fresh"], in_real=t["in_real"],
                       in_fake=t["in_fake"], in_g=t["in_g"], y_real=t["y_real"],
                       y_fake=t["y_fake"], z3=t["z3"])
    tnew, tm = tgan.gan_update(tstate, tb, t["measured"], cfg=tcfg)
    return jnew, jm, tnew, tm, tcfg


def test_gan_step_bf16_losses_match(gan_case):
    _, jm, _, tm, _ = gan_case
    for k in ("d_loss", "g_loss"):
        assert tm[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-2, err_msg=k)
    # the gate reads float32 accuracies; one sample of 4 is 1/8 of d_acc
    for k, one in (("d_acc", 0.125), ("g_acc", 0.25)):
        assert tm[k].dtype == torch.float32, k
        assert abs(float(tm[k]) - float(jm[k])) <= one, k


def test_gan_step_bf16_weights_and_stats_match(gan_case):
    jnew, _, tnew, _, cfg = gan_case
    want_g = convert.flax_to_torch_generator(jax.device_get(jnew.g_params),
                                             jax.device_get(jnew.g_stats))
    want_d = convert.flax_to_torch_discriminator(jax.device_get(jnew.d_params))
    for module, want, lr in ((tnew.generator, want_g, cfg.lr),
                             (tnew.discriminator, want_d, cfg.lr * cfg.d_lr_scale)):
        got = module.state_dict()
        assert all(v.dtype == torch.float32 for v in got.values())
        n = close = 0
        for k in want:
            if "running" in k:
                assert _rel(got[k], want[k]) <= 1e-2, k
                continue
            diff = np.abs(got[k].numpy() - want[k].numpy())
            assert diff.max() <= 2 * lr * (1 + 1e-3), k
            n, close = n + diff.size, close + int((diff <= 0.5 * lr).sum())
        assert close >= 0.95 * n, close / n
    # the Adam moments are float32 and every parameter got a gradient
    for opt in (tnew.g_opt, tnew.d_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state[p]
                assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
                assert p.grad is not None and p.grad.dtype == torch.float32
