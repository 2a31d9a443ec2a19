"""One GAN update of the port against the JAX package with the residual-route
family: the burst scheme (raw-series D, residual route), the residual route
on ``BBHGenerator`` in eval and train mode, the spectral residual loss, R1,
the diversity term, the terminal anneal and the debug probes. The same
converted weights and the same numpy-made ``GANBatch`` go through both; G
and D have dropout rate 0, so no dropout mask needs to match.

Tolerances as in tests/test_torch_train.py: losses and metrics rtol 1e-4;
gradients (R1's included) 1e-3 of their largest entry; weights within lr
per Adam state that stepped them (Adam's first step moves a weight by at
most lr, and a gradient that differs near zero can flip a step's sign), so
2·lr for G under the residual route, which steps G twice; a bias that
feeds a BatchNorm has an exactly zero gradient in batch-statistics mode
and may flip in every such step: 2·lr per step; BatchNorm running
statistics rtol 1e-5. The debug probes' norms at rtol 1e-4 (parameters,
extremes) and 1e-3 (gradients).

Also here: the reference cannot differentiate R1 through its Pallas conv
(grad of grad through ``conv1d_train`` fails), and the port refuses that
combination up front.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import BurstDiscriminator as JBD
from gennet_tpu.models import BurstGenerator as JBG
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.train import gan as jgan
from gennet_tpu_torch import convert
from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.models import (BBHGenerator, BurstDiscriminator, BurstGenerator,
                                     PairDiscriminator)
from gennet_tpu_torch.ops import conv1d as conv_ops
from gennet_tpu_torch.train import gan as tgan

N, B = 64, 4
G_FEAT, D_FEAT, BG_FEAT = (16, 16, 32, 32, 64), (16, 32), (8, 8, 16, 16)
PROBES = ("d_grad_norm", "g_grad_norm", "res_grad_norm", "g_param_norm", "d_param_norm",
          "x_fake_absmax", "d_logit_absmax", "bn_var_min")

# name → (scheme, GANConfig overrides, knob overrides)
CASES = {
    "burst": ("burst", {"res_loss_weight": 10.0}, {}),
    "burst_spectral": ("burst", {"res_loss_weight": 10.0, "res_spectral_bands": 8}, {}),
    "bbh_res_eval": ("bbh", {"residual_route": True, "res_eval_mode": True}, {}),
    "bbh_res_train": ("bbh", {"residual_route": True, "res_eval_mode": False}, {}),
    "bbh_r1": ("bbh", {"r1_gamma": 2.0}, {}),
    "bbh_diversity": ("bbh", {"diversity_weight": 0.5}, {}),
    "burst_anneal": ("burst", {"res_loss_weight": 10.0}, {"d_acc_gate": -1.0, "adv_weight": 0.0}),
    "bbh_probes": ("bbh", {"residual_route": True, "pair_discriminator": False,
                           "debug_probes": True}, {}),
}


def _batch(d_ch, seed=0):
    rng = np.random.default_rng(seed)
    nb = {"z1": rng.uniform(-1, 1, (B, 100)), "real": rng.normal(size=(B, N)),
          "fresh": rng.normal(size=(B, N)) * 0.5, "in_real": rng.normal(size=(B, N, d_ch)),
          "in_fake": rng.normal(size=(B, N, d_ch)), "in_g": rng.normal(size=(1, B, N, d_ch)),
          "y_real": rng.uniform(0.7, 1.0, B), "y_fake": rng.uniform(0.0, 0.3, B),
          "z2": rng.uniform(-1, 1, (B, 100)), "z3": rng.uniform(-1, 1, (1, B, 100)),
          "measured": 0.3 * rng.normal(size=N)}
    return {k: v.astype(np.float32) for k, v in nb.items()}


def _run(scheme, cfg_kw, knob_kw):
    kw = dict(n_pix=N, batch_size=B, label_smoothing=True, d_instance_noise=0.3,
              d_lr_scale=0.5, d_acc_gate=0.9, n_sig=0.5)
    if scheme == "burst":
        kw.update(pair_discriminator=False, residual_route=True)
    kw.update(cfg_kw)
    jcfg, tcfg = jgan.GANConfig(**kw), tgan.GANConfig(**kw)
    if scheme == "burst":
        jG, jD = JBG(n_out=N, features=BG_FEAT, drate=0.0), JBD()
        tG, tD = BurstGenerator(n_out=N, features=BG_FEAT, drate=0.0), BurstDiscriminator(n_pix=N)
        g_conv, d_conv = (convert.flax_to_torch_burst_generator,
                          convert.flax_to_torch_burst_discriminator)
    else:
        jG, jD = JG(n_out=N, features=G_FEAT, drate=0.0), JD(features=D_FEAT, drate=0.0)
        tG = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0)
        tD = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=N,
                               in_ch=2 if tcfg.pair_discriminator else 1)
        g_conv, d_conv = convert.flax_to_torch_generator, convert.flax_to_torch_discriminator
    jstate = jgan.init_gan(jax.random.PRNGKey(0), jG, jD, jcfg)
    if jstate.g_stats:
        # running statistics away from their init, so eval mode differs from batch mode
        rng = np.random.default_rng(5)
        jstate = jstate.replace(g_stats=jax.tree_util.tree_map(
            lambda x: np.asarray(x) + 0.2 * np.abs(rng.normal(size=np.shape(x))).astype(np.float32),
            jax.device_get(jstate.g_stats)))
    nb = _batch(2 if tcfg.pair_discriminator else 1)
    k = jax.random.PRNGKey(9)
    jb = jgan.GANBatch(z1=nb["z1"], real=nb["real"], fresh=nb["fresh"], in_real=nb["in_real"],
                       in_fake=nb["in_fake"], in_g=nb["in_g"], y_real=nb["y_real"],
                       y_fake=nb["y_fake"], z2=nb["z2"] if jcfg.residual_route else None,
                       z3=nb["z3"], kfake=k, kd=k, kres=k,
                       kg=jax.random.split(k, 2).reshape(1, 2, 2))
    jknobs = jgan.knobs_from_cfg(jcfg).replace(
        **{n: jnp.asarray(v, jnp.float32) for n, v in knob_kw.items()})
    jnew, jm = jax.jit(partial(jgan.gan_update, generator=jG, discriminator=jD, cfg=jcfg))(
        jstate, jb, jnp.asarray(nb["measured"]), jknobs)

    tstate = tgan.init_gan(torch.Generator().manual_seed(0), tG, tD, tcfg, "cpu")
    tG.load_state_dict(g_conv(jax.device_get(jstate.g_params), jax.device_get(jstate.g_stats)))
    tD.load_state_dict(d_conv(jax.device_get(jstate.d_params)))
    d_before = {k_: v.clone() for k_, v in tD.state_dict().items()}
    t = {k_: torch.tensor(v) for k_, v in nb.items()}
    tb = tgan.GANBatch(z1=t["z1"], real=t["real"], fresh=t["fresh"], in_real=t["in_real"],
                       in_fake=t["in_fake"], in_g=t["in_g"], y_real=t["y_real"],
                       y_fake=t["y_fake"], z3=t["z3"],
                       z2=t["z2"] if tcfg.residual_route else None)
    tknobs = dataclasses.replace(tgan.knobs_from_cfg(tcfg), **knob_kw)
    tnew, tm = tgan.gan_update(tstate, tb, t["measured"], tknobs, cfg=tcfg)
    return dict(jnew=jnew, jm=jm, tnew=tnew, tm=tm, d_before=d_before, cfg=tcfg,
                g_conv=g_conv, d_conv=d_conv, jstate=jstate, jG=jG, jD=jD, nb=nb)


_RUNS: dict = {}


def _case(name):
    if name not in _RUNS:
        scheme, cfg_kw, knob_kw = CASES[name]
        _RUNS[name] = _run(scheme, cfg_kw, knob_kw)
    return _RUNS[name]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return request.param, _case(request.param)


def test_metrics_match(case):
    name, r = case
    for k in ("d_loss", "d_acc", "g_loss", "g_acc", "res_loss"):
        np.testing.assert_allclose(float(r["tm"][k]), float(r["jm"][k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    if r["cfg"].residual_route:
        assert float(r["tm"]["res_loss"]) > 0.0
    if name == "bbh_probes":
        for k in PROBES:
            rtol = 1e-3 if k.endswith("grad_norm") else 1e-4
            np.testing.assert_allclose(float(r["tm"][k]), float(r["jm"][k]), rtol=rtol, err_msg=k)
        assert float(r["tm"]["bn_var_min"]) != 1.0   # BBHGenerator has running variances
    else:
        assert not set(PROBES) & set(r["tm"])


def test_discriminator_matches(case):
    name, r = case
    cfg = r["cfg"]
    got = r["tnew"].discriminator.state_dict()
    want = r["d_conv"](jax.device_get(r["jnew"].d_params))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=cfg.lr * cfg.d_lr_scale, err_msg=k)
    moved = any(not torch.equal(v, r["d_before"][k]) for k, v in got.items())
    # the anneal knobs freeze D and its Adam state: bit-identical, the
    # state optax holds right after init (zero moments, count 0)
    assert moved == (name != "burst_anneal")
    if name == "burst_anneal":
        for s in r["tnew"].d_opt.state.values():
            assert int(s["step"]) == 0
            assert not s["exp_avg"].any() and not s["exp_avg_sq"].any()


def test_generator_matches(case):
    name, r = case
    cfg = r["cfg"]
    want = r["g_conv"](jax.device_get(r["jnew"].g_params), jax.device_get(r["jnew"].g_stats))
    got = r["tnew"].generator.state_dict()
    g_steps = 2 if cfg.residual_route else 1
    # steps that see batch statistics: the adversarial step, and the
    # residual step in train mode
    bn_steps = 1 + int(cfg.residual_route and not cfg.res_eval_mode)
    pre_bn = [k for k in want if k == "dense.bias" or (k.startswith("convs.") and k.endswith("bias"))]
    if isinstance(r["tnew"].generator, BurstGenerator):
        pre_bn = []
    stats = [k for k in want if "running" in k]
    for k in want:
        if k in stats:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            tol = (2 * bn_steps + (g_steps - bn_steps)) * cfg.lr if k in pre_bn \
                else g_steps * cfg.lr
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                       err_msg=k)
    if stats:
        # the running statistics moved (the JAX values they match above count
        # one update per batch-statistics pass)
        before = r["g_conv"](jax.device_get(r["jstate"].g_params),
                             jax.device_get(r["jstate"].g_stats))
        assert not torch.allclose(got[stats[0]], before[stats[0]])


def test_r1_gradients_match():
    # the D gradient of the full D loss, R1 term included: the port's grads
    # after one update against jax.grad of the reference's D loss
    r = _case("bbh_r1")
    nb, jD, cfg = r["nb"], r["jD"], r["cfg"]
    d_params = r["jstate"].d_params
    x_fake = r["jG"].apply({"params": r["jstate"].g_params, "batch_stats": r["jstate"].g_stats},
                           jnp.asarray(nb["z1"]), train=True, mutable=["batch_stats"])[0]
    x_fake = x_fake.reshape(B, -1)
    meas = jnp.asarray(nb["measured"])
    fake = jnp.stack([x_fake, meas[None, :] - x_fake], -1) + 0.3 * nb["in_fake"]
    real = jnp.stack([nb["real"], nb["fresh"]], -1) + 0.3 * nb["in_real"]

    def d_loss(dp):
        lr_ = jD.apply({"params": dp}, real)
        lf_ = jD.apply({"params": dp}, fake)
        loss = 0.5 * (jgan.L.bce_with_logits(lr_, nb["y_real"])
                      + jgan.L.bce_with_logits(lf_, nb["y_fake"]))
        gx = jax.grad(lambda x: jD.apply({"params": dp}, x).sum())(real)
        return loss + 0.5 * 2.0 * jnp.mean(jnp.sum(gx**2, axis=(1, 2)))

    np.testing.assert_allclose(float(r["tm"]["d_loss"]), float(jax.jit(d_loss)(d_params)),
                               rtol=1e-4)
    want = r["d_conv"](jax.device_get(jax.jit(jax.grad(d_loss))(d_params)))
    got = {k: p.grad for k, p in r["tnew"].discriminator.named_parameters()}
    for k in want:
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
    assert cfg.r1_gamma == 2.0


def test_anneal_keeps_a_trained_discriminator_and_its_adam_state():
    # one ordinary update gives D Adam moments; an annealed one must leave
    # D's weights and every moment and count bit-identical
    cfg = tgan.GANConfig(n_pix=N, batch_size=B, pair_discriminator=False, residual_route=True,
                         res_loss_weight=10.0, label_smoothing=True, n_sig=0.5)
    st = tgan.init_gan(torch.Generator().manual_seed(1), BurstGenerator(n_out=N, features=BG_FEAT),
                       BurstDiscriminator(n_pix=N), cfg, "cpu")
    bank = torch.randn(16, N, generator=torch.Generator().manual_seed(2))
    measured = torch.randn(N, generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    st, _ = tgan.gan_step(st, bank, measured, gen, cfg=cfg)
    assert len(st.d_opt.state) > 0
    d_before = {k: v.clone() for k, v in st.discriminator.state_dict().items()}
    opt_before = {id(p): {k: v.clone() for k, v in s.items()} for p, s in st.d_opt.state.items()}
    g_before = {k: v.clone() for k, v in st.generator.state_dict().items()}
    knobs = dataclasses.replace(tgan.knobs_from_cfg(cfg), d_acc_gate=-1.0, adv_weight=0.0)
    st, m = tgan.gan_step(st, bank, measured, gen, knobs, cfg=cfg)
    for k, v in st.discriminator.state_dict().items():
        assert torch.equal(v, d_before[k]), k
    for p, s in st.d_opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[id(p)][k]), k
    # G still moves: the residual route, and Adam's momentum in the adversarial state
    assert any(not torch.equal(v, g_before[k]) for k, v in st.generator.state_dict().items())
    assert float(m["g_loss"]) == 0.0


def test_reference_cannot_take_r1_through_its_pallas_conv():
    from gennet_tpu.ops.pallas_conv1d import conv1d_train

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 16, 3)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(5, 3, 4)).astype(np.float32))
    b = jnp.zeros((4,), jnp.float32)

    def r1(w_):
        gx = jax.grad(lambda x_: conv1d_train(x_, w_, b, 256, 256, True).sum())(x)
        return jnp.sum(gx**2)

    with pytest.raises(AssertionError):
        jax.grad(r1)(w)


def test_port_conv_op_refuses_a_second_derivative():
    # the kernel's dx carries no graph, so differentiating it again raises
    # instead of silently dropping the conv's share of R1's gradient
    x = torch.randn(2, 3, 16, requires_grad=True)
    w = torch.randn(4, 3, 5, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    gx, = torch.autograd.grad(torch.tanh(conv_ops.conv1d_train(x, w, b)).sum(), x,
                              create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        torch.sum(gx**2).backward()


def test_run_bbh_refuses_r1_under_pallas_before_any_work(tmp_path):
    cfg = twl.BBHConfig(plots=False, out_dir=str(tmp_path / "x"), r1_gamma=1.0,
                        conv_impl="pallas")
    with pytest.raises(ValueError, match="r1_gamma.*pallas"):
        twl.run_bbh(cfg, device="cpu")
    assert not (tmp_path / "x").exists()
