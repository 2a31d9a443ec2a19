"""One CNN update and one GAN update of the port against the JAX package,
from the same (converted) weights on the same numpy-made batch.

Tolerances: losses and metrics at rtol 1e-4 (float32 forward passes in two
libraries); gradients at 1e-3 of their largest entry; weights after one
Adam step at atol = lr, since Adam's first step moves each weight by at
most lr and a gradient that differs near zero can flip a step's sign;
BatchNorm running statistics and the EMA at rtol 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import DualBranchPE as JPE
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.train import cnn as jcnn
from gennet_tpu.train import gan as jgan
from gennet_tpu_torch import convert
from gennet_tpu_torch.models import BBHGenerator, DualBranchPE, PairDiscriminator
from gennet_tpu_torch.train import cnn as tcnn
from gennet_tpu_torch.train import gan as tgan

N = 256
G_FEAT, D_FEAT = (16, 16, 32, 32, 64), (16, 32)


def _sd_close(got: dict, want: dict, atol, rtol=0.0, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# ------------------------------------------------------------------ CNN


@pytest.fixture(scope="module")
def cnn_case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, N, 1)).astype(np.float32)
    y = np.stack([rng.uniform(20, 35, 8), rng.uniform(0.5, 1, 8)], -1).astype(np.float32)
    jcfg = jcnn.CNNConfig(n_pix=N, ema_decay=0.999, lr_decay_steps=10)
    jmodel = JPE()
    jstate = jcnn.init_cnn(jax.random.PRNGKey(0), jmodel, jcfg)
    # jitted: the reference's eager flax apply compiles op by op on the CPU
    jnew, jm = jax.jit(partial(jcnn.cnn_update, model=jmodel, cfg=jcfg))(
        jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1))

    def loss(p):
        return jcnn.L.mse_multi_output(jmodel.apply({"params": p}, jnp.asarray(x)), jnp.asarray(y))

    jgrads = jax.jit(jax.grad(loss))(jstate.params)
    tcfg = tcnn.CNNConfig(n_pix=N, ema_decay=0.999, lr_decay_steps=10)
    tmodel = DualBranchPE(n_pix=N)
    tstate = tcnn.init_cnn(torch.Generator().manual_seed(0), tmodel, tcfg, "cpu")
    tmodel.load_state_dict(convert.flax_to_torch_pe(jax.device_get(jstate.params)))
    tnew, tm = tcnn.cnn_update(tstate, torch.tensor(x), torch.tensor(y), cfg=tcfg)
    return jnew, jm, jgrads, tnew, tm


def test_cnn_update_loss_matches(cnn_case):
    _, jm, _, tnew, tm = cnn_case
    np.testing.assert_allclose(float(tm["pe_loss"]), float(jm["pe_loss"]), rtol=1e-4)
    assert tnew.step == 1


def test_cnn_update_grads_match(cnn_case):
    _, _, jgrads, tnew, _ = cnn_case
    want = convert.flax_to_torch_pe(jax.device_get(jgrads))
    got = {k: p.grad for k, p in tnew.model.named_parameters()}
    for k in want:
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=k)


def test_cnn_update_params_and_ema_match(cnn_case):
    jnew, _, _, tnew, _ = cnn_case
    lr = tcnn.CNNConfig().lr
    _sd_close(dict(tnew.model.named_parameters()),
              convert.flax_to_torch_pe(jax.device_get(jnew.params)), atol=lr)
    _sd_close(tnew.ema, convert.flax_to_torch_pe(jax.device_get(jnew.ema)), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("count", [0, 1, 4, 10, 25])
def test_cosine_decay_matches_optax(count):
    sched = optax.cosine_decay_schedule(9e-5, 10, alpha=0.1)
    np.testing.assert_allclose(9e-5 * tcnn.cosine_decay(10, 0.1)(count), float(sched(count)),
                               rtol=1e-6)


def test_cnn_lr_follows_schedule():
    cfg = tcnn.CNNConfig(n_pix=64, lr_decay_steps=4)
    model = torch.nn.Sequential(torch.nn.Linear(2, 1))
    state = tcnn.CNNState(model=model, opt=tcnn.adam(model.parameters(), cfg.lr, cfg.beta1),
                          sched=None)
    state.sched = torch.optim.lr_scheduler.LambdaLR(state.opt, tcnn.cosine_decay(4, 0.1))
    lrs = []
    for _ in range(5):
        lrs.append(state.opt.param_groups[0]["lr"])
        state.opt.step()
        state.sched.step()
    sched = optax.cosine_decay_schedule(cfg.lr, 4, alpha=0.1)
    np.testing.assert_allclose(lrs, [float(sched(i)) for i in range(5)], rtol=1e-6)


def test_draw_cnn_batch_augments_first_eighth():
    bank = torch.zeros((32, 16))
    targets = torch.arange(64, dtype=torch.float32).reshape(32, 2)
    x, y = tcnn.draw_cnn_batch(torch.Generator().manual_seed(0), bank, targets,
                               tcnn.CNNConfig(n_pix=16, batch_size=16))
    assert x.shape == (16, 16, 1) and y.shape == (16, 2)
    assert float(x[:2].abs().sum()) > 0 and float(x[2:].abs().sum()) == 0.0


# ------------------------------------------------------------------ GAN


def _gan_batch(cfg_b, seed=0):
    rng = np.random.default_rng(seed)
    b = cfg_b
    return {
        "z1": rng.uniform(-1, 1, (b, 100)), "real": rng.normal(size=(b, N)),
        "fresh": rng.normal(size=(b, N)) * 0.5, "in_real": rng.normal(size=(b, N, 2)),
        "in_fake": rng.normal(size=(b, N, 2)), "in_g": rng.normal(size=(1, b, N, 2)),
        "y_real": rng.uniform(0.7, 1.0, b), "y_fake": rng.uniform(0.0, 0.3, b),
        "z3": rng.uniform(-1, 1, (1, b, 100)), "measured": rng.normal(size=N),
    }


def _run_gan(gate):
    kw = dict(n_pix=N, batch_size=4, label_smoothing=True, d_instance_noise=0.3,
              d_lr_scale=0.5, d_acc_gate=0.9)
    jcfg, tcfg = jgan.GANConfig(**kw), tgan.GANConfig(**kw)
    jG, jD = JG(n_out=N, features=G_FEAT, drate=0.0), JD(features=D_FEAT, drate=0.0)
    jstate = jgan.init_gan(jax.random.PRNGKey(0), jG, jD, jcfg)
    nb = {k: v.astype(np.float32) for k, v in _gan_batch(4).items()}
    k = jax.random.PRNGKey(9)
    jb = jgan.GANBatch(z1=nb["z1"], real=nb["real"], fresh=nb["fresh"], in_real=nb["in_real"],
                       in_fake=nb["in_fake"], in_g=nb["in_g"], y_real=nb["y_real"],
                       y_fake=nb["y_fake"], z2=None, z3=nb["z3"], kfake=k, kd=k, kres=k,
                       kg=jax.random.split(k, 2).reshape(1, 2, 2))
    jknobs = jgan.knobs_from_cfg(jcfg).replace(d_acc_gate=jnp.asarray(gate, jnp.float32))
    jnew, jm = jax.jit(partial(jgan.gan_update, generator=jG, discriminator=jD, cfg=jcfg))(
        jstate, jb, jnp.asarray(nb["measured"]), jknobs)

    tG = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0)
    tD = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=N)
    tstate = tgan.init_gan(torch.Generator().manual_seed(0), tG, tD, tcfg, "cpu")
    tG.load_state_dict(convert.flax_to_torch_generator(jax.device_get(jstate.g_params),
                                                       jax.device_get(jstate.g_stats)))
    tD.load_state_dict(convert.flax_to_torch_discriminator(jax.device_get(jstate.d_params)))
    d_before = {k: v.clone() for k, v in tD.state_dict().items()}
    t = {k: torch.tensor(v) for k, v in nb.items()}
    tb = tgan.GANBatch(z1=t["z1"], real=t["real"], fresh=t["fresh"], in_real=t["in_real"],
                       in_fake=t["in_fake"], in_g=t["in_g"], y_real=t["y_real"],
                       y_fake=t["y_fake"], z3=t["z3"])
    tknobs = tgan.knobs_from_cfg(tcfg)
    tknobs.d_acc_gate = gate
    tnew, tm = tgan.gan_update(tstate, tb, t["measured"], tknobs, cfg=tcfg)
    return jnew, jm, tnew, tm, d_before, tcfg


@pytest.fixture(scope="module", params=[0.9, 0.25], ids=["gate_open", "gate_closed"])
def gan_case(request):
    return request.param, _run_gan(request.param)


def test_gan_update_metrics_match(gan_case):
    gate, (_, jm, _, tm, _, _) = gan_case
    for k in ("d_loss", "d_acc", "g_loss", "g_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    # the two parametrisations really exercise both sides of the gate
    assert (float(tm["d_acc"]) < gate) == (gate == 0.9)


def test_gan_update_discriminator_matches(gan_case):
    gate, (jnew, _, tnew, _, d_before, cfg) = gan_case
    got = tnew.discriminator.state_dict()
    _sd_close(got, convert.flax_to_torch_discriminator(jax.device_get(jnew.d_params)),
              atol=cfg.lr * cfg.d_lr_scale)
    if gate == 0.25:
        # a closed gate holds back D and its Adam state: optax's state right
        # after init, every moment zero and every count 0
        for k, v in got.items():
            assert torch.equal(v, d_before[k]), k
        for s in tnew.d_opt.state.values():
            assert int(s["step"]) == 0
            assert not s["exp_avg"].any() and not s["exp_avg_sq"].any()
    else:
        assert any(not torch.equal(v, d_before[k]) for k, v in got.items())
        assert all(int(s["step"]) == 1 for s in tnew.d_opt.state.values())


def test_gan_update_generator_and_bn_stats_match(gan_case):
    _, (jnew, _, tnew, _, _, cfg) = gan_case
    want = convert.flax_to_torch_generator(jax.device_get(jnew.g_params),
                                           jax.device_get(jnew.g_stats))
    got = tnew.generator.state_dict()
    # A bias that feeds a BatchNorm has an exactly zero gradient (BN removes
    # the batch mean), so both packages step it by lr·sign(rounding noise):
    # two such steps differ by up to 2·lr. Every other weight is held to lr.
    pre_bn = [k for k in want if k == "dense.bias" or (k.startswith("convs.") and k.endswith("bias"))]
    params = [k for k in want if "running" not in k and k not in pre_bn]
    stats = [k for k in want if "running" in k]
    _sd_close(got, want, atol=cfg.lr, keys=params)
    _sd_close(got, want, atol=2 * cfg.lr, keys=pre_bn)
    # exactly one running-stat update per iteration, from the G step
    _sd_close(got, want, atol=1e-6, rtol=1e-5, keys=stats)
    assert tnew.step == 1


def test_sample_generator_eval_mode_matches():
    cfg = tgan.GANConfig(n_pix=N)
    jG = JG(n_out=N, features=G_FEAT)
    v = jG.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                jnp.zeros((1, 100)), train=False)
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.1, v["batch_stats"])
    tG = BBHGenerator(n_out=N, features=G_FEAT)
    tD = PairDiscriminator(features=D_FEAT, n_pix=N)
    state = tgan.init_gan(torch.Generator().manual_seed(0), tG, tD, cfg, "cpu")
    tG.load_state_dict(convert.flax_to_torch_generator(jax.device_get(v["params"]), stats))
    out = tgan.sample_generator(tG, state, torch.Generator().manual_seed(3), 5, cfg, chunk=8)
    assert out.shape == (5, N)
    # the latents sample_generator drew: the first uniform draw of the seed
    z = -1.0 + 2.0 * torch.rand((8, 100), generator=torch.Generator().manual_seed(3))
    ref = jG.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(z.numpy()),
                   train=False)
    ref = np.asarray(ref).reshape(8, N)[:5]
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


# ---------------------------------------------------- checkpoints, metrics


def test_checkpoint_manager_saves_full_state_and_rotates(tmp_path):
    from gennet_tpu_torch.train.checkpoints import CheckpointManager

    cfg = tcnn.CNNConfig(n_pix=64, ema_decay=0.9, lr_decay_steps=5)
    state = tcnn.init_cnn(torch.Generator().manual_seed(0), DualBranchPE(n_pix=64), cfg, "cpu")
    state, _ = tcnn.cnn_update(state, torch.randn(8, 64, 1), torch.rand(8, 2), cfg=cfg)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.all_steps() == [2, 3]
    payload = torch.load(tmp_path / "ck" / "ckpt_3.pt", weights_only=False)
    assert payload["step"] == 3 and payload["state"]["step"] == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(payload["state"]["model"][k], v), k
    assert payload["state"]["opt"]["state"]          # Adam moments and count
    assert set(payload["state"]["ema"]) == set(dict(state.model.named_parameters()))


def test_metrics_jsonl_matches_reference_schema(tmp_path):
    from gennet_tpu.train.metrics import MetricLogger as JLog
    from gennet_tpu_torch.train.metrics import MetricLogger, fetch_metrics

    m = fetch_metrics({"d_loss": torch.tensor(0.5), "d_acc": torch.tensor(0.75)})
    assert m == {"d_loss": 0.5, "d_acc": 0.75}
    for cls, d in ((MetricLogger, tmp_path / "t"), (JLog, tmp_path / "j")):
        log = cls(str(d), "bbh")
        log.log(10, m)
        log.close()
    assert (tmp_path / "t" / "bbh_metrics.jsonl").read_bytes() == \
        (tmp_path / "j" / "bbh_metrics.jsonl").read_bytes()
    assert MetricLogger().status_line(10, m) == JLog().status_line(10, m)


def test_posterior_snapshot_matches_reference_format(tmp_path):
    from gennet_tpu.train.checkpoints import load_posterior_snapshot
    from gennet_tpu_torch.train.checkpoints import save_posterior_snapshot

    s = np.random.default_rng(0).normal(size=(40, 2))
    p = save_posterior_snapshot(str(tmp_path), 1000, s)
    assert p.endswith("posterior_samples_01000.npz")
    np.testing.assert_array_equal(load_posterior_snapshot(p), s)
