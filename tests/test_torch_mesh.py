"""The port's data parallelism (``gennet_tpu_torch.train.mesh``) against the
JAX package's ``shard_map`` steps on the CPU.

- A world of 2 over gloo (spawned ranks, tests/torch_dp_worker.py) against
  ``make_gan_step`` / ``make_cnn_step`` with ``mesh=data_mesh(2)``: the GAN
  step with the reference test's recipe (pair D, residual route, label
  smoothing, instance noise 0.3, d_acc gate 0.9, 2 G steps, d_lr_scale 0.5,
  tests/test_train.py:143-148) and a batch-norm G; the CNN step with a
  batch-norm PE. Each rank is fed JAX's per-device draws, as
  tests/test_train.py:159-166,201-208 builds them, so the per-shard batch
  statistics and the averaged running statistics are both compared.
  Tolerances: the JAX test's own for the metrics (rtol 1e-5, atol 1e-6)
  and for the weights, running statistics and Adam moments (rtol 1e-4,
  atol 1e-6), with one allowance the JAX test (JAX against JAX) does not
  need: Adam normalises each gradient entry (its first step moves a weight
  by lr·m̂/(√v̂ + ε) ≈ ±lr), so an entry whose gradient is within float32
  noise of zero may step differently in the two libraries. At most 1 in
  10⁴ entries of a tensor may then differ, by at most lr per Adam step
  taken (three for G here); so may every entry of a bias that feeds a
  BatchNorm, whose gradient is zero but for rounding, and the running
  means take that bias in with weight 1 − momentum at each of the step's
  three commits (so within 3 · 0.01 · 3·lr). Adam's moments are compared
  as totals per optimiser. Both ranks must hold bitwise-equal states.
- A world of 1 equals the plain step bit for bit.
- ``gan_real_bank``'s round-up against the JAX function for 2, 4 and 8
  devices; the refusal of rows that do not divide, beside JAX's
  ``shard_map`` refusing the same rows.
- A broadcast moves each tensor's version counter, so the conv kernel's
  weight-pack cache makes a new pack.
- Each rank's device: ``cuda:LOCAL_RANK`` under torchrun, where a device
  naming another card is refused (every rank would pin that card).
"""

from dataclasses import asdict

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_worker as W
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.cli import workloads as jwl
from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.train import cnn as jcnn
from gennet_tpu.train import gan as jgan
from gennet_tpu.train.mesh import data_mesh
from gennet_tpu_torch import convert
from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.ops import tf32
from gennet_tpu_torch.train import cnn as tcnn
from gennet_tpu_torch.train import gan as tgan
from gennet_tpu_torch.train import mesh as tmesh

N = 64
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHT_TOL = dict(rtol=1e-4, atol=1e-6)
GAN_KW = dict(n_pix=N, batch_size=4, pair_discriminator=True, residual_route=True, n_sig=0.25,
              lr=2e-4, label_smoothing=True, d_instance_noise=0.3, d_acc_gate=0.9,
              g_steps_per_iter=2, d_lr_scale=0.5)
CNN_KW = dict(n_pix=N, batch_size=4, noise_frac=0.25)


class JBNPE(fnn.Module):
    """The flax twin of tests/torch_dp_worker.py's ``BNPE``."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jnp.tanh(fnn.Conv(8, (5,), strides=(2,), padding="SAME")(x))
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        return fnn.Dense(2)(x.reshape(x.shape[0], -1))


def _pe_sd(params, stats) -> dict:
    return {**convert._conv(params["Conv_0"], "conv"), **convert._dense(params["Dense_0"], "dense"),
            **convert._bn(params["BatchNorm_0"], stats["BatchNorm_0"], "bn")}


def _np_batch(b) -> dict:
    keys = ("z1", "real", "fresh", "in_real", "in_fake", "in_g", "y_real", "y_fake", "z3", "z2")
    return {k: None if getattr(b, k) is None else np.asarray(getattr(b, k), np.float32)
            for k in keys}


@pytest.fixture(scope="module")
def jax_dp():
    """The JAX package's 2-device steps and the per-device draws they made."""
    n_dev = 2
    jcfg = jgan.GANConfig(**GAN_KW)
    G, D = JG(n_out=N, features=W.G_FEAT, drate=0.0), JD(features=W.D_FEAT, drate=0.0)
    state = jgan.init_gan(jax.random.PRNGKey(0), G, D, jcfg)
    bank = jax.random.normal(jax.random.PRNGKey(1), (16, N))
    measured = jax.random.normal(jax.random.PRNGKey(2), (N,))
    key = jax.random.PRNGKey(5)
    s_dp, m_dp = jgan.make_gan_step(G, D, jcfg, mesh=data_mesh(n_dev))(state, bank, measured, key)
    shards = bank.reshape(n_dev, -1, N)
    gan_case = {
        "cfg": asdict(tgan.GANConfig(**GAN_KW)),
        "g_sd": convert.flax_to_torch_generator(jax.device_get(state.g_params),
                                                jax.device_get(state.g_stats)),
        "d_sd": convert.flax_to_torch_discriminator(jax.device_get(state.d_params)),
        "batches": [_np_batch(jgan.draw_gan_batch(jax.random.fold_in(key, d), shards[d], jcfg))
                    for d in range(n_dev)],
        "measured": np.asarray(measured),
    }
    gan_ref = {"metrics": {k: float(v) for k, v in m_dp.items()},
               "g": convert.flax_to_torch_generator(jax.device_get(s_dp.g_params),
                                                    jax.device_get(s_dp.g_stats)),
               "d": convert.flax_to_torch_discriminator(jax.device_get(s_dp.d_params)),
               "opt": s_dp}

    ccfg = jcnn.CNNConfig(**CNN_KW)
    pe = JBNPE()
    cstate = jcnn.init_cnn(jax.random.PRNGKey(0), pe, ccfg)
    rng = np.random.default_rng(3)
    cbank = jnp.asarray(rng.normal(size=(16, N)), jnp.float32)
    pars = jnp.asarray(rng.uniform(size=(16, 2)), jnp.float32)
    ckey = jax.random.PRNGKey(9)
    cs_dp, cm_dp = jcnn.make_cnn_step(pe, ccfg, mesh=data_mesh(n_dev))(cstate, cbank, pars, ckey)
    bank_sh, pars_sh = cbank.reshape(n_dev, -1, N), pars.reshape(n_dev, -1, 2)
    batches = []
    for d in range(n_dev):
        x, y, _ = jcnn.draw_cnn_batch(jax.random.fold_in(ckey, d), bank_sh[d], pars_sh[d], ccfg)
        batches.append((np.asarray(x), np.asarray(y)))
    cnn_case = {"cfg": asdict(tcnn.CNNConfig(**CNN_KW)),
                "sd": _pe_sd(jax.device_get(cstate.params), jax.device_get(cstate.stats)),
                "batches": batches}
    cnn_ref = {"pe_loss": float(cm_dp["pe_loss"]),
               "sd": _pe_sd(jax.device_get(cs_dp.params), jax.device_get(cs_dp.stats)),
               "opt": cs_dp}
    return gan_case, gan_ref, cnn_case, cnn_ref


@pytest.fixture(scope="module")
def world2(jax_dp, tmp_path_factory):
    gan_case, _, cnn_case, _ = jax_dp
    return W.spawn(W.gan_and_cnn_updates, 2, tmp_path_factory.mktemp("w2"), gan_case, cnn_case,
                   N)


def _g_noise(key: str, lr: float) -> float:
    """The bound on G's entries that rounding decides (see the docstring):
    the biases that feed a BatchNorm (the Dense and every conv but the
    output conv) and the running means that take them in; 0 elsewhere."""
    if key == "dense.bias" or (key.startswith("convs.") and key.endswith(".bias")):
        return 3 * lr
    return 3 * 0.01 * 3 * lr if key.endswith("running_mean") else 0.0


def _close_sd(got: dict, want: dict, what: str, step_bound: float = 0.0,
              noise=lambda k: 0.0):
    """WEIGHT_TOL on every entry, but for at most 1 in 10⁴ entries of a
    tensor that may differ by up to ``step_bound``, and every entry of a
    key with a ``noise`` bound by up to that (see the docstring)."""
    assert got.keys() >= want.keys(), what
    for k, v in want.items():
        a, b = got[k], v.numpy()
        if noise(k):
            np.testing.assert_allclose(a, b, rtol=0, atol=noise(k), err_msg=f"{what} {k}")
            continue
        off = ~np.isclose(a, b, **WEIGHT_TOL)
        assert off.sum() <= a.size // 10_000, f"{what} {k}: {off.sum()} of {a.size} off"
        np.testing.assert_allclose(a, b, rtol=0, atol=max(step_bound, WEIGHT_TOL["atol"]),
                                   err_msg=f"{what} {k}")


def test_gan_dp_step_matches_jax_data_mesh(jax_dp, world2):
    _, ref, _, _ = jax_dp
    out = world2[0][0]
    for k in ("d_loss", "d_acc", "g_loss", "g_acc", "res_loss"):
        np.testing.assert_allclose(out["metrics"][k], ref["metrics"][k], err_msg=k, **METRIC_TOL)
    # the G weights and the running statistics averaged over the two
    # shards; G took three Adam steps (the residual route and 2 G steps), D one
    lr = GAN_KW["lr"]
    _close_sd(out["g"], ref["g"], "G", 3 * lr, noise=lambda k: _g_noise(k, lr))
    _close_sd(out["d"], ref["d"], "D", lr * GAN_KW["d_lr_scale"])


def test_gan_dp_adam_moments_match_jax(jax_dp, world2):
    _, ref, _, _ = jax_dp
    s = ref["opt"]
    # D's gate opened (its moments exist) and the two G routes stepped
    assert float(ref["metrics"]["d_acc"]) < 0.9
    for name, opt, got in zip(("G", "D", "G residual"), (s.g_opt, s.d_opt, s.g_res_opt),
                              world2[0][0]["opt"]):
        adam = opt[0] if isinstance(opt, tuple) else opt
        want = [sum(float(np.abs(np.asarray(x)).sum()) for x in jax.tree_util.tree_leaves(t))
                for t in (adam.mu, adam.nu)]
        # torch's per-parameter state: exp_avg, exp_avg_sq, step
        have = [sum(float(np.abs(a).sum()) for a in got[i::3]) for i in (0, 1)]
        np.testing.assert_allclose(have, want, rtol=1e-4, err_msg=name)


def test_cnn_dp_step_matches_jax_data_mesh(jax_dp, world2):
    _, _, _, ref = jax_dp
    out = world2[0][1]
    np.testing.assert_allclose(out["pe_loss"], ref["pe_loss"], **METRIC_TOL)
    _close_sd(out["sd"], ref["sd"], "PE", tcnn.CNNConfig().lr)


@pytest.mark.parametrize("part", ["gan", "cnn"])
def test_dp_ranks_hold_bitwise_equal_states(world2, part):
    a, b = (r[0] if part == "gan" else r[1] for r in world2)
    for key in ("g", "d") if part == "gan" else ("sd",):
        for k in a[key]:
            np.testing.assert_array_equal(a[key][k], b[key][k], err_msg=f"{key} {k}")
    flat = [sum(o, []) if part == "gan" else o for o in (a["opt"], b["opt"])]
    assert len(flat[0]) == len(flat[1])
    for x, y in zip(*flat):
        np.testing.assert_array_equal(x, y)


@pytest.fixture
def world1():
    mesh = tmesh.init_data_mesh("cpu")
    yield mesh
    mesh.close()


def test_world1_gan_and_cnn_steps_equal_the_plain_steps_bitwise(world1):
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator

    cfg = tgan.GANConfig(**GAN_KW)
    bank = torch.randn((16, N), generator=torch.Generator().manual_seed(1))
    measured = torch.randn(N, generator=torch.Generator().manual_seed(2))
    states, metrics = [], []
    for mesh in (None, world1):
        st = tgan.init_gan(torch.Generator().manual_seed(0),
                           BBHGenerator(n_out=N, features=W.G_FEAT),
                           PairDiscriminator(features=W.D_FEAT, n_pix=N), cfg, "cpu")
        gen = torch.Generator().manual_seed(7)
        for _ in range(3):
            st, m = tgan.gan_step(st, bank, measured, gen, cfg=cfg, mesh=mesh)
        pe = tcnn.init_cnn(torch.Generator().manual_seed(0), W.BNPE(N),
                           tcnn.CNNConfig(**CNN_KW, ema_decay=0.9), "cpu")
        for _ in range(3):
            pe, cm = tcnn.cnn_step(pe, bank, bank[:, :2], gen, cfg=tcnn.CNNConfig(**CNN_KW,
                                                                                  ema_decay=0.9),
                                   mesh=mesh)
        states.append(W.state_digest(st.generator, st.discriminator, pe.model)
                      + W.opt_digest(st.g_opt, st.d_opt, st.g_res_opt, pe.opt)
                      + [v.numpy() for v in pe.ema.values()])
        metrics.append({**{k: float(v) for k, v in m.items()}, "pe_loss": float(cm["pe_loss"])})
    assert metrics[0] == metrics[1]
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_gan_real_bank_rounds_up_as_the_reference(n_dev):
    bank, signal = np.zeros((24, 16), np.float32), np.ones((16,), np.float32)
    for boost in (1, 3, 8):
        want = jwl.gan_real_bank(jwl.BBHConfig(twin_boost=boost), jnp.asarray(bank),
                                 jnp.asarray(signal), mesh=data_mesh(n_dev))
        mesh = tmesh.DataMesh(world=n_dev, rank=0, device=torch.device("cpu"), backend="gloo")
        got = twl.gan_real_bank(twl.BBHConfig(twin_boost=boost), torch.tensor(bank),
                                torch.tensor(signal), mesh)
        assert got.shape == want.shape and got.shape[0] % n_dev == 0
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rows_that_do_not_divide_are_refused_as_in_the_reference():
    jcfg = jgan.GANConfig(**GAN_KW)
    G, D = JG(n_out=N, features=W.G_FEAT, drate=0.0), JD(features=W.D_FEAT, drate=0.0)
    state = jgan.init_gan(jax.random.PRNGKey(0), G, D, jcfg)
    odd = jnp.zeros((7, N))
    with pytest.raises(ValueError, match="divisible"):
        jgan.make_gan_step(G, D, jcfg, mesh=data_mesh(2))(state, odd, jnp.zeros((N,)),
                                                          jax.random.PRNGKey(0))
    mesh = tmesh.DataMesh(world=2, rank=1, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match=r"7 rows.*world of 2.*shard_map"):
        mesh.shard_rows(torch.zeros((7, N)))
    np.testing.assert_array_equal(mesh.shard_rows(torch.arange(8.0)).numpy(), [4, 5, 6, 7])


def test_rank_streams():
    assert tmesh.rank_seed(5, 0) == 5
    seeds = {tmesh.rank_seed(5, r) for r in range(8)}
    assert len(seeds) == 8 and all(0 <= s < 2**32 for s in seeds)
    a = tmesh.rank_generator(5, 0, "cpu")
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=torch.Generator()
                                                               .manual_seed(5)))


def test_broadcast_renews_the_weight_pack(world1):
    w = torch.nn.Parameter(torch.randn(8, 4, 5))
    packs = []
    pack = tf32.cached_pack("test", (w,), lambda: packs.append(w.detach().clone()) or len(packs))
    assert tf32.cached_pack("test", (w,), lambda: -1) == pack  # a hit while unchanged
    version = w._version
    world1.broadcast_([w])
    assert w._version > version
    assert tf32.cached_pack("test", (w,), lambda: "new") == "new"
    assert len(tmesh.running_stats(W.BNPE(N))) == 2  # mean and var, no step count


@pytest.mark.parametrize("device,local,torchrun,want", [
    ("cuda", 3, True, "cuda:3"),        # torchrun: each rank on its own card
    ("cuda:1", 1, True, "cuda:1"),      # the rank's own card, named
    ("cuda:0", 1, True, ValueError),    # every rank would pin card 0
    ("cuda", 0, False, "cuda:0"),       # a world of 1 in this process
    ("cuda:2", 0, False, "cuda:2"),     # a library caller's card
    ("cpu", 2, True, "cpu"),
])
def test_rank_device(device, local, torchrun, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="LOCAL_RANK 1 runs on cuda:1"):
            tmesh.rank_device(device, local, torchrun)
    else:
        assert tmesh.rank_device(device, local, torchrun) == torch.device(want)
