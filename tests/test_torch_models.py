"""Networks of the port against the flax modules, with flax weights
converted by ``gennet_tpu_torch.convert``.

Sizes: G at n_out 256 with features (16, 16, 32, 32, 64), D with features
(16, 32), the PE at its fixed widths at n_pix 256; batch 6. Every weight
and BatchNorm statistic is perturbed away from its init so each one
matters. Tolerance: atol 1e-4·max|ref| (float32 convolutions sum in other
orders in XLA and in PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import CombinedPE as JCPE
from gennet_tpu.models import DualBranchPE as JPE
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu_torch import convert
from gennet_tpu_torch.models import BBHGenerator, CombinedPE, DualBranchPE, PairDiscriminator
from gennet_tpu_torch.models.layers import Conv1d

N, B = 256, 6
G_FEAT, D_FEAT = (16, 16, 32, 32, 64), (16, 32)


def _perturb(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.normal(size=np.shape(x)).astype(np.float32), tree)


def _close(out, ref, tol=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), np.abs(out - ref).max()


@pytest.fixture(scope="module")
def gen_pair():
    jg = JG(n_out=N, features=G_FEAT, drate=0.0)
    z = np.random.default_rng(0).uniform(-1, 1, (B, 100)).astype(np.float32)
    v = jg.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                jnp.asarray(z), train=False)
    params = _perturb(v["params"], 1)
    stats = jax.tree_util.tree_map(lambda x: np.abs(x) + 0.5, _perturb(v["batch_stats"], 2, 0.3))
    tg = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0)
    tg.load_state_dict(convert.flax_to_torch_generator(params, stats))
    return jg, params, stats, tg, z


def test_generator_eval_matches(gen_pair):
    jg, params, stats, tg, z = gen_pair
    ref = jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(z), train=False)
    with torch.no_grad():
        out = tg(torch.tensor(z), train=False)
    assert out.shape == (B, N, 1)
    _close(out, ref)


def test_generator_train_matches_and_commits_flax_stats(gen_pair):
    # batch-statistics BN (drate 0, so train mode is deterministic); the
    # running averages must take flax's update: momentum 0.99 and the
    # BIASED batch variance
    jg, params, stats, _, z = gen_pair
    tg = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0)
    tg.load_state_dict(convert.flax_to_torch_generator(params, stats))
    ref, mut = jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(z), train=True,
                        mutable=["batch_stats"])
    with torch.no_grad():
        out = tg(torch.tensor(z), train=True, commit_stats=True)
    _close(out, ref)
    want = convert.flax_to_torch_generator(params, jax.device_get(mut["batch_stats"]))
    got = tg.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_generator_batch_mode_without_commit_keeps_stats(gen_pair):
    _, _, _, tg, z = gen_pair
    before = {k: v.clone() for k, v in tg.state_dict().items()}
    with torch.no_grad():
        tg(torch.tensor(z), train=True, bn_train=True)
    for k, v in tg.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_generator_dropout_uses_the_given_generator(gen_pair):
    _, params, stats, _, z = gen_pair
    tg = BBHGenerator(n_out=N, features=G_FEAT, drate=0.2)
    tg.load_state_dict(convert.flax_to_torch_generator(params, stats))
    with torch.no_grad():
        a = tg(torch.tensor(z), train=True, gen=torch.Generator().manual_seed(4))
        b = tg(torch.tensor(z), train=True, gen=torch.Generator().manual_seed(4))
        c = tg(torch.tensor(z), train=True, gen=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        tg(torch.tensor(z), train=True)


@pytest.mark.parametrize("train", [False, True])
def test_discriminator_matches(train):
    jd = JD(features=D_FEAT, drate=0.0)
    x = np.random.default_rng(3).normal(size=(B, N, 2)).astype(np.float32)
    params = _perturb(jd.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"], 4)
    ref = jd.apply({"params": params}, jnp.asarray(x), train=train,
                   rngs={"dropout": jax.random.PRNGKey(0)})
    td = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=N)
    td.load_state_dict(convert.flax_to_torch_discriminator(params))
    with torch.no_grad():
        out = td(torch.tensor(x), train=train)
    assert out.shape == (B, 1)
    _close(out, ref)


def test_pe_matches():
    jp = JPE()
    x = np.random.default_rng(5).normal(size=(B, N, 1)).astype(np.float32)
    params = _perturb(jp.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 6, 0.02)
    ref = jp.apply({"params": params}, jnp.asarray(x))
    tp = DualBranchPE(n_pix=N)
    tp.load_state_dict(convert.flax_to_torch_pe(params))
    with torch.no_grad():
        out = tp(torch.tensor(x))
    assert out.shape == (B, 2)
    _close(out, ref)


@pytest.mark.parametrize("L,stride,padding", [(256, 2, "SAME"), (255, 2, "SAME"),
                                              (256, 1, "SAME"), (256, 2, "VALID"),
                                              (251, 1, "VALID")])
def test_conv_padding_alignment(L, stride, padding):
    # flax SAME at stride 2 pads (1, 2) for K = 5 and even L; a symmetric
    # padding=2 would shift every output by one sample
    x = np.random.default_rng(7).normal(size=(2, L, 3)).astype(np.float32)
    jc = fnn.Conv(4, (5,), strides=(stride,), padding=padding)
    p = _perturb(jc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 8)
    ref = jc.apply({"params": p}, jnp.asarray(x))
    tc = Conv1d(3, 4, 5, stride=stride, padding=padding)
    tc.load_state_dict({"weight": torch.tensor(np.asarray(p["kernel"]).transpose(2, 1, 0).copy()),
                        "bias": torch.tensor(np.asarray(p["bias"]))})
    with torch.no_grad():
        out = tc(torch.tensor(x).transpose(1, 2)).transpose(1, 2)
    _close(out, ref, 1e-5)


def test_init_is_flax_lecun_normal():
    from gennet_tpu_torch.models.layers import reset_module

    td = reset_module(PairDiscriminator(n_pix=N), torch.Generator().manual_seed(0))
    jd = JD()
    jp = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, N, 2)))["params"]
    for name, w, fan_in, jk in (("convs.1", td.convs[1].weight, 256 * 5, jp["Conv_1"]["kernel"]),
                                ("dense", td.dense.weight, td.dense.in_features,
                                 jp["Dense_0"]["kernel"])):
        w = w.detach().numpy()
        std = 1.0 / np.sqrt(fan_in)
        assert abs(w.std() / std - 1.0) < 0.03, name
        assert np.abs(w).max() <= 2.0 * std / 0.8796 + 1e-6, name   # truncated at ±2σ
        assert abs(w.std() / np.asarray(jk).std() - 1.0) < 0.03, name
    assert torch.count_nonzero(td.convs[1].bias) == 0 and torch.count_nonzero(td.dense.bias) == 0


def test_init_reproducible_from_generator():
    from gennet_tpu_torch.models.layers import reset_module

    a = reset_module(BBHGenerator(n_out=64, features=G_FEAT), torch.Generator().manual_seed(1))
    b = reset_module(BBHGenerator(n_out=64, features=G_FEAT), torch.Generator().manual_seed(1))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k


# ---- BBHGenerator(norm="group" | "none") and CombinedPE (the options
# --g-norm and --comb-pe-model); the same tolerance

@pytest.mark.parametrize("norm", ["group", "none"])
@pytest.mark.parametrize("train", [False, True])
def test_generator_norm_variants_match(norm, train):
    # GroupNorm (groups of 16, eps 1e-6) is batch-independent: train mode
    # differs from eval mode only by dropout, here off (drate 0)
    jg = JG(n_out=N, features=G_FEAT, drate=0.0, norm=norm)
    z = np.random.default_rng(9).uniform(-1, 1, (B, 100)).astype(np.float32)
    params = _perturb(jg.init({"params": jax.random.PRNGKey(4)}, jnp.asarray(z))["params"], 10)
    ref = jg.apply({"params": params}, jnp.asarray(z), train=train)
    tg = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0, norm=norm)
    sd = convert.flax_to_torch_generator(params)
    assert set(sd) == set(tg.state_dict())  # GroupNorm scale/bias → weight/bias; none: no norm
    tg.load_state_dict(sd)
    with torch.no_grad():
        out = tg(torch.tensor(z), train=train, commit_stats=train)
    _close(out, ref)
    assert not list(tg.buffers())  # nothing batch-dependent to carry


def test_generator_refuses_an_unknown_norm():
    # the reference's module runs any other string as "none"
    with pytest.raises(ValueError, match="norm"):
        BBHGenerator(n_out=N, features=G_FEAT, norm="grp")


def test_posterior_sampler_clone_needs_the_same_norm():
    # run_bbh's posterior_drate sampler runs the state's weights through a
    # second G: built with another norm it silently reads its own BN
    # buffers, so it must be built with cfg.g_norm (workloads.py:1451-1453)
    z = torch.tensor(np.random.default_rng(11).uniform(-1, 1, (4, 100)).astype(np.float32))
    G = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0, norm="group")
    weights = dict(G.named_parameters())
    with torch.no_grad():
        ref = G(z)
        same = torch.func.functional_call(
            BBHGenerator(n_out=N, features=G_FEAT, drate=0.3, norm="group"), weights, (z,))
        other = torch.func.functional_call(
            BBHGenerator(n_out=N, features=G_FEAT, drate=0.3, norm="batch"), weights, (z,))
    assert torch.equal(same, ref)
    assert not torch.allclose(other, ref, atol=1e-3)


@pytest.fixture(scope="module")
def combined_pair():
    jp = JCPE()
    x = np.random.default_rng(12).normal(size=(B, N, 1)).astype(np.float32)
    v = jp.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                jnp.asarray(x))
    params = _perturb(v["params"], 13, 0.02)
    stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, _perturb(v["batch_stats"], 14, 0.3))
    return jp, params, stats, x


def _combined(params, stats):
    tp = CombinedPE(n_pix=N)
    tp.load_state_dict(convert.flax_to_torch_combined_pe(params, stats))
    return tp


def test_combined_pe_eval_matches(combined_pair):
    jp, params, stats, x = combined_pair
    ref = jp.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = _combined(params, stats)(torch.tensor(x))
    assert out.shape == (B, 2)
    _close(out, ref)


def test_combined_pe_train_matches_and_commits_flax_stats(combined_pair, monkeypatch):
    # train mode: batch statistics, committed with momentum 0.9 as the JAX
    # cnn_update does; the Dropout(0.5) masks differ between the packages'
    # generators, so both are switched off here (and checked below)
    jp, params, stats, x = combined_pair
    import gennet_tpu_torch.models.cnn_pe as tpe

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, y, *a, **k: y)
    monkeypatch.setattr(tpe, "dropout", lambda y, rate, active, gen: y)
    ref, mut = jp.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    tp = _combined(params, stats)
    with torch.no_grad():
        out = tp(torch.tensor(x), train=True)
    _close(out, ref)
    want = convert.flax_to_torch_combined_pe(params, jax.device_get(mut["batch_stats"]))
    for k, v in tp.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_combined_pe_dropout_and_init(combined_pair):
    _, params, stats, x = combined_pair
    tp = _combined(params, stats)
    xt = torch.tensor(x)
    with torch.no_grad():
        a = tp(xt, train=True, gen=torch.Generator().manual_seed(1))
        tp.load_state_dict(convert.flax_to_torch_combined_pe(params, stats))
        b = tp(xt, train=True, gen=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tp(xt, train=True)  # dropout is active: it needs a generator
    from gennet_tpu_torch.models.layers import reset_module

    fresh = reset_module(CombinedPE(n_pix=N), torch.Generator().manual_seed(0))
    assert all(float(p.negative_slope.detach()) == pytest.approx(0.01) for p in fresh.prelus)
