"""The conv1d op and the ``conv_impl="pallas"`` models: the port's plain
path against the JAX Pallas kernel (interpret mode, as
tests/test_pallas_ops.py runs it), the differentiable op's gradients
against ``jax.grad`` of ``conv1d_train``, the models under both conv
implementations, and (on a CUDA card only) the kernel against the plain
version. JAX is imported inside the comparisons, so on the card (no JAX
there) the file runs with ``pytest --noconftest -m gpu``.

Tolerances: rtol/atol 2e-4 for the op and the models (test_pallas_ops.py's
values: float32 sums of Cin·K terms in other orders); gradients scaled by
their max, rtol 1e-3 / atol 1e-4 (test_pallas_ops.py:155-160); "pallas" vs
"xla" inside the port 1e-4·max (the same plain convolution, summed in
other orders on the two paths); the kernel on the card 1e-4·max against
plain and 1e-5·max against float64.
"""

import numpy as np
import pytest
import torch

from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
from gennet_tpu_torch.models.layers import Conv1d, PallasConv1d, conv1d_layer
from gennet_tpu_torch.ops import conv1d as C


def _jax():
    """(jax, jax.numpy, gennet_tpu.ops.pallas_conv1d)."""
    jax = pytest.importorskip("jax")
    from gennet_tpu.ops import pallas_conv1d

    return jax, jax.numpy, pallas_conv1d


def _inputs(B, L, Cin, Cout, K, seed, wscale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, Cin)).astype(np.float32)
    w = (rng.normal(size=(K, Cin, Cout)) * wscale).astype(np.float32)   # flax (K, Cin, Cout)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    return x, w, b


def _port(x, w, b):
    """(B, L, C) / (K, Cin, Cout) numpy → the port's (B, C, L) / (Cout, Cin, K) tensors."""
    return (torch.tensor(x.transpose(0, 2, 1).copy()), torch.tensor(w.transpose(2, 1, 0).copy()),
            torch.tensor(b))


@pytest.mark.parametrize("B,L,Cin,Cout,K,stride,act", [
    (2, 64, 16, 256, 5, 1, "none"),
    (2, 64, 8, 128, 5, 2, "none"),
    (2, 64, 8, 128, 5, 1, "tanh"),
    (2, 64, 8, 128, 5, 1, "leaky_relu"),
    (2, 64, 8, 128, 5, 1, "relu"),
    (1, 48, 4, 96, 3, 1, "none"),      # ragged L and Cout
    (3, 50, 2, 24, 5, 2, "leaky_relu"),  # D Conv_0's Cin = 2, odd batch, ragged stride-2 length
    (2, 255, 8, 16, 5, 2, "tanh"),     # odd L at stride 2
])
def test_conv1d_matches_pallas_interpret(B, L, Cin, Cout, K, stride, act):
    _, jnp, jc = _jax()
    x, w, b = _inputs(B, L, Cin, Cout, K, seed=L + Cin)
    ref = np.asarray(jc.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                               act=act, bl=32, bc=128, interpret=True))
    out = C.conv1d(*_port(x, w, b), stride=stride, act=act).numpy().transpose(0, 2, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_conv1d_train_grads_match_jax():
    jax, jnp, jc = _jax()
    x, w, b = _inputs(2, 32, 8, 128, 5, seed=5)

    def loss_j(x, w, b):
        y = jc.conv1d_train(x, w, b, 32, 128, True)
        return jnp.sum(jnp.sin(y) * y)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (t.requires_grad_() for t in _port(x, w, b))
    y = C.conv1d_train(xt, wt, bt)
    assert type(y.grad_fn).__name__ == "Conv1dTrainBackward"
    torch.sum(torch.sin(y) * y).backward()
    got = (xt.grad.numpy().transpose(0, 2, 1), wt.grad.numpy().transpose(2, 1, 0), bt.grad.numpy())
    for name, a, r in zip(("dx", "dw", "db"), got, g_j):
        scale = np.abs(np.asarray(r)).max() + 1e-12
        np.testing.assert_allclose(a / scale, np.asarray(r) / scale, rtol=1e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("L", [64, 255])
def test_strided_conv1d_train_grads_match_jax(L):
    # the reference's strided PallasConv1D is conv1d_train sampled; the
    # port's Conv1dTrain takes the stride (native on the card) and
    # zero-stuffs dy in its backward
    jax, jnp, jc = _jax()
    x, w, b = _inputs(2, L, 8, 16, 5, seed=L)
    off, out_len = C.stride_offset(L, 5, 2)

    def loss_j(x, w, b):
        y = jc.conv1d_train(x, w, b, 32, 128, True)[:, off::2, :][:, :out_len, :]
        return jnp.sum(jnp.sin(y) * y)

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (t.requires_grad_() for t in _port(x, w, b))
    y = C.conv1d_train(xt, wt, bt, stride=2)
    assert y.shape == (2, 16, out_len)
    torch.sum(torch.sin(y) * y).backward()
    got = (xt.grad.numpy().transpose(0, 2, 1), wt.grad.numpy().transpose(2, 1, 0), bt.grad.numpy())
    for name, a, r in zip(("dx", "dw", "db"), got, g_j):
        scale = np.abs(np.asarray(r)).max() + 1e-12
        np.testing.assert_allclose(a / scale, np.asarray(r) / scale, rtol=1e-3, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("L,K", [(256, 5), (255, 5), (37, 3), (4, 5)])
def test_strided_plain_is_the_sampled_stride_1_output(L, K):
    # conv1d_ref runs F.conv1d at the stride with flax's padding; the
    # reference's strided layer is the stride-1 SAME output, sampled
    x, w, b = _port(*_inputs(2, L, 3, 4, K, seed=L))
    off, out_len = C.stride_offset(L, K, 2)
    want = C.conv1d_same_ref(x, w, b, "tanh")[:, :, off::2][:, :, :out_len]
    torch.testing.assert_close(C.conv1d_ref(x, w, b, 2, "tanh"), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("L", [256, 255])
def test_pallas_layer_agrees_with_conv1d_at_stride_2(L):
    # Conv1d pads flax's asymmetric (1, 2) at stride 2; the kernel path pads
    # (2, 2) at stride 1 and samples from the right offset
    torch.manual_seed(0)
    ref = Conv1d(3, 4, 5, stride=2)
    layer = PallasConv1d(3, 4, 5, stride=2)
    layer.load_state_dict(ref.state_dict())
    x = torch.randn(2, 3, L)
    with torch.no_grad():
        a, r = layer(x), ref(x)
    assert a.shape == r.shape == (2, 4, -(-L // 2))
    torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def _flax_weights(module, x, seed):
    jax, jnp, _ = _jax()
    v = module.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                    jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32),
        v["params"])
    return params, v.get("batch_stats")


def test_models_under_pallas_match_jax_pallas():
    jax, jnp, _ = _jax()
    from gennet_tpu.models import BBHGenerator as JG
    from gennet_tpu.models import PairDiscriminator as JD
    from gennet_tpu_torch import convert

    z = np.random.default_rng(0).uniform(-1, 1, (2, 100)).astype(np.float32)
    jg = JG(n_out=256, features=(64, 128, 256), drate=0.0, conv_impl="pallas")
    params, stats = _flax_weights(jg, z, 1)
    ref = np.asarray(jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(z)))
    tg = BBHGenerator(n_out=256, features=(64, 128, 256), drate=0.0, conv_impl="pallas")
    tg.load_state_dict(convert.flax_to_torch_generator(params, jax.device_get(stats)))
    with torch.no_grad():
        out = tg(torch.tensor(z)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)

    pair = np.random.default_rng(2).normal(size=(2, 256, 2)).astype(np.float32)
    jd = JD(features=(64, 128), conv_impl="pallas")
    dparams, _ = _flax_weights(jd, pair, 3)
    ref = np.asarray(jd.apply({"params": dparams}, jnp.asarray(pair)))
    td = PairDiscriminator(features=(64, 128), n_pix=256, conv_impl="pallas")
    td.load_state_dict(convert.flax_to_torch_discriminator(dparams))
    with torch.no_grad():
        out = td(torch.tensor(pair)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def _close(a, r, tol=1e-4):
    a, r = np.asarray(a), np.asarray(r)
    assert a.shape == r.shape
    assert np.abs(a - r).max() <= tol * np.abs(r).max(), np.abs(a - r).max() / np.abs(r).max()


def test_pallas_and_xla_agree_in_the_port_forward_and_gan_step():
    from gennet_tpu_torch.train import gan as tgan

    n, G_FEAT, D_FEAT = 128, (16, 16, 32, 32, 64), (16, 32)
    cfg = tgan.GANConfig(n_pix=n, batch_size=4, label_smoothing=True, d_instance_noise=0.3,
                         d_lr_scale=0.5, d_acc_gate=0.9)
    states = {}
    for impl in ("xla", "pallas"):
        G = BBHGenerator(n_out=n, features=G_FEAT, drate=0.2, conv_impl=impl)
        D = PairDiscriminator(features=D_FEAT, n_pix=n, conv_impl=impl)
        states[impl] = tgan.init_gan(torch.Generator().manual_seed(3), G, D, cfg, "cpu")
    gx, gp = states["xla"], states["pallas"]
    assert isinstance(gp.generator.convs[0], PallasConv1d)
    assert type(gx.generator.convs[0]) is Conv1d and type(gp.generator.out_conv) is Conv1d
    for a, b in zip(gx.generator.state_dict().values(), gp.generator.state_dict().values()):
        assert torch.equal(a, b)

    z = torch.rand(8, 100, generator=torch.Generator().manual_seed(4)) * 2 - 1
    with torch.no_grad():
        _close(gp.generator(z), gx.generator(z))
        pair = torch.randn(8, n, 2, generator=torch.Generator().manual_seed(5))
        _close(gp.discriminator(pair), gx.discriminator(pair))

    bank = torch.randn(16, n, generator=torch.Generator().manual_seed(6))
    measured = torch.randn(n, generator=torch.Generator().manual_seed(7))
    metrics = {}
    for impl, st in states.items():
        batch = tgan.draw_gan_batch(torch.Generator().manual_seed(8), bank, cfg)
        _, metrics[impl] = tgan.gan_update(st, batch, measured, cfg=cfg)
    for key in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(metrics["pallas"][key]), float(metrics["xla"][key]),
                                   rtol=1e-4, err_msg=key)
    for (name, a), b in zip(gx.generator.named_parameters(), gp.generator.parameters()):
        # one Adam step of ≤ lr from equal weights: equal but for sum order,
        # where a zero gradient's sign (biases before a BatchNorm) may flip
        assert float((a - b).detach().abs().max()) <= 2 * cfg.lr + 1e-6, name
    for (name, a), b in zip(gx.discriminator.named_parameters(), gp.discriminator.parameters()):
        _close(b.detach(), a.detach(), 1e-4)


def test_conv_layer_factory_refuses_unknown_impl():
    with pytest.raises(ValueError, match="conv_impl"):
        conv1d_layer("cudnn", 2, 4)
    with pytest.raises(ValueError, match="conv_impl"):
        BBHGenerator(n_out=64, features=(8, 8), conv_impl="triton")


def test_cpu_tensors_never_count_launches():
    before = C.LAUNCHES
    x, w, b = _port(*_inputs(1, 16, 4, 8, 5, seed=0))
    C.conv1d_same(x, w, b, act="tanh")
    assert C.LAUNCHES == before


@pytest.mark.parametrize("bad", ["float64", "noncontig", "even_k", "cin", "bias", "act", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    x, w, b = torch.ones(2, 3, 16), torch.ones(4, 3, 5), torch.zeros(4)
    if bad == "float64":
        x = x.double()
    elif bad == "noncontig":
        x = torch.ones(2, 16, 3).transpose(1, 2)
    elif bad == "even_k":
        w = torch.ones(4, 3, 4)
    elif bad == "cin":
        w = torch.ones(4, 2, 5)
    elif bad == "bias":
        b = torch.zeros(5)
    elif bad == "device":
        x, w, b = (t.to("meta") for t in (x, w, b))
    with pytest.raises((TypeError, ValueError)):
        C.conv1d_same(x, w, b, act="swish" if bad == "act" else "none")


# the flagship's conv shapes (n_pix 1024): (B, L, Cin, Cout, K, stride) of
# the kernel's calls, forward (the three strided layers at their native
# stride 2) and dx (stride 1), and edge cases: Cout 2, 7 and 64, ragged L,
# Cin 2048 (beyond the earlier kernel's shared-memory window), K 3, and
# the raw-series D's Conv_0 at Cin 1 (forward) and Cout 1 (its dx)
_CARD_SHAPES = [(8, 1024, 256, 64, 5, 2), (8, 1024, 64, 128, 5, 1), (8, 1024, 128, 256, 5, 1),
                (8, 1024, 256, 512, 5, 1), (8, 1024, 512, 1024, 5, 1), (8, 1024, 2, 256, 5, 2),
                (8, 512, 256, 512, 5, 2), (8, 1024, 1024, 512, 5, 1), (8, 1024, 256, 2, 5, 1),
                (8, 1024, 64, 256, 5, 1), (3, 37, 5, 7, 5, 1), (2, 255, 3, 2, 5, 2),
                (1, 37, 2048, 64, 5, 1), (2, 100, 9, 200, 3, 1),
                (8, 1024, 1, 256, 5, 2), (8, 1024, 256, 1, 5, 1)]


def _card_inputs(B, L, Cin, Cout, K, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, Cin, L), generator=g, device="cuda")
    w = torch.randn((Cout, Cin, K), generator=g, device="cuda") / (K * Cin) ** 0.5
    b = torch.randn((Cout,), generator=g, device="cuda")
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride", _CARD_SHAPES)
@pytest.mark.parametrize("act", ["none", "tanh", "leaky_relu", "relu"])
def test_kernel_matches_plain_on_card(B, L, Cin, Cout, K, stride, act):
    # 1e-4·max against plain (float32 sums in other orders) and 1e-5·max
    # against float64: 3xTF32 keeps float32-class accuracy
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1d kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    x, w, b = _card_inputs(B, L, Cin, Cout, K)
    before = C.LAUNCHES
    out = C.conv1d(x, w, b, stride=stride, act=act)
    torch.cuda.synchronize()
    assert C.LAUNCHES == before + 1
    ref = C.conv1d_ref(x, w, b, stride=stride, act=act)
    assert out.shape == ref.shape == (B, Cout, -(-L // stride))
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-4
    r64 = C.conv1d_ref(x.double(), w.double(), b.double(), stride=stride, act=act)
    assert float((out.double() - r64).abs().max() / r64.abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("cout,cin,K", [(64, 256, 5), (2, 256, 5), (256, 2, 5), (7, 5, 3),
                                        (1024, 512, 5), (200, 9, 9)])
def test_pack_kernel_matches_pack_weight_on_card(cout, cin, K):
    # bit for bit, special values included: the kernel splits on the bit
    # pattern exactly as split_tf32 does
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pack kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn((cout, cin, K), generator=g, device="cuda")
    specials = [float("inf"), -float("inf"), float("nan"), 1e-40, -3e-39, 0.0, -0.0, 3.4028235e38]
    w.view(-1)[:len(specials)] = torch.tensor(specials, device="cuda")
    for transposed in (False, True):
        got, want = C._pack_on_card(w, transposed), C.pack_weight(w, transposed)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), transposed


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,Cin,Cout,K,stride", [(8, 1024, 256, 64, 5, 2), (2, 255, 300, 7, 5, 1)])
def test_kernel_is_bitwise_deterministic_on_card(B, L, Cin, Cout, K, stride):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1d kernel has no CPU mode")
    x, w, b = _card_inputs(B, L, Cin, Cout, K, seed=2)
    assert torch.equal(C.conv1d(x, w, b, stride=stride), C.conv1d(x, w, b, stride=stride))


@pytest.mark.gpu
def test_conv1d_train_grads_on_card_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1d kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((4, 64, 200), generator=g, device="cuda", requires_grad=True)
    w = (torch.randn((96, 64, 5), generator=g, device="cuda") / 18).requires_grad_()
    b = torch.randn((96,), generator=g, device="cuda", requires_grad=True)
    for stride in (1, 2):
        dy = torch.randn((4, 96, -(-200 // stride)), generator=g, device="cuda")
        got = torch.autograd.grad(C.conv1d_train(x, w, b, stride), (x, w, b), dy)
        ref = torch.autograd.grad(C.conv1d_ref(x, w, b, stride), (x, w, b), dy)
        for a, r in zip(got, ref):
            assert float((a - r).abs().max() / r.abs().max()) <= 1e-4


@pytest.mark.gpu
def test_conv1d_train_follows_optimizer_steps_on_card():
    # a training step reuses the cached pack only while the weight is
    # unchanged: the optimizer's in-place update forces a new pack for the
    # forward and for dx
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1d kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    from gennet_tpu_torch.runtime.optim import adam

    x, w, b = _card_inputs(4, 200, 64, 96, 5, seed=4)
    x.requires_grad_()
    w, b = torch.nn.Parameter(w), torch.nn.Parameter(b)
    opt = adam([w, b], 1e-2, 0.5)
    for _ in range(3):
        dy = torch.randn((4, 96, 100), device="cuda")
        out = C.conv1d_train(x, w, b, 2)
        ref = C.conv1d_ref(x, w, b, 2)
        assert float((out - ref).detach().abs().max() / ref.detach().abs().max()) <= 1e-4
        got = torch.autograd.grad(out, (x, w, b), dy)
        want = torch.autograd.grad(ref, (x, w, b), dy)
        for a, r in zip(got, want):
            assert float((a - r).abs().max() / r.abs().max()) <= 1e-4
        opt.zero_grad()
        w.grad, b.grad = got[1], got[2]
        opt.step()
