"""The phasor → iDFT op: its plain version against the JAX Pallas kernel
(interpret mode, as tests/test_pallas_ops.py runs it) and the dense iDFT,
the wrapper's checks, and (on a CUDA card only) the kernel against the
plain version. JAX is imported inside the comparisons, so on the card
(no JAX there) the file runs with ``pytest --noconftest -m gpu``.

Tolerances: rtol/atol 2e-4 for random phasor products and 2e-5·max|ref|
for the windowed iDFT slice, the values of tests/test_pallas_ops.py
(float32 sums of K = 256…513 terms in different orders).
"""

import numpy as np
import pytest
import torch

from gennet_tpu_torch.ops import dft as tdft
from gennet_tpu_torch.ops import phasor_dft as P


def _jax():
    """(jax.numpy, gennet_tpu.ops.dft, gennet_tpu.ops.phasor_dft)."""
    jnp = pytest.importorskip("jax.numpy")
    from gennet_tpu.ops import dft, phasor_dft

    return jnp, dft, phasor_dft


def _rand(shape, seed, square=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x**2 if square else x


def test_plain_matches_pallas_interpret():
    jnp, _, jp = _jax()
    B, K, T = 8, 256, 128
    amp, ph = _rand((B, K), 0, True), _rand((B, K), 1)
    C, S = _rand((K, T), 2), _rand((K, T), 3)
    ref = np.asarray(jp.phasor_matmul(*map(jnp.asarray, (amp, ph, C, S)), bm=8, bk=128, bt=128,
                              interpret=True))
    out = P.phasor_matmul(*map(torch.tensor, (amp, ph, C, S))).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_grads_match_jax_custom_vjp():
    # the CPU runs the same autograd.Function as the card: its closed-form
    # backward must match JAX's custom VJP (rtol/atol 2e-4 after scaling,
    # the forward's tolerance)
    jnp, _, jp = _jax()
    import jax

    B, K, T = 8, 256, 128
    amp, ph = _rand((B, K), 10, True), _rand((B, K), 11)
    C, S = _rand((K, T), 12) / 16, _rand((K, T), 13) / 16
    wgt = _rand((B, T), 14)

    def loss_j(a, p, c, s):
        out = jp.phasor_matmul(a, p, c, s, bm=8, bk=128, bt=128, interpret=True)
        return jnp.sum(jnp.sin(out) * wgt)

    ref = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (amp, ph, C, S)))
    args = [torch.tensor(a, requires_grad=True) for a in (amp, ph, C, S)]
    out = P.phasor_matmul(*args)
    assert type(out.grad_fn).__name__ == "PhasorMatmulBackward"
    torch.sum(torch.sin(out) * torch.tensor(wgt)).backward()
    for name, a, r in zip(("amp", "phase", "cos", "sin"), args, ref):
        r = np.asarray(r)
        scale = np.abs(r).max()
        np.testing.assert_allclose(a.grad.numpy() / scale, r / scale, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_backward_skips_grads_nobody_asked_for():
    amp, ph = torch.rand(3, 5, requires_grad=True), torch.zeros(3, 5)
    C, S = torch.ones(5, 4), torch.ones(5, 4)
    P.phasor_matmul(amp, ph, C, S).sum().backward()
    assert amp.grad is not None and ph.grad is None and C.grad is None
    torch.testing.assert_close(amp.grad, torch.full((3, 5), 4.0))


def _slice_inputs(B, N, pad_to=None, seed=1):
    rng = np.random.default_rng(seed)
    nf = N // 2 + 1
    width = pad_to or nf
    amp = np.zeros((B, width), np.float32)
    amp[:, 40:nf - 1] = rng.normal(size=(B, nf - 41)).astype(np.float32) ** 2
    ph = (3 * rng.normal(size=(B, width))).astype(np.float32)
    return amp, ph


@pytest.mark.parametrize("B", [8, 7])
def test_slice_matches_pallas_and_dense(B):
    # the port runs the unpadded K = 513 bins; the JAX kernel needs them
    # padded to its lane tile (640) with zero amplitude
    jnp, jdft, jp = _jax()
    N, start, width = 1024, 384, 256
    nf = N // 2 + 1
    w = tuple(float(x) for x in np.hanning(width))
    amp, ph = _slice_inputs(B, N, pad_to=640)
    ref_k = np.asarray(jp.phasor_irdft_slice(jnp.asarray(amp), jnp.asarray(ph), N, start, width, weights=w,
                               interpret=True))
    re = jnp.asarray(amp[:, :nf]) * jnp.cos(jnp.asarray(ph[:, :nf]))
    im = -jnp.asarray(amp[:, :nf]) * jnp.sin(jnp.asarray(ph[:, :nf]))
    ref_d = np.asarray(jdft.irdft_slice(re, im, N, start, width, weights=w))
    out = P.phasor_irdft_slice(torch.tensor(amp[:, :nf]), torch.tensor(ph[:, :nf]), N, start,
                               width, weights=w).numpy()
    assert out.shape == (B, width)
    for ref in (ref_k, ref_d):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out / scale, ref / scale, atol=2e-5)


def test_slice_tables_match_reference_tables():
    _, jdft, _ = _jax()
    w = tuple(float(x) for x in np.hanning(128))
    for a, b in zip(tdft._irdft_slice_tables(1024, 960, 128, w),
                    jdft._irdft_slice_tables(1024, 960, 128, w)):
        np.testing.assert_array_equal(a, b)


def test_plain_irdft_slice_matches_dense_reference():
    jnp, jdft, _ = _jax()
    rng = np.random.default_rng(4)
    re, im = rng.normal(size=(3, 513)).astype(np.float32), rng.normal(size=(3, 513)).astype(np.float32)
    ref = np.asarray(jdft.irdft_slice(jnp.asarray(re), jnp.asarray(im), 1024, 1000, 64))
    out = tdft.irdft_slice(torch.tensor(re), torch.tensor(im), 1024, 1000, 64).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    full = np.fft.irfft(re + 1j * im, 1024)[:, np.arange(1000, 1064) % 1024]
    np.testing.assert_allclose(out, full, rtol=1e-4, atol=1e-6)


def test_cpu_tensors_never_count_launches():
    before = P.LAUNCHES
    amp, ph = _slice_inputs(4, 256)
    P.phasor_irdft_slice(torch.tensor(amp), torch.tensor(ph), 256, 0, 64)
    assert P.LAUNCHES == before


@pytest.mark.parametrize("bad", ["float64", "noncontig", "phase_shape", "table_shape", "ndim"])
def test_wrapper_rejects_bad_inputs(bad):
    amp, ph = torch.ones(4, 33), torch.zeros(4, 33)
    C, S = torch.ones(33, 8), torch.ones(33, 8)
    if bad == "float64":
        amp = amp.double()
    elif bad == "noncontig":
        C = torch.ones(8, 33).t()
    elif bad == "phase_shape":
        ph = torch.zeros(4, 32)
    elif bad == "table_shape":
        S = torch.ones(32, 8)
    elif bad == "ndim":
        amp = amp[None]
    with pytest.raises((TypeError, ValueError)):
        P.phasor_matmul(amp, ph, C, S)


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,T", [(8, 256, 128), (3907, 2049, 128), (7, 513, 256),
                                   (8, 2049, 128), (8, 2049, 1024), (4096, 2049, 128),
                                   (5, 300, 40)])
def test_kernel_matches_plain_on_card(B, K, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the phasor kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    amp = torch.rand((B, K), generator=g, device="cuda")
    ph = 1e3 * torch.randn((B, K), generator=g, device="cuda")
    C = torch.randn((K, T), generator=g, device="cuda") / K
    S = torch.randn((K, T), generator=g, device="cuda") / K
    before = P.LAUNCHES
    out = P.phasor_matmul(amp, ph, C, S)
    torch.cuda.synchronize()
    assert P.LAUNCHES == before + 1
    ref = P.phasor_matmul_ref(amp, ph, C, S)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("skip_amp,skip_ph", [(1, 1), (1, 2), (0, 3)])
def test_kernel_takes_unaligned_row_views_on_card(skip_amp, skip_ph):
    # contiguous row views of (B, 2049) tensors start 8196 bytes apart, so
    # amp[1:] is not 16-byte aligned: the wrapper hands the kernel aligned
    # copies, and the result is the plain version's
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the phasor kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, K, T = 300, 2049, 128
    g = torch.Generator(device="cuda").manual_seed(5)
    amp = torch.rand((B + skip_amp, K), generator=g, device="cuda")[skip_amp:]
    ph = (1e3 * torch.randn((B + skip_ph, K), generator=g, device="cuda"))[skip_ph:]
    C = torch.randn((K, T), generator=g, device="cuda") / K
    S = torch.randn((K, T), generator=g, device="cuda") / K
    assert amp.is_contiguous() and ph.is_contiguous()
    out = P.phasor_matmul(amp, ph, C, S)
    ref = P.phasor_matmul_ref(amp, ph, C, S)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 2e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,T", [(8, 2049, 128), (4096, 2049, 1024)])
def test_kernel_is_bitwise_deterministic_on_card(B, K, T):
    # the bin axis is split across blocks at these shapes (B = 8) or not
    # (pass B); the split sums in a fixed order, with no atomics
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the phasor kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    amp = torch.rand((B, K), generator=g, device="cuda")
    ph = 1e3 * torch.randn((B, K), generator=g, device="cuda")
    C = torch.randn((K, T), generator=g, device="cuda") / K
    S = torch.randn((K, T), generator=g, device="cuda") / K
    assert torch.equal(P.phasor_matmul(amp, ph, C, S), P.phasor_matmul(amp, ph, C, S))


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,T", [(8, 2049, 1024), (4096, 2049, 1024)])
def test_vjp_on_card_matches_plain_autograd(B, K, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the phasor kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    amp = torch.rand((B, K), generator=g, device="cuda").requires_grad_()
    ph = (1e3 * torch.randn((B, K), generator=g, device="cuda")).requires_grad_()
    C = torch.randn((K, T), generator=g, device="cuda") / K
    S = torch.randn((K, T), generator=g, device="cuda") / K
    dy = torch.randn((B, T), generator=g, device="cuda")
    before = P.LAUNCHES
    out = P.phasor_matmul(amp, ph, C, S)
    assert P.LAUNCHES == before + 1 and type(out.grad_fn).__name__ == "PhasorMatmulBackward"
    got = torch.autograd.grad(out, (amp, ph), dy)
    ref = torch.autograd.grad(P.phasor_matmul_ref(amp, ph, C, S), (amp, ph), dy)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max() / r.abs().max()) <= 1e-4


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from gennet_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if (_build.Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()


def test_wrapper_refuses_other_devices():
    t = torch.ones(2, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        P.phasor_matmul(t, t, torch.ones(3, 4, device="meta"), torch.ones(3, 4, device="meta"))
