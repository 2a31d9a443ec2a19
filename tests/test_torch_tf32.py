"""The 3xTF32 split and the kernels' packed operands, on the CPU.

The CUDA kernels take each float32 product as three TF32 tensor-core
products of split operands (``csrc/tf32_wgmma.cuh``). Here: the torch split
against a numpy bit-level reference; the packed conv weights and iDFT tables
unpack to the originals; and a plain emulation of the kernels' arithmetic
(the split operands, products summed in float64) stays within 1e-6·max of
the float64 result at small shapes, the argument for the card tolerances
(1e-5·max against float64 for the conv, 2e-5·max against plain for the
phasor) beside float32 summation.
"""

import numpy as np
import pytest
import torch

from gennet_tpu_torch.ops import conv1d as C
from gennet_tpu_torch.ops import phasor_dft as P
from gennet_tpu_torch.ops.tf32 import cached_pack, split_tf32


def _np_round_tf32(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away, to TF32 on the sign-magnitude bits."""
    bits = x.astype(np.float32).view(np.uint32)
    sign, mag = bits & np.uint32(0x80000000), bits & np.uint32(0x7FFFFFFF)
    out = (((mag + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) | sign).view(np.float32)
    return np.where(np.isfinite(x), out, x)


def _np_trunc_tf32(x: np.ndarray) -> np.ndarray:
    """What the tensor cores read of a float32 operand: its top 19 bits."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_split_matches_bit_reference_and_is_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096),
                        rng.normal(size=64)]).astype(np.float32)
    hi, lo = split_tf32(torch.tensor(x))
    hi, lo = hi.numpy(), lo.numpy()
    np.testing.assert_array_equal(_bits(hi), _bits(_np_round_tf32(x)))
    assert not np.any(_bits(hi) & np.uint32(0x1FFF))  # low 13 mantissa bits clear
    np.testing.assert_array_equal(hi + lo, x)           # exact in float32
    assert np.all(np.abs(lo) <= np.abs(x) * 2.0 ** -11)


def test_split_rounds_ties_away_from_zero():
    one = np.float32(1.0).view(np.uint32)
    x = np.array([one + 0x1000, one + 0x0FFF, one + 0x1001, one + 0x3000], np.uint32).view(np.float32)
    x = np.concatenate([x, -x])
    want = np.array([one + 0x2000, one, one + 0x2000, one + 0x4000], np.uint32).view(np.float32)
    want = np.concatenate([want, -want])
    hi, lo = split_tf32(torch.tensor(x))
    np.testing.assert_array_equal(_bits(hi.numpy()), _bits(want))
    np.testing.assert_array_equal(hi.numpy() + lo.numpy(), x)


def test_split_passes_special_values_through():
    sub = np.array([1, 0x1FFF, 0x1000, 0x7FFFFF], np.uint32).view(np.float32)  # subnormals
    x = np.concatenate([[0.0, -0.0, np.inf, -np.inf, np.nan], sub, -sub,
                        [np.finfo(np.float32).max, -np.finfo(np.float32).max]]).astype(np.float32)
    hi, lo = (t.numpy() for t in split_tf32(torch.tensor(x)))
    np.testing.assert_array_equal(hi + lo, x)  # nan == nan in assert_array_equal
    np.testing.assert_array_equal(np.signbit(hi[:2]), [False, True])
    assert np.all(lo[2:5] == 0) and np.isinf(hi[2:4]).all() and np.isnan(hi[4])
    assert np.isfinite(hi[-2:]).all()  # the largest floats do not round to inf
    with pytest.raises(TypeError):
        split_tf32(torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("cout,cin", [(6, 2), (6, 8), (70, 13), (2, 256)])
def test_conv_weight_pack_unpacks_to_the_weight(cout, cin, transposed):
    w = torch.tensor(np.random.default_rng(cin).normal(size=(cout, cin, 5)).astype(np.float32))
    pack = C.pack_weight(w, transposed)
    want = w.flip(-1).transpose(0, 1).contiguous() if transposed else w
    co, ci = want.shape[:2]
    bn = C.tile_n(co)
    assert bn == min(max(8, 1 << (co - 1).bit_length()), 128)
    assert pack.shape == (-(-co // bn), -(-ci // 8), 2, 5, 2, bn // 8, 8, 4)
    torch.testing.assert_close(C.unpack_weight(pack, co, ci), want, rtol=0, atol=0)
    # hi carries TF32 values; the padding is zeros
    assert not torch.any(pack[:, :, 0].contiguous().view(torch.int32) & 0x1FFF)
    padded = C.unpack_weight(pack, pack.shape[0] * bn, pack.shape[1] * 8)
    assert not torch.any(padded[co:]) and not torch.any(padded[:, ci:])


@pytest.mark.parametrize("K,T", [(33, 8), (2049, 128), (40, 64), (2049, 1024), (17, 200)])
def test_table_pack_unpacks_to_the_tables(K, T):
    rng = np.random.default_rng(K)
    cos_t, sin_t = (torch.tensor(rng.normal(size=(K, T)).astype(np.float32)) for _ in range(2))
    pack = P.pack_tables(cos_t, sin_t)
    bn = P.TILE_N
    assert pack.shape == (-(-T // bn), -(-K // 8), 2, 2, 2, bn // 8, 8, 4)
    for got, want in zip(P.unpack_tables(pack, K, T), (cos_t, sin_t)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.any(pack[:, :, :, 0].contiguous().view(torch.int32) & 0x1FFF)
    padded = P.unpack_tables(pack, pack.shape[1] * 8, pack.shape[0] * bn)
    for t in padded:
        assert not torch.any(t[K:]) and not torch.any(t[:, T:])


def _emulated_products(a: np.ndarray, b: np.ndarray):
    """The three products of the kernels' split, in float64: a is split in
    registers (hi and lo rounded to TF32), b is packed (lo read as its top
    19 bits by the tensor cores)."""
    a_hi = _np_round_tf32(a)
    a_lo = _np_round_tf32(a - a_hi)
    b_hi, b_lo = (t.numpy() for t in split_tf32(torch.tensor(b)))
    b_lo = _np_trunc_tf32(b_lo)
    return [x.astype(np.float64) for x in (a_hi, a_lo, b_hi, b_lo)]


@pytest.mark.parametrize("B,L,Cin,Cout,stride", [(2, 37, 5, 7, 1), (2, 64, 24, 16, 2),
                                                 (1, 48, 64, 3, 1)])
def test_emulated_3xtf32_conv_matches_float64(B, L, Cin, Cout, stride):
    rng = np.random.default_rng(L)
    x = rng.normal(size=(B, Cin, L)).astype(np.float32)
    w = (rng.normal(size=(Cout, Cin, 5)) / np.sqrt(5 * Cin)).astype(np.float32)
    x_hi, x_lo, w_hi, w_lo = (torch.tensor(t) for t in _emulated_products(x, w))
    zero = torch.zeros(Cout, dtype=torch.float64)
    conv = lambda a, b: C.conv1d_ref(a, b, zero, stride)
    got = conv(x_lo, w_hi) + conv(x_hi, w_lo) + conv(x_hi, w_hi)
    ref = conv(torch.tensor(x, dtype=torch.float64), torch.tensor(w, dtype=torch.float64))
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6


@pytest.mark.parametrize("B,K,T", [(8, 256, 128), (3, 513, 64)])
def test_emulated_3xtf32_phasor_matches_float64(B, K, T):
    rng = np.random.default_rng(K)
    amp = rng.random((B, K)).astype(np.float32)
    ph = (1e3 * rng.normal(size=(B, K))).astype(np.float32)
    tables = (rng.normal(size=(2, K, T)) / K).astype(np.float32)
    # the kernel forms the phasor in float32 and splits it
    re, im = amp * np.cos(ph), amp * np.sin(ph)
    got = np.zeros((B, T))
    for a, tab in ((re, tables[0]), (im, tables[1])):
        a_hi, a_lo, t_hi, t_lo = _emulated_products(a, tab)
        got += a_lo @ t_hi + a_hi @ t_lo + a_hi @ t_hi
    ref = re.astype(np.float64) @ tables[0] + im.astype(np.float64) @ tables[1]
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_cached_pack_follows_version_and_lifetime():
    calls = []
    make = lambda t: (lambda: calls.append(1) or t.clone())
    w = torch.ones(4)
    a = cached_pack("t", (w,), make(w))
    assert cached_pack("t", (w,), make(w)) is a and len(calls) == 1
    w.add_(1.0)  # an in-place update (an optimizer step) bumps the version
    b = cached_pack("t", (w,), make(w))
    assert len(calls) == 2 and torch.equal(b, torch.full((4,), 2.0))
    assert cached_pack("other", (w,), make(w)) is not b and len(calls) == 3
    from gennet_tpu_torch.ops import tf32

    n = len(tf32._PACKS)
    del w, a, b
    assert len(tf32._PACKS) == n - 2  # the entries die with their source
