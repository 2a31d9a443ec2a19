"""The input gradient of the port's stride-2 convolutions
(``ops/conv1d_dx.py``): the plain parity-split dx against
``torch.autograd.grad`` of ``F.conv1d`` in float64 on the CPU, at every
stride-2 shape the benchmark's cells run (batch cut to 1-2) and at edge
shapes; the op's gradients and R1's second derivatives against
``F.conv1d``'s; which backward calls the engine makes; the dx route's
rule; the weight pack's layout; a CPU ``Conv1d``'s gradients, which the
route leaves alone; and (on a CUDA card only) the kernel against the plain
version, against float64 beside cuDNN's FP32 dgrad, bitwise repeatable and
equal under a CUDA-graph replay, and the pack kernel against
``pack_weight``. The weight gradient's kernel and rule are
``test_torch_conv1d_dw.py``'s.

No JAX here: on the card the file runs with ``pytest --noconftest -m gpu``.
Tolerances: float64 against float64 1e-12 of the maximum (the same sums in
other orders); the kernel 1e-4·max against plain (float32 sums in other
orders) and, against float64, at most twice cuDNN's FP32 dgrad's error on
the same inputs at the cells' shapes (1e-5·max at the edge shapes, sums of
a few products, where cuDNN's FP32 is near exact).
"""

import types

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from gennet_tpu_torch.models.layers import Conv1d
from gennet_tpu_torch.ops import conv1d as C
from gennet_tpu_torch.ops import conv1d_dx as D
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

# (name, B, L, Cin, Cout, K, padding): the stride-2 layers of the
# benchmark's cells at their lengths and widths (DualBranchPE's mc and q
# branches, BurstPE's conv1, G Conv_0 and D Conv_1, D Conv_0 at Cin 1 and
# 2), then odd and even L and other tap counts
SHAPES = [("q_convs.3", 1, 1016, 256, 512, 5, "VALID"),
          ("q_convs.4", 1, 506, 512, 1024, 5, "VALID"),
          ("mc_convs.1", 2, 512, 64, 128, 5, "VALID"),
          ("mc_convs.2", 2, 254, 128, 256, 5, "VALID"),
          ("mc_convs.3", 2, 125, 256, 512, 5, "VALID"),
          ("burst conv1", 2, 256, 64, 128, 5, "VALID"),
          ("G Conv_0", 1, 1024, 256, 64, 5, "SAME"),
          ("D Conv_1", 1, 512, 256, 512, 5, "SAME"),
          ("D Conv_0 Cin 2", 2, 1024, 2, 256, 5, "SAME"),
          ("D Conv_0 Cin 1", 2, 1024, 1, 256, 5, "SAME"),
          ("odd L SAME", 3, 255, 9, 7, 5, "SAME"),
          ("odd L VALID", 3, 38, 9, 7, 5, "VALID"),
          ("K 3", 2, 100, 9, 20, 3, "VALID"),
          ("K 4", 2, 41, 5, 6, 4, "VALID"),
          ("K 2", 2, 40, 5, 6, 2, "SAME"),
          ("K 9", 1, 30, 8, 3, 9, "VALID"),
          ("L = K", 2, 5, 3, 4, 5, "VALID")]


def _pad(x, K, padding):
    """``Conv1d``'s flax padding at stride 2."""
    if padding == "VALID":
        return x
    L = x.shape[-1]
    total = max((-(-L // 2) - 1) * 2 + K - L, 0)
    return F.pad(x, (total // 2, total - total // 2))


def _case(B, L, Cin, Cout, K, padding, seed=0, dtype=torch.float64, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    x = _pad(torch.randn((B, Cin, L), generator=g, dtype=dtype, device=device), K, padding)
    w = torch.randn((Cout, Cin, K), generator=g, dtype=dtype, device=device) / (K * Cin) ** 0.5
    L_out = (x.shape[-1] - K) // 2 + 1
    dy = torch.randn((B, Cout, L_out), generator=g, dtype=dtype, device=device)
    return x, w, dy


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name,B,L,Cin,Cout,K,padding", SHAPES)
def test_plain_dx_matches_autograd(name, B, L, Cin, Cout, K, padding):
    x, w, dy = _case(B, L, Cin, Cout, K, padding)
    x.requires_grad_()
    want, = torch.autograd.grad(F.conv1d(x, w, stride=2), x, dy)
    got = D.conv1d_dx_ref(dy, w, x.shape[-1])
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-12, name


def test_op_gradients_match_conv1d_and_leave_dw_db_to_its_node():
    # dx and dw from the plain parity splits (the op's own nodes); db from
    # F.conv1d's node, so bitwise that of F.conv1d, as is the forward
    x, w, dy = _case(2, 61, 12, 10, 5, "VALID", seed=1)
    b = torch.randn(10, dtype=torch.float64)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    got = torch.autograd.grad(D.conv1d_s2(x, w, b), (x, w, b), dy)
    want = torch.autograd.grad(F.conv1d(x, w, b, stride=2), (x, w, b), dy)
    assert torch.equal(D.conv1d_s2(x, w, b), F.conv1d(x, w, b, stride=2))
    assert _rel(got[0], want[0]) <= 1e-12
    assert _rel(got[1], want[1]) <= 1e-12
    assert torch.equal(got[2], want[2])


class _Calls(TorchDispatchMode):
    """The aten calls made under it; convolution_backward by its mask."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, arg_types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name == "convolution_backward":
            name = tuple(args[-1])  # its output mask (dx, dw, db)
        self.calls.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("wrt,x_grad,masks,dx", [
    (("x",), True, [], True),                            # convtime.py's "dx" row
    (("w",), False, [], False),                          # its "dw" row
    (("b",), False, [(False, False, True)], False),
    (("w", "b"), False, [(False, False, True)], False),
    (("x", "w", "b"), True, [(False, False, True)], True)])
def test_backward_computes_only_what_is_asked(wrt, x_grad, masks, dx):
    # db as F.conv1d's own node computes it, by the engine's mask, which
    # never asks it for dw; dx and dw (the plain versions' F.conv1d per
    # parity) each only when asked for: benchmark/harness/convtime.py times
    # the "dx" and "dw" rows with torch.autograd.grad on one input each
    x, w, dy = _case(2, 40, 8, 6, 5, "VALID", seed=2)
    b = torch.zeros(6, dtype=torch.float64, requires_grad=True)
    w.requires_grad_()
    x.requires_grad_(x_grad)
    y = D.conv1d_s2(x, w, b)
    with _Calls() as mode:
        torch.autograd.grad(y, [{"x": x, "w": w, "b": b}[k] for k in wrt], dy)
    assert [c for c in mode.calls if isinstance(c, tuple)] == masks
    assert mode.calls.count("convolution") == (2 if dx else 0) + (2 if "w" in wrt else 0)


def test_r1_second_derivatives_match_conv1d():
    # R1 differentiates D's input gradient again, with respect to D's
    # weights and its input
    x, w, _ = _case(2, 23, 9, 5, 5, "VALID", seed=3)
    b = torch.randn(5, dtype=torch.float64)
    x, w, b = (t.requires_grad_() for t in (x, w, b))

    def r1(conv):
        def f(x, w, b):
            y = torch.tanh(conv(torch.sin(x), w, b))
            gx, = torch.autograd.grad((y ** 2).sum(), x, create_graph=True)
            return gx
        return f

    assert torch.autograd.gradcheck(r1(D.conv1d_s2), (x, w, b))
    got = torch.autograd.grad((r1(D.conv1d_s2)(x, w, b) ** 2).sum(), (x, w, b))
    want = torch.autograd.grad((r1(lambda *a: F.conv1d(*a, stride=2))(x, w, b) ** 2).sum(),
                               (x, w, b))
    for a, r in zip(got, want):
        assert _rel(a, r) <= 1e-12


def _stub(device, dtype, cin, K, cout=64):
    return (types.SimpleNamespace(is_cuda=device == "cuda", dtype=dtype),
            types.SimpleNamespace(dtype=dtype, shape=(cout, cin, K)))


@pytest.mark.parametrize("device,dtype,cin,K,stride,routed", [
    ("cuda", torch.float32, 1, 5, 2, False),     # D Conv_0 of the raw-series D
    ("cuda", torch.float32, 2, 5, 2, False),     # D Conv_0 of the pair D
    ("cuda", torch.float32, 7, 5, 2, False),
    ("cuda", torch.float32, 8, 5, 2, True),
    ("cuda", torch.float32, 512, 5, 2, True),    # q_convs.4
    ("cuda", torch.bfloat16, 512, 5, 2, False),  # a bf16 layer
    ("cuda", torch.float32, 512, 5, 1, False),
    ("cuda", torch.float32, 512, 1, 2, False),
    ("cuda", torch.float32, 512, 11, 2, False),
    ("cpu", torch.float32, 512, 5, 2, False)])
def test_route_rule(device, dtype, cin, K, stride, routed):
    # the dx kernel's rule (the dw kernel's, which takes Cin 1 to 7 too, is
    # test_torch_conv1d_dw.py's)
    assert D.routes_dx(*_stub(device, dtype, cin, K), stride) is routed


@pytest.mark.parametrize("padding,L", [("SAME", 64), ("SAME", 63), ("VALID", 64), ("VALID", 63)])
def test_cpu_conv1d_gradients_unchanged(padding, L):
    # on the CPU the layer is F.conv1d's node, as before the route existed
    torch.manual_seed(4)
    layer = Conv1d(16, 24, 5, stride=2, padding=padding)
    x = torch.randn(3, 16, L, requires_grad=True)
    before = D.LAUNCHES
    y = layer(x)
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, layer.weight, layer.bias), dy)
    xp = _pad(x, 5, padding)
    want = torch.autograd.grad(F.conv1d(xp, layer.weight, layer.bias, stride=2),
                               (x, layer.weight, layer.bias), dy)
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    assert D.LAUNCHES == before


@pytest.mark.parametrize("cout,cin,K,bn", [(20, 37, 5, 64), (1024, 512, 5, 128), (6, 9, 4, 16),
                                           (3, 8, 2, 8), (5, 130, 9, 128)])
def test_pack_holds_each_parity_taps(cout, cin, K, bn):
    w = torch.randn(cout, cin, K)
    pack = D.pack_weight(w, bn)
    n_tiles, n_chunks = -(-cin // bn), -(-cout // 8)
    assert pack.numel() == n_tiles * n_chunks * 2 * K * bn * 8
    off = 0
    for p in (0, 1):
        kp = (K + 1 - p) // 2
        n = n_tiles * n_chunks * 2 * kp * bn * 8
        half = pack[off:off + n].reshape(n_tiles, n_chunks, 2, kp, 2, bn // 8, 8, 4)
        off += n
        # Wp[ci, co, u] = w[co, ci, p + 2(Kp − 1 − u)]
        want = torch.stack([w[:, :, p + 2 * (kp - 1 - u)].T for u in range(kp)], -1)
        assert torch.equal(C.unpack_weight(half, cin, cout), want)


def test_cpu_tensors_never_count_launches():
    x, w, dy = _case(2, 40, 8, 6, 5, "VALID", dtype=torch.float32)
    before = D.LAUNCHES
    D.conv1d_dx(dy, w, x.shape[-1])
    assert D.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dims", "length", "channels", "dtype", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    dy, w, L = torch.ones(2, 4, 18), torch.ones(4, 3, 5), 40
    if bad == "dims":
        dy = dy[0]
    elif bad == "length":
        L = 41 + 2
    elif bad == "channels":
        w = torch.ones(5, 3, 5)
    elif bad == "dtype":
        w = w.double()
    elif bad == "device":
        dy, w = dy.to("meta"), w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        D.conv1d_dx(dy, w, L)


# ---- on the card ----------------------------------------------------------

# the routed shapes of the cells, at their batch, and two edge shapes:
# (name, B, L, Cin, Cout, padding)
CELL_SHAPES = [("q_convs.3", 64, 1016, 256, 512, "VALID"),
               ("q_convs.4", 64, 506, 512, 1024, "VALID"),
               ("mc_convs.1", 64, 512, 64, 128, "VALID"),
               ("mc_convs.2", 64, 254, 128, 256, "VALID"),
               ("mc_convs.3", 64, 125, 256, 512, "VALID"),
               ("burst conv1", 64, 256, 64, 128, "VALID"),
               ("G Conv_0", 8, 1024, 256, 64, "SAME"), ("D Conv_1", 8, 512, 256, 512, "SAME")]
EDGE_SHAPES = [("odd L", 3, 255, 9, 7, "SAME"), ("Cin 8 Cout 1", 2, 37, 8, 1, "VALID")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1d_dx kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,L,Cin,Cout,padding", CELL_SHAPES + EDGE_SHAPES)
def test_kernel_matches_plain_and_float64_on_card(name, B, L, Cin, Cout, padding):
    _card()
    x, w, dy = _case(B, L, Cin, Cout, 5, padding, dtype=torch.float32, device="cuda")
    before = D.LAUNCHES
    got = D.conv1d_dx(dy, w, x.shape[-1])
    torch.cuda.synchronize()
    assert D.LAUNCHES == before + 1
    assert _rel(got, D.conv1d_dx_ref(dy, w, x.shape[-1])) <= 1e-4
    r64 = D.conv1d_dx_ref(dy.double(), w.double(), x.shape[-1])
    cudnn = torch.nn.grad.conv1d_input(x.shape, w, dy, stride=2)
    err, err_cudnn = _rel(got.double(), r64), _rel(cudnn.double(), r64)
    if (name, B, L, Cin, Cout, padding) in CELL_SHAPES:  # within twice cuDNN's FP32 dgrad's
        assert err <= 2 * err_cudnn, (name, err, err_cudnn)
    else:  # a sum of a few products, where cuDNN's FP32 is near exact
        assert err <= 1e-5, (name, err, err_cudnn)


@pytest.mark.gpu
@pytest.mark.parametrize("cout,cin,K,bn", [(1024, 512, 5, 128), (128, 64, 5, 64), (7, 9, 4, 16),
                                           (6, 8, 2, 8), (3, 40, 9, 32)])
def test_pack_kernel_matches_pack_weight_on_card(cout, cin, K, bn):
    # bit for bit, special values included
    _card()
    w = torch.randn((cout, cin, K), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    specials = [float("inf"), -float("inf"), float("nan"), 1e-40, -3e-39, 0.0, -0.0, 3.4028235e38]
    w.view(-1)[:len(specials)] = torch.tensor(specials, device="cuda")
    got, want = D._pack_on_card(w, bn), D.pack_weight(w, bn)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_layer_on_card_takes_the_kernel_for_dx_only():
    # dx from the kernel, once; dw from the dw kernel (its own tests are
    # test_torch_conv1d_dw.py's) and db bitwise F.conv1d's; a first layer
    # (input without a gradient) launches no dx; two backward passes and a
    # captured replay are bitwise equal
    _card()
    torch.manual_seed(5)
    layer = Conv1d(256, 512, 5, stride=2).cuda()
    x = torch.randn(8, 256, 512, device="cuda", requires_grad=True)
    params = (layer.weight, layer.bias)
    side = torch.cuda.Stream()  # the forward on the capture's stream, as its backward runs there
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = layer(x)
        dy = torch.randn_like(y)
        before = D.LAUNCHES
        got = torch.autograd.grad(y, (x, *params), dy, retain_graph=True)
        assert D.LAUNCHES == before + 1
        xp = _pad(x, 5, "SAME")
        want = torch.autograd.grad(F.conv1d(xp, *params, stride=2), (x, *params), dy)
        again = torch.autograd.grad(y, (x, *params), dy, retain_graph=True)
        before = D.LAUNCHES
        torch.autograd.grad(layer(x.detach()), params, dy)
        assert D.LAUNCHES == before
    torch.cuda.current_stream().wait_stream(side)
    assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = torch.autograd.grad(y, x, dy, retain_graph=True)[0]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = torch.autograd.grad(y, x, dy, retain_graph=True)[0]
    torch.cuda.current_stream().wait_stream(side)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got[0])
