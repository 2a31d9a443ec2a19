"""The weight gradient of the port's stride-2 convolutions
(``ops/conv1d_dw.py``, routed by ``ops/conv1d_dx.py::conv1d_s2``): the
plain parity-split dw against ``torch.autograd.grad`` of ``F.conv1d`` in
float64 on the CPU at ``test_torch_conv1d_dx.py``'s shapes; the route's
rule; the plan of the kernel's grid; second derivatives through the op
against ``F.conv1d``'s, R1's at the narrow inputs whose dx stays cuDNN's
included; and (on a CUDA card only) the kernel against the plain version,
against float64 beside cuDNN's FP32 wgrad, bitwise repeatable and equal
under a CUDA-graph replay, and its launches per PE iteration.

No JAX here: on the card the file runs with ``pytest --noconftest -m gpu``.
Tolerances: float64 against float64 1e-12 of the maximum (the same sums in
other orders); the kernel 1e-4·max against plain (float32 sums in other
orders) and, against float64, at most twice cuDNN's FP32 wgrad's error on
the same inputs at the cells' shapes (1e-5·max at the edge shapes).
"""

import types

import pytest
import torch
import torch.nn.functional as F

from gennet_tpu_torch.models.layers import Conv1d
from gennet_tpu_torch.ops import conv1d as C
from gennet_tpu_torch.ops import conv1d_dw as W
from gennet_tpu_torch.ops import conv1d_dx as D
from test_torch_conv1d_dx import SHAPES, _case, _pad, _rel
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("name,B,L,Cin,Cout,K,padding", SHAPES)
def test_plain_dw_matches_autograd(name, B, L, Cin, Cout, K, padding):
    x, w, dy = _case(B, L, Cin, Cout, K, padding)
    w.requires_grad_()
    want, = torch.autograd.grad(F.conv1d(x, w, stride=2), w, dy)
    got = W.conv1d_dw_ref(dy, x, K)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-12, name


def _stub(device, dtype, cin, K, cout=64):
    return (types.SimpleNamespace(is_cuda=device == "cuda", dtype=dtype),
            types.SimpleNamespace(dtype=dtype, shape=(cout, cin, K)))


@pytest.mark.parametrize("device,dtype,cin,K,stride,routed,routed_dx", [
    ("cuda", torch.float32, 1, 5, 2, True, False),     # mc_convs.0, BurstPE.conv0, raw-series D Conv_0
    ("cuda", torch.float32, 2, 5, 2, True, False),     # the pair D's Conv_0
    ("cuda", torch.float32, 7, 5, 2, True, False),
    ("cuda", torch.float32, 8, 5, 2, True, True),
    ("cuda", torch.float32, 512, 5, 2, True, True),    # q_convs.4
    ("cuda", torch.float32, 64, 2, 2, True, True),
    ("cuda", torch.float32, 64, 9, 2, True, True),
    ("cuda", torch.bfloat16, 512, 5, 2, False, False),  # a bf16 layer
    ("cuda", torch.float32, 512, 5, 1, False, False),  # every stride-1 layer
    ("cuda", torch.float32, 1, 5, 1, False, False),
    ("cuda", torch.float32, 512, 1, 2, False, False),
    ("cuda", torch.float32, 1, 11, 2, False, False),
    ("cpu", torch.float32, 1, 5, 2, False, False)])
def test_dw_route_rule(device, dtype, cin, K, stride, routed, routed_dx):
    # the layer takes conv1d_s2 (and the dw kernel) at any Cin; its dx is
    # the dx kernel's from 8 input channels
    assert D.routes(*_stub(device, dtype, cin, K), stride) is routed
    assert D.routes_dx(*_stub(device, dtype, cin, K), stride) is routed_dx


# (B, Ly, Cin, Cout, K) of every routed call of the cells
PLANNED = [(64, 506, 256, 512, 5), (64, 251, 512, 1024, 5), (64, 512, 1, 64, 5),
           (64, 254, 64, 128, 5), (64, 125, 128, 256, 5), (64, 61, 256, 512, 5),
           (64, 256, 1, 64, 5), (64, 126, 64, 128, 5), (8, 512, 256, 64, 5),
           (8, 256, 256, 512, 5), (8, 512, 1, 256, 5), (8, 512, 2, 256, 5), (3, 17, 9, 1, 3)]


@pytest.mark.parametrize("B,Ly,Cin,Cout,K", PLANNED)
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_fits_the_grid_to_the_shape(B, Ly, Cin, Cout, K, sms):
    bn, mt, splits = W.plan(B, Ly, Cin, Cout, K, sms)
    items = B * -(-Ly // W.STAGE)
    tiles = -(-W.rows(Cin, K) // (128 * mt)) * -(-Cout // bn)
    mt_want = 2 if W.rows(Cin, K) >= 512 else 1
    assert mt == mt_want and bn == (min(C.tile_n(Cout), 64) if mt == 2 else C.tile_n(Cout))
    assert 1 <= splits <= min(items, 2 * sms)  # no block without a stage

    def span(s):  # waves of blocks times the stages of the longest split
        return -(-tiles * s // sms) * -(-items // s)

    # never longer than one split or than one wave of as many splits as fit
    assert span(splits) <= min(span(1), span(max(1, min(items, sms // tiles))))


def test_plan_splits_q_convs_4_into_whole_waves():
    # q_convs.4 at batch 64: 10 x 16 tiles of 256 x 64 over 64 x 8 stages;
    # 4 splits make 640 blocks, 4.85 waves of 132 (1 split: 1.2 waves)
    assert W.plan(64, 251, 512, 1024, 5, 132) == (64, 2, 4)


def _second(conv, wrt):
    """(x, w, b) ↦ the gradient of a loss through ``conv`` with respect to
    ``wrt`` (0: x, 1: w), kept differentiable."""
    def f(x, w, b):
        y = torch.tanh(conv(torch.sin(x), w, b))
        g, = torch.autograd.grad((y ** 2).sum(), (x, w)[wrt], create_graph=True)
        return g
    return f


@pytest.mark.parametrize("cin,wrt", [(1, 0), (2, 0), (9, 1), (1, 1)])
def test_second_derivatives_match_conv1d(cin, wrt):
    # wrt 0: R1's gradient of the input gradient, at the narrow inputs whose
    # dx is cuDNN's; wrt 1: the weight gradient differentiated again (its
    # second derivatives with respect to x, w and b), which must never
    # silently be zero
    x, w, _ = _case(2, 23, cin, 5, 5, "VALID", seed=3)
    b = torch.randn(5, dtype=torch.float64)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    assert torch.autograd.gradcheck(_second(D.conv1d_s2, wrt), (x, w, b))
    got = torch.autograd.grad((_second(D.conv1d_s2, wrt)(x, w, b) ** 2).sum(), (x, w, b))
    ref = _second(lambda *a: F.conv1d(*a, stride=2), wrt)
    want = torch.autograd.grad((ref(x, w, b) ** 2).sum(), (x, w, b))
    for a, r in zip(got, want):
        assert r.abs().max() > 0 and _rel(a, r) <= 1e-12


def test_cpu_tensors_never_count_launches():
    x, w, dy = _case(2, 40, 8, 6, 5, "VALID", dtype=torch.float32)
    before = W.LAUNCHES
    got = W.conv1d_dw(dy, x, 5)
    assert W.LAUNCHES == before and got.shape == w.shape


@pytest.mark.parametrize("bad", ["dims", "length", "batch", "dtype", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    dy, x, K = torch.ones(2, 4, 18), torch.ones(2, 3, 40), 5
    if bad == "dims":
        dy = dy[0]
    elif bad == "length":
        x = torch.ones(2, 3, 43)
    elif bad == "batch":
        x = torch.ones(3, 3, 40)
    elif bad == "dtype":
        x = x.double()
    elif bad == "device":
        dy, x = dy.to("meta"), x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        W.conv1d_dw(dy, x, K)


# ---- on the card ----------------------------------------------------------

# the routed shapes of the cells, at their batch: (name, B, L, Cin, Cout, K,
# padding); the dx kernel's CELL_SHAPES, the narrow-input layers, then edge
# shapes (odd L, Cout 1, Cin·K < 8, B·Ly no multiple of the split)
DW_CELL_SHAPES = [("q_convs.3", 64, 1016, 256, 512, 5, "VALID"),
                  ("q_convs.4", 64, 506, 512, 1024, 5, "VALID"),
                  ("mc_convs.0", 64, 1024, 1, 64, 5, "SAME"),
                  ("mc_convs.1", 64, 512, 64, 128, 5, "VALID"),
                  ("mc_convs.2", 64, 254, 128, 256, 5, "VALID"),
                  ("mc_convs.3", 64, 125, 256, 512, 5, "VALID"),
                  ("BurstPE conv0", 64, 512, 1, 64, 5, "SAME"),
                  ("BurstPE conv1", 64, 256, 64, 128, 5, "VALID"),
                  ("G Conv_0", 8, 1024, 256, 64, 5, "SAME"),
                  ("D Conv_1", 8, 512, 256, 512, 5, "SAME"),
                  ("D Conv_0 Cin 1", 8, 1024, 1, 256, 5, "SAME"),
                  ("D Conv_0 Cin 2", 8, 1024, 2, 256, 5, "SAME")]
DW_EDGE_SHAPES = [("odd L", 3, 255, 9, 7, 5, "SAME"), ("Cout 1", 2, 37, 8, 1, 5, "VALID"),
                  ("Cin K 3", 5, 41, 1, 16, 3, "VALID"), ("K 9", 3, 77, 20, 40, 9, "VALID"),
                  ("K 2 ragged", 7, 131, 33, 130, 2, "SAME")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1d_dw kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,L,Cin,Cout,K,padding", DW_CELL_SHAPES + DW_EDGE_SHAPES)
def test_kernel_matches_plain_and_float64_on_card(name, B, L, Cin, Cout, K, padding):
    _card()
    x, w, dy = _case(B, L, Cin, Cout, K, padding, dtype=torch.float32, device="cuda")
    before = W.LAUNCHES
    got = W.conv1d_dw(dy, x, K)
    torch.cuda.synchronize()
    assert W.LAUNCHES == before + 1
    assert _rel(got, W.conv1d_dw_ref(dy, x, K)) <= 1e-4
    r64 = W.conv1d_dw_ref(dy.double(), x.double(), K)
    cudnn = torch.nn.grad.conv1d_weight(x, w.shape, dy, stride=2)
    err, err_cudnn = _rel(got.double(), r64), _rel(cudnn.double(), r64)
    assert torch.equal(got, W.conv1d_dw(dy, x, K))  # bitwise repeatable
    if (name, B, L, Cin, Cout, K, padding) in DW_CELL_SHAPES:  # within twice cuDNN's FP32 wgrad's
        assert err <= 2 * err_cudnn, (name, err, err_cudnn)
    else:  # short sums, where cuDNN's FP32 is near exact
        assert err <= 1e-5, (name, err, err_cudnn)


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [256, 2])
def test_layer_on_card_takes_the_dw_kernel_bitwise_under_replay(cin):
    # dw from the kernel, once, and dx from the dx kernel (Cin 256) or
    # cuDNN (Cin 2); db bitwise F.conv1d's; a first layer (input without a
    # gradient) launches no dx; two backward passes and a captured replay
    # are bitwise equal
    _card()
    torch.manual_seed(5)
    layer = Conv1d(cin, 512, 5, stride=2).cuda()
    x = torch.randn(8, cin, 512, device="cuda", requires_grad=True)
    params = (layer.weight, layer.bias)
    side = torch.cuda.Stream()  # the forward on the capture's stream, as its backward runs there
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = layer(x)
        dy = torch.randn_like(y)
        before = W.LAUNCHES, D.LAUNCHES
        got = torch.autograd.grad(y, (x, *params), dy, retain_graph=True)
        assert (W.LAUNCHES - before[0], D.LAUNCHES - before[1]) == (1, int(cin >= D.MIN_CIN))
        xp = _pad(x, 5, "SAME")
        want = torch.autograd.grad(F.conv1d(xp, *params, stride=2), (x, *params), dy)
        again = torch.autograd.grad(y, (x, *params), dy, retain_graph=True)
        before = W.LAUNCHES, D.LAUNCHES
        torch.autograd.grad(layer(x.detach()), params, dy)
        assert (W.LAUNCHES - before[0], D.LAUNCHES - before[1]) == (1, 0)
    torch.cuda.current_stream().wait_stream(side)
    assert _rel(got[0], want[0]) <= 1e-4 and _rel(got[1], want[1]) <= 1e-4
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = torch.autograd.grad(y, params[0], dy, retain_graph=True)[0]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = torch.autograd.grad(y, params[0], dy, retain_graph=True)[0]
    torch.cuda.current_stream().wait_stream(side)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got[1])


@pytest.mark.gpu
@pytest.mark.parametrize("model,n_pix,expect", [("DualBranchPE", 1024, 6), ("BurstPE", 512, 2)])
def test_dw_launches_per_pe_iteration_on_card(model, n_pix, expect):
    # one dw launch per stride-2 layer an iteration, read at the chunk's
    # capture: mc_convs.0-3 and q_convs.3-4, BurstPE's conv0 and conv1
    _card()
    from gennet_tpu_torch import models
    from gennet_tpu_torch.train import cnn as tcnn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    cfg = tcnn.CNNConfig(n_pix=n_pix, batch_size=64)
    st = tcnn.init_cnn(torch.Generator().manual_seed(1), getattr(models, model)(n_pix=n_pix),
                       cfg, dev)
    bank = torch.randn((4096, n_pix), generator=g, device=dev)
    targets = torch.rand((4096, 2), generator=g, device=dev)
    scan = tcnn.make_cnn_step_scan(st.model, cfg, 5)
    before = W.LAUNCHES
    scan(st, bank, targets, torch.Generator(device=dev).manual_seed(2))
    assert scan.graph.launches.get(W, 0) == expect
    assert W.LAUNCHES - before == 5 * expect
