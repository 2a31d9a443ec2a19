"""The input gradient (dx) of a stride-2 1-D convolution: the CUDA kernel's
wrapper, its plain PyTorch version, and the op through which
``models.layers.Conv1d`` takes it and the weight gradient
(``ops/conv1d_dw.py``).

For y = ``F.conv1d(x, w, stride=2)`` with x (B, Cin, L), w (Cout, Cin, K)
and dy (B, Cout, Ly), Ly = (L − K) // 2 + 1,

    dx[b, ci, t] = Σ_{co, k: t − k even} w[co, ci, k] · dy[b, co, (t − k)/2]

taken as two dense stride-1 correlations over dy, one per parity p of t,
with the taps k ≡ p (mod 2): no zero-stuffed dy, no zero tap
(``csrc/conv1d_dx_s2.cu``). On a CUDA tensor :func:`conv1d_dx` launches
the kernel; on a CPU tensor it runs the plain version
(:func:`conv1d_dx_ref`), which the tests and the on-card comparison also
use. There is no fallback from one to the other: a CUDA tensor launches
the kernel or raises.

The route depends only on what the layer sees. A float32 CUDA call at
stride 2 with a tap count the kernels take (2 to ``MAX_K``) runs
:func:`conv1d_s2` (:func:`routes`): its forward is cuDNN's ``F.conv1d``,
its weight gradient the dw kernel's at any Cin (D Conv_0's Cin 1 and 2
included), and its bias gradient F.conv1d's own node, which sums dy over
(0, 2). Its input gradient is this module's kernel where the call has at
least ``MIN_CIN`` input channels (:func:`routes_dx`: the kernel's narrowest
N tile is 8 channels of dx), else cuDNN's. Each gradient has a node of its
own, so the engine computes only those it asks for.
"""

import torch
import torch.nn.functional as F

from gennet_tpu_torch.ops import _build
from gennet_tpu_torch.ops import conv1d as conv_ops
from gennet_tpu_torch.ops import conv1d_dw
from gennet_tpu_torch.ops.tf32 import cached_pack

# Kernel launches in this process. Incremented only where the kernel is
# launched, so a run can show that its main path went through the kernel.
LAUNCHES = 0

MIN_CIN = 8  # the kernel's narrowest N tile
MAX_K = 9


def routes(x: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    """Whether a conv layer's call takes :func:`conv1d_s2`, whose weight
    gradient is the dw kernel's (see the module docstring)."""
    return (stride == 2 and x.is_cuda and x.dtype == torch.float32
            and w.dtype == torch.float32 and 2 <= w.shape[-1] <= MAX_K)


def routes_dx(x: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    """Whether such a call's input gradient is this module's kernel too."""
    return routes(x, w, stride) and w.shape[1] >= MIN_CIN


def conv1d_dx_ref(dy: torch.Tensor, w: torch.Tensor, L: int) -> torch.Tensor:
    """Plain version: each parity's half of dx as one ``F.conv1d`` of dy,
    left-padded by Kp − 1, with the parity's taps flipped and channels
    swapped, Wp[ci, co, u] = w[co, ci, p + 2(Kp − 1 − u)]."""
    B, _, Ly = dy.shape
    dx = dy.new_zeros((B, w.shape[1], L))
    for p in (0, 1):
        taps = w[:, :, p::2].flip(-1).transpose(0, 1)  # (Cin, Cout, Kp)
        kp, M = taps.shape[-1], (L + 1 - p) // 2
        if kp:
            dx[:, :, p::2] = F.conv1d(F.pad(dy, (kp - 1, max(M - Ly, 0))), taps)[..., :M]
    return dx


def tile_n(cin: int) -> int:
    """The kernel's N tile for ``cin`` channels of dx (as the forward
    kernel's for its Cout: :func:`gennet_tpu_torch.ops.conv1d.tile_n`)."""
    return conv_ops.tile_n(cin)


def pack_weight(w: torch.Tensor, bn: int) -> torch.Tensor:
    """The kernel's B operand, flat: for each parity p, the even first,
    :func:`gennet_tpu_torch.ops.conv1d.pack_weight` of Wp (Cin, Cout, Kp)
    at tile width ``bn``, the 3xTF32 split in the stage layout
    (Cin / bn, cout8 / 8, hi|lo, Kp, bn x 8). The plain version of the
    library's pack kernel (:func:`_pack_on_card`)."""
    return torch.cat([conv_ops.pack_weight(w[:, :, p::2].flip(-1).transpose(0, 1), bn=bn)
                      .reshape(-1) for p in (0, 1)])


def _pack_on_card(w: torch.Tensor, bn: int) -> torch.Tensor:
    """:func:`pack_weight` of a CUDA weight, bit for bit, in one launch."""
    cout, cin, K = w.shape
    pack = torch.empty(-(-cin // bn) * -(-cout // 8) * 2 * K * bn * 8, dtype=torch.float32,
                       device=w.device)
    lib = _build.load()
    with torch.cuda.device(w.device):
        rc = lib.conv1d_dx_s2_pack_f32(w.data_ptr(), pack.data_ptr(), cout, cin, K, bn,
                                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1d_dx_s2_pack_f32 launch failed ({rc}: "
                           f"{lib.gennet_cuda_error_string(rc).decode()}) at w {tuple(w.shape)}")
    return pack


def _check(dy, w, L):
    for name, t in (("dy", dy), ("w", w)):
        if t.ndim != 3:
            raise ValueError(f"conv1d_dx: {name} must be 3-D, got shape {tuple(t.shape)}")
        if t.device != dy.device or t.dtype != dy.dtype:
            raise ValueError(f"conv1d_dx: w is {w.dtype} on {w.device}, dy {dy.dtype} on "
                             f"{dy.device}")
    K = w.shape[-1]
    if dy.shape[1] != w.shape[0] or L < K or dy.shape[-1] != (L - K) // 2 + 1:
        raise ValueError(f"conv1d_dx: dy {tuple(dy.shape)} is not the stride-2 output of w "
                         f"{tuple(w.shape)} over L={L}")
    if dy.device.type == "cuda":
        if dy.dtype != torch.float32:
            raise TypeError(f"conv1d_dx: the kernel takes float32, got {dy.dtype}")
        if not (dy.is_contiguous() and w.is_contiguous()):
            raise ValueError("conv1d_dx: dy and w must be contiguous")
        if not 2 <= K <= MAX_K:
            raise ValueError(f"conv1d_dx: the kernel takes K from 2 to {MAX_K}, got K={K}")
    elif dy.device.type != "cpu":
        raise ValueError(f"conv1d_dx: unsupported device {dy.device}")


def conv1d_dx(dy: torch.Tensor, w: torch.Tensor, L: int) -> torch.Tensor:
    """dx (B, Cin, L) of y = ``F.conv1d(x, w, stride=2)`` for x of length
    ``L``, from dy (B, Cout, Ly). On a CUDA tensor: the kernel, float32,
    contiguous, K from 2 to ``MAX_K``; any B, L, Cin, Cout."""
    global LAUNCHES
    _check(dy, w, L)
    if dy.device.type == "cpu":
        return conv1d_dx_ref(dy, w, L)
    (B, Cout, Ly), (_, Cin, K) = dy.shape, w.shape
    bn = tile_n(Cin)
    pack = cached_pack(f"conv_dx_s2_{bn}", (w,), lambda: _pack_on_card(w, bn))
    dx = torch.empty((B, Cin, L), dtype=torch.float32, device=dy.device)
    if dx.numel() == 0:
        return dx
    lib = _build.load()
    with torch.cuda.device(dy.device):
        rc = lib.conv1d_dx_s2_f32(dy.data_ptr(), pack.data_ptr(), dx.data_ptr(), B, L, Ly, Cin,
                                  Cout, K, bn, torch.cuda.current_stream(dy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1d_dx_s2_f32 launch failed ({rc}: "
                           f"{lib.gennet_cuda_error_string(rc).decode()}) at B={B} L={L} "
                           f"Cin={Cin} Cout={Cout} K={K}")
    LAUNCHES += 1
    return dx


class _Dx(torch.autograd.Function):
    """:func:`conv1d_dx` as a function of (dy, w) that can be differentiated
    once more (R1's gradient of a gradient runs through it): its adjoints
    are the strided conv of the incoming gradient and that conv's weight
    gradient."""

    @staticmethod
    def forward(ctx, dy, w, L):
        ctx.save_for_backward(dy, w)
        return conv1d_dx(dy, w, L)

    @staticmethod
    def backward(ctx, g):
        dy, w = ctx.saved_tensors
        d_dy = F.conv1d(g, w, stride=2) if ctx.needs_input_grad[0] else None
        d_w = (torch.nn.grad.conv1d_weight(g, w.shape, dy, stride=2)
               if ctx.needs_input_grad[1] else None)
        return d_dy, d_w, None


class _Dw(torch.autograd.Function):
    """:func:`~gennet_tpu_torch.ops.conv1d_dw.conv1d_dw` as a function of
    (dy, x) that can be differentiated once more: dw is bilinear in them,
    so its adjoints are the strided conv of x by the incoming gradient and
    that gradient's transposed conv of dy."""

    @staticmethod
    def forward(ctx, dy, x, K):
        ctx.save_for_backward(dy, x)
        return conv1d_dw.conv1d_dw(dy, x, K)

    @staticmethod
    def backward(ctx, g):
        dy, x = ctx.saved_tensors
        d_dy = F.conv1d(x, g, stride=2) if ctx.needs_input_grad[0] else None
        d_x = (torch.nn.grad.conv1d_input(x.shape, g, dy, stride=2)
               if ctx.needs_input_grad[1] else None)
        return d_dy, d_x, None


class _InputGrad(torch.autograd.Function):
    """The input gradient of :func:`conv1d_s2` as a node of its own: on x, a
    token of y's shape whose value is never read; its backward gives x the
    kernel's dx of the dy that :class:`_Join` hands it where
    :func:`routes_dx`, else cuDNN's. w comes inside a tuple, so that it is
    not an input of this node (a pass that asks for dw alone never runs
    it), and keeps its history for R1's second derivatives."""

    @staticmethod
    def forward(ctx, x, shape, held):
        ctx.save_for_backward(held[0])
        ctx.x_shape = x.shape
        return x.new_empty(()).expand(shape)

    @staticmethod
    def backward(ctx, dy):
        w, = ctx.saved_tensors
        dy = dy.contiguous()
        dx = (_Dx.apply(dy, w, ctx.x_shape[-1]) if w.shape[1] >= MIN_CIN
              else torch.nn.grad.conv1d_input(ctx.x_shape, w, dy, stride=2))
        return dx, None, None


class _WeightGrad(torch.autograd.Function):
    """The weight gradient of :func:`conv1d_s2` as a node of its own, as
    :class:`_InputGrad` is the input gradient's: on w, with x inside the
    tuple; its backward gives w the dw kernel's gradient."""

    @staticmethod
    def forward(ctx, w, shape, held):
        ctx.save_for_backward(held[0])
        ctx.taps = w.shape[-1]
        return w.new_empty(()).expand(shape)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        return _Dw.apply(dy.contiguous(), x.contiguous(), ctx.taps), None, None


class _Join(torch.autograd.Function):
    """y, F.conv1d's value (whose own node gives the bias dy's sum over
    (0, 2)), joined with the gradient tokens: the identity on y, whose
    backward hands dy to each. The engine then runs a token's node only
    when it needs that token's input's gradient."""

    @staticmethod
    def forward(ctx, y, *tokens):
        return y

    @staticmethod
    def backward(ctx, dy):
        return (dy,) * len(ctx.needs_input_grad)


def conv1d_s2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``F.conv1d(x, w, bias, stride=2)`` (no padding: the layer pads
    first) whose weight gradient is the dw kernel's and whose input
    gradient is :func:`conv1d_dx` where :func:`routes_dx`, each computed
    only when the engine asks for it."""
    y = F.conv1d(x.detach(), w.detach(), bias, stride=2)
    tokens = [grad.apply(t, y.shape, (other,))
              for grad, t, other in ((_InputGrad, x, w), (_WeightGrad, w, x)) if t.requires_grad]
    return _Join.apply(y, *tokens) if tokens else y
