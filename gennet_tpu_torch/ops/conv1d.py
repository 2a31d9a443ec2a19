"""SAME-padded 1-D convolution with fused bias and activation: the CUDA
kernel's wrapper, its plain PyTorch version, and the differentiable layer
op built on them (port of ``gennet_tpu.ops.pallas_conv1d``).

    out[b, co, j] = act(Σ_{ci,k} x[b, ci, j·s + k − pad_low] · w[co, ci, k] + bias[co])

with x zero outside [0, L) and flax's SAME padding: ``pad_low = (K − 1)/2``
at stride 1 (K odd), ``pad_total // 2`` at stride s (:func:`stride_offset`).
Tensors are in the port's layouts: x (B, Cin, L), w (Cout, Cin, K) as
``Conv1d.weight``, out (B, Cout, ⌈L/s⌉). On a CUDA tensor the ops launch
the hand-written kernel (``csrc/conv1d_same.cu``, a 3xTF32 implicit GEMM
that computes strided layers natively); on a CPU tensor they run the plain
version (:func:`conv1d_ref`), which the tests and the on-card comparison
also use. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.
"""

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from gennet_tpu_torch.ops import _build
from gennet_tpu_torch.ops.tf32 import cached_pack, split_tf32

# Kernel launches in this process. Incremented only where the kernel is
# launched, so a run can show that its main path went through the kernel.
LAUNCHES = 0

ACTS = {"none": 0, "tanh": 1, "leaky_relu": 2, "relu": 3}
KERNEL_TAPS = (1, 3, 5, 7, 9)  # the tap counts the kernel takes


def _apply_act(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "tanh":
        return torch.tanh(y)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, slope * y)
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    return y


def conv1d_same_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, act: str = "none",
                    slope: float = 0.2) -> torch.Tensor:
    """Plain version at stride 1: :func:`conv1d_ref`."""
    return conv1d_ref(x, w, bias, 1, act, slope)


def stride_offset(L: int, K: int, stride: int) -> tuple:
    """(offset, out_len) that sample a stride-1 SAME output into flax's
    stride-``stride`` SAME output: flax pads ``pad_total // 2`` low with
    ``pad_total = (⌈L/s⌉ − 1)·s + K − L``, the stride-1 op (K − 1)/2."""
    out_len = -(-L // stride)
    pad_low = max((out_len - 1) * stride + K - L, 0) // 2
    return (K - 1) // 2 - pad_low, out_len


def conv1d_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, stride: int = 1,
               act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """Plain version at any stride: ``F.conv1d`` at that stride with flax's
    SAME padding (what ``models.layers.Conv1d`` runs; symmetric padding
    without a padded copy), then the activation. It equals the stride-1
    output sampled by :func:`stride_offset`. On the card it goes through
    cuDNN, so a caller comparing with the kernel sets
    ``torch.backends.cudnn.allow_tf32 = False``."""
    L, K = x.shape[-1], w.shape[-1]
    off, out_len = stride_offset(L, K, stride)
    pad_low = (K - 1) // 2 - off
    pad_high = max((out_len - 1) * stride + K - L, 0) - pad_low
    if pad_low != pad_high:
        x, pad_low = F.pad(x, (pad_low, pad_high)), 0
    y = F.conv1d(x, w, bias, stride=stride, padding=pad_low)
    return _apply_act(y, act, slope)


def tile_n(cout: int) -> int:
    """The kernel's N tile for ``cout`` output channels: the smallest of 8,
    16, 32, 64, 128 that holds them (128 for wider layers)."""
    return next((n for n in (8, 16, 32, 64) if cout <= n), 128)


def pack_weight(w: torch.Tensor, transposed: bool = False, bn: int | None = None) -> torch.Tensor:
    """The kernel's B operand: the 3xTF32 split (hi, lo) of the weight, laid
    out as the shared-memory image of each pipeline stage,

        (Cout / BN, cin8 / 8, hi|lo, K, 2, BN / 8, 8, 4)   BN = bn or tile_n(Cout)

    i.e. for each N tile and 8-channel chunk, per tap a K-major BN x 8 tile
    of 2 x BN/8 core matrices of 8 rows x 4 channels, Cout padded to BN and
    Cin to cin8 with zeros. With ``transposed`` the weight of dx: taps
    flipped, channels swapped, i.e. the pack of ``w.flip(-1).transpose(0,
    1)``. This is the plain version of the library's pack kernel, which
    makes the same pack on the card in one launch (:func:`_pack_on_card`)."""
    taps = w.flip(-1).transpose(0, 1) if transposed else w  # (Cout', Cin', K)
    cout, cin, K = taps.shape
    bn = bn or tile_n(cout)
    full = F.pad(taps, (0, 0, 0, -cin % 8, 0, -cout % bn))
    tiles = full.reshape(-1, bn // 8, 8, full.shape[1] // 8, 2, 4, K).permute(0, 3, 6, 4, 1, 2, 5)
    return torch.stack(split_tf32(tiles.contiguous()), dim=2).contiguous()


def unpack_weight(pack: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """(Cout, Cin, K) weight from a pack: the inverse of :func:`pack_weight`."""
    n_tiles, n_chunks, _, K, _, g, _, _ = pack.shape
    tiles = (pack[:, :, 0] + pack[:, :, 1]).permute(0, 4, 5, 1, 3, 6, 2)
    return tiles.reshape(n_tiles * g * 8, n_chunks * 8, K)[:cout, :cin].contiguous()


def _pack_on_card(w: torch.Tensor, transposed: bool) -> torch.Tensor:
    """:func:`pack_weight` of a CUDA weight, bit for bit, made by the
    library's pack kernel in one launch."""
    cout, cin, K = w.shape
    rows, chans = (cin, cout) if transposed else (cout, cin)
    bn = tile_n(rows)
    pack = torch.empty((-(-rows // bn), -(-chans // 8), 2, K, 2, bn // 8, 8, 4),
                       dtype=torch.float32, device=w.device)
    lib = _build.load()
    with torch.cuda.device(w.device):
        rc = lib.conv1d_pack_weight_f32(w.data_ptr(), pack.data_ptr(), cout, cin, K, bn,
                                        int(transposed), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1d_pack_weight_f32 launch failed ({rc}: "
                           f"{lib.gennet_cuda_error_string(rc).decode()}) at w {tuple(w.shape)}")
    return pack


def _packed(w: torch.Tensor, transposed: bool) -> torch.Tensor:
    """The pack of a CUDA weight, reused while the weight is unchanged: the
    posterior draws run G 16 times per cloud on one pack, and a training
    step packs each weight once (once more for dx), after the optimizer's
    in-place update has bumped its ``_version``."""
    return cached_pack("conv_dx" if transposed else "conv", (w,),
                       lambda: _pack_on_card(w, transposed))


def _check(x, w, bias, act, stride=1):
    if act not in ACTS:
        raise ValueError(f"conv1d_same: act must be one of {sorted(ACTS)}, got {act!r}")
    if not (isinstance(stride, int) and stride >= 1):
        raise ValueError(f"conv1d_same: stride must be a positive int, got {stride!r}")
    for name, t, ndim in (("x", x, 3), ("w", w, 3), ("bias", bias, 1)):
        if t.dtype != torch.float32:
            raise TypeError(f"conv1d_same: {name} must be float32, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"conv1d_same: {name} must be {ndim}-D, got shape {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"conv1d_same: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv1d_same: {name} must be contiguous")
    Cout, Cin, K = w.shape
    if K % 2 != 1:
        raise ValueError(f"conv1d_same: the tap count must be odd, got K={K}")
    if x.shape[1] != Cin or bias.shape[0] != Cout:
        raise ValueError(f"conv1d_same: x {tuple(x.shape)}, w {tuple(w.shape)} and bias "
                         f"{tuple(bias.shape)} do not match")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv1d_same: unsupported device {x.device}")
    if x.device.type == "cuda" and K not in KERNEL_TAPS:
        raise ValueError(f"conv1d_same: the kernel takes K in {KERNEL_TAPS}, got K={K}")


def _launch(x, w_pack, bias, Cout, K, stride, act, slope):
    """The kernel on CUDA tensors: x (B, Cin, L), a weight pack and a bias
    (or None)."""
    global LAUNCHES
    B, Cin, L = x.shape
    off, L_out = stride_offset(L, K, stride)
    out = torch.empty((B, Cout, L_out), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv1d_same_f32(x.data_ptr(), w_pack.data_ptr(),
                                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                                 B, L, Cin, Cout, K, stride, (K - 1) // 2 - off, L_out,
                                 tile_n(Cout), ACTS[act], float(slope), stream)
    if rc != 0:
        msg = lib.gennet_cuda_error_string(rc).decode()
        raise RuntimeError(f"conv1d_same_f32 launch failed ({rc}: {msg}) at B={B} L={L} "
                           f"Cin={Cin} Cout={Cout} K={K} stride={stride}")
    LAUNCHES += 1
    return out


def conv1d_same(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, act: str = "none",
                slope: float = 0.2) -> torch.Tensor:
    """SAME stride-1 conv1d + bias + activation. x (B, Cin, L), w (Cout,
    Cin, K) with K odd, bias (Cout,), all float32 and contiguous on one
    device. Returns (B, Cout, L). Forward only (see :class:`Conv1dTrain`).
    On a CUDA tensor K must be one of ``KERNEL_TAPS``; any B, L, Cin."""
    _check(x, w, bias, act)
    if x.device.type == "cpu":
        return conv1d_same_ref(x, w, bias, act, slope)
    return _launch(x, _packed(w, False), bias, w.shape[0], w.shape[-1], 1, act, slope)


def conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, stride: int = 1,
           act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """:func:`conv1d_same` at stride ``stride`` with flax's SAME padding
    (the reference's ``conv1d``; forward only). Returns (B, Cout, ⌈L/s⌉);
    the kernel computes only those outputs."""
    if stride == 1:
        return conv1d_same(x, w, bias, act, slope)
    _check(x, w, bias, act, stride)
    if x.device.type == "cpu":
        return conv1d_ref(x, w, bias, stride, act, slope)
    return _launch(x, _packed(w, False), bias, w.shape[0], w.shape[-1], stride, act, slope)


def _conv1d_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of a SAME stride-1 conv: the same conv with taps flipped and
    channels transposed, without bias. dy (B, Cout, L), w (Cout, Cin, K)."""
    if dy.device.type == "cpu":
        return conv1d_same_ref(dy, w.flip(-1).transpose(0, 1), None)
    return _launch(dy, _packed(w, True), None, w.shape[1], w.shape[-1], 1, "none", 0.0)


class Conv1dTrain(torch.autograd.Function):
    """Differentiable SAME conv1d at stride s (port of ``conv1d_train``;
    the reference's strided layer is ``conv1d_train`` sampled).

    Forward is :func:`conv1d` without activation: the kernel at stride s.
    Backward: dy is zero-stuffed back to the stride-1 grid (what autograd
    through the sampling gives), then dx is the stride-1 kernel with taps
    flipped and in/out channels transposed (SAME stride-1 is
    self-transposing for odd K); dw (one contraction) and db are torch ops,
    as the JAX package leaves them to XLA. The backward is not itself
    differentiable (the kernel's output carries no graph), so a second
    derivative, such as R1's gradient of a gradient, raises rather than
    silently drop the conv's terms; the reference's Pallas body has no
    second derivative either.
    """

    @staticmethod
    def forward(ctx, x, w, bias, stride=1):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return conv1d(x, w, bias, stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        B, _, L = x.shape
        K = w.shape[-1]
        dy = dy.contiguous()
        if ctx.stride > 1:
            off, out_len = stride_offset(L, K, ctx.stride)
            full = dy.new_zeros((B, dy.shape[1], L))
            full[:, :, off::ctx.stride][:, :, :out_len] = dy
            dy = full
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _conv1d_dx(dy, w)
        if ctx.needs_input_grad[1]:
            # dw[co, ci, k] = Σ_{b,l} x_pad[b, ci, l + k] · dy[b, co, l], one
            # contraction (K per-tap einsums cost ~15 host launches a layer)
            dw = torch.nn.grad.conv1d_weight(x, w.shape, dy, padding=(K - 1) // 2)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2))
        return dx, dw, db, None


def conv1d_train(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 stride: int = 1) -> torch.Tensor:
    """Differentiable SAME conv1d at stride ``stride``, no activation; see
    :class:`Conv1dTrain`."""
    return Conv1dTrain.apply(x, w, bias, stride)
