"""SAME-padded 1-D convolution with fused bias and activation: the CUDA
kernel's wrapper, its plain PyTorch version, and the differentiable layer
op built on them (port of ``gennet_tpu.ops.pallas_conv1d``).

    out[b, co, l] = act(Σ_{ci,k} x_pad[b, ci, l + k] · w[co, ci, k] + bias[co])

with ``pad = (K − 1) / 2`` zeros on both sides (K odd). Tensors are in the
port's layouts: x (B, Cin, L), w (Cout, Cin, K) as ``Conv1d.weight``, out
(B, Cout, L). On a CUDA tensor :func:`conv1d_same` launches the
hand-written kernel (``csrc/conv1d_same.cu``); on a CPU tensor it runs
:func:`conv1d_same_ref`, the plain version, which the tests and the
on-card comparison also use. There is no fallback from one to the other: a
CUDA tensor launches the kernel or raises.
"""

import torch
import torch.nn.functional as F

from gennet_tpu_torch.ops import _build

# Kernel launches in this process. Incremented only where the kernel is
# launched, so a run can show that its main path went through the kernel.
LAUNCHES = 0

ACTS = {"none": 0, "tanh": 1, "leaky_relu": 2, "relu": 3}
KERNEL_TAPS = (1, 3, 5, 7, 9)  # the tap counts the kernel is instantiated for


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
    """Plain version: ``F.conv1d`` with symmetric SAME padding, then the
    activation. On the card it goes through cuDNN, so a caller comparing
    with the kernel sets ``torch.backends.cudnn.allow_tf32 = False``."""
    y = F.conv1d(x, w, bias, padding=(w.shape[-1] - 1) // 2)
    return _apply_act(y, act, slope)


def _check(x, w, bias, act):
    if act not in ACTS:
        raise ValueError(f"conv1d_same: act must be one of {sorted(ACTS)}, got {act!r}")
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


def conv1d_same(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, act: str = "none",
                slope: float = 0.2) -> torch.Tensor:
    """SAME stride-1 conv1d + bias + activation. x (B, Cin, L), w (Cout,
    Cin, K) with K odd, bias (Cout,), all float32 and contiguous on one
    device. Returns (B, Cout, L). Forward only (see :class:`Conv1dTrain`).
    On a CUDA tensor K must be one of ``KERNEL_TAPS`` and Cin at most what
    the kernel's shared-memory window holds (1329 at K = 5)."""
    global LAUNCHES
    _check(x, w, bias, act)
    if x.device.type == "cpu":
        return conv1d_same_ref(x, w, bias, act, slope)
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_same: unsupported device {x.device}")
    B, Cin, L = x.shape
    Cout, _, K = w.shape
    out = torch.empty((B, Cout, L), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    max_cin = lib.conv1d_same_max_cin(K)
    if K not in KERNEL_TAPS or Cin > max_cin:
        raise ValueError(f"conv1d_same: the kernel takes K in {KERNEL_TAPS} and Cin ≤ {max_cin} "
                         f"at K={K}, got K={K} Cin={Cin}")
    w_taps = w.permute(2, 1, 0).contiguous()  # (K, Cin, Cout): a channel tile is contiguous
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv1d_same_f32(x.data_ptr(), w_taps.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), B, L, Cin, Cout, K, ACTS[act], float(slope),
                                 stream)
    if rc != 0:
        msg = lib.gennet_cuda_error_string(rc).decode()
        raise RuntimeError(f"conv1d_same_f32 launch failed ({rc}: {msg}) at B={B} L={L} "
                           f"Cin={Cin} Cout={Cout} K={K}")
    LAUNCHES += 1
    return out


class Conv1dTrain(torch.autograd.Function):
    """Differentiable SAME stride-1 conv1d (port of ``conv1d_train``).

    Forward is :func:`conv1d_same` without activation. Backward: dx is the
    same kernel with taps flipped and in/out channels transposed, at zero
    bias (SAME stride-1 is self-transposing for odd K); dw and db are K
    shifted contractions in torch ops, as the JAX package leaves them to XLA.
    """

    @staticmethod
    def forward(ctx, x, w, bias):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return conv1d_same(x, w, bias)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        K = w.shape[-1]
        if ctx.needs_input_grad[0]:
            w_t = w.flip(-1).transpose(0, 1).contiguous()  # (Cin, Cout, K)
            dx = conv1d_same(dy, w_t, torch.zeros(w.shape[1], dtype=dy.dtype, device=dy.device))
        if ctx.needs_input_grad[1]:
            pad = (K - 1) // 2
            xp = F.pad(x, (pad, pad))
            L = x.shape[-1]
            # dw[co, ci, k] = Σ_{b,l} x_pad[b, ci, l + k] · dy[b, co, l]
            dw = torch.stack([torch.einsum("bil,bol->oi", xp[:, :, k:k + L], dy)
                              for k in range(K)], dim=-1)
        if ctx.needs_input_grad[2]:
            db = dy.sum(dim=(0, 2))
        return dx, dw, db


def conv1d_train(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Differentiable SAME stride-1 conv1d, no activation; see :class:`Conv1dTrain`."""
    return Conv1dTrain.apply(x, w, bias)


def stride_offset(L: int, K: int, stride: int) -> tuple:
    """(offset, out_len) that sample a stride-1 SAME output into flax's
    stride-``stride`` SAME output: flax pads ``pad_total // 2`` low with
    ``pad_total = (⌈L/s⌉ − 1)·s + K − L``, the stride-1 op (K − 1)/2."""
    out_len = -(-L // stride)
    pad_low = max((out_len - 1) * stride + K - L, 0) // 2
    return (K - 1) // 2 - pad_low, out_len


def conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, stride: int = 1,
           act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """:func:`conv1d_same` with stride support: stride > 1 samples the
    stride-1 output (the reference's ``conv1d``; forward only)."""
    y = conv1d_same(x, w, bias, act, slope)
    if stride == 1:
        return y
    off, out_len = stride_offset(x.shape[-1], w.shape[-1], stride)
    return y[:, :, off::stride][:, :, :out_len]
