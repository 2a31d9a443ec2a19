"""The weight gradient (dw) of a stride-2 1-D convolution: the CUDA kernel's
wrapper, its plain PyTorch version, and the plan that fits the kernel's
grid to a shape.

For y = ``F.conv1d(x, w, stride=2)`` with x (B, Cin, L), w (Cout, Cin, K)
and dy (B, Cout, Ly), Ly = (L − K) // 2 + 1,

    dw[co, ci, k] = Σ_{b, j} dy[b, co, j] · x[b, ci, 2j + k]

taken per parity p of the tap: x[b, ci, 2j + p + 2u] = x_p[b, ci, j + u]
with x_p = x[..., p::2], so each tap is a shifted read of one parity's
window, with no zero-stuffing and no im2col (``csrc/conv1d_dw_s2.cu``, a
3xTF32 GEMM over (ci, k) × Cout whose reduction over (b, j) is split across
blocks and summed in a fixed order by a second pass).
On a CUDA tensor :func:`conv1d_dw` launches the kernel; on a CPU tensor it
runs the plain version (:func:`conv1d_dw_ref`), which the tests and the
on-card comparison also use. There is no fallback from one to the other: a
CUDA tensor launches the kernel or raises.

A module of its own, beside ``conv1d_dx``, so that each kernel has its own
``LAUNCHES`` count; the autograd node that routes a layer's gradients to
both is ``conv1d_dx.conv1d_s2``.
"""

import functools

import torch
import torch.nn.functional as F

from gennet_tpu_torch.ops import _build
from gennet_tpu_torch.ops import conv1d as conv_ops

# Calls that launched the kernel (and the sum of its splits) in this
# process. Incremented only where the kernel is launched, so a run can show
# that its main path went through the kernel.
LAUNCHES = 0

MAX_K = 9
STAGE = 32  # positions of one batch row a pipeline stage reduces (the kernel's J)
# The plan's costs, in the time of one stage of a 128 x 128 tile (~1.6 us on
# an H100): a block's pipeline fill and store, and the partial sums the
# second pass reads on one SM in that time (~23 GB/s an SM of ~3 TB/s)
FILL = 2
SUM_FLOATS = 9000


def conv1d_dw_ref(dy: torch.Tensor, x: torch.Tensor, K: int) -> torch.Tensor:
    """Plain version: the taps of each parity p as one ``F.conv1d`` of
    x_p = x[..., p::2] with dy as its weight, batch and channels swapped:
    dw[co, ci, p + 2u] = Σ_{b, j} x_p[b, ci, j + u] · dy[b, co, j]."""
    dw = x.new_empty((dy.shape[1], x.shape[1], K))
    for p in (0, 1):
        kp = (K + 1 - p) // 2
        taps = F.conv1d(x[..., p::2].transpose(0, 1), dy.transpose(0, 1))  # (Cin, Cout, ·)
        dw[:, :, p::2] = taps[..., :kp].transpose(0, 1)
    return dw


@functools.lru_cache(maxsize=None)
def plan(B: int, Ly: int, Cin: int, Cout: int, K: int, sms: int) -> tuple:
    """(BN, MT, splits) of the kernel for this shape on a card of ``sms``
    SMs: the N tile fitted to Cout (:func:`gennet_tpu_torch.ops.conv1d.
    tile_n`); where M has two 256-row tiles or more, 256 x 64 tiles (MT 2:
    each stage's dy tile, which the producer splits, then serves twice the
    rows), else 128 x BN; and the split of the reduction's B · ⌈Ly / 32⌉
    stages that finishes soonest: whole waves of blocks, each the stages
    of its split plus ``FILL``, then the second pass over the splits'
    partial sums."""
    m = rows(Cin, K)
    bn = conv_ops.tile_n(Cout)
    mt = 2 if m >= 512 else 1
    if mt == 2:
        bn = min(bn, 64)
    tiles = -(-m // (128 * mt)) * -(-Cout // bn)
    items = B * -(-Ly // STAGE)

    def cost(s):
        return (-(-tiles * s // sms) * (-(-items // s) + FILL)
                + s * Cout * m / (sms * SUM_FLOATS), s)

    return bn, mt, min(range(1, min(items, 2 * sms) + 1), key=cost)


def rows(Cin: int, K: int) -> int:
    """The kernel's GEMM rows: (ci, k) with Cin rounded up to 8."""
    return -(-Cin // 8) * 8 * K


def _check(dy, x, K):
    for name, t in (("dy", dy), ("x", x)):
        if t.ndim != 3:
            raise ValueError(f"conv1d_dw: {name} must be 3-D, got shape {tuple(t.shape)}")
    if x.device != dy.device or x.dtype != dy.dtype:
        raise ValueError(f"conv1d_dw: x is {x.dtype} on {x.device}, dy {dy.dtype} on "
                         f"{dy.device}")
    L = x.shape[-1]
    if dy.shape[0] != x.shape[0] or L < K or dy.shape[-1] != (L - K) // 2 + 1:
        raise ValueError(f"conv1d_dw: dy {tuple(dy.shape)} is not the stride-2 output of x "
                         f"{tuple(x.shape)} at K={K}")
    if dy.device.type == "cuda":
        if dy.dtype != torch.float32:
            raise TypeError(f"conv1d_dw: the kernel takes float32, got {dy.dtype}")
        if not (dy.is_contiguous() and x.is_contiguous()):
            raise ValueError("conv1d_dw: dy and x must be contiguous")
        if not 2 <= K <= MAX_K:
            raise ValueError(f"conv1d_dw: the kernel takes K from 2 to {MAX_K}, got K={K}")
    elif dy.device.type != "cpu":
        raise ValueError(f"conv1d_dw: unsupported device {dy.device}")


def conv1d_dw(dy: torch.Tensor, x: torch.Tensor, K: int) -> torch.Tensor:
    """dw (Cout, Cin, K) of y = ``F.conv1d(x, w, stride=2)`` from dy (B,
    Cout, Ly) and x (B, Cin, L). On a CUDA tensor: the kernel, float32,
    contiguous, K from 2 to ``MAX_K``; any B, L, Cin, Cout."""
    global LAUNCHES
    _check(dy, x, K)
    if dy.device.type == "cpu":
        return conv1d_dw_ref(dy, x, K)
    (B, Cin, L), (_, Cout, Ly) = x.shape, dy.shape
    if B == 0:
        return torch.zeros((Cout, Cin, K), dtype=torch.float32, device=dy.device)
    # the kernel copies 16-byte pieces: a view that starts elsewhere is copied
    dy, x = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (dy, x))
    sms = torch.cuda.get_device_properties(dy.device).multi_processor_count
    bn, mt, splits = plan(B, Ly, Cin, Cout, K, sms)
    part = torch.empty(splits * Cout * rows(Cin, K), dtype=torch.float32, device=dy.device)
    dw = torch.empty((Cout, Cin, K), dtype=torch.float32, device=dy.device)
    lib = _build.load()
    with torch.cuda.device(dy.device):
        rc = lib.conv1d_dw_s2_f32(dy.data_ptr(), x.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                  B, L, Ly, Cin, Cout, K, bn, mt, splits,
                                  torch.cuda.current_stream(dy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv1d_dw_s2_f32 launch failed ({rc}: "
                           f"{lib.gennet_cuda_error_string(rc).decode()}) at B={B} L={L} "
                           f"Cin={Cin} Cout={Cout} K={K} (BN={bn} MT={mt} splits={splits})")
    LAUNCHES += 1
    return dw
