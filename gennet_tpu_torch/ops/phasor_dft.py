"""Fused phasor → inverse real DFT: the CUDA kernel's wrapper and its plain
PyTorch version.

For h̃ = A e^{−iΨ} the template pipeline ends with

    out[b, t] = Σ_k A[b,k]·cos Ψ[b,k]·C[k,t] + A[b,k]·sin Ψ[b,k]·S[k,t]

(C/S the inverse-rDFT tables of :mod:`.dft`). On a CUDA tensor
:func:`phasor_matmul` launches the hand-written kernel
(``csrc/phasor_irdft.cu``, the port of ``gennet_tpu.ops.phasor_dft``'s
Pallas kernel: a 3xTF32 GEMM on the tensor cores whose A operand, the
phasor, is formed in registers and never written to device memory). On a
CPU tensor it runs :func:`phasor_matmul_ref`, the plain version, which the
tests and the on-card comparison also use. There is no fallback from one to
the other: a CUDA tensor launches the kernel or raises.

On every device the op is differentiable through :class:`PhasorMatmul`,
the port of the JAX package's closed-form custom VJP (``_phasor_bwd``):
the backward is plain matmuls around the forward's inputs, as there.
"""

import torch
import torch.nn.functional as F

from gennet_tpu_torch.ops import _build
from gennet_tpu_torch.ops.dft import _irdft_slice_tables
from gennet_tpu_torch.ops.tf32 import cached_pack, split_tf32

# Kernel launches in this process. Incremented only where the kernel is
# launched, so a run can show that its main path went through the kernel.
LAUNCHES = 0

_TABLES: dict = {}  # (N, start, width, weights, device) → (cos, sin) tensors


def phasor_matmul_ref(amp: torch.Tensor, phase: torch.Tensor, cos_t: torch.Tensor,
                      sin_t: torch.Tensor) -> torch.Tensor:
    """Plain version: materialises the phasor and runs two matmuls."""
    return (amp * torch.cos(phase)) @ cos_t + (amp * torch.sin(phase)) @ sin_t


def _check(amp, phase, cos_t, sin_t):
    for name, t in (("amp", amp), ("phase", phase), ("cos_t", cos_t), ("sin_t", sin_t)):
        if t.dtype != torch.float32:
            raise TypeError(f"phasor_matmul: {name} must be float32, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"phasor_matmul: {name} must be 2-D, got shape {tuple(t.shape)}")
        if t.device != amp.device:
            raise ValueError(f"phasor_matmul: {name} is on {t.device}, amp on {amp.device}")
        if not t.is_contiguous():
            raise ValueError(f"phasor_matmul: {name} must be contiguous")
    if phase.shape != amp.shape:
        raise ValueError(f"phasor_matmul: phase {tuple(phase.shape)} != amp {tuple(amp.shape)}")
    if cos_t.shape != sin_t.shape or cos_t.shape[0] != amp.shape[1]:
        raise ValueError(f"phasor_matmul: tables {tuple(cos_t.shape)}/{tuple(sin_t.shape)} "
                         f"do not match amp {tuple(amp.shape)}")


TILE_N = 128  # the kernel's N tile: output samples per block, masked past T


def pack_tables(cos_t: torch.Tensor, sin_t: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand: the 3xTF32 split (hi, lo) of the tables,
    transposed to K-major and laid out as the shared-memory image of each
    pipeline stage,

        (T / BN, kp / 8, C|S, hi|lo, 2, BN / 8, 8, 4)   BN = TILE_N

    i.e. for each N tile and 8-bin step, four K-major BN x 8 tiles of
    2 x BN/8 core matrices of 8 rows x 4 bins, T padded to BN and the K
    bins to kp (a multiple of 8) with zeros."""
    K, T = cos_t.shape
    bn = TILE_N
    tables = F.pad(torch.stack((cos_t.T, sin_t.T)), (0, -K % 8, 0, -T % bn))  # (2, T', kp)
    tiles = tables.reshape(2, -1, bn // 8, 8, tables.shape[-1] // 8, 2, 4).permute(1, 4, 0, 5, 2, 3, 6)
    return torch.stack(split_tf32(tiles.contiguous()), dim=3).contiguous()


def unpack_tables(pack: torch.Tensor, K: int, T: int) -> tuple:
    """(cos_t, sin_t) from a pack: the inverse of :func:`pack_tables`."""
    n_tiles, n_steps, _, _, _, g, _, _ = pack.shape
    tiles = (pack[:, :, :, 0] + pack[:, :, :, 1]).permute(2, 0, 4, 5, 1, 3, 6)
    full = tiles.reshape(2, n_tiles * g * 8, n_steps * 8)[:, :T, :K]
    return full[0].T.contiguous(), full[1].T.contiguous()


def _forward(amp, phase, cos_t, sin_t):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    global LAUNCHES
    if amp.device.type == "cpu":
        return phasor_matmul_ref(amp, phase, cos_t, sin_t)
    if amp.device.type != "cuda":
        raise ValueError(f"phasor_matmul: unsupported device {amp.device}")
    B, K = amp.shape
    T = cos_t.shape[1]
    out = torch.empty((B, T), dtype=torch.float32, device=amp.device)
    if B == 0 or T == 0 or K == 0:
        return out.zero_()
    # the tables are constants (slice_tables caches them): packed once
    tables = cached_pack("phasor", (cos_t, sin_t), lambda: pack_tables(cos_t, sin_t))
    # the kernel copies amp/phase in 16-byte pieces from 16-byte aligned
    # storage: a row view such as amp[1:] is copied to a fresh allocation
    amp, phase = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (amp, phase))
    lib = _build.load()
    n_ws = lib.phasor_irdft_workspace(B, K, T)
    ws = torch.empty(n_ws, dtype=torch.float32, device=amp.device) if n_ws else None
    with torch.cuda.device(amp.device):
        stream = torch.cuda.current_stream(amp.device).cuda_stream
        rc = lib.phasor_irdft_f32(amp.data_ptr(), phase.data_ptr(), tables.data_ptr(),
                                  out.data_ptr(), ws.data_ptr() if ws is not None else None,
                                  B, K, T, stream)
    if rc != 0:
        msg = lib.gennet_cuda_error_string(rc).decode()
        raise RuntimeError(f"phasor_irdft_f32 launch failed ({rc}: {msg}) at B={B} K={K} T={T}")
    LAUNCHES += 1
    return out


class PhasorMatmul(torch.autograd.Function):
    """Forward: :func:`_forward`. Backward, the closed form of
    ``gennet_tpu.ops.phasor_dft._phasor_bwd`` (out is linear in
    (amp·cosΨ, amp·sinΨ)), with gc = g Cᵀ and gs = g Sᵀ:

        ∂/∂amp = cosΨ·gc + sinΨ·gs,     ∂/∂Ψ = amp·(cosΨ·gs − sinΨ·gc),
        ∂/∂C = (amp·cosΨ)ᵀ g,           ∂/∂S = (amp·sinΨ)ᵀ g.

    The (B, K) intermediates it materialises are what the forward kernel
    avoids; the backward runs only where a gradient is asked for
    (``posterior_post.ml_recenter``)."""

    @staticmethod
    def forward(ctx, amp, phase, cos_t, sin_t):
        ctx.save_for_backward(amp, phase, cos_t, sin_t)
        return _forward(amp, phase, cos_t, sin_t)

    @staticmethod
    def backward(ctx, g):
        amp, phase, cos_t, sin_t = ctx.saved_tensors
        g = g.contiguous()
        cos_p, sin_p = torch.cos(phase), torch.sin(phase)
        d_amp = d_phase = d_cos = d_sin = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gc = g @ cos_t.T
            gs = g @ sin_t.T
            d_amp = cos_p * gc + sin_p * gs
            d_phase = amp * (cos_p * gs - sin_p * gc)
        if ctx.needs_input_grad[2]:
            d_cos = (amp * cos_p).T @ g
        if ctx.needs_input_grad[3]:
            d_sin = (amp * sin_p).T @ g
        return d_amp, d_phase, d_cos, d_sin


def phasor_matmul(amp: torch.Tensor, phase: torch.Tensor, cos_t: torch.Tensor,
                  sin_t: torch.Tensor) -> torch.Tensor:
    """out[b,t] = Σ_k amp·cos(phase)·cos_t + amp·sin(phase)·sin_t.

    amp/phase (B, K), cos_t/sin_t (K, T), all float32 and contiguous on one
    device; any B, K, T (the kernel masks ragged edges). Differentiable
    with respect to all four through :class:`PhasorMatmul`.
    """
    _check(amp, phase, cos_t, sin_t)
    return PhasorMatmul.apply(amp, phase, cos_t, sin_t)


def slice_tables(N: int, start: int, width: int, weights: tuple | None, device) -> tuple:
    """Device copies of the (N//2+1, width) iDFT column tables, cached (and
    so is the kernel's pack of them, made at their first launch)."""
    key = (N, start, width, weights, str(device))
    if key not in _TABLES:
        c, s = _irdft_slice_tables(N, start, width, weights)
        _TABLES[key] = (torch.as_tensor(c, device=device), torch.as_tensor(s, device=device))
    return _TABLES[key]


def phasor_irdft_slice(amp: torch.Tensor, phase: torch.Tensor, N: int, start: int, width: int,
                       weights: tuple | None = None) -> torch.Tensor:
    """Inverse real DFT of h̃ = amp·e^{−i·phase} onto output samples
    ``[start, start+width) mod N``, with optional per-sample weights folded
    into the tables. amp/phase: (B, N//2+1), unpadded."""
    cos_t, sin_t = slice_tables(N, start, width, weights, amp.device)
    return phasor_matmul(amp.contiguous(), phase.contiguous(), cos_t, sin_t)
