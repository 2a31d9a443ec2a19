"""Operation and byte counts of a bfloat16 cell's calls, and the published
peak of one NVIDIA H100 SXM that bounds them (:mod:`benchmark.harness.costs`
holds the float32 ones).

The peak is the BF16 dense tensor-core rate, 989 TFLOP/s; bytes are bound
by HBM3's 3.35 TB/s (``costs.PEAK_BYTES``). Both assume the card's full
700 W; the run prints the card's power limit beside its numbers. A
bfloat16 conv or dense call reads and writes 2-byte operands: x, w, the
bias and y, each once, as ``costs`` counts them.
"""

import math

import torch

from .costs import F32, PEAK_BYTES
from .flops import cost

PEAK_FLOPS_BF16 = 989e12  # BF16 dense, FLOP/s (NVIDIA H100 SXM data sheet)
BF16 = 2


def call_cost_bf16(call) -> tuple:
    """(flops, bytes) of one conv or dense call (``benchmark.harness.flops``)
    on bfloat16 operands."""
    flops, nbytes = cost(call)
    return flops, nbytes // F32 * BF16


def bound_s_bf16(flops: float, nbytes: float) -> float:
    """The least seconds the card could take at the bfloat16 peak."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


def cast_bytes(shape, src: torch.dtype, dst: torch.dtype) -> int:
    """Bytes of one dtype conversion: the tensor read in ``src`` and
    written in ``dst``."""
    return math.prod(shape) * (src.itemsize + dst.itemsize)


def bn_bytes_bf16(kind: str, B: int, shape) -> int:
    """``bntime.bn_bytes`` for a BatchNorm with bfloat16 in and out: x, y,
    dy and dx at 2 bytes, the scale, the bias, their gradients and the
    running averages at 4."""
    n, c = B * math.prod(shape), shape[0]
    return {"stats": BF16 * 2 * n + F32 * 2 * c, "commit": BF16 * 2 * n + F32 * 6 * c,
            "bwd": BF16 * 3 * n + F32 * 3 * c}[kind]
