"""Operation and byte counts of the step's convolutions and dense layers,
and the published peaks of one NVIDIA H100 SXM that bound them.

The peak is the TF32 dense tensor-core rate, 495 TFLOP/s: the program's
float32 convolutions reach float32 accuracy either without tensor cores
or by a split over several TF32 products, and none of them can pass this
rate, so a share of it never reads above 100%. Bytes are bound by HBM3's
3.35 TB/s. Both figures assume the card's full 700 W; the run prints the
card's power limit beside its numbers.
"""

PEAK_FLOPS = 495e12   # TF32 dense, FLOP/s (NVIDIA H100 SXM data sheet)
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
F32 = 4


def conv_out_len(L: int, K: int, stride: int, padding: str) -> int:
    return -(-L // stride) if padding == "SAME" else (L - K) // stride + 1


def conv_cost(kind: str, B: int, L: int, cin: int, cout: int, stride: int, K: int = 5,
              padding: str = "SAME") -> tuple:
    """(flops, bytes) of one conv call: ``fwd`` (x, w, bias read, y
    written), ``dx`` (dy and w read, dx written) or ``dw`` (x and dy read,
    dw written), each byte once. The three make one multiply-add per
    (b, l_out, k, c_in, c_out)."""
    L_out = conv_out_len(L, K, stride, padding)
    flops = 2.0 * B * L_out * K * cin * cout
    x, y, w = B * cin * L, B * cout * L_out, cout * cin * K
    nbytes = {"fwd": x + w + cout + y, "dx": y + w + x, "dw": x + y + w}[kind]
    return flops, F32 * nbytes


def dense_cost(kind: str, B: int, fin: int, fout: int) -> tuple:
    """(flops, bytes) of one dense call (``fwd``, ``dx`` or ``dw``)."""
    flops = 2.0 * B * fin * fout
    x, y, w = B * fin, B * fout, fin * fout
    nbytes = {"fwd": x + w + fout + y, "dx": y + w + x, "dw": x + y + w}[kind]
    return flops, F32 * nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
