"""Compute ops: real DFTs as matrix products, and the four CUDA kernels (the
phasor → inverse-real-DFT, the width-5 conv1d, and the input and weight
gradients of a stride-2 conv1d)."""

from gennet_tpu_torch.ops.dft import irdft, irdft_matrices, rdft, rdft_matrices

__all__ = ["irdft", "rdft", "irdft_matrices", "rdft_matrices"]
