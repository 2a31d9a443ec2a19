"""Compute ops: real DFTs as matrix products, and the three CUDA kernels (the
phasor → inverse-real-DFT, the width-5 conv1d and the input gradient of a
stride-2 conv1d)."""

from gennet_tpu_torch.ops.dft import irdft, irdft_matrices, rdft, rdft_matrices

__all__ = ["irdft", "rdft", "irdft_matrices", "rdft_matrices"]
