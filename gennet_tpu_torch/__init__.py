"""gennet-tpu, ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The package mirrors ``gennet_tpu`` module by module, keeping its function
names and public tensor layouts, so each piece can be held against the JAX
reference on the same inputs. It imports ``torch`` and numpy and never JAX.

Slice covered: the flagship ``train-bbh`` path (bank synthesis → CNN point
estimator → pair GAN → posterior draws and their evaluation). The one TPU
kernel on that path, the fused phasor → inverse-real-DFT, is a hand-written
CUDA kernel (``csrc/phasor_irdft.cu``).
"""

__version__ = "0.1.0"
