"""gennet-tpu, ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The package mirrors ``gennet_tpu`` module by module, keeping its function
names and public tensor layouts, so each piece can be held against the JAX
reference on the same inputs. It imports ``torch`` and numpy and never JAX.

Coverage: all that ``gennet_tpu`` does, apart from its TPU-only code and
the orbax loader: the flagship ``train-bbh`` path (bank synthesis → CNN
point estimator → pair GAN → posterior draws and their evaluation), the
staged workflow, the burst ``smoke`` workload and the variant generations
(``blob-toy``, ``image-gan`` and the gen-2 to gen-4 trainers). The two TPU
kernels, the fused phasor → inverse-real-DFT and the width-5 conv1d, are
hand-written CUDA kernels (``csrc/``).
"""

__version__ = "0.1.0"
