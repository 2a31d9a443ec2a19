"""Runtime setup: device resolution, the float32 precision policy and
reproducibility.

The port starts at float32 parity with the JAX reference, so TF32 is
switched off explicitly for both matmuls and cuDNN convolutions (cuDNN
defaults to TF32 for float32 convolutions). Lower precision is a later,
measured decision.

A seed reproduces a run bit for bit on one card (exact resume and a
data-parallel world of 1 rely on it), so cuDNN is held to its
deterministic algorithms: on an H100 its default backward of the image
models' 5×5 2-D convolutions differs from call to call (dgrad and wgrad,
measured by ``chip_smoke.py``'s slice 8), while the 1-D convolutions of
the other models were already repeatable.
"""

import torch


def setup(device: str, debug_nans: bool = False) -> dict:
    """Resolve ``device``, pin the precision and determinism policy, and
    describe the device.
    ``debug_nans`` turns on autograd's anomaly detection, which raises on a
    NaN in a backward pass (:func:`~gennet_tpu_torch.train.metrics.
    debug_nans`).

    Raises if a CUDA device is asked for and none is available: the device
    is never guessed or silently downgraded to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if debug_nans:
        torch.autograd.set_detect_anomaly(True)
    info = {
        "device": str(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
    }
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        info["device_name"] = torch.cuda.get_device_name(idx)
        info["device_count"] = torch.cuda.device_count()
    return info
