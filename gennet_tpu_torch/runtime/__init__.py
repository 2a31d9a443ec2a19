"""Runtime setup: device resolution and float32 precision policy.

The port starts at float32 parity with the JAX reference, so TF32 is
switched off explicitly for both matmuls and cuDNN convolutions (cuDNN
defaults to TF32 for float32 convolutions). Lower precision is a later,
measured decision.
"""

import torch


def setup(device: str) -> dict:
    """Resolve ``device``, pin the precision policy, and describe the device.

    Raises if a CUDA device is asked for and none is available: the device
    is never guessed or silently downgraded to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "device": str(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        info["device_name"] = torch.cuda.get_device_name(idx)
        info["device_count"] = torch.cuda.device_count()
    return info
