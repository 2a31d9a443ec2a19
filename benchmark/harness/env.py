"""What a run needs from its surroundings: caches inside the checkout, the
cards a cell asks for, the card's name and power limit, and the modules
that must never be loaded."""

import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gennet_tpu")


class NoCard(RuntimeError):
    """The run cannot measure: no CUDA card, or fewer than the cell asks for."""


def pin_caches(root: str):
    """Every build and kernel cache of the run at a fixed path inside the
    checkout (before torch is imported). The program's own kernel library
    is already built under ``build/gennet_tpu_torch/`` there."""
    cache = os.path.join(root, "build", "benchmark_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)


def require_cards(n: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark measures a CUDA card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} card(s), torch sees {torch.cuda.device_count()}")


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("unknown" where
    it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unknown"


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``gennet_tpu_torch`` is not ``gennet_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
