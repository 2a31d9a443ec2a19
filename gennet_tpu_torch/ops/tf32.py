"""The 3xTF32 split of the kernels' constant operands, and a cache of packs.

The port's CUDA kernels (``csrc/tf32_wgmma.cuh``) take each float32
product as three TF32 tensor-core products of split operands, hi = x
rounded to TF32 and lo = x − hi. The operands made on chip are split in
registers; the constant ones (conv weights, iDFT tables) are split here
once, in torch, and handed to the kernels as two tensors.
"""

import contextlib
import weakref

import torch

_MANTISSA_DROP = 13  # float32 keeps 23 mantissa bits, TF32 10


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo) of a float32 tensor: hi = x rounded to TF32 (nearest, ties
    away from zero, on the bit pattern: its low 13 mantissa bits are zero)
    and lo = x − hi, so hi + lo == x exactly. inf and nan pass through in
    hi with lo = 0; a finite x that would round past the largest float
    keeps its truncation as hi."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32: x must be float32, got {x.dtype}")
    bits = x.view(torch.int32)
    half, mask = 1 << (_MANTISSA_DROP - 1), -(1 << _MANTISSA_DROP)
    hi = ((bits + half) & mask).view(torch.float32)
    hi = torch.where(torch.isfinite(x) & ~torch.isfinite(hi), (bits & mask).view(torch.float32), hi)
    hi = torch.where(torch.isnan(x), x, hi)
    lo = torch.where(torch.isfinite(x), x - hi, torch.zeros_like(x))
    return hi, lo


_PACKS: dict = {}  # (tag, id of each source) → (weakrefs, (version, data_ptr)s, pack)
_CAPTURE: list = []  # the pack caches of the CUDA-graph captures in progress, innermost last


def cached_pack(tag: str, sources: tuple, make):
    """``make()``, reused while every tensor in ``sources`` is the same live
    object with the same ``_version`` and ``data_ptr()``: an in-place update
    (an optimizer step) or a freed tensor forces a new pack, and an entry
    is dropped when one of its sources is freed.

    Inside :func:`capturing` the pack is made in the graph and reused only
    within that capture, under the same rule: a replay fills it from the
    sources as they are at that point of the replay, so no pack made
    outside the graph is read there, and none made inside it is served
    after. A replay changes its sources without a ``_version`` bump, so
    the replaying code bumps their versions itself
    (``torch.autograd.graph.increment_version``) before eager code runs."""
    key = (tag,) + tuple(id(t) for t in sources)
    state = tuple((t._version, t.data_ptr()) for t in sources)
    cache = _CAPTURE[-1] if _CAPTURE else _PACKS
    hit = cache.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], sources)) and hit[1] == state:
        return hit[2]
    pack = make()
    # the capture's dict holds its packs until the capture ends
    drop = (lambda _, k=key: _PACKS.pop(k, None)) if cache is _PACKS else None
    cache[key] = (tuple(weakref.ref(t, drop) for t in sources), state, pack)
    return pack


@contextlib.contextmanager
def capturing():
    """The pack cache of one CUDA-graph capture (see :func:`cached_pack`),
    dropped when the capture ends."""
    _CAPTURE.append({})
    try:
        yield
    finally:
        _CAPTURE.pop()
