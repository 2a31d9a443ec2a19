"""Checkpoints (``torch.save``) and posterior snapshots (npz).

A checkpoint holds the full training state: module weights and buffers,
every optimiser's state (Adam moments and step count), the learning-rate
schedule, the EMA weights and the step, plus an ``extra`` dict in which the
workloads keep their ``torch.Generator`` states. Restoring all of it makes
a resumed run equal to the uninterrupted one, bit for bit (the reference's
docstring promises this, but its loop key is not part of its state).
Posterior snapshots are byte-compatible with the JAX package's
(``posterior_samples_<step:05d>.npz`` with one ``samples`` array), so the
``scripts/`` readers work on the port's output.

The JAX package's orbax checkpoints are not read: orbax imports JAX
(ROADMAP queue 1 #7). A directory that holds them is refused rather than
read as empty.

Under a data-parallel mesh every rank calls :meth:`CheckpointManager.save`:
the ranks' ``extra`` dicts (their generator states) are gathered by rank,
rank 0 writes the file, and a barrier holds the other ranks until it is
there. :meth:`~CheckpointManager.restore` hands each rank its own
``extra``. A checkpoint records the world size that wrote it, and a
restore at another world size is refused, unless the caller asks for the
state alone (the CNN cache, which the reference shares across mesh sizes).
"""

import os
from dataclasses import fields, is_dataclass

import numpy as np
import torch

from gennet_tpu_torch.train.mesh import DataMesh


def state_dict_of(state) -> dict:
    """Everything a training-state dataclass holds, as a picklable dict."""
    out = {}
    for f in fields(state):
        v = getattr(state, f.name)
        out[f.name] = v.state_dict() if hasattr(v, "state_dict") else v
    return out


def _device_of(state) -> torch.device:
    for f in fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.nn.Module):
            return next(v.parameters()).device
    return torch.device("cpu")


# the optimizer settings that follow the live optimizer's device, not the
# checkpoint's: a card's Adam is the capturable form (train/cnn.py::adam)
_DEVICE_KEYS = ("capturable", "foreach", "fused", "differentiable")


def _load_optimizer(opt: torch.optim.Optimizer, saved: dict):
    """``opt.load_state_dict(saved)``, keeping the live optimizer's device
    form: its capturable flags (so the step counts land on its device) and
    its ``lr`` tensor, which a captured step reads, given the saved value.
    A checkpoint written on another device restores into either form."""
    groups = [{**sg, **{k: g[k] for k in _DEVICE_KEYS if k in g}}
              for sg, g in zip(saved["param_groups"], opt.param_groups)]
    lrs = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict({**saved, "param_groups": groups})
    for g, lr in zip(opt.param_groups, lrs):
        if isinstance(lr, torch.Tensor):
            with torch.no_grad():
                lr.copy_(torch.as_tensor(g["lr"]))
            g["lr"] = lr
        elif isinstance(g["lr"], torch.Tensor):
            g["lr"] = float(g["lr"])


def _load_into(state, saved: dict):
    """Load a :func:`state_dict_of` dict into ``state`` in place: modules,
    optimisers and schedules through their ``load_state_dict``, tensor
    dicts (the EMA) onto the state's device, plain values as they are. A
    schedule the live state does not have is skipped (``train-gan`` builds
    the PE without one: it does not train it)."""
    device = _device_of(state)
    for f in fields(state):
        v, s = getattr(state, f.name), saved[f.name]
        if isinstance(v, torch.optim.Optimizer):
            _load_optimizer(v, s)
        elif hasattr(v, "load_state_dict"):
            if s is not None:
                v.load_state_dict(s)
        elif isinstance(s, dict):
            if all(torch.is_tensor(t) for t in s.values()):
                setattr(state, f.name, {k: t.to(device) for k, t in s.items()})
            # else: the state dict of a schedule the live state does not have
        else:
            setattr(state, f.name, s)
    return state


class CheckpointManager:
    """Writes ``<directory>/ckpt_<step>.pt``, keeps the newest
    ``max_to_keep`` and restores the newest or a given step; ``mesh``: the
    data-parallel world whose ranks save and restore together."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh: DataMesh | None = None):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self) -> list:
        """Saved steps, ascending. Raises ``ValueError`` on a directory of
        the JAX package's orbax checkpoints (numbered step directories)."""
        names = os.listdir(self._dir)
        steps = sorted(int(p[5:-3]) for p in names if p.startswith("ckpt_") and p.endswith(".pt"))
        if not steps and any(p.isdigit() and os.path.isdir(os.path.join(self._dir, p))
                             for p in names):
            raise ValueError(f"{self._dir} holds orbax checkpoints of the JAX package; the port "
                             "reads only its own ckpt_<step>.pt (the orbax loader is not ported: "
                             "ROADMAP queue 1 #7)")
        return steps

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, extra: dict | None = None):
        """``state``: a training-state dataclass or a :func:`state_dict_of`
        dict of one (read on rank 0 only). Under a mesh every rank calls
        this with its own ``extra``."""
        mesh = self.mesh
        ranks = [extra] if mesh is None else mesh.gather_objects(extra)
        if mesh is None or mesh.is_main:
            payload = {"step": step,
                       "state": state_dict_of(state) if is_dataclass(state) else state,
                       "extra": extra, "world": len(ranks), "rank_extra": ranks}
            path = os.path.join(self._dir, f"ckpt_{step}.pt")
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(os.path.join(self._dir, f"ckpt_{old}.pt"))
        if mesh is not None:
            mesh.barrier()

    def restore(self, state, step: int | None = None, *, any_world: bool = False):
        """Load the newest checkpoint (or ``step``) into ``state`` in place.
        Returns (state, this rank's extra), or (None, None) when there is
        none. Raises ``ValueError`` for a checkpoint written at another
        world size: its generator states are one per rank. With
        ``any_world=True`` such a checkpoint restores without its extra
        (None is returned for it): the state is the same on every rank."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self._dir, f"ckpt_{step}.pt")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        world, rank = (1, 0) if self.mesh is None else (self.mesh.world, self.mesh.rank)
        saved = payload.get("world", 1)
        if saved != world:
            if any_world:
                return _load_into(state, payload["state"]), None
            raise ValueError(f"{path} was written by a data-parallel world of {saved} ranks; "
                             f"restoring it at a world of {world} is refused: it holds one "
                             f"generator state per rank of that world")
        extra = payload["rank_extra"][rank] if "rank_extra" in payload else payload["extra"]
        return _load_into(state, payload["state"]), extra


def save_posterior_snapshot(directory: str, step: int, samples: np.ndarray):
    """Posterior-sample snapshot per eval cadence (ref: pickle dumps,
    bbhMahoGANy.py:1379-1381)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"posterior_samples_{step:05d}.npz")
    np.savez_compressed(path, samples=np.asarray(samples))
    return path


def load_posterior_snapshot(path: str) -> np.ndarray:
    return np.load(path)["samples"]
