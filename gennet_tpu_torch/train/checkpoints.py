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
"""

import os
from dataclasses import fields, is_dataclass

import numpy as np
import torch


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


def _load_into(state, saved: dict):
    """Load a :func:`state_dict_of` dict into ``state`` in place: modules,
    optimisers and schedules through their ``load_state_dict``, tensor
    dicts (the EMA) onto the state's device, plain values as they are. A
    schedule the live state does not have is skipped (``train-gan`` builds
    the PE without one: it does not train it)."""
    device = _device_of(state)
    for f in fields(state):
        v, s = getattr(state, f.name), saved[f.name]
        if hasattr(v, "load_state_dict"):
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
    ``max_to_keep`` and restores the newest or a given step."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
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
        dict of one."""
        payload = {"step": step, "state": state_dict_of(state) if is_dataclass(state) else state,
                   "extra": extra}
        path = os.path.join(self._dir, f"ckpt_{step}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self._dir, f"ckpt_{old}.pt"))

    def restore(self, state, step: int | None = None):
        """Load the newest checkpoint (or ``step``) into ``state`` in place.
        Returns (state, extra), or (None, None) when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        payload = torch.load(os.path.join(self._dir, f"ckpt_{step}.pt"), map_location="cpu",
                             weights_only=True)
        return _load_into(state, payload["state"]), payload["extra"]


def save_posterior_snapshot(directory: str, step: int, samples: np.ndarray):
    """Posterior-sample snapshot per eval cadence (ref: pickle dumps,
    bbhMahoGANy.py:1379-1381)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"posterior_samples_{step:05d}.npz")
    np.savez_compressed(path, samples=np.asarray(samples))
    return path


def load_posterior_snapshot(path: str) -> np.ndarray:
    return np.load(path)["samples"]
