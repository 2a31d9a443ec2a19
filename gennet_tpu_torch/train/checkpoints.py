"""Checkpoints (``torch.save``) and posterior snapshots (npz).

A checkpoint holds the full training state: module weights and buffers,
every optimiser's state (Adam moments and step count), the EMA weights and
the step. Posterior snapshots are byte-compatible with the JAX package's
(``posterior_samples_<step:05d>.npz`` with one ``samples`` array), so the
``scripts/`` readers work on the port's output. Restoring a run (resume,
the CNN cache, orbax checkpoints) is not ported yet (ROADMAP queue 1,
item 7).
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


class CheckpointManager:
    """Writes ``<directory>/ckpt_<step>.pt`` and keeps the newest
    ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self) -> list:
        return sorted(int(p[5:-3]) for p in os.listdir(self._dir)
                      if p.startswith("ckpt_") and p.endswith(".pt"))

    def save(self, step: int, state):
        payload = {"step": step, "state": state_dict_of(state) if is_dataclass(state) else state}
        path = os.path.join(self._dir, f"ckpt_{step}.pt")
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self._dir, f"ckpt_{old}.pt"))


def save_posterior_snapshot(directory: str, step: int, samples: np.ndarray):
    """Posterior-sample snapshot per eval cadence (ref: pickle dumps,
    bbhMahoGANy.py:1379-1381)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"posterior_samples_{step:05d}.npz")
    np.savez_compressed(path, samples=np.asarray(samples))
    return path
