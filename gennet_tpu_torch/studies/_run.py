"""What the studies share: reading a finished run directory of the port,
rebuilding its event, grid and forward model as the run built them, and
restoring its checkpoints.

The event of a run is drawn again from the run's seed through the
workload's own code, on the device the study runs on, and held against the
event the run kept (``workloads.EVENT_RECORD``): a study refuses a run made
on another kind of device (a CUDA generator and a CPU generator give
different streams), or one whose event it does not draw again.
"""

import argparse
import json
import os

import numpy as np
import torch

from gennet_tpu_torch import runtime
from gennet_tpu_torch.cli.workloads import (EVENT_RECORD, BBHConfig, BurstSmokeConfig,
                                            _prepare_bbh_data, bbh_cnn_cache_tag, bbh_pe_config,
                                            burst_event, burst_synth)
from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.eval import overlap as ov
from gennet_tpu_torch.train.checkpoints import (CheckpointManager, list_posterior_snapshots,
                                                load_posterior_snapshot)
from gennet_tpu_torch.train.cnn import CNNConfig, init_cnn
from gennet_tpu_torch.train.gan import init_gan

# where the studies write: the JAX scripts' file names under the port's
# root for the recipes (gennet_tpu_torch.recipes), relative to the working
# directory
BBH_OUT = "out/torch/bbh_sweeps"
BURST_OUT = "out/torch/sweeps"


def parse(argv, doc: str, *specs) -> argparse.Namespace:
    """A study's command line: ``specs`` are ``(name, kwargs)`` pairs of
    ``add_argument``, then ``--device`` (default ``cuda``; never the CPU
    unless asked). Sets the device up as the CLI does."""
    p = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawTextHelpFormatter)
    for name, kwargs in specs:
        p.add_argument(name, **kwargs)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    runtime.setup(args.device)
    return args


def load_bbh_config(run_dir: str) -> BBHConfig:
    """The run's ``config.json`` (the fields ``BBHConfig`` knows), with
    ``out_dir`` set to ``run_dir``."""
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    known = {k: v for k, v in saved.items() if k in BBHConfig.__dataclass_fields__}
    return BBHConfig(**{**known, "out_dir": run_dir})


def require_bank_geometry(cfg: BBHConfig, study: str):
    """Refuse a run at n_pix ≠ 1024 for a study whose JAX script builds
    its grid and syntheses on ``tb.BankConfig()`` (fs 1024) whatever the
    run's config says: there the run's PSD and event do not fit those
    templates and the script fails."""
    if cfg.n_pix != tb.BankConfig().fs:
        raise ValueError(f"{study} on a run at n_pix {cfg.n_pix}: the JAX script synthesizes on "
                         f"tb.BankConfig() (n_pix {tb.BankConfig().fs}) whatever the run's config "
                         "says, and fails on any other geometry; the port refuses it")


def snapshot_paths(run_dir: str) -> list:
    """(step, path) of the run's saved clouds, by step."""
    return sorted(list_posterior_snapshots(os.path.join(run_dir, "GAN_posterior_samples")))


def load_cloud(path: str) -> np.ndarray:
    return load_posterior_snapshot(path).astype(np.float64)


def check_event(run_dir: str, measured: torch.Tensor):
    """Refuse a study whose event, drawn again from the run's seed, is not
    the one the run kept in ``run_dir``."""
    path = os.path.join(run_dir, EVENT_RECORD)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {EVENT_RECORD} in {run_dir}: the study cannot check that "
                                "it draws the run's event again")
    kept = np.load(path)
    drawn_on, here = str(kept["device"]), measured.device.type
    if drawn_on != here:
        raise ValueError(f"{run_dir} drew its event on {drawn_on} and the study runs on {here}: "
                         f"the two generators give different streams; pass --device {drawn_on}")
    ref = kept["measured"]
    if ref.shape != tuple(measured.shape) or not np.allclose(
            measured.cpu().numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max()):
        raise ValueError(f"the event drawn again from the seed is not the one {run_dir} kept")


def bbh_event(cfg: BBHConfig, device, skip_bank: bool = True):
    """The run's event (and bank, unless ``skip_bank``) drawn again from
    its seed and checked against the one the run kept:
    ``_prepare_bbh_data``'s tuple, and the generator, which has gone on
    past the draws, as the JAX scripts' key does."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    data = _prepare_bbh_data(cfg, gen, device, skip_bank=skip_bank)
    check_event(cfg.out_dir, data[3])
    return data, gen


def bbh_grid(cfg: BBHConfig, measured, signal, psd, norm, bank_cfg):
    """The exact grid posterior of the event and its 3907 reference draws,
    as ``run_bbh`` builds them: ((L, mc grid, q grid), ref_samples)."""
    sigma_eff = float(torch.std(measured - signal, correction=0))
    Lg, gmc, gq = gp.bbh_grid_posterior(measured, psd, bank_cfg, norm, sigma_eff,
                                        grain=cfg.grid_grain)
    return (np.asarray(Lg), gmc, gq), gp.sample_grid_posterior(Lg, gmc, gq, 3907, seed=cfg.seed)


def score(s: np.ndarray, ref_samples, grid) -> tuple:
    """(β overlap against ``ref_samples``, 0 for a collapsed mc column;
    grid overlap)."""
    return (ov.beta_overlap(s, ref_samples) if s[:, 0].var() > 0 else 0.0,
            gp.grid_overlap_score(s, *grid))


def restore_pe(directory: str, model, pe_cfg: CNNConfig, seed: int, device, what: str):
    """A PE state restored from the newest checkpoint of ``directory``;
    ``FileNotFoundError`` naming ``what`` when there is none."""
    state = init_cnn(torch.Generator().manual_seed(seed + 1), model, pe_cfg, device)
    if not os.path.isdir(directory) or CheckpointManager(directory).restore(
            state, any_world=True)[0] is None:
        raise FileNotFoundError(f"no {what} checkpoint in {directory}")
    return state


def cached_pe(cfg: BBHConfig, model, device):
    """The run's PE from its CNN cache entry (``run_bbh``'s tag); refused
    for a run without a ``cnn_cache``, which has no such entry."""
    if not cfg.cnn_cache:
        raise FileNotFoundError(f"{cfg.out_dir} has no cnn_cache: the study reads the PE from "
                                "the run's CNN cache entry, as its JAX script does")
    return restore_pe(os.path.join(cfg.cnn_cache, bbh_cnn_cache_tag(cfg)), model,
                      bbh_pe_config(cfg), cfg.seed, device, "cached CNN")


def restore_gan(run_dir: str, G, D, gan_cfg, seed: int, device, at_most=None) -> tuple:
    """(GAN state, checkpoint index) from ``run_dir/ckpt_gan``: the newest
    checkpoint, or with ``at_most`` the newest at an index ≤ it (the newest
    when there is none)."""
    state = init_gan(torch.Generator().manual_seed(seed + 2), G, D, gan_cfg, device)
    mgr = CheckpointManager(os.path.join(run_dir, "ckpt_gan"))
    steps = mgr.all_steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {os.path.join(run_dir, 'ckpt_gan')}")
    below = [s for s in steps if at_most is not None and s <= at_most]
    step = max(below) if below else steps[-1]
    mgr.restore(state, step=step)
    return state, step


def burst_seed(run_dir: str) -> int:
    """A burst run's seed, from its directory name ``…_s<seed>``."""
    return int(run_dir.rstrip("/").rsplit("_s", 1)[1])


def burst_measured(cfg: BurstSmokeConfig, device) -> torch.Tensor:
    """The burst event of seed ``cfg.seed``, drawn as ``run_burst_smoke``
    draws it (the bank first, then the noise)."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    return burst_event(cfg, gen, device)[3]


def burst_reference(cfg: BurstSmokeConfig, device):
    """The burst event of the run in ``cfg.out_dir``, checked against the
    one the run kept, its exact (t0, τ) grid and the forward model:
    (measured, (L, t0 grid, τ grid), synth)."""
    measured = burst_measured(cfg, device)
    check_event(cfg.out_dir, measured)
    L, gx, gy = gp.burst_grid_posterior(measured, cfg.n_sig, cfg.pe_grain)
    return measured, (np.asarray(L), gx, gy), burst_synth(cfg.n_pix, device)


def burst_clouds(run_dir: str) -> dict:
    """The run's saved clouds by step, in the order of their file names."""
    return {st: load_cloud(p) for st, p in sorted(snapshot_paths(run_dir), key=lambda sp: sp[1])}
