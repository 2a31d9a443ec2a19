"""The two workloads (port of ``gennet_tpu.cli.workloads``).

- :func:`run_bbh`, ``train-bbh`` / ``train-cnn`` / ``train-gan`` (ref:
  BBH_version/bbhMahoGANy.py:959-1384): synthetic GW150914-like event (or
  lalinference products) → 50k-template whitened bank (or a bank file) →
  exact (mc, q) grid posterior (or the products' posterior) and CNN sanity
  set → CNN point-estimator training (or a CNN-cache hit)
  → GAN training (pair or raw-series D, optionally the residual route,
  R1, the diversity term, a terminal anneal and the whiteness/res early
  stop) → posterior draws (G → CNN, pooled over ``n_snapshots`` states),
  optionally post-processed by the truth-free routes of
  :mod:`gennet_tpu_torch.eval.posterior_post`, scored by β overlap, grid
  overlap, residual whiteness (and ELBO) at each eval cadence and at the
  end, with an ELBO-selected final cloud under ``select_best="elbo"``.
  Both phases save checkpoints, and ``resume`` restores them.
- :func:`sample_posterior`, ``sample-posterior`` (ref: gennet_tpu/cli/
  main.py:217-304): posterior draws from the checkpoints of a run.
- :func:`run_burst_smoke`, ``smoke`` (ref: tests/burstMahoGANy.py:569-901):
  the sine-Gaussian burst, its analytic bank and exact (t0, τ) grid, the
  burst CNN PE, the 3-loss GAN (raw-series D, residual route), posterior
  draws scored against the grid, with the same early stop, restarts,
  anneal and selection.

Both workloads take ``mesh`` (:mod:`gennet_tpu_torch.train.mesh`), the
reference's data parallelism: every rank prepares the same event and bank
from the seed, trains on its block of the bank's rows with its own random
stream, and the PE and GAN steps average their gradients across the
ranks. Evaluation, posterior draws, plots, metric rows, the CNN cache and
checkpoint writes run on rank 0, and rank 0's decisions (the early stop,
the restarts, the best-whiteness state) are broadcast, so that every rank
leaves every loop at the same step. A bank whose rows do not divide over
the ranks is refused before any work, as the reference's ``shard_map``
refuses it.

The configs keep every field and default of the JAX configs, so the flags
are identical, and every option is ported: ``bf16`` computes G and D in
bfloat16 (parameters float32), and ``plots`` (on by default) writes the
reference's dashboards through :mod:`gennet_tpu_torch.eval.plots`. What
the reference refuses, or cannot run, is refused before any work, and so
is ``plots=True`` without matplotlib.
"""

import copy
import dataclasses
import functools
import glob
import json
import os
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from gennet_tpu_torch.data import lalinf_io
from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.data.bankstore import BankStore
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.eval import overlap as ov
from gennet_tpu_torch.eval import plots
from gennet_tpu_torch.eval import posterior_post as pp
from gennet_tpu_torch.eval.whiteness import posterior_whiteness
from gennet_tpu_torch.models import (BBHGenerator, BurstDiscriminator, BurstGenerator, BurstPE,
                                     CombinedPE, DualBranchPE, PairDiscriminator)
from gennet_tpu_torch.physics import priors
from gennet_tpu_torch.physics import psd as psd_mod
from gennet_tpu_torch.physics.burst import make_burst_bank, sine_gaussian
from gennet_tpu_torch.train.checkpoints import (CheckpointManager, save_posterior_snapshot,
                                                state_dict_of)
from gennet_tpu_torch.train.cnn import (CNNConfig, cnn_step, init_cnn, make_cnn_step_scan,
                                        normalize_max)
from gennet_tpu_torch.train.cnn import predict as cnn_predict
from gennet_tpu_torch.train.gan import (GANConfig, GANState, gan_step, init_gan, knobs_from_cfg,
                                        make_gan_step, make_gan_step_scan, sample_generator)
from gennet_tpu_torch.train.mesh import DataMesh, check_rows, is_main, rank_generator
from gennet_tpu_torch.train.metrics import MetricLogger, fetch_metrics


@dataclass
class BBHConfig:
    """Flagship workload config (ref defaults: bbhMahoGANy.py:83-113). Field
    meanings are documented on ``gennet_tpu.cli.workloads.BBHConfig``."""

    n_pix: int = 1024
    training_num: int = 50_000
    batch_size: int = 8
    pe_batch_size: int = 8
    gan_iters: int = 500_000
    pe_iters: int = 500_000
    lr: float = 9e-5
    gan_lr: float = 0.0
    cadence: int = 100
    eval_cadence: int = 1000
    pe_cadence: int = 1000
    n_posterior: int = 4000
    chi_loss: bool = False
    comb_pe_model: bool = False
    bf16: bool = False
    conv_impl: str = "xla"
    posterior_dropout: bool = True
    posterior_bn_mode: str = "eval"
    g_norm: str = "batch"
    pe_ema_decay: float = 0.999
    pe_lr_decay: bool = True
    label_smoothing: bool = True
    instance_noise: float = 0.3
    d_lr_scale: float = 0.5
    d_acc_gate: float = 0.9
    diversity_weight: float = 0.0
    r1_gamma: float = 0.0
    res_loss_weight: float = 0.0
    res_eval_mode: bool = True
    posterior_drate: float = -1.0
    anneal_frac: float = 0.0
    freeze_on_res: float = 0.0
    freeze_on_white: float = 0.0
    g_ema_decay: float = 0.0
    debug_probes: bool = False
    res_spectral_bands: int = 0
    pair_d: bool = True
    twin_boost: int = 0
    posterior_temp: float = 1.0
    posterior_noise: float = 0.0
    n_snapshots: int = 1
    pe_debias: int = 0
    pe_bootcal: int = 0
    pe_mlrc: int = 0
    reweight_temper: float = 0.0
    select_best: str = ""
    select_route: str = ""
    grid_grain: int = 95
    n_sig: float = 1.0
    n_sig_event: bool = True
    cnn_noise_frac: float = 1.0 / 8.0
    out_dir: str = "out/bbh"
    ckpt_every: int = 5000
    seed: int = 0
    plots: bool = True
    resume: bool = False
    cnn_cache: str | None = None
    lalinf_dir: str | None = None
    bank_file: str | None = None


# bank rows the PE-accuracy plot draws, without replacement, at each PE
# cadence step (ref: workloads.py:1361)
_PE_PLOT_ROWS = 4000

# the PE phase's own generator: seed + this offset (seed + 1 and + 2 seed
# the PE and GAN weights), so a CNN-cache hit leaves the later draws as
# they are on a miss
_PE_SEED_OFFSET = 3


def _pe_generator(seed: int, device, mesh: DataMesh | None = None) -> torch.Generator:
    return rank_generator(seed + _PE_SEED_OFFSET, 0 if mesh is None else mesh.rank, device)


def _rank_stream(gen: torch.Generator, seed: int, mesh: DataMesh | None) -> torch.Generator:
    """The stream a rank draws from once the shared event and bank are
    made: rank 0 goes on with ``gen``, rank r > 0 switches to its own."""
    if mesh is None or mesh.rank == 0:
        return gen
    return rank_generator(seed, mesh.rank, gen.device)


def _decide(mesh: DataMesh | None, value):
    """Rank 0's decision on every rank (the value itself without a mesh)."""
    return value if mesh is None else mesh.decide(value)


def _check_common(cfg):
    """The ValueErrors both workloads share with the reference
    (workloads.py:251-263, 1233-1245): a typo or an inert combination must
    not fall back to other semantics."""
    for name in ("select_best", "select_route"):
        if getattr(cfg, name) not in ("", "elbo"):
            raise ValueError(f"{name}={getattr(cfg, name)!r}: must be '' or 'elbo'")
    if cfg.freeze_on_res > 0 and cfg.freeze_on_white <= 0:
        raise ValueError("freeze_on_res > 0 requires freeze_on_white > 0: the res criterion "
                         "is only evaluated inside the whiteness gate, so a res-only config "
                         "would silently never freeze")


def check_bbh_config(cfg: BBHConfig):
    """Raise ValueError for option values the reference refuses too (and
    for R1 under ``conv_impl="pallas"``, which the reference cannot run),
    and ImportError for ``plots=True`` without matplotlib."""
    if cfg.conv_impl not in ("xla", "pallas"):
        raise ValueError(f"conv_impl={cfg.conv_impl!r}: must be 'xla' or 'pallas'")
    if cfg.g_norm not in ("batch", "group", "none"):
        raise ValueError(f"g_norm={cfg.g_norm!r}: must be 'batch', 'group' or 'none'")
    _check_common(cfg)
    if not cfg.pair_d and cfg.res_loss_weight <= 0:
        raise ValueError("pair_d=False requires res_loss_weight > 0: without the pair channel, "
                         "the residual-moment route is the only term anchoring G to the "
                         "measured event")
    if cfg.r1_gamma > 0 and cfg.conv_impl == "pallas":
        raise ValueError("r1_gamma > 0 with conv_impl='pallas': R1 differentiates D's input "
                         "gradient again, and neither the conv kernel nor the reference's "
                         "Pallas conv (conv1d_train) has a second derivative; use "
                         "conv_impl='xla' for R1")
    if cfg.plots:
        plots.require_matplotlib()


def check_pe_plot_draw(cfg: BBHConfig, n_rows: int, start: int):
    """The PE-accuracy plot draws 4000 bank rows without replacement at each
    PE cadence step, as the reference does (``choice(n_rows, 4000,
    replace=False)``, ref: workloads.py:1361), and that draw fails for a
    smaller bank. Refuse such a run with the reason before PE training (the
    reference raises numpy's error at the first cadence step)."""
    reached = cfg.pe_iters // cfg.pe_cadence > start // cfg.pe_cadence
    if cfg.plots and reached and n_rows < _PE_PLOT_ROWS:
        raise ValueError(
            f"plots=True with a bank of {n_rows} rows: the PE-accuracy plot draws "
            f"{_PE_PLOT_ROWS} bank rows without replacement at each pe_cadence step, as the "
            f"reference does, which a bank under {_PE_PLOT_ROWS} rows cannot give; use a larger "
            "bank, a pe_cadence beyond pe_iters, or --plots false")


def bbh_cnn_cache_tag(cfg: BBHConfig) -> str:
    """The CNN cache's entry for ``run_bbh``: every field that changes what
    the trained CNN is, the bank included through its seed and size (the
    reference's expression, workloads.py:1313-1316)."""
    return (f"s{cfg.seed}_i{cfg.pe_iters}_n{cfg.n_pix}_b{cfg.pe_batch_size}"
            f"_lr{cfg.lr:g}_nf{cfg.cnn_noise_frac:g}_tn{cfg.training_num}"
            f"_ema{cfg.pe_ema_decay:g}_lrd{int(cfg.pe_lr_decay)}"
            f"_cmb{int(cfg.comb_pe_model)}")


def effective_n_sig(cfg: BBHConfig, norm: float) -> float:
    """The noise std every residual/whiteness target uses: the event noise
    in normalised units sits at std = norm (truth-free, = 1/std(measured))."""
    return float(norm) if getattr(cfg, "n_sig_event", True) else cfg.n_sig


def gan_real_bank(cfg: BBHConfig, bank, signal, mesh: DataMesh | None = None):
    """The GAN's real set: the bank plus ``twin_boost`` copies of the event
    twin (the CNN's bank is untouched). Under a mesh the boost is rounded
    up until the rows divide over the ranks (ref: workloads.py:1136-1153)."""
    boost = int(getattr(cfg, "twin_boost", 0) or 0)
    if boost <= 0 or bank is None:
        return bank
    if mesh is not None:
        boost += (-(bank.shape[0] + boost)) % mesh.world
    return torch.cat([bank, signal[None, :].expand(boost, -1)])


def _bank_file_rows(path: str) -> int:
    """The row count of a bank file, read before the bank is loaded."""
    if path.endswith(".gntb"):
        with BankStore(path) as store:
            return store.n
    with np.load(path) as data:
        return int(data["templates"].shape[0])


def check_bbh_rows(cfg: BBHConfig, mesh: DataMesh | None):
    """Refuse, before any work, a PE bank whose rows do not divide over the
    ranks: ``training_num − 1`` rows of a synthesized bank (the event twin
    is dropped, so the default 50,000 gives 49,999 and the reference's own
    ``train-bbh --data-parallel`` fails on more than one device), or a
    bank file's rows. The GAN bank is then the same rows, or rounded up by
    ``twin_boost``."""
    if mesh is None:
        return
    if cfg.bank_file:
        check_rows(_bank_file_rows(cfg.bank_file), mesh.world, f"the bank file {cfg.bank_file}")
    else:
        check_rows(cfg.training_num - 1, mesh.world,
                   f"the PE bank (training_num {cfg.training_num} less the event twin)")


def _bbh_bank_cfg(cfg: BBHConfig):
    """Bank geometry from n_pix: templates are the central 1 s at fs, so
    fs = n_pix (n_pix = 1024 is the reference geometry, ref: :123)."""
    return tb.BankConfig(fs=int(cfg.n_pix))


def _prepare_bbh_data(cfg: BBHConfig, gen: torch.Generator, device, skip_bank: bool = False):
    """Event and bank, all on ``device`` (ref: workloads.py:1168-1225).
    Returns (bank, targets, signal, measured, norm, psd, truth,
    lalinf_samples); ``truth`` is the (mc, q) point the plots mark.

    - ``lalinf_dir``: PSD, event and norm come from the lalinference
      products, and ``lalinf_samples`` is their (mc, q) posterior (None
      without one). Otherwise the synthetic event is drawn from ``gen``.
    - ``bank_file``: the bank is read from an ``.npz`` (``templates``,
      ``mc``, ``q``) or a ``.gntb`` (``params[:, :2]``), every row kept.
      Otherwise it is synthesized from ``gen`` and the event twin (its last
      row) is dropped.
    - ``skip_bank``: bank = targets = None (``sample-posterior``); the
      event is drawn first, so ``measured`` is bit-identical to the
      training run's.
    """
    bank_cfg = _bbh_bank_cfg(cfg)
    lalinf_samples = None
    if cfg.lalinf_dir:
        prod = lalinf_io.load_event_products(cfg.lalinf_dir, fs=bank_cfg.fs,
                                             T_safe=bank_cfg.T_obs * bank_cfg.safe)
        psd = torch.as_tensor(prod["psd"], dtype=torch.float32, device=device)
        measured = torch.as_tensor(prod["measured_whitened"], device=device)
        signal = torch.as_tensor(prod["signal_whitened"], device=device)
        norm = float(prod["norm_constant"])
        lalinf_samples = prod.get("posterior_mc_q")
    else:
        psd = psd_mod.analytic_advligo_psd(bank_cfg.fs, bank_cfg.T_obs * bank_cfg.safe,
                                           device=device)
        signal, measured, norm = tb.make_event(gen, psd, bank_cfg)
        norm = float(norm)

    if skip_bank:
        bank = targets = None
    elif cfg.bank_file:
        if cfg.bank_file.endswith(".gntb"):
            with BankStore(cfg.bank_file) as store:  # copies out of the mapping
                bank = torch.tensor(store.templates, device=device)
                targets = torch.tensor(store.params[:, :2], device=device)  # (mc, q)
        else:
            data = np.load(cfg.bank_file)
            bank = torch.as_tensor(data["templates"], dtype=torch.float32, device=device)
            targets = torch.as_tensor(np.stack([data["mc"], data["q"]], axis=-1),
                                      dtype=torch.float32, device=device)
    else:
        templates, params = tb.make_bank(gen, cfg.training_num, psd, bank_cfg, norm)
        # drop the event-twin last template from training (ref: bbhMahoGANy.py:1033-1036)
        bank = templates[:-1]
        targets = torch.stack([params["mc"][:-1], params["q"][:-1]], dim=-1).to(torch.float32)
    if cfg.lalinf_dir:
        truth = (30.0, 0.79)  # the event paper's point values (ref: :1064)
    else:  # the injected template's own parameters
        mc_t, _ = priors.chirp_mass_eta(bank_cfg.tmpl_m1, bank_cfg.tmpl_m2)
        truth = (float(mc_t), bank_cfg.tmpl_m2 / bank_cfg.tmpl_m1)
    return bank, targets, signal, measured, norm, psd, truth, lalinf_samples


def _snapshot(state: GANState) -> GANState:
    """A pooled snapshot: the port updates states in place, so it is a copy
    of what sampling reads (G's weights and buffers, its EMA), on the
    device."""
    return GANState(generator=copy.deepcopy(state.generator), discriminator=None,
                    g_opt=None, d_opt=None, g_res_opt=None,
                    g_ema=copy.deepcopy(state.g_ema), step=state.step)


def _anneal_knobs(gan_cfg: GANConfig, cfg):
    """(base knobs, terminal-anneal knobs, first annealed step index): for
    the last ``anneal_frac`` of the iterations D is frozen (gate −1) and G's
    adversarial term is off, so the final state settles on the residual
    route (ref :436-439, 1592-1596)."""
    base = knobs_from_cfg(gan_cfg)
    return (base, dataclasses.replace(base, d_acc_gate=-1.0, adv_weight=0.0),
            int(cfg.gan_iters * (1.0 - cfg.anneal_frac)))


def run_bbh(cfg: BBHConfig, *, device, mesh: DataMesh | None = None):
    """Flagship pipeline on ``device``: CNN PE training, then GAN training
    with posterior validation against the exact grid posterior. Returns the
    same summary dict as the JAX workload (``None`` on ranks other than
    0 of a ``mesh``)."""
    check_bbh_config(cfg)
    check_bbh_rows(cfg, mesh)
    main = is_main(mesh)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    os.makedirs(cfg.out_dir, exist_ok=True)
    if main:
        with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1)
    log = MetricLogger(cfg.out_dir if main else None, "bbh")

    bank, targets, signal, measured, norm, psd, truth, lalinf_samples = _prepare_bbh_data(
        cfg, gen, device)
    gen = _rank_stream(gen, cfg.seed, mesh)
    bank_cfg = _bbh_bank_cfg(cfg)
    n_sig_eff = effective_n_sig(cfg, norm)
    if main:
        print(f"effective noise std (residual/whiteness targets): {n_sig_eff:.4f}"
              f" ({'event norm' if cfg.n_sig_event else 'config n_sig'})")

    # ---- reference posterior: the lalinference products' when mounted
    # (ref: :1274-1279), else the exact (mc, q) grid of the synthetic event
    # (evaluation: rank 0 only)
    grid = None
    ref_samples = None
    if main and lalinf_samples is not None:
        ref_samples = np.asarray(lalinf_samples)
    elif main and cfg.grid_grain > 0:
        sigma_eff = float(torch.std(measured - signal, correction=0))
        Lg, gmc, gq = gp.bbh_grid_posterior(measured, psd, bank_cfg, norm, sigma_eff,
                                            grain=cfg.grid_grain)
        grid = (Lg, gmc, gq)
        ref_samples = gp.sample_grid_posterior(Lg, gmc, gq, 3907, seed=cfg.seed)

    # ---- CNN PE ---------------------------------------------------------
    pe_cfg = CNNConfig(n_pix=cfg.n_pix, batch_size=cfg.pe_batch_size, lr=cfg.lr,
                       noise_frac=cfg.cnn_noise_frac, ema_decay=cfg.pe_ema_decay,
                       lr_decay_steps=cfg.pe_iters if cfg.pe_lr_decay else 0)
    pe_use_ema = cfg.pe_ema_decay > 0
    pe_model = CombinedPE(n_pix=cfg.n_pix) if cfg.comb_pe_model else DualBranchPE(n_pix=cfg.n_pix)
    pe_state = init_cnn(torch.Generator().manual_seed(cfg.seed + 1), pe_model, pe_cfg, device)
    pe_gen = _pe_generator(cfg.seed, device, mesh)
    if mesh is not None:
        mesh.broadcast_modules_(pe_model)

    # CNN sanity set: ideal waveforms from the reference posterior's own
    # mass rows; the CNN's cloud on them bounds its best posterior
    # (ref: lalinf_post_waveform_maker.py + bbhMahoGANy.py:1226-1231)
    sanity_waveforms = None
    if ref_samples is not None:
        rs = torch.as_tensor(ref_samples, dtype=torch.float32, device=device)
        m1s, m2s = priors.mc_q_to_m1m2(rs[:, 0], rs[:, 1])
        sanity_waveforms = tb.make_templates_from_params(m1s, m2s, psd, bank_cfg, norm)
    # the CNN cache (shared across sweep variants) or the run's own
    # checkpoints, restored on resume (ref: :1310-1328)
    if cfg.cnn_cache:
        pe_ckpt = CheckpointManager(os.path.join(cfg.cnn_cache, bbh_cnn_cache_tag(cfg)),
                                    max_to_keep=1, mesh=mesh)
        # the entry is shared across world sizes, as the reference's is:
        # one written at another world restores without its generator state
        restored, pe_extra = pe_ckpt.restore(pe_state, any_world=True)
        if restored is not None and main:
            print("CNN PE restored from cache")
    else:
        pe_ckpt = CheckpointManager(os.path.join(cfg.out_dir, "ckpt_pe"), mesh=mesh)
        pe_extra = pe_ckpt.restore(pe_state)[1] if cfg.resume else None
    if pe_extra:
        pe_gen.set_state(pe_extra["gen"])
    start = pe_state.step
    check_pe_plot_draw(cfg, bank.shape[0], start)

    def pe_save(step):
        pe_ckpt.save(step, pe_state, extra={"gen": pe_gen.get_state()})

    # each rank trains on its block of the bank's rows
    pe_bank, pe_targets = ((bank, targets) if mesh is None
                           else (mesh.shard_rows(bank), mesh.shard_rows(targets)))
    # the reference's chunk rule (ref :1329-1332): pe_cadence iterations
    # per call where the schedule, the checkpoints and the start allow
    pe_chunk = cfg.pe_cadence if (cfg.pe_cadence > 1 and cfg.pe_iters % cfg.pe_cadence == 0
                                  and cfg.ckpt_every % cfg.pe_cadence == 0
                                  and start % cfg.pe_cadence == 0) else 1
    pe_step = (make_cnn_step_scan(pe_model, pe_cfg, pe_chunk, mesh=mesh) if pe_chunk > 1
               else functools.partial(cnn_step, cfg=pe_cfg, mesh=mesh))
    for i0 in range(start, cfg.pe_iters, pe_chunk):
        pe_state, m = pe_step(pe_state, pe_bank, pe_targets, pe_gen)
        if pe_chunk > 1:
            m = {k: v[-1] for k, v in m.items()}
        i = i0 + pe_chunk  # completed updates
        if main and i % cfg.pe_cadence == 0:
            m = fetch_metrics(m)
            log.log(i, m)
            print(log.status_line(i, m, log.steps_per_sec(i)))
            if sanity_waveforms is not None:
                sane = cnn_predict(pe_state, sanity_waveforms, use_ema=pe_use_ema).cpu().numpy()
                if sane[:, 0].var() > 0 and sane[:, 1].var() > 0:
                    b = ov.beta_overlap(sane, ref_samples)
                    log.log(i, {"cnn_sanity_beta": b})
                    print(f"CNN sanity-check beta: {b:.4f}")
            if cfg.plots:
                idx = torch.as_tensor(np.random.default_rng(i).choice(
                    bank.shape[0], _PE_PLOT_ROWS, replace=False), device=device)
                est = cnn_predict(pe_state, bank[idx], use_ema=pe_use_ema).cpu().numpy()
                plots.plot_pe_accuracy(targets[idx].cpu().numpy(), est, cfg.out_dir,
                                       f"pe_accuracy{i:05d}.png")
        if i % cfg.ckpt_every == 0:
            pe_save(i)
    if cfg.pe_iters > start:
        pe_save(cfg.pe_iters)
    pe_rms = pe_std = None
    if main:
        # final CNN accuracy: MSE and mean |err| per parameter on a
        # held-out draw (ref: bbhMahoGANy.py:1188-1198)
        idx = np.random.default_rng(0).choice(bank.shape[0], min(4000, bank.shape[0]),
                                              replace=False)
        idx_t = torch.as_tensor(idx, device=device)
        est = cnn_predict(pe_state, bank[idx_t], use_ema=pe_use_ema).cpu().numpy()
        tgt = targets[idx_t].cpu().numpy()
        pe_rms = [float(np.mean((tgt[:, k] - est[:, k]) ** 2)) for k in range(2)]
        pe_std = [float(np.mean(np.abs(tgt[:, k] - est[:, k]))) for k in range(2)]
        print(f"Completed CNN PE  RMS: {pe_rms[0]:f},{pe_rms[1]:f}  "
              f"pe_std: {pe_std[0]:f},{pe_std[1]:f}")

    sanity_cloud, cnn_sanity_beta = None, None
    if sanity_waveforms is not None:
        sanity_cloud = cnn_predict(pe_state, sanity_waveforms, use_ema=pe_use_ema).cpu().numpy()
        if sanity_cloud[:, 0].var() > 0 and sanity_cloud[:, 1].var() > 0:
            cnn_sanity_beta = ov.beta_overlap(sanity_cloud, ref_samples)
        else:
            cnn_sanity_beta = 0.0  # untrained/collapsed CNN
        print(f"CNN sanity bound beta: {cnn_sanity_beta:.4f}")

    # ---- GAN -------------------------------------------------------------
    inoise = n_sig_eff if cfg.instance_noise < 0 else cfg.instance_noise
    gan_cfg = GANConfig(n_pix=cfg.n_pix, batch_size=cfg.batch_size, lr=cfg.gan_lr or cfg.lr,
                        chi_loss=cfg.chi_loss, n_sig=n_sig_eff,
                        pair_discriminator=cfg.pair_d,
                        label_smoothing=cfg.label_smoothing, d_instance_noise=inoise,
                        d_lr_scale=cfg.d_lr_scale, d_acc_gate=cfg.d_acc_gate,
                        diversity_weight=cfg.diversity_weight, r1_gamma=cfg.r1_gamma,
                        residual_route=cfg.res_loss_weight > 0,
                        res_loss_weight=cfg.res_loss_weight, res_eval_mode=cfg.res_eval_mode,
                        res_spectral_bands=cfg.res_spectral_bands,
                        g_ema_decay=cfg.g_ema_decay, debug_probes=cfg.debug_probes)
    # bf16: G and D compute in bfloat16, their parameters stay float32
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    G = BBHGenerator(n_out=cfg.n_pix, norm=cfg.g_norm, conv_impl=cfg.conv_impl, dtype=dtype)
    D = PairDiscriminator(n_pix=cfg.n_pix, in_ch=2 if cfg.pair_d else 1,
                          conv_impl=cfg.conv_impl, dtype=dtype)
    gan_state = init_gan(torch.Generator().manual_seed(cfg.seed + 2), G, D, gan_cfg, device)
    if mesh is not None:
        mesh.broadcast_modules_(G, D)
    gan_ckpt = CheckpointManager(os.path.join(cfg.out_dir, "ckpt_gan"), mesh=mesh)
    if cfg.resume:
        # the newest step: after a finished run with evals, the diagnostic
        # best-whiteness state at gan_iters + 1, as in the reference
        gan_extra = gan_ckpt.restore(gan_state)[1]
        if gan_extra:
            gen.set_state(gan_extra["gen"])
    start = gan_state.step
    # the reference's chunk rule (ref :1419-1423): cadence iterations per
    # call where the schedule, the evals, the checkpoints and the start allow
    chunk = cfg.cadence if (cfg.cadence > 1 and cfg.gan_iters % cfg.cadence == 0
                            and cfg.eval_cadence % cfg.cadence == 0
                            and cfg.ckpt_every % cfg.cadence == 0
                            and start % cfg.cadence == 0) else 1
    gan_step_fn = (make_gan_step_scan(G, D, gan_cfg, chunk, mesh=mesh) if chunk > 1
                   else make_gan_step(G, D, gan_cfg, mesh=mesh))

    def gan_save(step, payload=None, gen_state=None):
        gan_ckpt.save(step, gan_state if payload is None else payload,
                      extra={"gen": gen.get_state() if gen_state is None else gen_state})

    if cfg.posterior_drate >= 0.0:
        G_samp = BBHGenerator(n_out=cfg.n_pix, drate=cfg.posterior_drate, norm=cfg.g_norm,
                              conv_impl=cfg.conv_impl, dtype=dtype).to(device)
        samp_dropout = True
    else:
        G_samp, samp_dropout = G, cfg.posterior_dropout
    snapshots = deque(maxlen=max(1, cfg.n_snapshots))

    def synth(sm):
        # clip to where the PhenomD fits are sane (the hunt_constrain prior is
        # mc 20-35, q >= 0.5; ML refinement's Adam can wander to the corners)
        sm = torch.as_tensor(sm, dtype=torch.float32, device=device)
        m1s, m2s = priors.mc_q_to_m1m2(torch.clamp(sm[:, 0], 5.0, 60.0),
                                       torch.clamp(sm[:, 1], 0.2, 1.0))
        return tb.make_templates_from_params(m1s, m2s, psd, bank_cfg, norm)

    def cnn(w):
        return cnn_predict(pe_state, w, use_ema=pe_use_ema)

    def draw_posterior(states):
        per = cfg.n_posterior if len(states) == 1 else max(cfg.n_posterior // len(states), 256)
        wf = torch.cat([sample_generator(G_samp, snap, gen, per, gan_cfg, dropout=samp_dropout,
                                         temp=cfg.posterior_temp, bn_mode=cfg.posterior_bn_mode)
                        for snap in states])
        wf_in = wf
        if cfg.posterior_noise > 0:
            # parametric bootstrap through the noise-augmented CNN
            wf_in = wf + cfg.posterior_noise * n_sig_eff * torch.randn(
                wf.shape, generator=gen, device=gen.device)
        samples = cnn(wf_in).cpu().numpy()
        samples_raw = samples
        route_elbo = None  # select_route's score for the returned cloud
        if cfg.select_route == "elbo":
            route, samples, scores = pp.select_route(
                samples, synth, cnn, measured, n_sig_eff, gen,
                temper=cfg.reweight_temper if cfg.reweight_temper > 0 else 1.0)
            route_elbo = scores[route]
            print(f"auto route: {route} (ELBO {route_elbo:.1f})")
        else:
            if cfg.pe_debias > 0:
                samples = pp.self_calibrate(samples, synth, cnn, gen, n_sig_eff,
                                            rounds=cfg.pe_debias)
            if cfg.pe_bootcal > 0:
                samples = pp.bootstrap_calibrate(samples, synth, cnn, gen, n_sig_eff)
            if cfg.pe_mlrc > 0:
                samples = pp.ml_recenter(samples, synth, measured, gen)
            if cfg.reweight_temper > 0:
                ess = pp.effective_sample_size(samples, synth, measured, n_sig_eff,
                                               cfg.reweight_temper)
                samples = pp.likelihood_resample(samples, synth, measured, n_sig_eff, gen,
                                                 temper=cfg.reweight_temper)
                print(f"likelihood resample ESS: {ess:.1f}/{len(samples)}")
        return wf, samples, samples_raw, route_elbo

    def eval_posterior(states, step, tag=None, cloud_override=None):
        """Posterior draw → CNN → post-processing → β / grid overlap /
        whiteness (/ ELBO). ``cloud_override`` scores that cloud instead of
        a fresh draw (the library-selected final product); its waveforms
        are synthesized from its parameters."""
        if cloud_override is not None:
            samples = samples_raw = np.asarray(cloud_override)
            wf = synth(samples[:256])
            route_elbo = None
        else:
            wf, samples, samples_raw, route_elbo = draw_posterior(states)
        raw_row = {}
        if samples_raw is not samples and ref_samples is not None:
            # post-processing active: keep the untransformed cloud's score
            if samples_raw[:, 0].var() > 0:
                raw_row = {"beta_raw": ov.beta_overlap(samples_raw, ref_samples)}
                if grid is not None:
                    raw_row["grid_overlap_raw"] = gp.grid_overlap_score(samples_raw, *grid)
                log.log(step, raw_row)
        save_posterior_snapshot(os.path.join(cfg.out_dir, "GAN_posterior_samples"),
                                step + 1 if tag == "final" else step, samples)
        # whiteness of the posterior-MEAN waveform's residual
        ws = posterior_whiteness(measured.cpu().numpy(), wf[:256].cpu().numpy(), n_sig_eff)
        w_score = (ws["mean_pass"] + ws["var_pass"] + ws["ljung_box_pass"]) / 3.0
        out = {"whiteness": w_score, "ws": ws, "wf": wf, "samples": samples,
               "beta": None, "grid_overlap": None, **raw_row}
        if grid is not None:
            gm = gp.grid_moments(*grid)
            log.log(step, {
                "bias_mc": (float(samples[:, 0].mean()) - gm[0]) / max(gm[2], 1e-12),
                "bias_q": (float(samples[:, 1].mean()) - gm[1]) / max(gm[3], 1e-12),
                "disp_mc": float(samples[:, 0].std()) / max(gm[2], 1e-12),
                "disp_q": float(samples[:, 1].std()) / max(gm[3], 1e-12),
            })
        if ref_samples is not None:
            if samples[:, 0].var() > 0 and samples[:, 1].var() > 0:
                out["beta"] = ov.beta_overlap(samples, ref_samples)
                if sanity_cloud is not None:
                    out["beta_sanity"] = ov.beta_overlap(samples, sanity_cloud)
                if grid is not None:
                    out["grid_overlap"] = gp.grid_overlap_score(samples, *grid)
            else:
                # degenerate cloud (ref guard: bbhMahoGANy.py:1354-1355)
                out["beta"] = 0.0
                out["grid_overlap"] = 0.0 if grid is not None else None
        if cfg.select_best == "elbo" and samples[:, 0].var() > 0 and samples[:, 1].var() > 0:
            # a collapsed cloud is never selectable; non-finite scores stay
            # out of the log; select_route's score is reused for its cloud
            elbo = route_elbo if route_elbo is not None else \
                pp.elbo_score(samples, synth, measured, n_sig_eff)
            print(f"cloud ELBO: {elbo:.1f}")
            if np.isfinite(elbo):
                out["elbo"] = elbo
        row = {k: out[k] for k in ("whiteness", "beta", "beta_sanity", "grid_overlap", "elbo")
               if out.get(k) is not None}
        log.log(step, row if tag is None else {f"{k}_{tag}": v for k, v in row.items()})
        return out

    base_knobs, anneal_knobs, anneal_start = _anneal_knobs(gan_cfg, cfg)
    gan_bank = gan_real_bank(cfg, bank, signal, mesh)
    if mesh is not None:
        gan_bank = mesh.shard_rows(gan_bank)
    beta_hist, beta_steps = [], []
    best_white, best_state, best_gen = -1.0, None, None
    sel_score, sel_step = float("-inf"), None
    frozen_at = None
    log.steps_per_sec(start)  # reset the steps/sec window for the GAN phase
    # deferred metric flush (ref :1604-1633): a chunked loop logs the last
    # cadence point while the device runs the next chunk; an eval and the
    # end of the loop flush first
    pending = None  # (step, metrics on the device) awaiting their log line

    def flush():
        nonlocal pending
        if pending is not None:
            i_p, mh = pending[0], fetch_metrics(pending[1])
            pending = None
            log.log(i_p, mh)
            print(log.status_line(i_p, mh, log.steps_per_sec(i_p)))

    for i0 in range(start, cfg.gan_iters, chunk):
        i = i0 + chunk  # completed iterations
        # the knobs of a chunk are those of its first step (ref :1628)
        knobs = anneal_knobs if (cfg.anneal_frac > 0 and i0 >= anneal_start) else base_knobs
        gan_state, m = gan_step_fn(gan_state, gan_bank, measured, gen, knobs)
        if chunk > 1:
            m = {k: v[-1] for k, v in m.items()}
        if main and i % cfg.cadence == 0:
            flush()
            pending = (i, m)
            if chunk == 1:
                flush()
        if i % cfg.eval_cadence == 0:
            improved = freeze = False
            if main:
                flush()
                snapshots.append(_snapshot(gan_state))
                ev = eval_posterior(list(snapshots), i)
                improved = bool(ev["whiteness"] > best_white)
                if improved:
                    best_white = ev["whiteness"]
                if ev.get("elbo", float("-inf")) > sel_score:
                    sel_score, sel_step = ev["elbo"], i
                # combined early stop (ref :1648-1661): white draws AND a
                # converged raw residual loss of the newest step
                # (freeze_on_res ≤ 0: whiteness only)
                res_raw = float(m["res_loss"]) / max(cfg.res_loss_weight, 1e-30)
                res_ok = cfg.freeze_on_res <= 0 or 0.0 < res_raw < cfg.freeze_on_res
                freeze = bool(cfg.freeze_on_white > 0 and ev["whiteness"] >= cfg.freeze_on_white
                              and res_ok)
            improved, freeze = _decide(mesh, (improved, freeze))
            if improved:
                # a copy of the whole state: it restores like any checkpoint
                # (each rank keeps its stream's state for the gathered save)
                best_state = copy.deepcopy(state_dict_of(gan_state)) if main else {}
                best_gen = gen.get_state()
            if freeze:
                frozen_at = i
                if main:
                    print(f"residuals white ({ev['whiteness']:.3f} ≥ {cfg.freeze_on_white}, "
                          f"raw res_loss {res_raw:.2e}) — training frozen at {i}")
                gan_save(i)
                break
            if main and ev["beta"] is not None:
                beta_hist.append(ev["beta"])
                beta_steps.append(i)
                print(f"beta result: {ev['beta']}" +
                      ("" if ev["grid_overlap"] is None
                       else f"  grid overlap: {ev['grid_overlap']:.4f}"))
            if main and cfg.plots:
                sig, meas, wf = (t.cpu().numpy() for t in (signal, measured, ev["wf"]))
                plots.plot_waveform_est(sig, meas, wf, cfg.out_dir, i)
                plots.plot_waveform_est(sig, meas, wf, cfg.out_dir, i, zoom=(450, 550))
                plots.plot_losses(log.arrays(), cfg.out_dir)
                plots.plot_pe_samples(ev["samples"], truth, cfg.out_dir, i, ref_samples=ref_samples)
                if beta_hist:
                    plots.plot_beta_history(beta_hist, beta_steps, cfg.out_dir)
        if i % cfg.ckpt_every == 0:
            gan_save(i)
    flush()
    gan_save(max(cfg.gan_iters, 1))

    # ---- final-state artefacts (the reference uses the last iteration's
    # state, ref: :1241); the best-whiteness state is kept as a diagnostic
    whiteness = beta_final = grid_overlap_final = beta_sanity_final = None
    beta_raw_final = grid_overlap_raw_final = None
    sel_route_name, sel_info = None, None
    if main and cfg.gan_iters > start:
        final_states = [gan_state]
        if cfg.n_snapshots > 1:
            # the pooled snapshots, plus the final state unless the last eval took it
            final_states = list(snapshots) + (
                [] if snapshots and snapshots[-1].step == gan_state.step else [gan_state])
        cloud_override = None
        if cfg.select_best == "elbo":
            # candidate-library selection over the saved per-eval clouds and
            # the trained-final cloud (ref :1697-1733), truth-free
            _, samples_f, _, _ = draw_posterior(final_states)
            lib = {}
            for path in glob.glob(os.path.join(cfg.out_dir, "GAN_posterior_samples",
                                               "posterior_samples_*.npz")):
                st = int(path.rsplit("_", 1)[1].split(".")[0])
                if st <= cfg.gan_iters:  # skip a previous run's final (+1)
                    lib[st] = np.load(path)["samples"]
            sel_route_name, chosen, sel_info = pp.select_final_cloud(
                lib, synth, measured, n_sig_eff, gen, extra={"final": np.asarray(samples_f)},
                # search-window prior: the exact grid's parameter box
                bounds=((20.0, 35.0), (0.5, 1.0)))
            if sel_info:
                print(f"library-selected posterior: {sel_route_name} (scores {{"
                      + ", ".join(f"{k}: {v:.1f}" for k, v in sel_info["scores"].items())
                      + f"}}, plateau K={len(sel_info.get('plateau_members', []))}, "
                      f"pool ESS {sel_info.get('pool_ess', 0.0):.0f})")
            if chosen is not None:
                cloud_override = np.asarray(chosen)
        ev = eval_posterior(final_states, cfg.gan_iters, tag="final",
                            cloud_override=cloud_override)
        whiteness, beta_final = ev["ws"], ev["beta"]
        grid_overlap_final = ev["grid_overlap"]
        beta_sanity_final = ev.get("beta_sanity")
        # null under select_best="elbo": the override cloud is its own raw
        # cloud, as in the reference (ROADMAP queue 3, reproduced)
        beta_raw_final = ev.get("beta_raw")
        grid_overlap_raw_final = ev.get("grid_overlap_raw")
        print(f"final-state residual whiteness: {whiteness}")
        if beta_final is not None:
            print(f"final-state beta: {beta_final:.4f}" +
                  ("" if beta_sanity_final is None
                   else f"  beta vs sanity cloud: {beta_sanity_final:.4f}") +
                  ("" if grid_overlap_final is None
                   else f"  grid overlap: {grid_overlap_final:.4f}"))
        if cfg.plots:
            sig, meas, wf = (t.cpu().numpy() for t in (signal, measured, ev["wf"]))
            plots.plot_waveform_est(sig, meas, wf, cfg.out_dir, cfg.gan_iters,
                                    fname="waveform_final.png")
            plots.plot_pe_samples(ev["samples"], truth, cfg.out_dir, cfg.gan_iters,
                                  ref_samples=ref_samples, fname="pe_samples_final.png")
    if cfg.gan_iters > start and best_state is not None:
        gan_save(cfg.gan_iters + 1, best_state, best_gen)  # diagnostic state

    log.close()
    if not main:
        return None
    return {
        "beta": beta_final,
        "beta_raw": beta_raw_final,
        "grid_overlap_raw": grid_overlap_raw_final,
        "beta_sanity": beta_sanity_final,
        "beta_hist_last": beta_hist[-1] if beta_hist else None,
        "grid_overlap": grid_overlap_final,
        "cnn_sanity_beta": cnn_sanity_beta,
        "final_step": int(gan_state.step),
        "frozen_at": frozen_at,
        "selected_at": sel_step,                 # in-run ELBO argmax (diagnostic)
        "selected_route": sel_route_name,        # library candidate chosen
        "pool_ess": (sel_info or {}).get("pool_ess"),
        "plateau_k": len((sel_info or {}).get("plateau_members", [])) or None,
        "whiteness": whiteness,
        "pe_rms": pe_rms,
        "pe_std": pe_std,
    }


# ---------------------------------------------------------------------------
# sample-posterior


def _routes_on(cfg: BBHConfig) -> bool:
    return (cfg.select_route == "elbo" or cfg.pe_debias > 0 or cfg.pe_bootcal > 0
            or cfg.pe_mlrc > 0 or cfg.reweight_temper > 0)


def check_sample_posterior(cfg: BBHConfig):
    """Refuse what the reference's ``sample-posterior`` cannot run. It
    restores into ``DualBranchPE()``, a pair ``PairDiscriminator()`` and a
    batch-norm ``BBHGenerator`` whatever the flags say, and synthesizes on
    the n_pix 1024 geometry (``tb.BankConfig()``); each case below fails
    there (orbax tree or shape mismatch, or a broadcast error in the
    route)."""
    bad = []
    if cfg.comb_pe_model:
        bad.append("comb_pe_model=True (the PE is restored into DualBranchPE)")
    if not cfg.pair_d:
        bad.append("pair_d=False (D is restored into the pair discriminator)")
    if cfg.g_norm != "batch":
        bad.append(f"g_norm={cfg.g_norm!r} (G is restored into the batch-norm generator)")
    if cfg.n_pix != 1024 and _routes_on(cfg):
        bad.append(f"n_pix={cfg.n_pix} with a posterior route (the routes synthesize at "
                   "n_pix 1024)")
    if bad:
        raise ValueError("sample-posterior cannot run, as in the reference: " + "; ".join(bad))


def sample_posterior(cfg: BBHConfig, *, n_samples: int, out: str, device):
    """Posterior draws from a run's checkpoints (ref: gennet_tpu/cli/
    main.py:217-304): G → CNN, then the truth-free routes the flags ask for
    (noise std ``cfg.n_sig``, as in the reference), saved as ``out`` with
    ``samples`` and ``waveforms``, or ``waveforms_unpaired`` when a
    resampling route reordered the rows. Restores the newest checkpoint of
    each phase (after a finished run with evals, G's best-whiteness state).
    Returns the summary the CLI prints."""
    check_sample_posterior(cfg)
    device = torch.device(device)
    gan_cfg = GANConfig(n_pix=cfg.n_pix, batch_size=cfg.batch_size)
    G = BBHGenerator(n_out=cfg.n_pix, conv_impl=cfg.conv_impl)
    D = PairDiscriminator(n_pix=cfg.n_pix, conv_impl=cfg.conv_impl)
    gan_state = init_gan(torch.Generator().manual_seed(0), G, D, gan_cfg, device)
    pe_state = init_cnn(torch.Generator().manual_seed(1), DualBranchPE(n_pix=cfg.n_pix),
                        CNNConfig(n_pix=cfg.n_pix), device)
    for phase, state in (("ckpt_gan", gan_state), ("ckpt_pe", pe_state)):
        directory = os.path.join(cfg.out_dir, phase)
        if CheckpointManager(directory).restore(state)[0] is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    use_ema = cfg.pe_ema_decay > 0  # the training run's eval path
    wf = sample_generator(G, gan_state, torch.Generator(device=device).manual_seed(cfg.seed),
                          n_samples, gan_cfg)
    samples = cnn_predict(pe_state, wf, use_ema=use_ema).cpu().numpy()
    extra, resampled = {}, False
    if _routes_on(cfg):
        # the event as the training run drew it (skip_bank: same draws)
        measured, norm, psd = _prepare_bbh_data(
            cfg, torch.Generator(device=device).manual_seed(cfg.seed), device,
            skip_bank=True)[3:6]
        bank_cfg = tb.BankConfig()

        def synth(sm):
            sm = torch.as_tensor(sm, dtype=torch.float32, device=device)
            m1s, m2s = priors.mc_q_to_m1m2(torch.clamp(sm[:, 0], 5.0, 60.0),
                                           torch.clamp(sm[:, 1], 0.2, 1.0))
            return tb.make_templates_from_params(m1s, m2s, psd, bank_cfg, norm)

        def cnn(w):
            return cnn_predict(pe_state, w, use_ema=use_ema)

        rgen = torch.Generator(device=device).manual_seed(cfg.seed + 7)
        if cfg.select_route == "elbo":
            route, samples, _ = pp.select_route(
                samples, synth, cnn, measured, cfg.n_sig, rgen,
                temper=cfg.reweight_temper if cfg.reweight_temper > 0 else 1.0)
            extra["route"] = route
            resampled = route.endswith("reweight")
        else:
            if cfg.pe_debias > 0:
                samples = pp.self_calibrate(samples, synth, cnn, rgen, cfg.n_sig,
                                            rounds=cfg.pe_debias)
            if cfg.pe_bootcal > 0:
                samples = pp.bootstrap_calibrate(samples, synth, cnn, rgen, cfg.n_sig)
            if cfg.pe_mlrc > 0:
                samples = pp.ml_recenter(samples, synth, measured, rgen)
            if cfg.reweight_temper > 0:
                samples = pp.likelihood_resample(samples, synth, measured, cfg.n_sig, rgen,
                                                 temper=cfg.reweight_temper)
                resampled = True
    # resampling reorders and repeats rows, so samples[i] no longer pairs
    # with wf[i]: the draws then go under another key
    wf_key = "waveforms_unpaired" if resampled else "waveforms"
    np.savez_compressed(out, samples=samples, **{wf_key: wf.cpu().numpy()})
    return {"samples": int(samples.shape[0]), "file": out, "waveforms_key": wf_key, **extra}


# ---------------------------------------------------------------------------
# the burst smoke workload


@dataclass
class BurstSmokeConfig:
    """``smoke`` workload config (ref defaults: burstMahoGANy.py:31-48). Field
    meanings, with the measurements behind each default, are documented on
    ``gennet_tpu.cli.workloads.BurstSmokeConfig``."""

    n_pix: int = 512
    n_signals: int = 50_000
    n_sig: float = 0.25
    batch_size: int = 64
    gan_iters: int = 50_000
    pe_iters: int = 60_000
    lr: float = 2e-4
    cadence: int = 100
    pe_grain: int = 95
    n_posterior: int = 4000
    label_smoothing: bool = True
    instance_noise: float = 0.0       # < 0: n_sig
    d_lr_scale: float = 0.5
    d_acc_gate: float = 0.0
    diversity_weight: float = 0.0
    r1_gamma: float = 0.0
    res_loss_weight: float = 10.0
    posterior_temp: float = 1.0
    per_sample_max: bool = False
    snapshot_every: int = 1           # pool a snapshot every k-th cadence point
    n_snapshots: int = 1
    g_ema_decay: float = 0.0
    posterior_dropout: bool = False
    posterior_drate: float = -1.0
    posterior_noise: float = 0.0
    pe_noise_frac: float = 0.5
    pe_debias: int = 0
    pe_bootcal: int = 0
    pe_mlrc: int = 0
    reweight_temper: float = 0.0
    pe_no_norm: bool = True
    freeze_on_res: float = 2e-5       # raw (unweighted) res_loss bound of the early stop
    gan_restarts: int = 2             # fresh-init reruns after an unconverged schedule
    freeze_on_white: float = 0.99     # whiteness score that freezes training
    anneal_frac: float = 0.0
    select_best: str = ""
    select_route: str = ""
    cnn_cache: str | None = None
    eval_every: int = 1               # posterior draw every k-th cadence point
    debug_probes: bool = False
    out_dir: str = "out/burst"
    seed: int = 0
    plots: bool = True


def check_burst_config(cfg: BurstSmokeConfig):
    """The reference's three ValueErrors, and ImportError for
    ``plots=True`` without matplotlib."""
    _check_common(cfg)
    if cfg.plots:
        plots.require_matplotlib()


def burst_cnn_cache_tag(cfg: BurstSmokeConfig) -> str:
    """The CNN cache's entry for ``run_burst_smoke``: lr and n_sig included
    (noise_scale_max = 2·n_sig), so a sweep never restores a mismatched
    CNN (the reference's expression, workloads.py:296-300)."""
    return (f"s{cfg.seed}_i{cfg.pe_iters}_n{cfg.n_pix}_b{cfg.batch_size}"
            f"_sig{cfg.n_signals}_psm{int(cfg.per_sample_max)}"
            f"_lr{cfg.lr:g}_ns{cfg.n_sig:g}"
            + (f"_pnf{cfg.pe_noise_frac}" if cfg.pe_noise_frac else "")
            + ("_nonorm" if cfg.pe_no_norm else ""))


# the exact grid's parameter box (burst_grid_posterior's defaults): the
# library selection's search-window prior
_BURST_BOUNDS = ((0.25, 0.75), (1.0 / 60.0, 1.0 / 15.0))


def run_burst_smoke(cfg: BurstSmokeConfig, *, device, mesh: DataMesh | None = None):
    """The burst mahoGANy on ``device`` (ref: tests/burstMahoGANy.py:569-901):
    analytic bank and event, exact (t0, τ) grid, CNN PE, the 3-loss GAN with
    early stop, restarts and terminal anneal, posterior draws scored
    against the grid. Returns the same summary dict as the JAX workload
    (``None`` on ranks other than 0 of a ``mesh``).

    Step labels count completed iterations, as in :func:`run_bbh` (the JAX
    loop labels an unchunked run's cadence points one step early).
    """
    check_burst_config(cfg)
    if mesh is not None:
        check_rows(cfg.n_signals, mesh.world, "the burst bank (n_signals)")
    main = is_main(mesh)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    os.makedirs(cfg.out_dir, exist_ok=True)
    log = MetricLogger(cfg.out_dir if main else None, "burst")
    snap_dir = os.path.join(cfg.out_dir, "GAN_posterior_samples")

    # training bank and the fixed event at (t0, τ) = truth (ref: :581,614-631)
    bank, pars = make_burst_bank(gen, cfg.n_signals, N=cfg.n_pix)
    truth = (0.5, 1.0 / 25.0)
    signal = sine_gaussian(*truth, N=cfg.n_pix, device=device)
    measured = signal + cfg.n_sig * torch.randn(signal.shape, generator=gen, device=device)
    gen = _rank_stream(gen, cfg.seed, mesh)
    # each rank trains on its block of the bank's rows
    train_bank, train_pars = ((bank, pars) if mesh is None
                              else (mesh.shard_rows(bank), mesh.shard_rows(pars)))
    # exact grid posterior (ref: :716-726; evaluation: rank 0 only)
    L = gx = gy = None
    if main:
        L, gx, gy = gp.burst_grid_posterior(measured, cfg.n_sig, cfg.pe_grain)
    measured_np, signal_np = measured.cpu().numpy(), signal.cpu().numpy()

    def synth(s):
        s = torch.as_tensor(s, dtype=torch.float32, device=device)
        return sine_gaussian(s[:, 0], s[:, 1], N=cfg.n_pix)

    # ---- CNN PE (ref: :732-771) ------------------------------------------
    pe_cfg = CNNConfig(n_pix=cfg.n_pix, batch_size=cfg.batch_size, lr=cfg.lr,
                       noise_frac=cfg.pe_noise_frac, noise_scale_max=2.0 * cfg.n_sig,
                       max_normalize=not cfg.pe_no_norm, max_per_sample=cfg.per_sample_max)
    pe_model = BurstPE(n_pix=cfg.n_pix)
    pe_state = init_cnn(torch.Generator().manual_seed(cfg.seed + 1), pe_model, pe_cfg, device)
    if mesh is not None:
        mesh.broadcast_modules_(pe_model)
    # the PE phase draws from its own generator, so a cache hit leaves the
    # GAN phase's draws as they are on a miss (ref: :287-307)
    cache = (CheckpointManager(os.path.join(cfg.cnn_cache, burst_cnn_cache_tag(cfg)),
                               max_to_keep=1, mesh=mesh) if cfg.cnn_cache else None)
    if cache is not None and cache.restore(pe_state, any_world=True)[0] is not None:
        if main:
            print("CNN PE restored from cache")
    else:
        pe_gen = _pe_generator(cfg.seed, device, mesh)
        # the reference's chunk rule (ref :309): cadence iterations per call
        pe_chunk = cfg.cadence if (cfg.cadence > 1 and cfg.pe_iters % cfg.cadence == 0) else 1
        pe_step = (make_cnn_step_scan(pe_model, pe_cfg, pe_chunk, mesh=mesh) if pe_chunk > 1
                   else functools.partial(cnn_step, cfg=pe_cfg, mesh=mesh))
        for i0 in range(0, cfg.pe_iters, pe_chunk):
            pe_state, m = pe_step(pe_state, train_bank, train_pars, pe_gen)
            if pe_chunk > 1:
                m = {k: v[-1] for k, v in m.items()}
            i = i0 + pe_chunk  # completed updates
            if main and i % cfg.cadence == 0:
                m = fetch_metrics(m)
                log.log(i, m)
                print(log.status_line(i, m, log.steps_per_sec(i)))
        if cache is not None:
            cache.save(cfg.pe_iters, pe_state)
    rms = pe_std = None
    if main:  # PE accuracy on the bank
        est = cnn_predict(pe_state, bank[:4000]).cpu().numpy()
        tgt = pars[:4000].cpu().numpy()
        rms = [float(np.mean((tgt[:, k] - est[:, k]) ** 2)) for k in range(2)]
        pe_std = [float(np.mean(np.abs(tgt[:, k] - est[:, k]))) for k in range(2)]
        print(f"Completed CNN PE  RMS: {rms[0]:f},{rms[1]:f}")

    def cnn(w):
        return cnn_predict(pe_state, normalize_max(w, pe_cfg))

    # ---- GAN (ref: :779-899) ---------------------------------------------
    inoise = cfg.n_sig if cfg.instance_noise < 0 else cfg.instance_noise
    gan_cfg = GANConfig(n_pix=cfg.n_pix, batch_size=cfg.batch_size, lr=cfg.lr, n_sig=cfg.n_sig,
                        pair_discriminator=False, residual_route=True,
                        label_smoothing=cfg.label_smoothing, d_instance_noise=inoise,
                        d_lr_scale=cfg.d_lr_scale, d_acc_gate=cfg.d_acc_gate,
                        diversity_weight=cfg.diversity_weight, r1_gamma=cfg.r1_gamma,
                        res_loss_weight=cfg.res_loss_weight, g_ema_decay=cfg.g_ema_decay,
                        debug_probes=cfg.debug_probes)
    G = BurstGenerator(n_out=cfg.n_pix)
    D = BurstDiscriminator(n_pix=cfg.n_pix)
    gan_state = init_gan(torch.Generator().manual_seed(cfg.seed + 2), G, D, gan_cfg, device)
    if mesh is not None:
        mesh.broadcast_modules_(G, D)
    snapshots = deque(maxlen=max(1, cfg.n_snapshots))
    # posterior sampler: optionally a weaker-dropout clone of G (the same
    # weights; GaussianDropout carries none)
    if cfg.posterior_drate >= 0.0:
        G_samp, samp_dropout = BurstGenerator(n_out=cfg.n_pix, drate=cfg.posterior_drate), True
    else:
        G_samp, samp_dropout = G, cfg.posterior_dropout

    def draw_posterior(states):
        """Posterior cloud pooled over snapshot states."""
        per = cfg.n_posterior if len(states) == 1 else max(cfg.n_posterior // len(states), 64)
        wf = torch.cat([sample_generator(G_samp, snap, gen, per, gan_cfg, dropout=samp_dropout,
                                         temp=cfg.posterior_temp) for snap in states])
        wf_in = wf
        if cfg.posterior_noise > 0:
            # parametric bootstrap: fresh measurement-scale noise on each draw
            wf_in = wf + cfg.posterior_noise * cfg.n_sig * torch.randn(
                wf.shape, generator=gen, device=gen.device)
        samples = cnn(wf_in).cpu().numpy()
        route_elbo = None  # select_route's score for the returned cloud
        if cfg.select_route == "elbo":
            route, samples, scores = pp.select_route(
                samples, synth, cnn, measured, cfg.n_sig, gen,
                temper=cfg.reweight_temper if cfg.reweight_temper > 0 else 1.0)
            route_elbo = scores[route]
            print(f"auto route: {route} (ELBO {route_elbo:.1f})")
        else:
            if cfg.pe_debias > 0:
                samples = pp.self_calibrate(samples, synth, cnn, gen, cfg.n_sig,
                                            rounds=cfg.pe_debias)
            if cfg.pe_bootcal > 0:
                samples = pp.bootstrap_calibrate(samples, synth, cnn, gen, cfg.n_sig)
            if cfg.pe_mlrc > 0:
                samples = pp.ml_recenter(samples, synth, measured, gen)
            if cfg.reweight_temper > 0:
                ess = pp.effective_sample_size(samples, synth, measured, cfg.n_sig,
                                               cfg.reweight_temper)
                samples = pp.likelihood_resample(samples, synth, measured, cfg.n_sig, gen,
                                                 temper=cfg.reweight_temper)
                print(f"likelihood resample ESS: {ess:.1f}/{len(samples)}")
        return wf, samples, route_elbo

    base_knobs, anneal_knobs, anneal_start = _anneal_knobs(gan_cfg, cfg)
    # the reference's chunk rule (ref :350): cadence iterations per call; a
    # restart's fresh modules are captured again
    chunk = cfg.cadence if (cfg.cadence > 1 and cfg.gan_iters % cfg.cadence == 0) else 1
    gan_step_fn = (make_gan_step_scan(G, D, gan_cfg, chunk, mesh=mesh) if chunk > 1
                   else make_gan_step(G, D, gan_cfg, mesh=mesh))
    gm = gp.grid_moments(L, gx, gy) if main else None
    best_score = -1.0
    sel_score, sel_step = float("-inf"), None
    frozen_at = None
    log.steps_per_sec(0)  # reset the steps/sec window for the GAN phase
    # up to gan_restarts fresh-init attempts while a whole schedule ends
    # unconverged; snapshots and the cadence count reset per attempt (a
    # pooled cloud must not mix generators of different inits)
    max_attempts = 1 + (cfg.gan_restarts if cfg.freeze_on_white > 0 else 0)
    for attempt in range(max_attempts):
        if attempt:
            gan_state = init_gan(torch.Generator().manual_seed(cfg.seed + 1000 + attempt),
                                 G, D, gan_cfg, device)
            if mesh is not None:
                mesh.broadcast_modules_(G, D)
            if main:
                print(f"schedule ended unconverged — random restart {attempt}")
                snapshots.clear()
                # the on-disk cloud history stays a single trajectory
                for path in glob.glob(os.path.join(snap_dir, "posterior_samples_*.npz")):
                    os.remove(path)
        n_cad = 0
        for i0 in range(0, cfg.gan_iters, chunk):
            i = i0 + chunk  # completed iterations
            # the knobs of a chunk are those of its first step (ref :471)
            knobs = anneal_knobs if (cfg.anneal_frac > 0 and i0 >= anneal_start) else base_knobs
            gan_state, m = gan_step_fn(gan_state, train_bank, measured, gen, knobs)
            if chunk > 1:
                m = {k: v[-1] for k, v in m.items()}
            if i % cfg.cadence != 0:
                continue
            n_cad += 1
            eval_now = n_cad % max(1, cfg.eval_every) == 0
            freeze = False  # rank 0 evaluates and decides the early stop
            if main:
                mh = fetch_metrics(m)
                log.log(i, mh)
                print(log.status_line(i, mh, log.steps_per_sec(i)))
                if n_cad % max(1, cfg.snapshot_every) == 0:
                    snapshots.append(_snapshot(gan_state))
            if main and eval_now:
                wf, samples, route_elbo = draw_posterior(list(snapshots) or [gan_state])
                save_posterior_snapshot(snap_dir, i, samples)
                # cloud diagnostics against the exact grid: bias (mean offset in
                # exact-σ units) and dispersion ratio per parameter
                wf_np = wf.cpu().numpy().reshape(wf.shape[0], -1)
                diag = {
                    "bias_t0": (float(samples[:, 0].mean()) - gm[0]) / max(gm[2], 1e-12),
                    "bias_tau": (float(samples[:, 1].mean()) - gm[1]) / max(gm[3], 1e-12),
                    "disp_t0": float(samples[:, 0].std()) / max(gm[2], 1e-12),
                    "disp_tau": float(samples[:, 1].std()) / max(gm[3], 1e-12),
                    "wf_corr": float(np.mean(
                        np.sum(wf_np * signal_np[None, :], axis=1)
                        / (np.linalg.norm(wf_np, axis=1) * np.linalg.norm(signal_np) + 1e-30))),
                }
                # degenerate-output guard (ref: bbhMahoGANy.py:1354-1355)
                if samples[:, 0].var() > 0 and samples[:, 1].var() > 0:
                    score = gp.grid_overlap_score(samples, L, gx, gy)
                    diag["grid_overlap"] = score
                    print(f"grid overlap: {score:.4f}  "
                          f"bias: ({diag['bias_t0']:+.2f}, {diag['bias_tau']:+.2f})σ  "
                          f"disp: ({diag['disp_t0']:.2f}, {diag['disp_tau']:.2f})×  "
                          f"wf_corr: {diag['wf_corr']:.4f}")
                    best_score = max(best_score, score)
                    if cfg.select_best == "elbo":
                        # inside the guard: a collapsed cloud is never selectable
                        elbo = route_elbo if route_elbo is not None else \
                            pp.elbo_score(samples, synth, measured, cfg.n_sig)
                        if np.isfinite(elbo):
                            diag["elbo"] = elbo
                        print(f"cloud ELBO: {elbo:.1f}")
                        if elbo > sel_score:
                            sel_score, sel_step = elbo, i
                if cfg.freeze_on_white > 0:
                    # the posterior-mean waveform's residual (eval/whiteness)
                    # AND a converged raw residual loss
                    ws = posterior_whiteness(measured_np / cfg.n_sig, wf_np[:256] / cfg.n_sig, 1.0)
                    w = (ws["mean_pass"] + ws["var_pass"] + ws["ljung_box_pass"]) / 3.0
                    diag["whiteness"] = w
                    res_raw = mh["res_loss"] / max(cfg.res_loss_weight, 1e-30)
                    res_ok = cfg.freeze_on_res <= 0 or 0.0 < res_raw < cfg.freeze_on_res
                    freeze = bool(w >= cfg.freeze_on_white and res_ok)
                log.log(i, diag)
                if freeze:
                    print(f"residuals white ({w:.3f} ≥ {cfg.freeze_on_white},"
                          f" raw res_loss {res_raw:.2e}) — training frozen at {i}")
                elif cfg.plots:
                    plots.plot_waveform_est(signal_np, measured_np, wf_np, cfg.out_dir, i)
                    plots.plot_pe_samples(samples, truth, cfg.out_dir, i, grid=(L, gx, gy))
                    plots.plot_losses(log.arrays(), cfg.out_dir)
            if eval_now and cfg.freeze_on_white > 0 and _decide(mesh, freeze):
                frozen_at = i
                break
        if frozen_at is not None:
            break

    # ---- final state (the reference scores the last iteration's state) ---
    whiteness, final_score = None, 0.0
    sel_route_name, sel_info = None, None
    if not main:
        log.close()
        return None
    if cfg.gan_iters > 0:
        final_states = [gan_state]
        if cfg.n_snapshots > 1 and snapshots:
            final_states = list(snapshots) + (
                [] if snapshots[-1].step == gan_state.step else [gan_state])
        wf, samples, _ = draw_posterior(final_states)
        if cfg.select_best == "elbo":
            # candidate-library selection over the saved per-eval clouds and
            # the trained-final cloud (posterior_post.select_final_cloud)
            clouds = {}
            for path in glob.glob(os.path.join(snap_dir, "posterior_samples_*.npz")):
                st = int(path.rsplit("_", 1)[1].split(".")[0])
                if st <= cfg.gan_iters:  # skip a previous run's final (+1)
                    clouds[st] = np.load(path)["samples"]
            sel_route_name, chosen, sel_info = pp.select_final_cloud(
                clouds, synth, measured, cfg.n_sig, gen, extra={"final": np.asarray(samples)},
                bounds=_BURST_BOUNDS)
            if chosen is not None and sel_route_name != "final":
                samples = np.asarray(chosen)
                wf = synth(samples[:256])
            if sel_info:
                print(f"library-selected posterior: {sel_route_name} (scores {{"
                      + ", ".join(f"{k}: {v:.1f}" for k, v in sel_info["scores"].items())
                      + f"}}, plateau K={len(sel_info.get('plateau_members', []))}, "
                      f"pool ESS {sel_info.get('pool_ess', 0.0):.0f})")
        save_posterior_snapshot(snap_dir, cfg.gan_iters + 1, samples)  # +1: the final cloud
        if samples[:, 0].var() > 0 and samples[:, 1].var() > 0:
            final_score = gp.grid_overlap_score(samples, L, gx, gy)
        log.log(cfg.gan_iters, {"grid_overlap_final": final_score})
        print(f"final-state grid overlap: {final_score:.4f}")
        # residual whiteness: h(t) − x_gen should be N(0, n_sig²) white
        whiteness = posterior_whiteness(measured_np / cfg.n_sig,
                                        wf.cpu().numpy() / cfg.n_sig, 1.0)
        print(f"residual whiteness: {whiteness}")
        if cfg.plots:
            plots.plot_waveform_est(signal_np, measured_np, wf.cpu().numpy(), cfg.out_dir,
                                    cfg.gan_iters, fname="waveform_final.png")
            plots.plot_pe_samples(samples, truth, cfg.out_dir, cfg.gan_iters, grid=(L, gx, gy),
                                  fname="pe_samples_final.png")

    log.close()
    return {"rms": rms, "pe_std": pe_std,
            "grid_overlap": final_score,          # final-state score (the gate)
            "grid_overlap_best": best_score,      # best cadence state (diagnostic)
            "frozen_at": frozen_at,               # early-stop step (None = ran full)
            "selected_at": sel_step,              # in-run ELBO argmax step (diagnostic)
            "selected_route": sel_route_name,     # library candidate chosen (None = off)
            "pool_ess": (sel_info or {}).get("pool_ess"),
            "plateau_k": len((sel_info or {}).get("plateau_members", [])) or None,
            "whiteness": whiteness}


# ---------------------------------------------------------------------------
# the gen-1 image workloads


@dataclass
class BlobToyConfig:
    """``blob-toy`` workload config (ref: tests/ganymede.py:31-64,494-740);
    the JAX package's fields and defaults."""

    n_pix: int = 28
    n_signals: int = 10_000
    n_sig: float = 0.3
    batch_size: int = 64
    pe_iters: int = 2_000
    mc_pe_iters: int = 2_000
    gan_iters: int = 2_000
    n_mc_draws: int = 1000         # MC-dropout posterior draws (ref: :617-620)
    rms_gate: float = 5e-4         # convergence gate (ref: :626)
    lr: float = 2e-4
    cadence: int = 200
    out_dir: str = "out/blob"
    seed: int = 0
    plots: bool = True             # the reference's blob toy draws no plot either way


def _image_gan(n_pix: int, cfg, seed: int, device, mesh: DataMesh | None):
    """The residual-route GAN on flattened n_pix × n_pix images (the 1-D
    GAN step with the raw-series D), initialised from ``seed`` and
    broadcast from rank 0 under a ``mesh``: (GANConfig, G, GANState)."""
    from gennet_tpu_torch.models.image_models import FlatImageDiscriminator, FlatImageGenerator

    gan_cfg = GANConfig(n_pix=n_pix * n_pix, batch_size=cfg.batch_size, lr=cfg.lr,
                        n_sig=cfg.n_sig, pair_discriminator=False, residual_route=True)
    G, D = FlatImageGenerator(n_pix=n_pix), FlatImageDiscriminator(n_pix=n_pix)
    state = init_gan(torch.Generator().manual_seed(seed), G, D, gan_cfg, device)
    if mesh is not None:
        mesh.broadcast_modules_(G, D)
    return gan_cfg, G, state


def _train_image_gan(state, gan_cfg, bank, measured, gen, cfg, log, mesh):
    """``cfg.gan_iters`` GAN steps, the metrics of step i logged at
    i % cadence == 0, i > 0 (0-based, the reference's labels). Returns the
    last step's metrics (empty without steps)."""
    m = {}
    for i in range(cfg.gan_iters):
        state, m = gan_step(state, bank, measured, gen, cfg=gan_cfg, mesh=mesh)
        if i % cfg.cadence == 0 and i > 0 and is_main(mesh):
            mh = fetch_metrics(m)
            log.log(i, mh)
            print(log.status_line(i, mh, log.steps_per_sec(i)))
    return m


def run_blob_toy(cfg: BlobToyConfig, *, device, mesh: DataMesh | None = None):
    """The blob-image workload on ``device`` (ref: tests/ganymede.py:494-740):
    the exact grid posterior of one noisy blob image, a deterministic
    image PE trained to the RMS gate, an MC-dropout PE trained on the noisy
    bank and ``n_mc_draws`` stochastic predictions of the measured image
    scored against the grid, then the image GAN (the residual route on the
    flattened bank). Returns {"pe_rms", "mc_overlap", "gan_d_loss"}, as the
    JAX workload does (``None`` on ranks other than 0 of a ``mesh``).

    ``mesh`` reaches the GAN step only, as in the reference: rank 0 trains
    both PEs, every rank trains the GAN on its block of the bank's rows.
    Metric rows carry the reference's 0-based labels (i % cadence == 0,
    i > 0). No plot is drawn, with or without ``plots``, as in the
    reference.
    """
    from gennet_tpu_torch.models.image_models import ImageMCDropoutPE, ImagePE
    from gennet_tpu_torch.models.layers import reset_module
    from gennet_tpu_torch.physics.blobs import blob_grid_posterior, make_blob_bank
    from gennet_tpu_torch.runtime.optim import adam

    if mesh is not None:
        check_rows(cfg.n_signals, mesh.world, "the blob bank (n_signals)")
    main = is_main(mesh)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    os.makedirs(cfg.out_dir, exist_ok=True)
    log = MetricLogger(cfg.out_dir if main else None, "blob")

    bank, pars = make_blob_bank(gen, cfg.n_signals, cfg.n_pix)
    signal = bank[0]
    measured = signal + cfg.n_sig * torch.randn(signal.shape, generator=gen, device=device)
    bank4 = bank[..., None]
    noisy_bank = bank4 + cfg.n_sig * torch.randn(bank4.shape, generator=gen, device=device)

    def train_pe(model, seed, iters, inputs, logged):
        """Adam(lr, β1 0.5) on the sum over parameters of the batch MSE;
        ``logged(i, loss)`` at i % cadence == 0, i > 0, True to stop."""
        reset_module(model.cpu(), torch.Generator().manual_seed(seed)).to(device)
        opt = adam(model.parameters(), cfg.lr, 0.5)
        for i in range(iters):
            idx = torch.randint(0, bank.shape[0], (cfg.batch_size,), generator=gen,
                                device=device)
            loss = torch.sum(torch.mean((model(inputs[idx], train=True, gen=gen)
                                         - pars[idx]) ** 2, dim=0))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if i % cfg.cadence == 0 and i > 0 and logged(i, float(loss.detach())):
                break
        return model

    rms, mc_overlap = [1.0, 1.0], None
    if main:
        L, gx, gy = (t.cpu().numpy() for t in blob_grid_posterior(measured, cfg.n_sig,
                                                                    grain=cfg.n_pix))
        # ---- deterministic PE to the RMS convergence gate (ref: :626) ----
        pe = ImagePE(n_pix=cfg.n_pix)
        tgt = pars[:2000].cpu().numpy()

        def pe_logged(i, loss):
            with torch.no_grad():
                est = pe(bank4[:2000]).cpu().numpy()
            rms[:] = [float(np.mean((tgt[:, k] - est[:, k]) ** 2)) for k in range(2)]
            log.log(i, {"pe_loss": loss, "rms0": rms[0], "rms1": rms[1]})
            print(f"{i}: [PE loss: {loss:f}, RMS: {rms[0]:f},{rms[1]:f}]")
            return max(rms) < cfg.rms_gate  # the reference's while-gate

        train_pe(pe, cfg.seed + 1, cfg.pe_iters, bank4, pe_logged)

        # ---- MC-dropout PE on the noisy bank, then its posterior draws ----
        def mc_logged(i, loss):
            log.log(i, {"mc_pe_loss": loss})
            return False

        mc = train_pe(ImageMCDropoutPE(n_pix=cfg.n_pix), cfg.seed + 2, cfg.mc_pe_iters,
                      noisy_bank, mc_logged)
        # n_mc_draws stochastic predictions of the one measured image
        # (ref: :617-620), batched: each row draws its own masks
        with torch.no_grad():
            draws = mc(measured[None, ..., None].expand(cfg.n_mc_draws, -1, -1, -1),
                       gen=gen).cpu().numpy()
        mc_overlap = float(gp.grid_overlap_score(draws, L, gx, gy))
        print(f"MC-dropout posterior grid overlap: {mc_overlap:.4f}")

    # ---- image GAN (the subtraction scheme on images) --------------------
    flat_bank = bank.reshape(bank.shape[0], -1)
    gen = _rank_stream(gen, cfg.seed, mesh)
    gan_cfg, _, gan_state = _image_gan(cfg.n_pix, cfg, cfg.seed + 3, device, mesh)
    m = _train_image_gan(gan_state, gan_cfg,
                         flat_bank if mesh is None else mesh.shard_rows(flat_bank),
                         measured.reshape(-1), gen, cfg, log, mesh)
    log.close()
    if not main:
        return None
    return {"pe_rms": rms, "mc_overlap": mc_overlap,
            "gan_d_loss": float(m["d_loss"]) if m else float("nan")}


@dataclass
class ImageGANConfig:
    """``image-gan`` workload config (ref: tests/ganymede.py:64,272-314, the
    face-image path; the repo's stand-in fixtures are tests/data/images/,
    regenerable by scripts/make_image_fixtures.py); the JAX package's
    fields and defaults. GAN only: the reference forbids PE for
    non-parametric image signals (ganymede.py:59-61)."""

    image_glob: str = "tests/data/images/*.jpg"
    n_pix: int = 32                # resized image side (divisible by 4)
    n_sig: float = 0.3
    batch_size: int = 32
    gan_iters: int = 2_000
    lr: float = 2e-4
    cadence: int = 100
    flip: bool = True              # append horizontally-flipped copies
    out_dir: str = "out/image_gan"
    seed: int = 0
    plots: bool = True


def run_image_gan(cfg: ImageGANConfig, *, device, mesh: DataMesh | None = None):
    """The image-directory GAN on ``device``: load the images, bury the
    first in N(0, n_sig) noise, and train the residual-route GAN to recover
    it. Returns {"n_images", "recovery_corr", "gan_d_loss", "gan_g_loss"},
    as the JAX workload does: recovery_corr is the correlation of the mean
    of 64 generator draws with the clean image (``None`` on ranks other
    than 0 of a ``mesh``).

    The images are read, and a missing reader or matplotlib for
    ``plots`` refused, before any device work. ``mesh`` reaches the GAN
    step only; the bank's rows must divide over the ranks. Metric rows
    carry the reference's 0-based labels (i % cadence == 0, i > 0).
    """
    from gennet_tpu_torch.data.images import load_image_dir

    imgs = load_image_dir(cfg.image_glob, cfg.n_pix, flip=cfg.flip)  # (N, n, n, 1)
    if cfg.plots:
        plots.require_matplotlib()
    if mesh is not None:
        check_rows(imgs.shape[0], mesh.world, f"the image bank ({cfg.image_glob})")
    main = is_main(mesh)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    os.makedirs(cfg.out_dir, exist_ok=True)
    log = MetricLogger(cfg.out_dir if main else None, "image_gan")

    bank = torch.as_tensor(imgs.reshape(imgs.shape[0], -1), device=device)
    signal = bank[0]
    measured = signal + cfg.n_sig * torch.randn(signal.shape, generator=gen, device=device)
    gen = _rank_stream(gen, cfg.seed, mesh)
    gan_cfg, G, gan_state = _image_gan(cfg.n_pix, cfg, cfg.seed + 1, device, mesh)
    m = _train_image_gan(gan_state, gan_cfg, bank if mesh is None else mesh.shard_rows(bank),
                         measured, gen, cfg, log, mesh)
    log.close()
    if not main:
        return None
    # recovery: the mean generated image against the clean one
    mean_gen = sample_generator(G, gan_state, gen, 64, gan_cfg).mean(dim=0).cpu().numpy()
    sig_np = signal.cpu().numpy()
    corr = float(np.corrcoef(mean_gen, sig_np)[0, 1])
    if cfg.plots:
        plots.plot_image_recovery(sig_np, measured.cpu().numpy(), mean_gen, cfg.n_pix,
                                  cfg.out_dir)
    return {"n_images": int(bank.shape[0]), "recovery_corr": corr,
            "gan_d_loss": float(m["d_loss"]) if m else float("nan"),
            "gan_g_loss": float(m["g_loss"]) if m else float("nan")}
