"""The flagship workload, ``train-bbh`` (port of ``gennet_tpu.cli.workloads``'s
``run_bbh``; ref: BBH_version/bbhMahoGANy.py:959-1384).

Synthetic GW150914-like event → 50k-template whitened bank → exact (mc, q)
grid posterior and CNN sanity set → CNN point-estimator training → pair-GAN
training → posterior draws (G → CNN) scored by β overlap, grid overlap and
residual whiteness at each eval cadence and at the end.

``BBHConfig`` keeps every field and default of the JAX config, so the flags
are identical. Options this port does not implement yet raise
``NotImplementedError`` naming their ROADMAP item when set away from their
defaults; none is silently ignored.
"""

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.eval import grid_posterior as gp
from gennet_tpu_torch.eval import overlap as ov
from gennet_tpu_torch.eval.whiteness import posterior_whiteness
from gennet_tpu_torch.models import BBHGenerator, DualBranchPE, PairDiscriminator
from gennet_tpu_torch.physics import priors
from gennet_tpu_torch.physics import psd as psd_mod
from gennet_tpu_torch.train.checkpoints import CheckpointManager, save_posterior_snapshot
from gennet_tpu_torch.train.cnn import CNNConfig, cnn_step, init_cnn
from gennet_tpu_torch.train.cnn import predict as cnn_predict
from gennet_tpu_torch.train.gan import GANConfig, gan_step, init_gan, sample_generator
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


# field → ROADMAP item of the port that brings it
_UNPORTED = {
    "select_best": "queue 1 #8 (posterior_post)",
    "select_route": "queue 1 #8 (posterior_post)",
    "pe_debias": "queue 1 #8 (posterior_post)",
    "pe_bootcal": "queue 1 #8 (posterior_post)",
    "pe_mlrc": "queue 1 #8 (posterior_post, phasor VJP)",
    "reweight_temper": "queue 1 #8 (posterior_post)",
    "n_snapshots": "queue 1 #8 (snapshot pooling)",
    "lalinf_dir": "queue 1 #12 (data interop)",
    "bank_file": "queue 1 #12 (data interop)",
    "cnn_cache": "queue 1 #7 (restore)",
    "resume": "queue 1 #7 (restore)",
    "conv_impl": "queue 2 #2 (conv1d_same kernel)",
    "bf16": "queue 1 #4 (reduced precision)",
    "comb_pe_model": "queue 1 #4 (CombinedPE)",
    "g_norm": "queue 1 #4 (group/none norm)",
    "res_loss_weight": "queue 1 #6 (residual route)",
    "res_eval_mode": "queue 1 #6 (residual route)",
    "res_spectral_bands": "queue 1 #6 (residual route)",
    "pair_d": "queue 1 #6 (residual route)",
    "r1_gamma": "queue 1 #6 (R1)",
    "diversity_weight": "queue 1 #6 (diversity)",
    "anneal_frac": "queue 1 #6 (anneal)",
    "freeze_on_res": "queue 1 #6 (early stop)",
    "freeze_on_white": "queue 1 #6 (early stop)",
    "debug_probes": "queue 1 #6 (debug probes)",
}


def check_ported(cfg: BBHConfig):
    """Raise NotImplementedError for any option set away from its default
    that this port does not implement yet, and for ``plots=True`` (plots
    are not ported; pass ``--plots false``)."""
    defaults = BBHConfig()
    off = [f"{k} (ROADMAP {item})" for k, item in _UNPORTED.items()
           if getattr(cfg, k) != getattr(defaults, k)]
    if cfg.plots:
        off.append("plots (ROADMAP queue 1 #13; pass --plots false)")
    if off:
        raise NotImplementedError("not ported yet: " + "; ".join(off))


def effective_n_sig(cfg: BBHConfig, norm: float) -> float:
    """The noise std every residual/whiteness target uses: the event noise
    in normalised units sits at std = norm (truth-free, = 1/std(measured))."""
    return float(norm) if getattr(cfg, "n_sig_event", True) else cfg.n_sig


def gan_real_bank(cfg: BBHConfig, bank, signal):
    """The GAN's real set: the bank plus ``twin_boost`` copies of the event
    twin (the CNN's bank is untouched)."""
    boost = int(getattr(cfg, "twin_boost", 0) or 0)
    if boost <= 0 or bank is None:
        return bank
    return torch.cat([bank, signal[None, :].expand(boost, -1)])


def _bbh_bank_cfg(cfg: BBHConfig):
    """Bank geometry from n_pix: templates are the central 1 s at fs, so
    fs = n_pix (n_pix = 1024 is the reference geometry, ref: :123)."""
    return tb.BankConfig(fs=int(cfg.n_pix))


def _prepare_bbh_data(cfg: BBHConfig, gen: torch.Generator, device):
    """Event and bank, all on ``device``. Returns (bank, targets, signal,
    measured, norm, psd)."""
    bank_cfg = _bbh_bank_cfg(cfg)
    psd = psd_mod.analytic_advligo_psd(bank_cfg.fs, bank_cfg.T_obs * bank_cfg.safe, device=device)
    signal, measured, norm = tb.make_event(gen, psd, bank_cfg)
    norm = float(norm)
    templates, params = tb.make_bank(gen, cfg.training_num, psd, bank_cfg, norm)
    # drop the event-twin last template from training (ref: bbhMahoGANy.py:1033-1036)
    bank = templates[:-1]
    targets = torch.stack([params["mc"][:-1], params["q"][:-1]], dim=-1).to(torch.float32)
    return bank, targets, signal, measured, norm, psd


def run_bbh(cfg: BBHConfig, *, device):
    """Flagship pipeline on ``device``: CNN PE training, then GAN training
    with posterior validation against the exact grid posterior. Returns the
    same summary dict as the JAX workload."""
    check_ported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    log = MetricLogger(cfg.out_dir, "bbh")

    bank, targets, signal, measured, norm, psd = _prepare_bbh_data(cfg, gen, device)
    bank_cfg = _bbh_bank_cfg(cfg)
    n_sig_eff = effective_n_sig(cfg, norm)
    print(f"effective noise std (residual/whiteness targets): {n_sig_eff:.4f}"
          f" ({'event norm' if cfg.n_sig_event else 'config n_sig'})")

    # ---- reference posterior: the exact (mc, q) grid of the synthetic event
    grid = None
    ref_samples = None
    if cfg.grid_grain > 0:
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
    init_gen = torch.Generator().manual_seed(cfg.seed + 1)
    pe_state = init_cnn(init_gen, DualBranchPE(n_pix=cfg.n_pix), pe_cfg, device)

    # CNN sanity set: ideal waveforms from the reference posterior's own
    # mass rows; the CNN's cloud on them bounds its best posterior
    # (ref: lalinf_post_waveform_maker.py + bbhMahoGANy.py:1226-1231)
    sanity_waveforms = None
    if ref_samples is not None:
        rs = torch.as_tensor(ref_samples, dtype=torch.float32, device=device)
        m1s, m2s = priors.mc_q_to_m1m2(rs[:, 0], rs[:, 1])
        sanity_waveforms = tb.make_templates_from_params(m1s, m2s, psd, bank_cfg, norm)
    pe_ckpt = CheckpointManager(os.path.join(cfg.out_dir, "ckpt_pe"))

    # i counts completed updates
    for i in range(1, cfg.pe_iters + 1):
        pe_state, m = cnn_step(pe_state, bank, targets, gen, cfg=pe_cfg)
        if i % cfg.pe_cadence == 0:
            m = fetch_metrics(m)
            log.log(i, m)
            print(log.status_line(i, m, log.steps_per_sec(i)))
            if sanity_waveforms is not None:
                sane = cnn_predict(pe_state, sanity_waveforms, use_ema=pe_use_ema).cpu().numpy()
                if sane[:, 0].var() > 0 and sane[:, 1].var() > 0:
                    b = ov.beta_overlap(sane, ref_samples)
                    log.log(i, {"cnn_sanity_beta": b})
                    print(f"CNN sanity-check beta: {b:.4f}")
        if i % cfg.ckpt_every == 0:
            pe_ckpt.save(i, pe_state)
    if cfg.pe_iters > 0:
        pe_ckpt.save(cfg.pe_iters, pe_state)
    # final CNN accuracy: MSE and mean |err| per parameter on a held-out
    # draw (ref: bbhMahoGANy.py:1188-1198)
    idx = np.random.default_rng(0).choice(bank.shape[0], min(4000, bank.shape[0]), replace=False)
    idx_t = torch.as_tensor(idx, device=device)
    est = cnn_predict(pe_state, bank[idx_t], use_ema=pe_use_ema).cpu().numpy()
    tgt = targets[idx_t].cpu().numpy()
    pe_rms = [float(np.mean((tgt[:, k] - est[:, k]) ** 2)) for k in range(2)]
    pe_std = [float(np.mean(np.abs(tgt[:, k] - est[:, k]))) for k in range(2)]
    print(f"Completed CNN PE  RMS: {pe_rms[0]:f},{pe_rms[1]:f}  pe_std: {pe_std[0]:f},{pe_std[1]:f}")

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
                        label_smoothing=cfg.label_smoothing, d_instance_noise=inoise,
                        d_lr_scale=cfg.d_lr_scale, d_acc_gate=cfg.d_acc_gate,
                        g_ema_decay=cfg.g_ema_decay)
    G = BBHGenerator(n_out=cfg.n_pix, norm=cfg.g_norm)
    D = PairDiscriminator(n_pix=cfg.n_pix)
    gan_state = init_gan(torch.Generator().manual_seed(cfg.seed + 2), G, D, gan_cfg, device)
    gan_ckpt = CheckpointManager(os.path.join(cfg.out_dir, "ckpt_gan"))
    if cfg.posterior_drate >= 0.0:
        G_samp = BBHGenerator(n_out=cfg.n_pix, drate=cfg.posterior_drate).to(device)
        samp_dropout = True
    else:
        G_samp, samp_dropout = G, cfg.posterior_dropout

    def draw_posterior(state):
        wf = sample_generator(G_samp, state, gen, cfg.n_posterior, gan_cfg,
                              dropout=samp_dropout, temp=cfg.posterior_temp,
                              bn_mode=cfg.posterior_bn_mode)
        wf_in = wf
        if cfg.posterior_noise > 0:
            # parametric bootstrap through the noise-augmented CNN
            wf_in = wf + cfg.posterior_noise * n_sig_eff * torch.randn(
                wf.shape, generator=gen, device=gen.device)
        samples = cnn_predict(pe_state, wf_in, use_ema=pe_use_ema).cpu().numpy()
        return wf, samples

    def eval_posterior(state, step, tag=None):
        """Posterior draw → CNN → β / grid overlap / whiteness."""
        wf, samples = draw_posterior(state)
        save_posterior_snapshot(os.path.join(cfg.out_dir, "GAN_posterior_samples"),
                                step + 1 if tag == "final" else step, samples)
        # whiteness of the posterior-MEAN waveform's residual
        ws = posterior_whiteness(measured.cpu().numpy(), wf[:256].cpu().numpy(), n_sig_eff)
        w_score = (ws["mean_pass"] + ws["var_pass"] + ws["ljung_box_pass"]) / 3.0
        out = {"whiteness": w_score, "ws": ws, "wf": wf, "samples": samples,
               "beta": None, "grid_overlap": None}
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
        row = {k: out[k] for k in ("whiteness", "beta", "beta_sanity", "grid_overlap")
               if out.get(k) is not None}
        log.log(step, row if tag is None else {f"{k}_{tag}": v for k, v in row.items()})
        return out

    gan_bank = gan_real_bank(cfg, bank, signal)
    beta_hist = []
    best_white, best_state_dict = -1.0, None
    log.steps_per_sec(0)  # reset the steps/sec window for the GAN phase
    for i in range(1, cfg.gan_iters + 1):  # i counts completed iterations
        gan_state, m = gan_step(gan_state, gan_bank, measured, gen, cfg=gan_cfg)
        if i % cfg.cadence == 0:
            mh = fetch_metrics(m)
            log.log(i, mh)
            print(log.status_line(i, mh, log.steps_per_sec(i)))
        if i % cfg.eval_cadence == 0:
            ev = eval_posterior(gan_state, i)
            if ev["whiteness"] > best_white:
                best_white = ev["whiteness"]
                best_state_dict = {"step": i, "generator": {k: v.clone() for k, v in
                                                            gan_state.generator.state_dict().items()}}
            if ev["beta"] is not None:
                beta_hist.append(ev["beta"])
                print(f"beta result: {ev['beta']}" +
                      ("" if ev["grid_overlap"] is None
                       else f"  grid overlap: {ev['grid_overlap']:.4f}"))
        if i % cfg.ckpt_every == 0:
            gan_ckpt.save(i, gan_state)
    gan_ckpt.save(max(cfg.gan_iters, 1), gan_state)

    # ---- final-state artefacts (the reference uses the last iteration's
    # state, ref: :1241); the best-whiteness generator is kept as a diagnostic
    whiteness = beta_final = grid_overlap_final = beta_sanity_final = None
    if cfg.gan_iters > 0:
        ev = eval_posterior(gan_state, cfg.gan_iters, tag="final")
        whiteness, beta_final = ev["ws"], ev["beta"]
        grid_overlap_final = ev["grid_overlap"]
        beta_sanity_final = ev.get("beta_sanity")
        print(f"final-state residual whiteness: {whiteness}")
        if beta_final is not None:
            print(f"final-state beta: {beta_final:.4f}" +
                  ("" if beta_sanity_final is None
                   else f"  beta vs sanity cloud: {beta_sanity_final:.4f}") +
                  ("" if grid_overlap_final is None
                   else f"  grid overlap: {grid_overlap_final:.4f}"))
        if best_state_dict is not None:
            gan_ckpt.save(cfg.gan_iters + 1, best_state_dict)  # diagnostic state

    log.close()
    return {
        "beta": beta_final,
        "beta_raw": None,
        "grid_overlap_raw": None,
        "beta_sanity": beta_sanity_final,
        "beta_hist_last": beta_hist[-1] if beta_hist else None,
        "grid_overlap": grid_overlap_final,
        "cnn_sanity_beta": cnn_sanity_beta,
        "final_step": int(gan_state.step),
        "frozen_at": None,
        "selected_at": None,
        "selected_route": None,
        "pool_ess": None,
        "plateau_k": None,
        "whiteness": whiteness,
        "pe_rms": pe_rms,
        "pe_std": pe_std,
    }
