"""Measure the event-twin cue of a ch1-only discriminator (port of
``scripts/twin_cue_probe.py``).

The event's twin is the one waveform never in the real set, so as G's
draws close in on it, D can learn "event-like ⇒ fake" and push G away
from the truth. The probe scores D (the raw-series D of ``pair_d=False``)
on 256 random bank rows, on the event's signal and on 256 G draws:

    twin_penalty = mean D-logit(bank rows) − mean D-logit(signal)

Positive is the anti-truth cue; near 0 or below, D does not penalize the
truth region. One row per run goes to ``out/torch/bbh_sweeps/twin_cue.jsonl``.

As in the script: the GAN state is the last training state, the newest
checkpoint at a step ≤ ``gan_iters`` (not the best-whiteness state a run
with evaluations parks at ``gan_iters + 1``), restored into G with the
run's norm and D at one channel; the bank is the PE's (the twin dropped,
no ``twin_boost`` copies); G's draws use its raw weights with dropout off
and BatchNorm's running statistics. The row indices and the latents come
from one ``torch.Generator`` seeded 123 (the script's ``PRNGKey(123)``;
the streams differ): a test passes JAX's in.

Usage: python -m gennet_tpu_torch.studies.twin_cue_probe RUN_DIR [--device cuda]
"""

import sys

import numpy as np
import torch

from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
from gennet_tpu_torch.recipes import append_row
from gennet_tpu_torch.studies import _run
from gennet_tpu_torch.train.gan import GANConfig, sample_generator

OUT = f"{_run.BBH_OUT}/twin_cue.jsonl"
N_ROWS = 256


def d_logits(state, x2d: torch.Tensor) -> np.ndarray:
    """D's logits of raw series (B, n_pix), with dropout off."""
    with torch.no_grad():
        return state.discriminator(x2d[..., None], train=False).reshape(-1).cpu().numpy()


def twin_cue(G, state, gan_cfg, bank: torch.Tensor, signal: torch.Tensor, gen,
             idx=None, z=None) -> dict:
    """The mean logits of ``N_ROWS`` bank rows, the signal and G's draws,
    and the twin penalty (:64-86). ``idx``: optional bank row indices;
    ``z``: optional latents of G's draws (see :func:`sample_generator`)."""
    if idx is None:
        idx = torch.randint(0, bank.shape[0], (N_ROWS,), generator=gen, device=gen.device)
    idx = torch.as_tensor(idx, device=bank.device)
    gz = sample_generator(G, state, gen, N_ROWS, gan_cfg, z=z)
    l_bank = d_logits(state, bank[idx])
    l_sig = d_logits(state, signal.reshape(1, -1).expand(N_ROWS, -1))
    l_gz = d_logits(state, gz)
    return {"logit_bank": float(l_bank.mean()), "logit_signal": float(l_sig.mean()),
            "logit_g": float(l_gz.mean()), "twin_penalty": float(l_bank.mean() - l_sig.mean())}


def verdict(penalty: float) -> str:
    return (f"twin_penalty = {penalty:+.3f} "
            f"({'anti-truth cue present' if penalty > 0.5 else 'cue absent'})")


def study(run_dir: str, device) -> dict:
    cfg = _run.load_bbh_config(run_dir)
    if cfg.pair_d:
        raise ValueError("twin_cue_probe measures the ch1-only scheme (pair_d=False)")
    (bank, _, signal, _, _, _, _, _), _ = _run.bbh_event(cfg, device, skip_bank=False)
    gan_cfg = GANConfig(latent_dim=100, batch_size=cfg.batch_size, n_sig=cfg.n_sig, lr=cfg.lr,
                        label_smoothing=cfg.label_smoothing, d_instance_noise=cfg.instance_noise,
                        d_lr_scale=cfg.d_lr_scale, d_acc_gate=cfg.d_acc_gate,
                        pair_discriminator=False, residual_route=cfg.res_loss_weight > 0,
                        res_loss_weight=cfg.res_loss_weight, res_eval_mode=cfg.res_eval_mode)
    G = BBHGenerator(n_out=cfg.n_pix, conv_impl=cfg.conv_impl, norm=cfg.g_norm)
    D = PairDiscriminator(n_pix=cfg.n_pix, in_ch=1, conv_impl=cfg.conv_impl)
    # the last training state, not the best-whiteness state parked above it
    state, _ = _run.restore_gan(run_dir, G, D, gan_cfg, cfg.seed, device, at_most=cfg.gan_iters)
    print(f"restored GAN state at step {int(state.step)}")
    out = {"run": run_dir, "step": int(state.step),
           "twin_boost": int(getattr(cfg, "twin_boost", 0) or 0),
           **twin_cue(G, state, gan_cfg, bank, signal, torch.Generator(device=device).manual_seed(
               123))}
    print(f"bank {out['logit_bank']:+.3f}  signal(twin) {out['logit_signal']:+.3f}  "
          f"G draws {out['logit_g']:+.3f}")
    print(verdict(out["twin_penalty"]))
    append_row(OUT, out)
    return out


def main(argv=None) -> dict:
    args = _run.parse(argv, __doc__, ("run_dir", {"metavar": "RUN_DIR"}))
    return study(args.run_dir, torch.device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])
