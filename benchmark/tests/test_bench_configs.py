"""Each configuration file holds today's recipe fields (``BASE`` +
``VARIANTS``), as the recipe's workload builds its GAN and PE configs and
its models, so a later change to a recipe shows here and cannot move the
yardstick unseen."""

import dataclasses

from benchmark.harness import cell
from gennet_tpu_torch.cli import workloads as W
from gennet_tpu_torch.models import BBHGenerator, BurstGenerator, PairDiscriminator
from gennet_tpu_torch.recipes import bbh_sweep, burst_sweep
from gennet_tpu_torch.train.cnn import CNNConfig
from gennet_tpu_torch.train.gan import GANConfig


def _fields(dc, skip=()):
    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc) if f.name not in skip}


def _defaults(cls, *names):
    return {n: p.default for n, p in
            __import__("inspect").signature(cls).parameters.items() if n in names}


def test_bbh_r4flag():
    c = dataclasses.replace(bbh_sweep.BASE, **bbh_sweep.VARIANTS["r4flag"])
    f = cell.load_json(cell.BENCH, "configs", "bbh_r4flag.json")
    # run_bbh's GAN config (cli/workloads.py), n_sig from the event
    gan = GANConfig(n_pix=c.n_pix, batch_size=c.batch_size, lr=c.gan_lr or c.lr,
                    chi_loss=c.chi_loss, n_sig=0.0, pair_discriminator=c.pair_d,
                    label_smoothing=c.label_smoothing,
                    d_instance_noise=c.instance_noise, d_lr_scale=c.d_lr_scale,
                    d_acc_gate=c.d_acc_gate, diversity_weight=c.diversity_weight,
                    r1_gamma=c.r1_gamma, residual_route=c.res_loss_weight > 0,
                    res_loss_weight=c.res_loss_weight, res_eval_mode=c.res_eval_mode,
                    res_spectral_bands=c.res_spectral_bands, g_ema_decay=c.g_ema_decay,
                    debug_probes=c.debug_probes)
    assert c.instance_noise >= 0 and c.n_sig_event == f["n_sig_event"] and c.n_sig == f["n_sig"]
    assert _fields(gan, ("n_pix", "n_sig")) == f["gan"]
    pe = CNNConfig(n_pix=c.n_pix, batch_size=c.pe_batch_size, lr=c.lr,
                   noise_frac=c.cnn_noise_frac, ema_decay=c.pe_ema_decay,
                   lr_decay_steps=c.pe_iters if c.pe_lr_decay else 0)
    assert _fields(pe, ("n_pix",)) == f["pe"]
    assert not c.comb_pe_model and not c.bf16 and f["dtype"] == "float32"
    assert (c.n_pix, c.training_num - 1, c.pe_iters, c.gan_iters, c.cadence) == (
        f["n_pix"], f["bank"]["n_templates"], f["pe_iters"], f["gan_iters"], f["cadence"])
    assert {k: getattr(c, k) for k in f["source_values"] if hasattr(c, k)} == {
        k: v for k, v in f["source_values"].items() if hasattr(c, k)}
    g = _defaults(BBHGenerator, "latent_dim", "features", "filt", "drate")
    assert {**g, "features": list(g["features"]), "norm": c.g_norm} == f["generator"]
    d = _defaults(PairDiscriminator, "features", "filt", "drate", "alpha")
    assert {**d, "features": list(d["features"]), "in_ch": 2 if c.pair_d else 1} == \
        f["discriminator"]
    bc = W._bbh_bank_cfg(c)
    assert {k: getattr(bc, k) for k in ("fs", "T_obs", "safe", "det", "f_low", "dist_mpc", "ra",
                                        "dec", "iota", "phi", "psi", "event_time",
                                        "calibration_offset", "tmpl_m1", "tmpl_m2")} == \
        {k: v for k, v in f["bank"].items() if hasattr(bc, k) and k != "beta"}
    assert list(bc.beta) == f["bank"]["beta"] and bc.mdist == "hunt_constrain"


def test_burst_mlrc_sel():
    c = dataclasses.replace(burst_sweep.BASE, **burst_sweep.VARIANTS["mlrc_sel"])
    f = cell.load_json(cell.BENCH, "configs", "burst_mlrc_sel.json")
    # run_burst_smoke's GAN and PE configs (cli/workloads.py)
    gan = GANConfig(n_pix=c.n_pix, batch_size=c.batch_size, lr=c.lr, n_sig=c.n_sig,
                    pair_discriminator=False, residual_route=True,
                    label_smoothing=c.label_smoothing,
                    d_instance_noise=c.n_sig if c.instance_noise < 0 else c.instance_noise,
                    d_lr_scale=c.d_lr_scale, d_acc_gate=c.d_acc_gate,
                    diversity_weight=c.diversity_weight, r1_gamma=c.r1_gamma,
                    res_loss_weight=c.res_loss_weight, g_ema_decay=c.g_ema_decay,
                    debug_probes=c.debug_probes)
    assert _fields(gan, ("n_pix", "n_sig")) == f["gan"] and c.n_sig == f["n_sig"]
    pe = CNNConfig(n_pix=c.n_pix, batch_size=c.batch_size, lr=c.lr, noise_frac=c.pe_noise_frac,
                   noise_scale_max=2.0 * c.n_sig, max_normalize=not c.pe_no_norm,
                   max_per_sample=c.per_sample_max)
    assert _fields(pe, ("n_pix",)) == f["pe"]
    assert (c.n_pix, c.n_signals, c.pe_iters, c.gan_iters) == (
        f["n_pix"], f["bank"]["n_templates"], f["pe_iters"], f["gan_iters"])
    assert {k: getattr(c, k) for k in f["source_values"]} == f["source_values"]
    assert list(W._BURST_TRUTH) == f["bank"]["truth"]
    from gennet_tpu_torch.physics.burst import sample_burst_params

    r = _defaults(sample_burst_params, "t0_range", "tau_range")
    assert [list(r["t0_range"]), list(r["tau_range"])] == [f["bank"]["t0_range"],
                                                           f["bank"]["tau_range"]]
    g = _defaults(BurstGenerator, "latent_dim", "features", "drate")
    assert {**g, "features": list(g["features"]), "filt": 5} == f["generator"]


def test_conv_impl_left_to_the_program():
    for name in ("bbh_r4flag", "burst_mlrc_sel"):
        assert "conv_impl" not in cell.load_json(cell.BENCH, "configs", name + ".json")
