"""The flagship family: ``BBHGenerator`` and the raw-series
``PairDiscriminator`` (in_ch 1), ``DualBranchPE``, on a bank of whitened
IMRPhenomD templates and an event made the way ``run_bbh`` makes them
(``gennet_tpu_torch/cli/workloads.py``: ``_prepare_bbh_data`` and the
configs of the PE and GAN phases), from masses, peak indices and event
noise that the benchmark draws from the seed."""

from types import SimpleNamespace

import torch

from benchmark.reference import bbh_bank
from benchmark.reference.bbh import PE_MC, PE_Q
from benchmark.reference.nets import out_len

SYNTH_ROWS = 8192  # templates per synthesis call


def make_inputs(cfg: dict, gen: torch.Generator) -> dict:
    """The benchmark's inputs: (mc, q) uniform over the recipe's prior box,
    their (m1, m2), a peak index per row and the event's unit noise."""
    b, dev = cfg["bank"], gen.device
    n = b["n_templates"]
    u = torch.rand((2, n), generator=gen, device=dev)
    mc = b["mc_range"][0] + (b["mc_range"][1] - b["mc_range"][0]) * u[0]
    q = b["q_range"][0] + (b["q_range"][1] - b["q_range"][0]) * u[1]
    m1, m2 = bbh_bank.mc_q_to_m1m2(mc, q)
    lo, hi = bbh_bank.beta_index_bounds(b)
    idx = torch.randint(lo, hi, (n,), generator=gen, device=dev)
    noise = torch.randn((b["fs"],), generator=gen, device=dev)
    return {"m1": m1, "m2": m2, "idx": idx, "targets": torch.stack([mc, q], dim=-1),
            "noise": noise}


def bank_config(cfg: dict):
    from gennet_tpu_torch.data.template_bank import BankConfig

    b = cfg["bank"]
    return BankConfig(fs=b["fs"], T_obs=b["T_obs"], safe=b["safe"], det=b["det"],
                      beta=tuple(b["beta"]), f_low=b["f_low"], dist_mpc=b["dist_mpc"],
                      ra=b["ra"], dec=b["dec"], iota=b["iota"], phi=b["phi"], psi=b["psi"],
                      event_time=b["event_time"], calibration_offset=b["calibration_offset"],
                      tmpl_m1=b["tmpl_m1"], tmpl_m2=b["tmpl_m2"])


def program_data(cfg: dict, inputs: dict):
    """The program's bank, event and noise scale from the inputs: its PSD,
    its event template plus the noise, normalised to unit std, and its
    templates of every row (``make_templates_from_params``), as
    ``run_bbh`` makes them."""
    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.physics import psd as psd_mod

    bc = bank_config(cfg)
    dev = inputs["noise"].device
    psd = psd_mod.analytic_advligo_psd(bc.fs, bc.T_obs * bc.safe, device=dev)
    raw = tb.make_event_template(psd, bc) + inputs["noise"]
    norm = float(1.0 / torch.std(raw, correction=0))
    m1, m2, idx = inputs["m1"], inputs["m2"], inputs["idx"]
    bank = torch.cat([tb.make_templates_from_params(m1[i:i + SYNTH_ROWS], m2[i:i + SYNTH_ROWS],
                                                    psd, bc, norm, idx=idx[i:i + SYNTH_ROWS])
                      for i in range(0, m1.shape[0], SYNTH_ROWS)])
    # n_sig_event: the residual target is the event's noise std, norm
    n_sig = norm if cfg["n_sig_event"] else cfg["n_sig"]
    return SimpleNamespace(bank=bank, targets=inputs["targets"], measured=raw * norm,
                           n_sig=n_sig)


def check_float32(cfg: dict):
    if cfg["dtype"] != "float32":
        raise ValueError(f"the benchmark's models compute in float32, not {cfg['dtype']}")


def models(cfg: dict, names) -> dict:
    """The program's modules of the networks ``names``, built on the
    current default device; implementation choices (the conv
    implementation) are the program's defaults (``BBHConfig``)."""
    from gennet_tpu_torch.cli.workloads import BBHConfig
    from gennet_tpu_torch.models import BBHGenerator, DualBranchPE, PairDiscriminator

    check_float32(cfg)
    impl, n = BBHConfig.conv_impl, cfg["n_pix"]
    g, d = cfg["generator"], cfg["discriminator"]
    make = {
        "pe": lambda: DualBranchPE(n_pix=n),
        "generator": lambda: BBHGenerator(n_out=n, latent_dim=g["latent_dim"], filt=g["filt"],
                                          drate=g["drate"], features=tuple(g["features"]),
                                          norm=g["norm"], conv_impl=impl),
        "discriminator": lambda: PairDiscriminator(features=tuple(d["features"]), filt=d["filt"],
                                                   drate=d["drate"], alpha=d["alpha"], n_pix=n,
                                                   in_ch=d["in_ch"], conv_impl=impl)}
    return {name: make[name]() for name in names}


def _conv(path, cin, cout, L, stride=1, padding="SAME", first=False, K=5):
    return {"kind": "conv", "name": path, "cin": cin, "cout": cout, "L": L, "K": K,
            "stride": stride, "padding": padding, "first": first}


def _dense(path, fin, fout, first=False):
    return {"kind": "dense", "name": path, "fin": fin, "fout": fout, "first": first}


def layers(cfg: dict, which: str) -> list:
    """The network's layers in forward order (``benchmark.harness.flops``)."""
    n = cfg["n_pix"]
    if which == "generator":
        g = cfg["generator"]
        out, cin = [_dense("dense", g["latent_dim"], 256 * (n // 2), first=True)], 256
        L = n // 2
        for i, f in enumerate(g["features"]):
            L = L * 2 if i <= 1 else L
            out.append(_conv(f"convs.{i}", cin, f, L, 2 if i == 0 else 1, K=g["filt"]))
            L, cin = -(-L // (2 if i == 0 else 1)), f
        return out + [_conv("out_conv", cin, 1, L, K=g["filt"])]
    if which == "discriminator":
        d = cfg["discriminator"]
        out, cin, L = [], d["in_ch"], n
        for i, f in enumerate(d["features"]):
            out.append(_conv(f"convs.{i}", cin, f, L, 2, first=i == 0, K=d["filt"]))
            cin, L = f, -(-L // 2)
        return out + [_dense("dense", cin * L, 1)]
    out = []
    for br, spec in (("mc", PE_MC), ("q", PE_Q)):
        cin, L = 1, n
        for i, (f, s, pad) in enumerate(spec):
            out.append(_conv(f"{br}_convs.{i}", cin, f, L, s, pad, first=i == 0))
            cin, L = f, out_len(L, 5, s, pad)
        out.append(_dense(f"{br}_dense", cin * L, 1))
    return out
