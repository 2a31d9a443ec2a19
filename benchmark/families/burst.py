"""The burst family: ``BurstGenerator``, ``BurstDiscriminator`` and
``BurstPE`` on a bank of sine-Gaussians and an event made the way
``run_burst_smoke`` makes them (``gennet_tpu_torch/cli/workloads.py``:
``burst_event`` and the configs of the PE and GAN phases), from (t0, τ)
rows and event noise that the benchmark draws from the seed."""

from types import SimpleNamespace

import torch

from benchmark.families.bbh import _conv, _dense, check_float32
from benchmark.reference.nets import out_len


def make_inputs(cfg: dict, gen: torch.Generator) -> dict:
    """(t0, τ) uniform over the recipe's prior box, and the event's unit
    noise."""
    b, dev = cfg["bank"], gen.device
    u = torch.rand((2, b["n_templates"]), generator=gen, device=dev)
    t0 = b["t0_range"][0] + (b["t0_range"][1] - b["t0_range"][0]) * u[0]
    tau = b["tau_range"][0] + (b["tau_range"][1] - b["tau_range"][0]) * u[1]
    return {"pars": torch.stack([t0, tau], dim=-1),
            "noise": torch.randn((cfg["n_pix"],), generator=gen, device=dev)}


def program_data(cfg: dict, inputs: dict):
    """The program's bank (``sine_gaussian`` of every row) and event
    (``sine_gaussian`` of the truth plus n_sig times the noise)."""
    from gennet_tpu_torch.physics.burst import sine_gaussian

    pars, n = inputs["pars"], cfg["n_pix"]
    signal = sine_gaussian(*cfg["bank"]["truth"], N=n, device=pars.device)
    return SimpleNamespace(bank=sine_gaussian(pars[:, 0], pars[:, 1], N=n), targets=pars,
                           measured=signal + cfg["n_sig"] * inputs["noise"], n_sig=cfg["n_sig"])


def models(cfg: dict, names) -> dict:
    """The program's modules of the networks ``names``, built on the
    current default device."""
    from gennet_tpu_torch.models import BurstDiscriminator, BurstGenerator, BurstPE

    check_float32(cfg)
    n, g = cfg["n_pix"], cfg["generator"]
    make = {"pe": lambda: BurstPE(n_pix=n),
            "generator": lambda: BurstGenerator(n_out=n, latent_dim=g["latent_dim"],
                                                drate=g["drate"], features=tuple(g["features"])),
            "discriminator": lambda: BurstDiscriminator(n_pix=n)}
    return {name: make[name]() for name in names}


def layers(cfg: dict, which: str) -> list:
    n = cfg["n_pix"]
    if which == "generator":
        g = cfg["generator"]
        out, cin = [_dense("dense", g["latent_dim"], 256 * (n // 2), first=True)], 256
        for i, f in enumerate(g["features"]):
            out.append(_conv(f"convs.{i}", cin, f, n))
            cin = f
        return out + [_conv("out_conv", cin, 1, n)]
    if which == "discriminator":
        L = (n // 2 - 4) // 2
        return [_conv("conv0", 1, 64, n, first=True), _conv("conv1", 64, 128, n // 2, 1, "VALID"),
                _dense("dense0", 128 * L, 1024), _dense("dense1", 1024, 1)]
    L1 = out_len(n, 5, 2, "SAME")
    L2 = out_len(L1, 5, 2, "VALID")
    return [_conv("conv0", 1, 64, n, 2, first=True), _conv("conv1", 64, 128, L1, 2, "VALID"),
            _dense("dense0", 128 * L2, 1024), _dense("dense1", 1024, 2)]
