"""GenNet's own BBH GAN under ``--bf16`` (``BBHConfig(bf16=True)``, as
``train-bbh --bf16 true`` runs it): the ``bbh_pair`` family's inputs, bank,
event, layers and BatchNorm layers, with ``BBHGenerator`` and
``PairDiscriminator`` built at ``dtype=torch.bfloat16`` as ``run_bbh``
builds them (``gennet_tpu_torch/cli/workloads.py``). Their parameters,
BatchNorm statistics and Adam state stay float32; G's Dense, Conv_0-4 and
norms and D's convs compute in bfloat16, G's output conv and D's Dense in
float32 (:func:`compute_dtypes`)."""

import torch

from benchmark.families.bbh import layers, make_inputs, program_data  # noqa: F401
from benchmark.families.bbh_pair import norms  # noqa: F401

def compute_dtype(cfg: dict) -> torch.dtype:
    """The configuration's compute dtype, bfloat16."""
    if cfg["dtype"] != "bfloat16":
        raise ValueError(f"the bbh_bf16 family computes in bfloat16, not {cfg['dtype']}")
    return torch.bfloat16


def compute_dtypes(cfg: dict) -> dict:
    """The dtype each layer computes in, by module path: G's Dense,
    Conv_0-4 and norms and D's convs in the configuration's dtype, G's
    output conv and D's Dense in float32 (the JAX modules'
    ``dtype=jnp.float32`` there)."""
    dt = compute_dtype(cfg)
    g, d = cfg["generator"]["features"], cfg["discriminator"]["features"]
    return {"generator.dense": dt,
            **{f"generator.norms.{i}": dt for i in range(len(g) + 1)},
            **{f"generator.convs.{i}": dt for i in range(len(g))},
            "generator.out_conv": torch.float32,
            **{f"discriminator.convs.{i}": dt for i in range(len(d))},
            "discriminator.dense": torch.float32}


def models(cfg: dict, names) -> dict:
    """The program's modules of the networks ``names``, built on the
    current default device in the configuration's compute dtype; the conv
    implementation is the program's default (``BBHConfig``)."""
    from gennet_tpu_torch.cli.workloads import BBHConfig
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator

    dt, impl, n = compute_dtype(cfg), BBHConfig.conv_impl, cfg["n_pix"]
    g, d = cfg["generator"], cfg["discriminator"]
    make = {
        "generator": lambda: BBHGenerator(n_out=n, latent_dim=g["latent_dim"], filt=g["filt"],
                                          drate=g["drate"], features=tuple(g["features"]),
                                          norm=g["norm"], conv_impl=impl, dtype=dt),
        "discriminator": lambda: PairDiscriminator(features=tuple(d["features"]), filt=d["filt"],
                                                   drate=d["drate"], alpha=d["alpha"], n_pix=n,
                                                   in_ch=d["in_ch"], conv_impl=impl, dtype=dt)}
    return {name: make[name]() for name in names}
