"""GenNet's own BBH GAN (``train-bbh``'s default recipe, ``BBHConfig()``):
``BBHGenerator`` with BatchNorm and ``PairDiscriminator`` over (waveform,
h(t) − waveform) pairs. Its inputs, bank, event and modules are the ``bbh``
family's, which build the generator's norm and the discriminator's
``in_ch`` from the configuration; so are the conv and dense layers. Only
the BatchNorm layers are this family's own."""

from benchmark.families.bbh import layers, make_inputs, models, program_data  # noqa: F401


def norms(cfg: dict) -> list:
    """G's BatchNorm layers in forward order, each with the shape of what
    it normalises, per row: (C,) for BN_0 on the Dense's 256·n/2 features,
    (C, L) after each conv."""
    n, g = cfg["n_pix"], cfg["generator"]
    out, L = [{"name": "norms.0", "shape": (256 * (n // 2),)}], n // 2
    for i, f in enumerate(g["features"]):
        L = L * 2 if i == 1 else L  # Conv_0: ×2 then stride 2; Conv_1: ×2
        out.append({"name": f"norms.{i + 1}", "shape": (f, L)})
    return out
