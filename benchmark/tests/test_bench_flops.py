"""The FLOP counts of one iteration (each phase's ``calls`` over
``benchmark/harness/flops.py``, from the shapes) equal
``torch.utils.flop_counter.FlopCounterMode`` on one iteration of the
program at the configuration's widths, batch 2, on the CPU."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import cell, flops
from benchmark.reference.nets import make_weights
from benchmark.tests.small import CELLS, few_threads


@pytest.mark.parametrize("workload", CELLS)
def test_step_flops_match_the_counter(workload):
    from gennet_tpu_torch.runtime.optim import adam
    from gennet_tpu_torch.train import cnn, gan

    few_threads()
    spec = cell.cell_spec(cell.load_json(cell.ROOT, "BENCHMARK.json"), workload)
    cfg = cell.load_json(cell.BENCH, "configs", spec["config"] + ".json")
    phase = cell.load_json(cell.BENCH, "traffic", spec["traffic"] + ".json")["phase"]
    family = cell.load_module(f"{cell.BENCH}/families/{cfg['family']}.py", "fam_" + cfg["family"])
    net = importlib.import_module(f"benchmark.reference.{cfg['family']}")
    ph = importlib.import_module(f"benchmark.phases.{phase}")
    B, n = 2, cfg["n_pix"]
    gen = torch.Generator().manual_seed(0)
    mods = family.models(cfg, ph.NETS)
    for name, m in mods.items():
        m.load_state_dict(make_weights(net.param_specs(cfg, name), gen, "cpu"))
    bank = torch.randn(16, n, generator=gen)
    if phase == "gan":
        c = gan.GANConfig(n_pix=n, n_sig=1.0, **{**cfg["gan"], "batch_size": B})
        G, D = mods["generator"], mods["discriminator"]
        state = gan.GANState(G, D, adam(G.parameters(), c.lr, c.beta1),
                             adam(D.parameters(), c.lr, c.beta1),
                             adam(G.parameters(), c.lr, c.beta1))
        batch = gan.draw_gan_batch(gen, bank, c)
        counter = FlopCounterMode(display=False)
        with counter:
            gan.gan_update(state, batch, torch.randn(n, generator=gen), cfg=c)
    else:
        c = cnn.CNNConfig(n_pix=n, **{**cfg["pe"], "batch_size": B})
        state = cnn.CNNState(mods["pe"], adam(mods["pe"].parameters(), c.lr, c.beta1), None)
        x, y = cnn.draw_cnn_batch(gen, bank, torch.rand(16, 2, generator=gen), c)
        counter = FlopCounterMode(display=False)
        with counter:
            cnn.cnn_update(state, x, y, cfg=c)
    sized = {**cfg, "gan": {**cfg["gan"], "batch_size": B}, "pe": {**cfg["pe"], "batch_size": B}}
    calls = ph.calls(sized, {k: family.layers(cfg, k) for k in ph.NETS})
    assert flops.step_flops(calls) == counter.get_total_flops()
