"""GenNet's own BBH GAN in the benchmark (``benchmark/configs/bbh_default.json``:
the ``bbh_pair`` family, the ``gan_bn`` phase), on the CPU at a narrow size:

- the program's checked iterations, run by ``make_gan_step_scan`` as the
  cell runs them, follow ``benchmark/reference/bbh_pair.py``: losses, first
  gradients, parameters and every BatchNorm running average;
- a run with a planted fault in the program comes out not correct: the
  commit of the running averages dropped, a commit in the D step's fake
  pass, the fake pair's channels swapped;
- the configuration file holds ``BBHConfig()`` as ``run_bbh`` maps it;
- the BatchNorm calls that the per-layer metrics time have the shapes the
  generator's own BatchNorm layers see, and the readers read them.
"""

import copy
import dataclasses
import inspect
from types import SimpleNamespace

import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from benchmark.harness import cell, loops
from benchmark.phases import gan_bn

WORKLOAD = "bbh_default-gan"


def _overrides() -> dict:
    """n_pix 64, narrow G and D, a bank of 256 rows; the recipe's batch of
    8 and every branch of the full cell kept. A chunk of 4, other than the
    checked calls' (1, 3), so the window's step is a step of its own."""
    cfg = copy.deepcopy(cell.load_json(cell.BENCH, "configs", "bbh_default.json"))
    return {"config": {"n_pix": 64, "bank": {**cfg["bank"], "fs": 64, "n_templates": 256},
                       "generator": {**cfg["generator"], "features": [16, 16, 32, 32, 32]},
                       "discriminator": {**cfg["discriminator"], "features": [32, 32]}},
            "traffic": {"chunk": 4}}


def test_program_follows_the_reference():
    ctx = cell.build(WORKLOAD, 11, "cpu", _overrides())
    checked = ctx.loop.checked_steps()
    ref = loops.reference(ctx)
    r = gan_bn.readings(checked, ref, loops.initial(ctx))
    # float32 rounding of the same arithmetic in another order (torch's
    # var_mean against the reference's two passes): measured up to 2.3e-7
    # (losses), 4.4e-7 (gradients), 8.2e-7 (parameters) over seeds 11-13
    assert r["loss"] < 1e-5 and r["grad"] < 1e-5 and r["change_median"] < 1e-5, r
    # the running means follow the conv biases before each BatchNorm, whose
    # gradient is zero but for rounding, so that Adam steps them by ±lr on
    # its sign: the means drift apart by up to (1 − m)·2·lr·(0 + 1 + 2 + 3)
    # = 1.08e-5 over four commits, ~1e-5 of the running averages' median
    # norm (measured: change 6.2e-5 at most, all of it theirs)
    assert r["change"] < 2e-4, r
    stats = [k for k in ref["params"] if k.endswith(gan_bn.STATS)]
    assert len(stats) == 2 * 6 and r["change_stats"] == r["change"], r
    for k in stats:
        # each running average moved by its four commits, and agrees with the
        # reference's element by element: the variances to rounding of O(1)
        # values, the means to the drift above
        moved = ref["params"][k] - ctx.weights["generator"][k.split(".", 1)[1]]
        assert float(moved.abs().max()) > 1e-4, k
        atol = 1.1e-5 if k.endswith("running_mean") else 1e-6
        torch.testing.assert_close(checked["params"][k], ref["params"][k], rtol=0, atol=atol)


def _dropped_commit(monkeypatch):
    from gennet_tpu_torch.models.layers import BatchNorm

    real = BatchNorm.forward
    monkeypatch.setattr(BatchNorm, "forward",
                        lambda self, x, batch_stats, commit=False: real(self, x, batch_stats))


def _d_step_commit(monkeypatch):
    """Every pass in train mode commits, the D step's fake pass with them."""
    from gennet_tpu_torch.models.generator import BBHGenerator

    real = BBHGenerator.forward

    def forward(self, z, train=False, bn_train=None, gen=None, commit_stats=False):
        return real(self, z, train, bn_train, gen, commit_stats or train)

    monkeypatch.setattr(BBHGenerator, "forward", forward)


def _swapped_pair(monkeypatch):
    """The D step sees the fake pair as (measured − x, x)."""
    from gennet_tpu_torch.train import gan

    real = gan._d_inputs

    def d_inputs(*a, **k):
        fake, realp = real(*a, **k)
        return fake.flip(-1), realp

    monkeypatch.setattr(gan, "_d_inputs", d_inputs)


@pytest.mark.parametrize("fault, caught_by", [(_dropped_commit, "change"),
                                              (_d_step_commit, "change"),
                                              (_swapped_pair, "loss")],
                         ids=["dropped_commit", "d_step_commit", "swapped_pair"])
def test_a_planted_fault_is_not_correct(fault, caught_by, monkeypatch):
    fault(monkeypatch)
    result = cell.run_cell(WORKLOAD, 13, 0.01, False, device="cpu", overrides=_overrides())
    assert result["correct"] is False, result["checks"]
    c = result["checks"][caught_by]
    assert c["value"] > c["limit"], result["checks"]


def _defaults(cls, *names):
    return {n: p.default for n, p in inspect.signature(cls).parameters.items() if n in names}


def test_config_is_the_default_recipe():
    from gennet_tpu_torch.cli import workloads as W
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.train.cnn import CNNConfig
    from gennet_tpu_torch.train.gan import GANConfig

    c = W.BBHConfig()
    f = cell.load_json(cell.BENCH, "configs", "bbh_default.json")
    # run_bbh's GAN and PE configs (cli/workloads.py), n_sig from the event
    gan = GANConfig(n_pix=c.n_pix, batch_size=c.batch_size, lr=c.gan_lr or c.lr,
                    chi_loss=c.chi_loss, n_sig=0.0, pair_discriminator=c.pair_d,
                    label_smoothing=c.label_smoothing, d_instance_noise=c.instance_noise,
                    d_lr_scale=c.d_lr_scale, d_acc_gate=c.d_acc_gate,
                    diversity_weight=c.diversity_weight, r1_gamma=c.r1_gamma,
                    residual_route=c.res_loss_weight > 0, res_loss_weight=c.res_loss_weight,
                    res_eval_mode=c.res_eval_mode, res_spectral_bands=c.res_spectral_bands,
                    g_ema_decay=c.g_ema_decay, debug_probes=c.debug_probes)
    assert {k.name: getattr(gan, k.name) for k in dataclasses.fields(gan)
            if k.name not in ("n_pix", "n_sig")} == f["gan"]
    assert f["gan"]["pair_discriminator"] and not f["gan"]["residual_route"]
    pe = CNNConfig(n_pix=c.n_pix, batch_size=c.pe_batch_size, lr=c.lr,
                   noise_frac=c.cnn_noise_frac, ema_decay=c.pe_ema_decay,
                   lr_decay_steps=c.pe_iters if c.pe_lr_decay else 0)
    assert {k.name: getattr(pe, k.name) for k in dataclasses.fields(pe)
            if k.name != "n_pix"} == f["pe"]
    assert (c.n_sig_event, c.n_sig, c.bf16, c.comb_pe_model) == (
        f["n_sig_event"], f["n_sig"], False, False) and f["dtype"] == "float32"
    assert (c.n_pix, c.training_num - 1, c.pe_iters, c.gan_iters, c.cadence, c.pe_cadence) == (
        f["n_pix"], f["bank"]["n_templates"], f["pe_iters"], f["gan_iters"], f["cadence"],
        f["pe_cadence"])
    # the cut: no evaluation and no checkpoint in the window, the source's
    # values kept beside them
    assert (f["eval_cadence"], f["ckpt_every"]) == (0, 0)
    assert {k: v for k, v in f["source_values"].items() if hasattr(c, k)} == {
        "eval_cadence": c.eval_cadence, "ckpt_every": c.ckpt_every}
    g = _defaults(BBHGenerator, "latent_dim", "features", "filt", "drate", "bn_momentum")
    assert {**g, "features": list(g["features"]), "norm": c.g_norm} == f["generator"]
    assert f["generator"]["norm"] == "batch"
    d = _defaults(PairDiscriminator, "features", "filt", "drate", "alpha")
    assert {**d, "features": list(d["features"]), "in_ch": 2 if c.pair_d else 1} == \
        f["discriminator"]
    bc = W._bbh_bank_cfg(c)
    assert {k: getattr(bc, k) for k in ("fs", "T_obs", "safe", "det", "f_low", "dist_mpc", "ra",
                                        "dec", "iota", "phi", "psi", "event_time",
                                        "calibration_offset", "tmpl_m1", "tmpl_m2")} == \
        {k: v for k, v in f["bank"].items() if hasattr(bc, k) and k != "beta"}
    assert list(bc.beta) == f["bank"]["beta"]
    r4 = cell.load_json(cell.BENCH, "configs", "bbh_r4flag.json")
    assert f["bank"] == r4["bank"]


def test_bn_calls_have_the_generators_shapes():
    """The family's BatchNorm layers and the phase's calls against the
    inputs G's BatchNorm layers see in one train-mode pass."""
    from benchmark.families import bbh_pair
    from gennet_tpu_torch.models.layers import BatchNorm

    cfg = {**cell.load_json(cell.BENCH, "configs", "bbh_default.json"),
           **_overrides()["config"]}
    G = bbh_pair.models(cfg, ("generator",))["generator"]
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen[name] = tuple(args[0].shape)
        return hook

    for name, m in G.named_modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(record(name))
    B = cfg["gan"]["batch_size"]
    G(torch.rand(B, cfg["gan"]["latent_dim"]), train=True, gen=torch.Generator())
    calls = gan_bn.bn_calls(cfg, bbh_pair.norms(cfg))
    assert {c["name"]: (c["B"], *c["shape"]) for c in calls} == seen
    assert sorted((c["call"], c["count"]) for c in calls[:3]) == [
        ("bwd", 1), ("commit", 1), ("stats", 1)]
    assert len(calls) == 3 * len(seen)


@pytest.mark.parametrize("metric", ["bn_roofline", "bn_share"])
def test_bn_readers(metric):
    reader = cell.load_module(f"{cell.BENCH}/metrics/{metric}.py", "m_" + metric)
    untraced = SimpleNamespace(chunk_ms=[], chunk=100)
    assert reader.read(untraced) is None
    rows = [("generator.norms.0", "stats", 8, 1, 0.02, 0.005),
            ("generator.norms.0", "bwd", 8, 2, 0.04, 0.01)]
    traced = SimpleNamespace(bn_rows=rows, chunk_ms=[200.0], chunk=100)
    want = {"bn_roofline": 100 * 0.025 / 0.1, "bn_share": 100 * 0.1 / 2.0}[metric]
    assert reader.read(traced) == pytest.approx(want)


def test_bn_bytes():
    from benchmark.harness.bntime import bn_bytes

    # B 8 rows of (C 4, L 16): n = 512 elements
    assert bn_bytes("stats", 8, (4, 16)) == 4 * (2 * 512 + 2 * 4)
    assert bn_bytes("commit", 8, (4, 16)) == 4 * (2 * 512 + 6 * 4)
    assert bn_bytes("stats", 8, (4,)) == 4 * (2 * 32 + 2 * 4)
    assert bn_bytes("bwd", 8, (4, 16)) == 4 * (3 * 512 + 3 * 4)
