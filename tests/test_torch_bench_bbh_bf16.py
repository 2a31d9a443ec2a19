"""GenNet's own BBH GAN under ``--bf16`` in the benchmark
(``benchmark/configs/bbh_bf16.json``: the ``bbh_bf16`` family, the
``gan_bf16`` phase), on the CPU at a narrow size:

- the configuration file holds ``BBHConfig(bf16=True)`` as ``run_bbh``
  maps it, and ``bbh_default.json`` in every other field;
- the program's forward passes and its checked iterations, run by
  ``make_gan_step_scan`` as the cell runs them, follow
  ``benchmark/reference/bbh_bf16.py``, and follow it more closely than
  the reference's own float32 switch does;
- a model built at float32 fails the cell's dtype check;
- the program's ``casts`` counter over one iteration reads the forward
  conversions the phase predicts from the layer lists (0 for a float32
  model), and every conversion the iteration makes, autograd's included,
  is one the phase lists;
- the bf16 cost functions and the three new readers.

On a card (``-m gpu``; without JAX installed, run the file with
``pytest --noconftest -m gpu``): the ``graph.capture`` span of a replayed
bf16 chunk carries that same count.
"""

import collections
import copy
import dataclasses
import inspect
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from benchmark.harness import cell, loops
from benchmark.phases import gan_bf16
from benchmark.reference import bbh_bf16 as ref_bf16
from benchmark.reference.bbh_pair import STATS
from benchmark.reference.steps import Draws
from gennet_tpu_torch.runtime import trace

WORKLOAD = "bbh_bf16-gan"
BF16, F32 = torch.bfloat16, torch.float32


def _overrides() -> dict:
    """n_pix 64, narrow G and D, a bank of 256 rows; the recipe's batch of
    8 and every branch of the full cell kept. A chunk of 4, other than the
    checked calls' (1, 3), so the window's step is a step of its own."""
    cfg = copy.deepcopy(cell.load_json(cell.BENCH, "configs", "bbh_bf16.json"))
    return {"config": {"n_pix": 64, "bank": {**cfg["bank"], "fs": 64, "n_templates": 256},
                       "generator": {**cfg["generator"], "features": [16, 16, 32, 32, 32]},
                       "discriminator": {**cfg["discriminator"], "features": [32, 32]}},
            "traffic": {"chunk": 4}}


def _rel(out, want) -> float:
    out, want = out.double(), want.double()
    return float((out - want).abs().max() / want.abs().max())


# --------------------------------------------------------- configuration


def _defaults(cls, *names):
    return {n: p.default for n, p in inspect.signature(cls).parameters.items() if n in names}


def test_config_is_the_default_recipe_under_bf16():
    from gennet_tpu_torch.cli import workloads as W
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.train.cnn import CNNConfig
    from gennet_tpu_torch.train.gan import GANConfig

    c = dataclasses.replace(W.BBHConfig(), bf16=True)
    f = cell.load_json(cell.BENCH, "configs", "bbh_bf16.json")
    # run_bbh: G and D in bfloat16 where cfg.bf16, their parameters float32
    assert c.bf16 and f["dtype"] == "bfloat16" and f["family"] == "bbh_bf16"
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
    pe = CNNConfig(n_pix=c.n_pix, batch_size=c.pe_batch_size, lr=c.lr,
                   noise_frac=c.cnn_noise_frac, ema_decay=c.pe_ema_decay,
                   lr_decay_steps=c.pe_iters if c.pe_lr_decay else 0)
    assert {k.name: getattr(pe, k.name) for k in dataclasses.fields(pe)
            if k.name != "n_pix"} == f["pe"]
    assert (c.n_sig_event, c.n_sig, c.comb_pe_model, c.conv_impl) == (
        f["n_sig_event"], f["n_sig"], False, "xla")
    assert (c.n_pix, c.training_num - 1, c.pe_iters, c.gan_iters, c.cadence, c.pe_cadence) == (
        f["n_pix"], f["bank"]["n_templates"], f["pe_iters"], f["gan_iters"], f["cadence"],
        f["pe_cadence"])
    # the cut: no evaluation and no checkpoint in the window
    assert (f["eval_cadence"], f["ckpt_every"]) == (0, 0)
    assert {k: v for k, v in f["source_values"].items() if hasattr(c, k)} == {
        "eval_cadence": c.eval_cadence, "ckpt_every": c.ckpt_every}
    g = _defaults(BBHGenerator, "latent_dim", "features", "filt", "drate", "bn_momentum")
    assert {**g, "features": list(g["features"]), "norm": c.g_norm} == f["generator"]
    d = _defaults(PairDiscriminator, "features", "filt", "drate", "alpha")
    assert {**d, "features": list(d["features"]), "in_ch": 2 if c.pair_d else 1} == \
        f["discriminator"]
    # bbh_default's fields in every other key: the same model, bank and loop
    default = cell.load_json(cell.BENCH, "configs", "bbh_default.json")
    differ = {k for k in {*f, *default} if f.get(k) != default.get(k)}
    assert differ == {"family", "recipe", "dtype", "departures"}, differ
    assert f["departures"]["discriminator"] == default["departures"]["discriminator"]


# --------------------------------------------- the program against the reference


def test_forward_follows_the_reference():
    """G (train mode, batch statistics, dropout) and D on its pairs, from
    the benchmark's weights and the same dropout draws. Both compute the
    same bf16 ops in the same order but for BatchNorm's float32 statistics
    (``torch.var_mean`` against two passes), whose difference may round an
    element to the neighbouring bf16 value (2⁻⁸ relative), which later
    layers carry. Measured on the CPU over seeds 7-9, 21 and 22: 0 for G
    and D; the reference's float32 switch moves G by 9.3e-3 to 1.4e-2·max
    and D by 2.3e-3 to 7.1e-3·max. Tolerance 1e-3·max: a G or D that
    dropped bf16 fails it."""
    ctx = cell.build(WORKLOAD, 7, "cpu", _overrides())
    cfg, P = ctx.cfg, ctx.weights
    G, D = ctx.modules["generator"], ctx.modules["discriminator"]
    n, B = cfg["n_pix"], cfg["gan"]["batch_size"]
    z = torch.rand((B, 100), generator=torch.Generator().manual_seed(1)) * 2 - 1
    stats = {k: v.clone() for k, v in P["generator"].items() if k.endswith(STATS)}

    def draws(seed):
        return Draws(torch.Generator().manual_seed(seed))

    with torch.no_grad():
        x = G(z, train=True, gen=torch.Generator().manual_seed(2))
        want = ref_bf16.generator(cfg["generator"], P["generator"], z, n, draws(2), stats, False)
        want32 = ref_bf16.generator(cfg["generator"], P["generator"], z, n, draws(2), stats,
                                    False, dtype=F32)
        pair = torch.cat([x, ctx.data.measured[None, :, None] - x], dim=-1)
        logits = D(pair, train=True, gen=torch.Generator().manual_seed(3))
        want_d = ref_bf16.discriminator(cfg["discriminator"], P["discriminator"], pair, draws(3))
    assert x.dtype == want.dtype == logits.dtype == F32
    assert _rel(x, want) <= 1e-3 < _rel(want32, want), (_rel(x, want), _rel(want32, want))
    assert _rel(logits, want_d) <= 1e-3


def test_checked_iterations_follow_the_reference():
    """One call of one iteration, then one of three, as the cell checks
    them, from seed 12, where a bf16 rounding did flip: the same ops on the
    same inputs but for BatchNorm's order (above). Measured on the CPU over
    seeds 11-15: ``loss_pre`` 0 to 3.6e-4 and ``grad_pre`` 0 to 7.3e-4;
    the reference's float32 switch reads ``loss_pre`` 4.3e-5 to 6.3e-4,
    too close to tell the two apart at this size, and ``grad_pre`` 4.5e-3
    to 1.3e-2. Tolerances: ``loss_pre`` 1e-3, ``grad_pre`` 2e-3 (below
    every float32 reading). The leaves whose gradient is rounding alone
    (the biases before a BatchNorm) move by ±lr on a sign the roundings
    set, so ``change`` is held by the cell's calibrated limit, not here."""
    ctx = cell.build(WORKLOAD, 12, "cpu", _overrides())
    checked = ctx.loop.checked_steps()
    ref, init = loops.reference(ctx), loops.initial(ctx)
    r = gan_bf16.readings(checked, ref, init)
    r32 = gan_bf16.readings(loops.reference(ctx, fault="float32"), ref, init)
    assert r["loss_pre"] <= 1e-3, r
    assert r["grad_pre"] <= 2e-3 < r32["grad_pre"], (r, r32)
    assert gan_bf16.dtype_reading(ctx.cfg, checked) == 0


# ---------------------------------------------------------- the dtype check


@pytest.mark.parametrize("net, layers", [("BBHGenerator", 12), ("PairDiscriminator", 2)],
                         ids=["generator", "discriminator"])
def test_a_float32_network_fails_the_dtype_check(net, layers, monkeypatch):
    """A network built at float32 in the bf16 cell: G's Dense, 5 convs and
    6 norms, or D's 2 convs, compute in float32; the cell is not correct
    by its ``dtype`` reading, whatever the tolerances say."""
    from gennet_tpu_torch import models

    cls = getattr(models, net)
    real = cls.__init__

    def init(self, *a, dtype=None, **k):
        real(self, *a, **k)  # the dtype dropped: float32

    monkeypatch.setattr(cls, "__init__", init)
    result = cell.run_cell(WORKLOAD, 13, 0.01, False, device="cpu", overrides=_overrides())
    assert result["correct"] is False
    assert result["checks"]["dtype"] == {"value": layers, "limit": 0}, result["checks"]


# ---------------------------------------------------------------- casts


class _Conversions(TorchDispatchMode):
    """Every float32 ↔ bfloat16 conversion the ops make, as (numel, source,
    target)."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._to_copy.default:
            src, dst = args[0].dtype, out.dtype
            if src != dst and {src, dst} <= {F32, BF16}:
                self.seen[(args[0].numel(), src, dst)] += 1
        return out


def _predicted(ctx) -> list:
    family = cell.load_module(f"{cell.BENCH}/families/{ctx.cfg['family']}.py", "fam")
    return gan_bf16.conversions(ctx.cfg, family.layers, family.norms(ctx.cfg),
                                family.compute_dtypes(ctx.cfg))


def test_one_iteration_makes_the_predicted_conversions():
    """One eager iteration of the cell's step: the program's ``casts``
    counter moves by the forward conversions of the phase's list (70 at
    the cell's layer counts: G 26 a pass, twice; D 6 a pass, three times),
    and the conversions the ops make, autograd's casts of the gradients
    back included, are the list's, size for size."""
    ctx = cell.build(WORKLOAD, 5, "cpu", _overrides())
    step = ctx.loop.make_step(1)
    ctx.loop.call(step)  # Adam's state made outside the count
    want = _predicted(ctx)
    before = trace.counts()["casts"]
    with _Conversions() as mode:
        ctx.loop.call(step)
    fwd = sum(c["count"] for c in want if c["call"] == "fwd")
    assert trace.counts()["casts"] - before == fwd == 70
    made = collections.Counter()
    for c in want:
        made[(torch.Size(c["shape"]).numel(), c["src"], c["dst"])] += c["count"]
    assert mode.seen == made
    assert sum(made.values()) == 70 + 37  # D step 2 × 5, G step G 25 + D 2 backward


def test_a_float32_model_counts_no_cast():
    ctx = cell.build("bbh_default-gan", 5, "cpu", {**_overrides(), "config": {
        **_overrides()["config"], "family": "bbh_pair", "dtype": "float32"}})
    before = trace.counts().get("casts", 0)
    ctx.loop.call(ctx.loop.make_step(1))
    assert trace.counts()["casts"] == before


# ------------------------------------------------------ costs and readers


def test_bf16_costs():
    from benchmark.harness import costs, costs_bf16
    from benchmark.harness.flops import cost

    conv = {"kind": "conv", "call": "fwd", "B": 8, "L": 1024, "cin": 512, "cout": 1024,
            "stride": 1, "K": 5, "padding": "SAME"}
    dense = {"kind": "dense", "call": "dw", "B": 8, "fin": 100, "fout": 131072}
    for c in (conv, dense):
        flops, nbytes = costs_bf16.call_cost_bf16(c)
        assert (flops, 2 * nbytes) == cost(c)  # 2 bytes an element, not 4
    assert costs_bf16.PEAK_FLOPS_BF16 == 989e12 == 2 * costs.PEAK_FLOPS - 1e12
    assert costs_bf16.bound_s_bf16(989e12, 0) == 1.0
    assert costs_bf16.bound_s_bf16(0, 3.35e12) == 1.0
    assert costs_bf16.cast_bytes((8, 4, 16), F32, BF16) == 512 * 6
    # B 8 rows of (C 4, L 16): n = 512 elements at 2 bytes, 4 channels' parameters at 4
    assert costs_bf16.bn_bytes_bf16("stats", 8, (4, 16)) == 2 * 2 * 512 + 4 * 2 * 4
    assert costs_bf16.bn_bytes_bf16("commit", 8, (4, 16)) == 2 * 2 * 512 + 4 * 6 * 4
    assert costs_bf16.bn_bytes_bf16("bwd", 8, (4, 16)) == 2 * 3 * 512 + 4 * 3 * 4


def _reader(name):
    return cell.load_module(f"{cell.BENCH}/metrics/{name}.py", "m_" + name.replace(".", "_"))


def test_mfu_and_conv_roofline_readers():
    untraced = SimpleNamespace(untraced_rate=None, chunk_ms=[], chunk=100)
    assert _reader("mfu.gan_bf16").read(untraced) is None
    assert _reader("conv_roofline.bf16").read(untraced) is None
    run = SimpleNamespace(untraced_rate=50.0, step_flops=989e9, chunk=100,
                          conv_rows_bf16=[("generator.convs.4", "fwd", 8, 2, 0.5, 0.1),
                                          ("generator.convs.4", "dx", 8, 1, 1.0, 0.1)])
    assert _reader("mfu.gan_bf16").read(run) == pytest.approx(5.0)
    assert _reader("conv_roofline.bf16").read(run) == pytest.approx(100 * 0.3 / 2.0)


@pytest.fixture
def captures(monkeypatch):
    recs = []
    monkeypatch.setattr(trace, "spans", lambda: list(recs))
    return recs


def test_cast_share_reads_only_a_count_the_program_agrees_with(captures):
    read = _reader("cast_share").read
    rows = [("generator.norms.5.input", "bfloat16->float32", (8, 1024, 1024), 3, 0.02, 0.01),
            ("generator.dense.weight", "float32->bfloat16", (131072, 100), 2, 0.03, 0.02)]
    run = SimpleNamespace(cast_rows=rows, casts_per_iteration=70, chunk_ms=[200.0], chunk=100)
    assert read(run) is None  # a program without the counter: no capture carries it
    captures.append((1, "graph.capture", 0, 1, None, {}))
    assert read(run) is None
    captures.append((2, "graph.capture", 2, 3, None, {"casts": 70}))
    assert read(run) == pytest.approx(100 * 0.12 / 2.0)
    captures.append((3, "graph.capture", 4, 5, None, {"casts": 69}))
    assert read(run) is None  # the program made a conversion the harness does not time
    assert read(SimpleNamespace(cast_rows=rows, casts_per_iteration=70, chunk_ms=[], chunk=100)) \
        is None


# ------------------------------------------------------------------ card


@pytest.mark.gpu
def test_a_replayed_bf16_chunk_records_its_casts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured only there")
    ctx = cell.build(WORKLOAD, 17, "cuda", _overrides())
    trace.clear()
    ctx.loop.call(ctx.loop.step)
    torch.cuda.synchronize()
    capture, = [r for r in trace.spans() if r[1] == "graph.capture"]
    assert capture[5] == {"casts": 70}
    assert sum(c["count"] for c in _predicted(ctx) if c["call"] == "fwd") == 70
