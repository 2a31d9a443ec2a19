"""The fused step loops: ``make_gan_step_scan``, ``make_cnn_step_scan`` and
``ml_recenter``'s Adam loop, which run as CUDA-graph replays on a card
(``gennet_tpu_torch.runtime.graphs``) and as eager steps on the CPU.

- A GAN chunk of 3 steps against the JAX package's ``make_gan_step_scan``:
  three port ``gan_update`` calls on JAX's own per-step draws
  (``draw_gan_batch`` on ``jax.random.split(key, 3)``), the balance gate
  open and closed. Stacked metrics at rtol 1e-4 (float32 forward passes in
  two libraries); weights within 2·lr per step (Adam moves a weight by at
  most lr a step, and a gradient that differs near zero can flip a step's
  sign, tests/test_torch_train.py).
- A chunk of n steps equals n single steps bit for bit (GAN, and PE with
  the cosine decay), stacked metrics and generator included.
- Tiny chunked ``run_burst_smoke`` and ``run_bbh`` in both packages with
  ``anneal_start`` not a multiple of the cadence: the same jsonl rows
  (steps and keys) and the same first annealed chunk (G's adversarial
  loss is exactly 0 from its end on).
- A chunked ``run_bbh`` resumed mid-schedule equals the uninterrupted run
  bit for bit.
- The weight-pack cache's invalidation rule, with a counting ``make()``,
  inside and outside a capture.
"""

import dataclasses
import json
from functools import partial

import gennet_tpu.models
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.cli import workloads as jwl
from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import BurstGenerator as JBG
from gennet_tpu.models import CombinedPE as JCPE
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.train import gan as jgan
from gennet_tpu_torch import convert
from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.models import (BBHGenerator, BurstGenerator, CombinedPE, DualBranchPE,
                                     PairDiscriminator)
from gennet_tpu_torch.ops import tf32
from gennet_tpu_torch.train import cnn as tcnn
from gennet_tpu_torch.train import gan as tgan
from gennet_tpu_torch.runtime import graphs

N = 256
G_FEAT, D_FEAT, PE_FEAT = (16, 16, 32, 32, 64), (16, 32), (8, 8, 16, 16)
N_STEPS = 3
GAN_KW = dict(n_pix=N, batch_size=4, label_smoothing=True, d_instance_noise=0.3,
              d_lr_scale=0.5, d_acc_gate=0.9)
GATES = {"open": 2.0, "closed": -1.0}


# ------------------------------------------------- GAN chunk against JAX


@pytest.fixture(scope="module")
def jax_chunks():
    """JAX's 3-step chunk from one state under each gate (one compile:
    the knobs are operands), and the draws its steps made."""
    jcfg = jgan.GANConfig(**GAN_KW)
    jG, jD = JG(n_out=N, features=G_FEAT, drate=0.0), JD(features=D_FEAT, drate=0.0)
    jstate = jgan.init_gan(jax.random.PRNGKey(0), jG, jD, jcfg)
    rng = np.random.default_rng(0)
    bank = rng.normal(size=(16, N)).astype(np.float32)
    measured = rng.normal(size=N).astype(np.float32)
    key = jax.random.PRNGKey(7)
    scan = jgan.make_gan_step_scan(jG, jD, jcfg, N_STEPS)
    draw = jax.jit(partial(jgan.draw_gan_batch, cfg=jcfg))
    batches = [draw(k, jnp.asarray(bank)) for k in jax.random.split(key, N_STEPS)]
    out = {}
    for name, gate in GATES.items():
        knobs = jgan.knobs_from_cfg(jcfg).replace(d_acc_gate=jnp.asarray(gate, jnp.float32))
        out[name] = scan(jstate, jnp.asarray(bank), jnp.asarray(measured), key, knobs)
    return jstate, batches, measured, out


def _port_batch(jb) -> tgan.GANBatch:
    t = {f: None if getattr(jb, f) is None else torch.tensor(np.asarray(getattr(jb, f)))
         for f in ("z1", "real", "fresh", "in_real", "in_fake", "in_g", "y_real", "y_fake",
                   "z2", "z3")}
    return tgan.GANBatch(**t)


@pytest.mark.parametrize("gate", list(GATES))
def test_gan_chunk_matches_jax_scan(jax_chunks, gate):
    jstate, batches, measured, out = jax_chunks
    jnew, jm = out[gate]
    cfg = tgan.GANConfig(**GAN_KW)
    G = BBHGenerator(n_out=N, features=G_FEAT, drate=0.0)
    D = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=N)
    state = tgan.init_gan(torch.Generator().manual_seed(0), G, D, cfg, "cpu")
    G.load_state_dict(convert.flax_to_torch_generator(jax.device_get(jstate.g_params),
                                                      jax.device_get(jstate.g_stats)))
    D.load_state_dict(convert.flax_to_torch_discriminator(jax.device_get(jstate.d_params)))
    d_before = {k: v.clone() for k, v in D.state_dict().items()}
    knobs = dataclasses.replace(tgan.knobs_from_cfg(cfg), d_acc_gate=GATES[gate])
    rows = [tgan.gan_update(state, _port_batch(jb), torch.tensor(measured), knobs, cfg=cfg)[1]
            for jb in batches]
    assert state.step == N_STEPS
    for k in ("d_loss", "d_acc", "g_loss", "g_acc"):
        np.testing.assert_allclose([float(r[k]) for r in rows], np.asarray(jm[k]), rtol=1e-4,
                                   err_msg=k)
    want_g = convert.flax_to_torch_generator(jax.device_get(jnew.g_params),
                                             jax.device_get(jnew.g_stats))
    for k, v in G.state_dict().items():
        atol = 1e-5 if "running" in k else 2 * cfg.lr * N_STEPS
        np.testing.assert_allclose(v.numpy(), want_g[k].numpy(), rtol=0, atol=atol, err_msg=k)
    want_d = convert.flax_to_torch_discriminator(jax.device_get(jnew.d_params))
    for k, v in D.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_d[k].numpy(), rtol=0,
                                   atol=2 * cfg.lr * cfg.d_lr_scale * N_STEPS, err_msg=k)
    counts = [int(s["step"]) for s in state.d_opt.state.values()]
    if gate == "closed":
        # D and its Adam state as optax's after init, in both packages
        assert all(torch.equal(v, d_before[k]) for k, v in D.state_dict().items())
        assert counts == [0] * len(counts)
        assert int(jax.device_get(jnew.d_opt[0].count)) == 0
    else:
        assert counts == [N_STEPS] * len(counts)
        assert int(jax.device_get(jnew.d_opt[0].count)) == N_STEPS


# ------------------------------------------ a chunk against single steps


def _tensors(*objs) -> list:
    """Every tensor of the modules, optimizers and tensor dicts given."""
    out = []
    for o in objs:
        if isinstance(o, torch.nn.Module):
            out += [t.detach() for t in o.state_dict().values()]
        elif isinstance(o, torch.optim.Optimizer):
            out += graphs.optimizer_tensors(o)
        elif isinstance(o, dict):
            out += list(o.values())
    return out


def _gan_state(cfg):
    G = BBHGenerator(n_out=N, features=G_FEAT)
    D = PairDiscriminator(features=D_FEAT, n_pix=N)
    return tgan.init_gan(torch.Generator().manual_seed(3), G, D, cfg, "cpu")


@pytest.mark.parametrize("recipe", ["default", "residual_anneal"])
def test_gan_chunk_equals_single_steps(recipe):
    extra = {} if recipe == "default" else dict(residual_route=True, res_loss_weight=2.0,
                                               diversity_weight=0.1, g_ema_decay=0.9)
    cfg = tgan.GANConfig(**{**GAN_KW, **extra})
    knobs = tgan.knobs_from_cfg(cfg)
    if recipe == "residual_anneal":
        knobs = dataclasses.replace(knobs, d_acc_gate=-1.0, adv_weight=0.0)
    bank = torch.randn(16, N, generator=torch.Generator().manual_seed(1))
    measured = torch.randn(N, generator=torch.Generator().manual_seed(2))
    runs = []
    for chunked in (True, False):
        state = _gan_state(cfg)
        gen = torch.Generator().manual_seed(5)
        if chunked:
            step = tgan.make_gan_step_scan(state.generator, state.discriminator, cfg, 4)
            state, m = step(state, bank, measured, gen, knobs)
        else:
            kt = tgan.knob_tensors(knobs, "cpu")
            rows = [tgan.gan_step(state, bank, measured, gen, kt, cfg=cfg)[1] for _ in range(4)]
            m = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        runs.append((state, m, gen.get_state()))
    (a, ma, ga), (b, mb, gb) = runs
    assert a.step == b.step == 4
    assert ma.keys() == mb.keys() and all(ma[k].shape == (4,) for k in ma)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert torch.equal(ga, gb)
    for x, y in zip(_tensors(a.generator, a.discriminator, a.g_opt, a.d_opt, a.g_res_opt,
                             a.g_ema or {}),
                    _tensors(b.generator, b.discriminator, b.g_opt, b.d_opt, b.g_res_opt,
                             b.g_ema or {})):
        assert torch.equal(x, y)


def test_cnn_chunk_equals_single_steps_with_the_decay():
    cfg = tcnn.CNNConfig(n_pix=N, ema_decay=0.9, lr_decay_steps=5)
    bank = torch.randn(32, N, generator=torch.Generator().manual_seed(1))
    targets = torch.rand(32, 2, generator=torch.Generator().manual_seed(2))
    runs = []
    for chunked in (True, False):
        state = tcnn.init_cnn(torch.Generator().manual_seed(0), DualBranchPE(n_pix=N), cfg, "cpu")
        gen = torch.Generator().manual_seed(4)
        if chunked:
            step = tcnn.make_cnn_step_scan(state.model, cfg, 3)
            for _ in range(2):
                state, m = step(state, bank, targets, gen)
        else:
            step = tcnn.make_cnn_step(state.model, cfg)
            rows = [step(state, bank, targets, gen)[1] for _ in range(6)]
            m = {"pe_loss": torch.stack([r["pe_loss"] for r in rows[3:]])}
        runs.append((state, m, gen.get_state()))
    (a, ma, ga), (b, mb, gb) = runs
    assert a.step == b.step == 6 and ma["pe_loss"].shape == (3,)
    assert torch.equal(ma["pe_loss"], mb["pe_loss"]) and torch.equal(ga, gb)
    # the decay ran past its end (6 updates of 5): lr·lr_min_frac
    assert a.opt.param_groups[0]["lr"] == b.opt.param_groups[0]["lr"] == pytest.approx(
        cfg.lr * cfg.lr_min_frac)
    for x, y in zip(_tensors(a.model, a.opt, a.ema), _tensors(b.model, b.opt, b.ema)):
        assert torch.equal(x, y)


def test_device_decay_is_lambda_lrs():
    # the card's decay (an expression of Adam's count) gives LambdaLR's
    # values; on the CPU it runs on a capturable-form stand-in
    cfg = tcnn.CNNConfig(n_pix=N, lr_decay_steps=4)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p], lr=torch.tensor(cfg.lr), betas=(0.5, 0.999))
    want = [cfg.lr * tcnn.cosine_decay(4, cfg.lr_min_frac)(c) for c in range(1, 7)]
    got = []
    for _ in range(6):
        p.grad = torch.ones(3)
        opt.step()
        tcnn._decay_lr_(opt, cfg)
        got.append(float(opt.param_groups[0]["lr"]))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------ the workloads against JAX


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _annealed(rows) -> list:
    """The GAN cadence rows' steps and whether G's adversarial loss is 0."""
    return [(r["step"], r["g_loss"] == 0.0) for r in rows if "g_loss" in r]


def test_chunked_burst_smoke_matches_jax_schedule(tmp_path, monkeypatch):
    # cadence 2 divides both schedules (chunks of 2); the anneal starts at
    # int(6 · 0.5) = 3, inside the second chunk: the chunk from step 4 on is
    # the first annealed one. G at narrow widths, to keep the run short
    monkeypatch.setattr(jwl, "BurstGenerator", partial(JBG, features=PE_FEAT))
    monkeypatch.setattr(twl, "BurstGenerator", partial(BurstGenerator, features=PE_FEAT))
    kw = dict(n_pix=128, n_signals=512, gan_iters=6, pe_iters=6, cadence=2, batch_size=8,
              n_posterior=32, pe_grain=21, anneal_frac=0.5, gan_restarts=0, plots=False)
    jwl.run_burst_smoke(jwl.BurstSmokeConfig(**kw, out_dir=str(tmp_path / "j")))
    twl.run_burst_smoke(twl.BurstSmokeConfig(**kw, out_dir=str(tmp_path / "t")), device="cpu")
    rows = {tag: _rows(tmp_path / tag / "burst_metrics.jsonl") for tag in ("j", "t")}
    assert [(r["step"], sorted(r)) for r in rows["t"]] == \
        [(r["step"], sorted(r)) for r in rows["j"]]
    assert _annealed(rows["t"]) == _annealed(rows["j"]) == [(2, False), (4, False), (6, True)]


def _narrow_models(monkeypatch):
    monkeypatch.setattr(jwl, "BBHGenerator", partial(JG, features=G_FEAT))
    monkeypatch.setattr(jwl, "PairDiscriminator", partial(JD, features=D_FEAT))
    monkeypatch.setattr(gennet_tpu.models, "CombinedPE", partial(JCPE, features=PE_FEAT))
    monkeypatch.setattr(twl, "BBHGenerator", partial(BBHGenerator, features=G_FEAT))
    monkeypatch.setattr(twl, "PairDiscriminator", partial(PairDiscriminator, features=D_FEAT))
    monkeypatch.setattr(twl, "CombinedPE", partial(CombinedPE, features=PE_FEAT))


BBH_KW = dict(n_pix=256, training_num=24, pe_iters=2, pe_cadence=2, gan_iters=6, cadence=2,
              eval_cadence=6, ckpt_every=2, n_posterior=8, grid_grain=0, comb_pe_model=True,
              plots=False)


def test_chunked_run_bbh_matches_jax_schedule(tmp_path, monkeypatch):
    _narrow_models(monkeypatch)
    kw = dict(BBH_KW, anneal_frac=0.5)  # anneal_start 3, inside the chunk of steps 3-4
    jwl.run_bbh(jwl.BBHConfig(**kw, out_dir=str(tmp_path / "j")))
    twl.run_bbh(twl.BBHConfig(**kw, out_dir=str(tmp_path / "t")), device="cpu")
    rows = {tag: _rows(tmp_path / tag / "bbh_metrics.jsonl") for tag in ("j", "t")}
    assert [(r["step"], sorted(r)) for r in rows["t"]] == \
        [(r["step"], sorted(r)) for r in rows["j"]]
    assert _annealed(rows["t"]) == _annealed(rows["j"]) == [(2, False), (4, False), (6, True)]


def test_chunked_run_bbh_resumes_bit_for_bit(tmp_path, monkeypatch):
    _narrow_models(monkeypatch)
    kw = dict(BBH_KW, gan_iters=4, eval_cadence=4)
    cfg = twl.BBHConfig(**kw, out_dir=str(tmp_path / "whole"))
    twl.run_bbh(cfg, device="cpu")
    split = dataclasses.replace(cfg, out_dir=str(tmp_path / "split"))
    twl.run_bbh(dataclasses.replace(split, gan_iters=2), device="cpu")
    out = twl.run_bbh(dataclasses.replace(split, resume=True), device="cpu")
    assert out["final_step"] == 4
    ck = {tag: torch.load(tmp_path / tag / "ckpt_gan" / "ckpt_4.pt", weights_only=True)
          for tag in ("whole", "split")}

    def leaves(x, path=""):
        if isinstance(x, dict):
            return [p for k in sorted(x, key=str) for p in leaves(x[k], f"{path}.{k}")]
        if isinstance(x, (list, tuple)):
            return [p for i, v in enumerate(x) for p in leaves(v, f"{path}.{i}")]
        return [(path, x)]

    a, b = leaves(ck["whole"]), leaves(ck["split"])
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), p
    rows = {tag: [r for r in _rows(tmp_path / tag / "bbh_metrics.jsonl")
                  if "g_loss" in r and r["step"] > 2] for tag in ("whole", "split")}
    assert rows["whole"] == rows["split"] and len(rows["whole"]) == 1


# ------------------------------------------------------ the pack cache


def test_cached_pack_invalidation_rule():
    made = []

    def make(w):
        made.append(1)
        return w.clone()

    w = torch.ones(4)
    p1 = tf32.cached_pack("t", (w,), lambda: make(w))
    assert tf32.cached_pack("t", (w,), lambda: make(w)) is p1 and len(made) == 1
    w.add_(1.0)                                   # an in-place update: a new pack
    p2 = tf32.cached_pack("t", (w,), lambda: make(w))
    assert p2 is not p1 and len(made) == 2 and torch.equal(p2, w)
    torch.autograd.graph.increment_version([w])   # what a replay's caller does
    tf32.cached_pack("t", (w,), lambda: make(w))
    assert len(made) == 3
    with tf32.capturing():                        # a capture never reads the cache...
        p4 = tf32.cached_pack("t", (w,), lambda: make(w))
        assert tf32.cached_pack("t", (w,), lambda: make(w)) is p4 and len(made) == 4
        w.mul_(2.0)                               # ...reuses its own packs while unchanged
        tf32.cached_pack("t", (w,), lambda: make(w))
        assert len(made) == 5
    p6 = tf32.cached_pack("t", (w,), lambda: make(w))  # ...and never serves one after
    assert p6 is not p4 and len(made) == 6
    key = ("t", id(w))
    assert key in tf32._PACKS
    del w                                         # a freed source drops its entry
    assert key not in tf32._PACKS


def test_step_graph_runs_eagerly_off_the_card():
    g = graphs.StepGraph("test", graphs.graphable("cpu"))
    x = torch.zeros(())

    def step():
        x.add_(1.0)
        return {"x": x.clone(), "twice": 2 * x}

    m = g.run(5, step, lambda: [x])
    assert not g.graphable and g.replays == 0
    assert torch.equal(m["x"], torch.arange(1.0, 6.0)) and torch.equal(m["twice"], 2 * m["x"])


def test_restore_keeps_the_live_optimizers_device_form():
    # a captured step reads the live lr tensor: a restore writes the saved
    # value into it, and a saved tensor lr becomes a number for a plain Adam
    from gennet_tpu_torch.train.checkpoints import _load_optimizer

    p = torch.nn.Parameter(torch.zeros(3))
    lr = torch.tensor(0.1)
    live = torch.optim.Adam([p], lr=lr, foreach=False)
    _load_optimizer(live, torch.optim.Adam([torch.nn.Parameter(torch.zeros(3))],
                                           lr=0.05).state_dict())
    assert live.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(0.05)
    plain = torch.optim.Adam([p], lr=0.1)
    _load_optimizer(plain, torch.optim.Adam([torch.nn.Parameter(torch.zeros(3))],
                                            lr=torch.tensor(0.02), foreach=False).state_dict())
    assert plain.param_groups[0]["lr"] == pytest.approx(0.02)
    assert not isinstance(plain.param_groups[0]["lr"], torch.Tensor)
    assert plain.param_groups[0]["foreach"] is None  # the live optimizer's own setting
