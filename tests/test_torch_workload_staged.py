"""The staged pipeline of the port on the CPU: ``make-bank`` → ``train-cnn``
→ ``train-gan`` → ``sample-posterior``, resume, the CNN cache, bank files
and lalinference products.

Runs are tiny (n_pix 256, 24 templates, ≤ 4 PE and 4 GAN steps, no grid),
with G, D and the PE at narrow widths (G (16, 16, 32, 32, 64), D (16, 32),
PE branches of 8-16 channels): what is held here is how state moves
between stages, which does not depend on the widths. Each test deletes its
run directories when it ends (a run's checkpoints take ~0.1 GB). "Equal" means bitwise: every tensor of the saved PE and GAN states
(weights, BatchNorm statistics, Adam moments, EMA, generator state), the
summary and the last metrics row.

- A run interrupted in the PE phase, and one interrupted in the GAN phase,
  resumed with ``resume=True``, equal the uninterrupted run; so does
  ``train-gan`` after ``train-cnn``.
- A CNN-cache miss and a hit equal the uncached run (``run_bbh``), and
  each other (``run_burst_smoke``); the cache entries' names are the JAX
  expressions' for the same config.
- A bank ``.npz`` or ``.gntb`` written by either package drives
  ``run_bbh(bank_file=…)`` with every row; the port's ``make-bank`` files
  have the JAX CLI's keys and shapes and are read by the JAX package.
- ``lalinf_dir`` runs on products from ``gennet_tpu.data.synth_products``.
- ``comb_pe_model`` and ``g_norm`` run, with the posterior sampler built
  with the run's norm.
- ``sample-posterior`` writes the JAX CLI's keys and shapes, renames the
  draws after a resampling route, and refuses, before any work, the four
  cases the reference cannot run (ROADMAP queue 3).
"""

import ast
import dataclasses
import functools
import inspect
import json
import os
import shutil
import textwrap

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.cli.main import main as cli
from gennet_tpu_torch.models import (BBHGenerator, BurstGenerator, CombinedPE, DualBranchPE,
                                     PairDiscriminator)
from gennet_tpu_torch.train.checkpoints import CheckpointManager

G_FEAT, D_FEAT = (16, 16, 32, 32, 64), (16, 32)
TINY = dict(n_pix=256, training_num=24, pe_iters=4, gan_iters=4, cadence=1, pe_cadence=2,
            eval_cadence=2, n_posterior=8, grid_grain=0, ckpt_every=2, plots=False)


class NarrowPE(DualBranchPE):
    _MC = ((8, 2, "SAME"), (8, 2, "VALID"), (16, 2, "VALID"), (16, 2, "VALID"))
    _Q = ((8, 1, "SAME"), (8, 1, "VALID"), (16, 1, "VALID"), (16, 2, "VALID"), (16, 2, "VALID"))


@pytest.fixture(scope="module", autouse=True)
def narrow_models():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twl, "BBHGenerator", functools.partial(BBHGenerator, features=G_FEAT))
        mp.setattr(twl, "PairDiscriminator", functools.partial(PairDiscriminator,
                                                               features=D_FEAT))
        mp.setattr(twl, "DualBranchPE", NarrowPE)
        mp.setattr(twl, "CombinedPE", functools.partial(CombinedPE, features=(8, 8, 16, 16)))
        mp.setattr(twl, "BurstGenerator", functools.partial(BurstGenerator,
                                                            features=(16, 16, 32, 32)))
        yield


@pytest.fixture(autouse=True)
def delete_runs(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _argv(cfg: dict) -> list:
    out = ["--device", "cpu"]
    for k, v in cfg.items():
        out += ["--" + k.replace("_", "-"), str(v)]
    return out


def _cfg(out_dir, **kw) -> twl.BBHConfig:
    return twl.BBHConfig(**{**TINY, "out_dir": str(out_dir), **kw})


class Interrupted(Exception):
    pass


def _interrupted(cfg, phase, step):
    """Run ``cfg`` until the checkpoint of ``phase`` at ``step`` is written,
    then fail, as a cut run does."""
    save = CheckpointManager.save

    def crashing(self, s, state, extra=None):
        save(self, s, state, extra)
        if os.path.basename(self._dir) == phase and s == step:
            raise Interrupted

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CheckpointManager, "save", crashing)
        with pytest.raises(Interrupted):
            twl.run_bbh(cfg, device="cpu")


def _payload(out_dir, phase, step):
    return torch.load(os.path.join(out_dir, phase, f"ckpt_{step}.pt"), weights_only=True)


def _assert_same(a, b, path="payload"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}.{i}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _last_row(out_dir, name="bbh"):
    with open(os.path.join(out_dir, f"{name}_metrics.jsonl")) as f:
        return json.loads(f.readlines()[-1])


def _assert_same_run(a, b, pe_phase=True):
    """The final PE and GAN checkpoints and the last metrics row of two
    run directories are equal."""
    if pe_phase:
        _assert_same(_payload(a, "ckpt_pe", 4), _payload(b, "ckpt_pe", 4))
    _assert_same(_payload(a, "ckpt_gan", 4), _payload(b, "ckpt_gan", 4))
    assert _last_row(a) == _last_row(b)


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """The uninterrupted tiny run every staged run is held to."""
    d = tmp_path_factory.mktemp("full")
    out = twl.run_bbh(_cfg(d), device="cpu")
    yield str(d), out
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------------ resume

def test_full_run_saves_what_resume_reads(full_run):
    d, out = full_run
    assert out["final_step"] == 4
    assert CheckpointManager(os.path.join(d, "ckpt_pe")).all_steps() == [2, 4]
    # steps 2 and 4, and the best-whiteness state (of an eval step) at 5
    assert CheckpointManager(os.path.join(d, "ckpt_gan")).all_steps() == [2, 4, 5]
    best = _payload(d, "ckpt_gan", 5)
    assert best["state"]["step"] in (2, 4) and set(best["state"]) == set(
        _payload(d, "ckpt_gan", 4)["state"])
    assert torch.is_tensor(best["extra"]["gen"])


@pytest.mark.parametrize("phase", ["ckpt_pe", "ckpt_gan"])
def test_resume_equals_the_uninterrupted_run(tmp_path, full_run, phase):
    d_full, out_full = full_run
    cfg = _cfg(tmp_path)
    _interrupted(cfg, phase, 2)
    assert CheckpointManager(os.path.join(tmp_path, phase)).latest_step() == 2
    out = twl.run_bbh(dataclasses.replace(cfg, resume=True), device="cpu")
    assert out == out_full
    _assert_same_run(str(tmp_path), d_full)


def test_train_gan_after_train_cnn_equals_train_bbh(tmp_path, full_run, capsys):
    d_full, out_full = full_run
    argv = _argv({**TINY, "out_dir": tmp_path})
    cli(["train-cnn", *argv])
    assert CheckpointManager(os.path.join(tmp_path, "ckpt_pe")).all_steps() == [2, 4]
    out = cli(["train-gan", *argv])
    assert out == out_full
    _assert_same_run(str(tmp_path), d_full)
    # train-gan trains no PE: it saved none
    assert CheckpointManager(os.path.join(tmp_path, "ckpt_pe")).all_steps() == [2, 4]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out_full


def test_resume_of_a_finished_run_takes_the_best_whiteness_state(tmp_path, full_run):
    # as the reference's restore(): the newest step is the diagnostic state
    # at gan_iters + 1, so the run goes on from that state's step
    d_full, _ = full_run
    best = _payload(d_full, "ckpt_gan", 5)
    cfg = _cfg(tmp_path, pe_iters=0, gan_iters=6, eval_cadence=100)
    gan_dir = tmp_path / "ckpt_gan"
    gan_dir.mkdir(parents=True)
    torch.save(best, gan_dir / "ckpt_5.pt")
    out = twl.run_bbh(dataclasses.replace(cfg, resume=True), device="cpu")
    rows = [json.loads(line) for line in open(tmp_path / "bbh_metrics.jsonl")]
    gan_steps = [r["step"] for r in rows if "d_loss" in r]
    assert gan_steps == list(range(best["state"]["step"] + 1, 7))
    assert out["final_step"] == 6


# --------------------------------------------------------------- CNN cache

def test_cnn_cache_miss_and_hit_equal_the_uncached_run(tmp_path, full_run, capsys):
    d_full, out_full = full_run
    cache = tmp_path / "cache"
    for name in ("miss", "hit"):
        out = twl.run_bbh(_cfg(tmp_path / name, cnn_cache=str(cache)), device="cpu")
        restored = "CNN PE restored from cache" in capsys.readouterr().out
        assert restored == (name == "hit")
        assert out == out_full
        _assert_same_run(str(tmp_path / name), d_full, pe_phase=False)
    entry = cache / twl.bbh_cnn_cache_tag(_cfg(tmp_path))
    assert CheckpointManager(str(entry)).all_steps() == [4]
    _assert_same(_payload(str(entry.parent), entry.name, 4)["state"],
                 _payload(d_full, "ckpt_pe", 4)["state"])


def test_burst_cnn_cache_hit_equals_the_miss(tmp_path, capsys):
    base = dict(n_pix=128, n_signals=512, gan_iters=4, pe_iters=4, cadence=2, batch_size=8,
                n_posterior=32, pe_grain=21, gan_restarts=0, plots=False,
                cnn_cache=str(tmp_path / "cache"))
    outs, rows = [], []
    for name in ("miss", "hit"):
        cfg = twl.BurstSmokeConfig(**base, out_dir=str(tmp_path / name))
        outs.append(twl.run_burst_smoke(cfg, device="cpu"))
        assert ("CNN PE restored from cache" in capsys.readouterr().out) == (name == "hit")
        rows.append([r for r in map(json.loads, open(tmp_path / name / "burst_metrics.jsonl"))
                     if "pe_loss" not in r])
    assert outs[0] == outs[1]
    assert rows[0] == rows[1]  # every GAN-phase row: the same draws on a hit
    assert (tmp_path / "cache" / twl.burst_cnn_cache_tag(cfg) / "ckpt_4.pt").exists()


def _jax_tag(fn, cfg) -> str:
    """Evaluate the ``tag = (…)`` expression of a JAX workload on ``cfg``."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "tag")
    return eval(compile(ast.Expression(node.value), "<tag>", "eval"), {"cfg": cfg})


@pytest.mark.parametrize("kw", [{}, dict(seed=3, lr=2.5e-4, pe_ema_decay=0.0, pe_lr_decay=False,
                                        comb_pe_model=True, cnn_noise_frac=0.25)])
def test_bbh_cache_tag_is_the_reference_expression(kw):
    from gennet_tpu.cli import workloads as jwl

    got = twl.bbh_cnn_cache_tag(twl.BBHConfig(**kw))
    assert got == _jax_tag(jwl.run_bbh, jwl.BBHConfig(**kw))
    assert f"_cmb{int(kw.get('comb_pe_model', False))}" in got


@pytest.mark.parametrize("kw", [{}, dict(pe_noise_frac=0.0, pe_no_norm=False, per_sample_max=True,
                                        n_sig=0.5, lr=1e-3)])
def test_burst_cache_tag_is_the_reference_expression(kw):
    from gennet_tpu.cli import workloads as jwl

    got = twl.burst_cnn_cache_tag(twl.BurstSmokeConfig(**kw))
    assert got == _jax_tag(jwl.run_burst_smoke, jwl.BurstSmokeConfig(**kw))


# -------------------------------------------------------------- bank files

@pytest.fixture(scope="module")
def bank_rows():
    rng = np.random.default_rng(4)
    t = rng.normal(size=(20, 256)).astype(np.float32)
    p = {"mc": rng.uniform(20, 35, 20).astype(np.float32),
         "q": rng.uniform(0.5, 1.0, 20).astype(np.float32)}
    return t, p


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("ext", ["npz", "gntb"])
def test_bank_file_from_either_package_drives_run_bbh(tmp_path, bank_rows, writer, ext):
    t, p = bank_rows
    path = str(tmp_path / f"bank.{ext}")
    if ext == "npz":
        from gennet_tpu.data import lalinf_io as jio
        from gennet_tpu_torch.data import lalinf_io as tio

        (jio if writer == "jax" else tio).save_bank_npz(path, t, p)
    else:
        from gennet_tpu.data import bankstore as jbs
        from gennet_tpu_torch.data import bankstore as tbs

        (jbs if writer == "jax" else tbs).write_bank(path, t, p)
    cfg = _cfg(tmp_path / "run", bank_file=path, pe_iters=2, gan_iters=1, eval_cadence=100)
    bank, targets = twl._prepare_bbh_data(cfg, torch.Generator().manual_seed(0), "cpu")[:2]
    np.testing.assert_array_equal(bank.numpy(), t)  # every row: no event twin dropped
    np.testing.assert_array_equal(targets.numpy(), np.stack([p["mc"], p["q"]], -1))
    assert bank.dtype == targets.dtype == torch.float32
    out = twl.run_bbh(cfg, device="cpu")
    assert out["final_step"] == 1 and all(np.isfinite(out["pe_rms"]))


@pytest.mark.parametrize("ext", ["npz", "gntb"])
def test_make_bank_cli_writes_the_reference_schema(tmp_path, ext):
    path = str(tmp_path / "sub" / f"bank.{ext}")
    out = cli(["make-bank", "--device", "cpu", "-N", "40", "-f", "256", "-z", "3", "-b", path])
    assert out == {"templates": 40, "file": path}
    if ext == "npz":
        from gennet_tpu.data import lalinf_io as jio

        t, p = jio.load_bank_npz(path)
        # the keys, shapes and dtypes of the JAX CLI's file
        assert set(p) == {"m1", "m2", "mc", "eta", "M", "q", "idx"}
        assert all(v.shape == (40,) and v.dtype == np.float32 for k, v in p.items() if k != "idx")
        assert p["idx"].dtype == np.int32
        mc, q = p["mc"], p["q"]
    else:
        from gennet_tpu.data import bankstore as jbs

        with jbs.BankStore(path) as store:
            t, mc, q = np.array(store.templates), *np.array(store.params[:, :2]).T
            assert store.n_par == 7
    assert t.shape == (40, 256) and t.dtype == np.float32 and np.isfinite(t).all()
    # the hunt_constrain prior's box; the last row is the event twin
    assert ((mc >= 20) & (mc <= 35) & (q >= 0.5) & (q <= 1.0)).all()
    assert q[-1] == pytest.approx(29.0 / 36.0)


def test_make_bank_with_lalinf_dir_uses_the_products(tmp_path, products):
    d, prod = products
    plain, lal = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    cli(["make-bank", "--device", "cpu", "-N", "8", "-f", "256", "-b", plain])
    cli(["make-bank", "--device", "cpu", "-N", "8", "-f", "256", "-b", lal, "--lalinf-dir", d])
    a, b = np.load(plain)["templates"], np.load(lal)["templates"]
    # the products carry the analytic PSD: the same bank, scaled by their norm
    np.testing.assert_allclose(b, a * prod["norm_constant"], rtol=0,
                               atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("argv,exc,match", [
    # --data-parallel runs (at a world of 1); these cases keep the ids they
    # had while the flag was refused
    pytest.param(["make-bank", "--device", "cpu", "--data-parallel"], None, None,
                 id="argv0-NotImplementedError-queue 1 #11"),
    pytest.param(["train-gan", "--device", "cpu", "--data-parallel"], None, None,
                 id="argv1-NotImplementedError-queue 1 #11"),
    (["make-bank", "--device", "cuda"], RuntimeError, "cuda"),
    (["sample-posterior", "--device", "cuda"], RuntimeError, "cuda"),
])
def test_new_subcommands_refuse(tmp_path, argv, exc, match):
    if exc is None:
        _run_data_parallel_at_world1(tmp_path, argv[0])
        return
    if "cuda" in argv and torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    with pytest.raises(exc, match=match):
        cli([*argv, "-b" if argv[0] == "make-bank" else "--out-dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


def _run_data_parallel_at_world1(tmp_path, cmd):
    # one process, no torchrun: a world of 1. train-gan equals the run
    # without the flag bit for bit; make-bank writes the sharded bank (one
    # synthesis of -N rows, no event twin), as the reference's does
    if cmd == "make-bank":
        out = cli(["make-bank", "--device", "cpu", "-N", "6", "-f", "256", "-b",
                   str(tmp_path / "b.gntb"), "--data-parallel"])
        assert out == {"templates": 6, "file": str(tmp_path / "b.gntb")}
        return
    cfg = dict(TINY, pe_iters=0, eval_cadence=100, ckpt_every=100)
    outs = [cli(["train-gan", *_argv(dict(cfg, out_dir=str(tmp_path / d))), *extra])
            for d, extra in (("plain", []), ("dp", ["--data-parallel"]))]
    assert json.dumps(outs[0]) == json.dumps(outs[1])
    a, b = (_payload(str(tmp_path / d), "ckpt_gan", 4) for d in ("plain", "dp"))
    _assert_same(a, b)


# ---------------------------------------------------- lalinference products

@pytest.fixture(scope="module")
def products(tmp_path_factory):
    from gennet_tpu.data import synth_products as sp
    from gennet_tpu.data import template_bank as jtb

    d = str(tmp_path_factory.mktemp("prod"))
    sp.write_synthetic_products(d, seed=0, n_posterior=300, grid_grain=12,
                                cfg=jtb.BankConfig(fs=256))
    from gennet_tpu.data import lalinf_io as jio

    yield d, jio.load_event_products(d, fs=256, T_safe=4)
    shutil.rmtree(d, ignore_errors=True)


def test_lalinf_dir_branch_of_run_bbh(tmp_path, products):
    d, prod = products
    cfg = _cfg(tmp_path, lalinf_dir=d, pe_iters=2, gan_iters=2, eval_cadence=100,
               pe_cadence=100)
    _, _, signal, measured, norm, psd, truth, post = twl._prepare_bbh_data(
        cfg, torch.Generator().manual_seed(0), "cpu")
    assert truth == (30.0, 0.79)  # the event paper's point, as in the reference
    np.testing.assert_array_equal(measured.numpy(), prod["measured_whitened"])
    np.testing.assert_array_equal(signal.numpy(), prod["signal_whitened"])
    assert norm == prod["norm_constant"] and psd.shape == (513,)
    np.testing.assert_array_equal(post, prod["posterior_mc_q"])
    out = twl.run_bbh(cfg, device="cpu")
    # β against the products' posterior (no grid is built), never None
    assert out["beta"] is not None and 0.0 <= out["beta"] <= 1.0
    assert out["cnn_sanity_beta"] is not None and out["grid_overlap"] is None


# ------------------------------------------------------ comb_pe_model, g_norm

@pytest.mark.parametrize("g_norm,comb", [("group", True), ("none", False)])
def test_model_options_run_and_the_sampler_takes_the_norm(tmp_path, g_norm, comb):
    built = []

    def recording(*a, **kw):
        built.append(kw.get("norm", "batch"))
        return BBHGenerator(*a, **{**kw, "features": G_FEAT})

    cfg = _cfg(tmp_path, g_norm=g_norm, comb_pe_model=comb, posterior_drate=0.1, pe_iters=2,
               gan_iters=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twl, "BBHGenerator", recording)
        out = twl.run_bbh(cfg, device="cpu")
    assert built == [g_norm, g_norm]  # G and the posterior sampler
    assert out["final_step"] == 2 and all(np.isfinite(out["pe_rms"]))
    pe = _payload(str(tmp_path), "ckpt_pe", 2)["state"]["model"]
    assert any("prelu" in k for k in pe) == comb
    g = _payload(str(tmp_path), "ckpt_gan", 2)["state"]["generator"]
    assert not any("running" in k for k in g)


def test_g_norm_typo_is_refused(tmp_path):
    with pytest.raises(ValueError, match="g_norm"):
        twl.run_bbh(_cfg(tmp_path / "x", g_norm="grp"), device="cpu")
    assert not (tmp_path / "x").exists()


# -------------------------------------------------------- sample-posterior

def test_sample_posterior_writes_the_reference_schema(tmp_path, full_run, capsys):
    d_full, _ = full_run
    out_file = str(tmp_path / "post.npz")
    args = ["sample-posterior", "--device", "cpu", "--n-pix", "256", "--out-dir", d_full,
            "--n-samples", "16", "--out", out_file]
    out = cli(args)
    assert out == {"samples": 16, "file": out_file, "waveforms_key": "waveforms"}
    data = np.load(out_file)
    assert {k: data[k].shape for k in data.files} == {"samples": (16, 2), "waveforms": (16, 256)}
    assert np.isfinite(data["samples"]).all()
    again = np.load(cli([*args[:-1], str(tmp_path / "again.npz")])["file"])
    np.testing.assert_array_equal(again["samples"], data["samples"])  # seeded draws
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["samples"] == 16


def test_sample_posterior_route_renames_resampled_draws(tmp_path):
    # the routes synthesize at n_pix 1024: fresh states saved as a run's
    from gennet_tpu_torch.train import cnn as tcnn
    from gennet_tpu_torch.train import gan as tgan

    gcfg = tgan.GANConfig(n_pix=1024)
    gan = tgan.init_gan(torch.Generator().manual_seed(0), twl.BBHGenerator(n_out=1024),
                        twl.PairDiscriminator(n_pix=1024), gcfg, "cpu")
    pe = tcnn.init_cnn(torch.Generator().manual_seed(1), twl.DualBranchPE(n_pix=1024),
                       tcnn.CNNConfig(n_pix=1024), "cpu")
    with torch.no_grad():  # a PE head inside the prior's box
        pe.model.mc_dense.bias.fill_(28.0)
    CheckpointManager(str(tmp_path / "ckpt_gan")).save(1, gan)
    CheckpointManager(str(tmp_path / "ckpt_pe")).save(1, pe)
    out = cli(["sample-posterior", "--device", "cpu", "--out-dir", str(tmp_path), "--n-samples",
               "16", "--reweight-temper", "1.0", "--out", str(tmp_path / "post.npz")])
    assert out["waveforms_key"] == "waveforms_unpaired"
    data = np.load(tmp_path / "post.npz")
    assert {k: data[k].shape for k in data.files} == {"samples": (16, 2),
                                                      "waveforms_unpaired": (16, 1024)}


@pytest.mark.parametrize("flags,match", [
    (["--comb-pe-model", "true"], "comb_pe_model"),
    (["--pair-d", "false", "--res-loss-weight", "1"], "pair_d"),
    (["--g-norm", "group"], "g_norm"),
    (["--g-norm", "none"], "g_norm"),
    (["--n-pix", "256", "--pe-mlrc", "1"], "n_pix=256 with a posterior route"),
])
def test_sample_posterior_refuses_what_the_reference_cannot_run(tmp_path, flags, match):
    out_file = tmp_path / "post.npz"
    with pytest.raises(ValueError, match=match):
        cli(["sample-posterior", "--device", "cpu", "--out-dir", str(tmp_path / "none"),
             "--out", str(out_file), *flags])
    assert not out_file.exists() and not (tmp_path / "none").exists()


def test_sample_posterior_without_checkpoints_fails(tmp_path):
    with pytest.raises(FileNotFoundError, match="ckpt_gan"):
        cli(["sample-posterior", "--device", "cpu", "--n-pix", "256", "--out-dir",
             str(tmp_path), "--out", str(tmp_path / "post.npz")])
