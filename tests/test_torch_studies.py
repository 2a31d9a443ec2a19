"""The post-run studies (``gennet_tpu_torch/studies/``) against the JAX
package functions that their scripts (``scripts/*.py``) call, in the
scripts' order, on the same inputs made from numpy seeds, with JAX's
random draws (made from the scripts' keys) passed into the port.

(a) Arithmetic, each study's functions on their own: the route sweep and
    the library rows (``bbh_postproc_eval.py:131-207``), the ELBO stacks
    (``elbo_stack_eval.py:102-132``), the burst library study
    (``burst_pool_study.py:63-97``) and score battery
    (``burst_rescore_study.py:74-127``) on the sine-Gaussian forward
    model; the twin cue (``twin_cue_probe.py:64-90``) and the memorization
    families (``d_memorization_probe.py:67-132``) on tiny JAX-initialized
    G and D carried across with ``gennet_tpu_torch.convert``; one sampler
    cell (``bbh_sampler_calibration.py:89-101``); the burst diagnosis
    (``burst_debias_diag.py``) at n_pix 256.
(b) The slice as a whole: each study's ``main`` on tiny port run
    directories (the workload's own runs, with narrow G, D and PE) writes,
    or prints, rows with the JAX script's keys in its order.
(c) The scripts' faults, reproduced or refused, stated on both sides:
    the syntheses on ``tb.BankConfig()``, the sampler calibration's
    default models and ``ckpt_pe``, and the memorization probe's newest
    checkpoint (ROADMAP queue 3).

Tolerances (float32 sums in other orders on the two sides):
- β, grid overlap, ELBO, ESS and scores of the rows: rtol 1e-4, as in
  ``tests/test_torch_posterior_post.py``, plus one unit of the place the
  script rounds the row to (a value on a rounding boundary may round
  either way);
- D logits and the sampler cell's cloud: 1e-4·max|JAX|;
- the burst diagnosis (float64 grids, float32 forward model): rtol 1e-5.
"""

import functools
import importlib.util
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.eval import grid_posterior as jgp
from gennet_tpu.eval import overlap as jov
from gennet_tpu.eval import posterior_post as jpp
from gennet_tpu.eval.whiteness import posterior_whiteness as j_whiteness
from gennet_tpu.models import BBHGenerator as JG
from gennet_tpu.models import CombinedPE as JCPE
from gennet_tpu.models import PairDiscriminator as JD
from gennet_tpu.physics.burst import sine_gaussian as j_sg
from gennet_tpu.train import cnn as jcnn
from gennet_tpu.train import gan as jgan
from gennet_tpu_torch import convert
from gennet_tpu_torch.cli import workloads
from gennet_tpu_torch.eval import grid_posterior as tgp
from gennet_tpu_torch.eval import posterior_post as tpp
from gennet_tpu_torch.models import BBHGenerator, CombinedPE, PairDiscriminator
from gennet_tpu_torch.physics.burst import sine_gaussian as t_sg
from gennet_tpu_torch.studies import (bbh_postproc_eval, bbh_sampler_calibration,
                                      burst_debias_diag, burst_pool_study, burst_rescore_study,
                                      d_memorization_probe, elbo_stack_eval, twin_cue_probe)
from gennet_tpu_torch.train import cnn as tcnn
from gennet_tpu_torch.train import gan as tgan

N_PIX, GRAIN, N_SIG = 512, 25, 0.25
# reference draws (the studies' 3907) and library candidates (select_final_cloud's
# 4000): β's KDE of each is the tests' main cost
N_REF, N_OUT = 300, 500
TRUTH = np.array([0.5, 1.0 / 25.0])
BURST_BOUNDS = ((0.25, 0.75), (1.0 / 60.0, 1.0 / 15.0))
TGRID = np.arange(N_PIX) / 512.0


def j_synth(s):
    s = jnp.asarray(s)
    return j_sg(s[:, 0], s[:, 1], N=N_PIX)


def t_synth(s):
    s = torch.as_tensor(s, dtype=torch.float32)
    return t_sg(s[:, 0], s[:, 1], N=N_PIX)


def moment_estimator(w):
    """A closed-form (t0, τ) estimator standing in for the CNN (the one of
    tests/test_posterior_post.py)."""
    w2 = np.asarray(w, np.float64) ** 2
    p = w2 / (w2.sum(axis=1, keepdims=True) + 1e-30)
    t0 = p @ TGRID
    m2 = (p * (TGRID[None, :] - t0[:, None]) ** 2).sum(axis=1)
    return np.column_stack([t0, 2.0 * np.sqrt(np.maximum(m2, 1e-12))]).astype(np.float32)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _uniform(key):
    return float(jax.random.uniform(key, ()))


def _event(seed):
    rng = np.random.default_rng(seed)
    measured = np.asarray(j_synth(TRUTH[None, :])[0]) + N_SIG * rng.normal(size=N_PIX)
    return measured.astype(np.float32), rng


def _cloud(rng, n, shift=(0.0, 0.0), spread=(0.002, 0.003)):
    c = TRUTH[None, :] + np.asarray(shift) + rng.normal(0, spread, (n, 2))
    c[:, 1] = np.clip(c[:, 1], 0.02, 0.06)
    return c.astype(np.float64)


def _grid(measured):
    """(JAX grid, port grid): the exact burst grid of ``measured``."""
    jL, jx, jy = jgp.burst_grid_posterior(jnp.asarray(measured), N_SIG, GRAIN)
    return (np.asarray(jL), np.asarray(jx), np.asarray(jy)), tgp.burst_grid_posterior(
        torch.tensor(measured), N_SIG, GRAIN)


def _load_script(name):
    """``scripts/<name>.py`` as a module (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_study_{name}", Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(out, ref, places=None, rtol=1e-4):
    """rtol, plus one unit of the place a row rounds to."""
    atol = 0.0 if places is None else 10.0 ** -places
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def _close_rows(rows, ref_rows, places):
    """Rows with the same keys in order; numbers at ``places`` (key → the
    place the script rounds it to), everything else equal."""
    assert [list(r) for r in rows] == [list(r) for r in ref_rows]
    for row, ref in zip(rows, ref_rows):
        for k, v in ref.items():
            if k in places and v is not None:
                _close(row[k], v, places[k])
            else:
                assert row[k] == v, (k, row[k], v)


def _select_draws(key, n_pool, n_out=4000):
    """The draws ``select_final_cloud`` takes from ``key``
    (posterior_post.py's splits), for a pool of ``n_pool`` rows."""
    k1, k2, _ = jax.random.split(key, 3)
    _, kk = jax.random.split(key)
    ki, kj, kr = jax.random.split(kk, 3)

    def smoothed(k):
        ku, kn = jax.random.split(k)
        return {"u0": _uniform(ku), "jitter": _normal(kn, (n_out, 2))}

    return {"plat_is": smoothed(k2), "pool_is": smoothed(k1),
            "kde_is": {"idx": np.asarray(jax.random.randint(ki, (16384,), 0, n_pool)),
                       "normal": _normal(kj, (16384, 2)), "u0": _uniform(kr)}}


# ---- (a) bbh_postproc_eval ---------------------------------------------------

ROW_PLACES = {"beta": 4, "grid_overlap": 4, "elbo": 2, "ess": 1, "pool_ess": 1, "kde_ess": 1,
              "elbo_se": 3}


def _jax_score(s, ref, grid):
    return (jov.beta_overlap(s, ref) if s[:, 0].var() > 0 else 0.0,
            jgp.grid_overlap_score(s, *grid))


def test_postproc_routes_match():
    measured, rng = _event(0)
    cloud = _cloud(rng, 300, shift=(0.001, 0.004))
    (jgrid, tgrid) = _grid(measured)
    ref = jgp.sample_grid_posterior(*jgrid, N_REF, seed=0)
    n = cloud.shape[0]
    # the script's routes and rows (bbh_postproc_eval.py:131-170), key PRNGKey(seed + 77)
    key = jax.random.PRNGKey(77)
    k1, k2, k3, k4, key = jax.random.split(key, 5)
    jr = {"raw": cloud}
    jr["debias1"] = jpp.self_calibrate(cloud, j_synth, moment_estimator, k1, N_SIG, rounds=1)
    jr["debias2"] = jpp.self_calibrate(cloud, j_synth, moment_estimator, k2, N_SIG, rounds=2)
    jr["bootcal"] = jpp.bootstrap_calibrate(cloud, j_synth, moment_estimator, k3, N_SIG)
    jr["debias1_bootcal"] = jpp.bootstrap_calibrate(jr["debias1"], j_synth, moment_estimator,
                                                    k4, N_SIG)
    km, kmr, key = jax.random.split(key, 3)
    jr["mlrc"] = jpp.ml_recenter(cloud, j_synth, measured, km)
    jr["mlrc_reweight1"] = jpp.likelihood_resample(jr["mlrc"], j_synth, measured, N_SIG, kmr,
                                                   temper=1.0)
    kr, kr5, key = jax.random.split(key, 3)
    jr["reweight1"] = jpp.likelihood_resample(cloud, j_synth, measured, N_SIG, kr, temper=1.0)
    jr["reweight05"] = jpp.likelihood_resample(cloud, j_synth, measured, N_SIG, kr5, temper=0.5)
    ess = {t: round(jpp.effective_sample_size(cloud, j_synth, measured, N_SIG, temper=t), 1)
           for t in (1.0, 0.5)}
    ref_rows = []
    for name, s in jr.items():
        b, g = _jax_score(np.asarray(s), ref, jgrid)
        e = jpp.elbo_score(np.asarray(s), j_synth, measured, N_SIG)
        row = {"run": "r", "route": name, "beta": round(float(b), 4),
               "grid_overlap": round(float(g), 4),
               "elbo": round(float(e), 2) if np.isfinite(e) else None, "cloud": "c.npz"}
        if name.startswith("reweight"):
            row["ess"] = ess[1.0 if name == "reweight1" else 0.5]
        ref_rows.append(row)

    def rounds(k, r):
        out = []
        for _ in range(r):
            k, kn = jax.random.split(k)
            out.append(_normal(kn, (n, N_PIX)))
        return np.stack(out)

    draws = {"debias1": {"noise": rounds(k1, 1)}, "debias2": {"noise": rounds(k2, 2)},
             "bootcal": {"noise": _normal(k3, (n, N_PIX))},
             "debias1_bootcal": {"noise": _normal(k4, (n, N_PIX))},
             "mlrc": {"jitter": _normal(km, (4, 2))}, "mlrc_reweight1": {"u0": _uniform(kmr)},
             "reweight1": {"u0": _uniform(kr)}, "reweight05": {"u0": _uniform(kr5)}}
    routes, t_ess = bbh_postproc_eval.route_clouds(cloud, t_synth, moment_estimator, measured,
                                                    N_SIG, None, draws=draws)
    assert list(routes) == list(jr)
    rows = bbh_postproc_eval.route_rows("r", "c.npz", routes, t_ess, t_synth, measured, N_SIG,
                                        tgp.sample_grid_posterior(*tgrid, N_REF, seed=0), tgrid)
    _close_rows(rows, ref_rows, ROW_PLACES)


@pytest.fixture
def small_library(monkeypatch):
    """select_final_cloud's resampled candidates at N_OUT rows (4000)."""
    monkeypatch.setattr(tpp, "select_final_cloud",
                        functools.partial(tpp.select_final_cloud, n_out=N_OUT))


def test_postproc_library_rows_match(small_library, monkeypatch):
    measured, rng = _event(1)
    lib = {st: _cloud(rng, 300, spread=(0.0015, 0.002)) for st in (1000, 2000, 3000)}
    jgrid, tgrid = _grid(measured)
    ref = jgp.sample_grid_posterior(*jgrid, N_REF, seed=1)
    # bbh_postproc_eval.py:176-207 (the burst grid's box stands in for the (mc, q) box)
    ksel = jax.random.PRNGKey(5)
    sel, chosen, info = jpp.select_final_cloud(lib, j_synth, measured, N_SIG, ksel,
                                               bounds=BURST_BOUNDS, n_out=N_OUT)
    ref_rows = []
    for cname, ccloud in info["candidates"].items():
        b, g = _jax_score(np.asarray(ccloud), ref, jgrid)
        e = info["scores"][cname]
        row = {"run": "r", "route": f"library:{cname}", "beta": round(float(b), 4),
               "grid_overlap": round(float(g), 4),
               "elbo": round(float(e), 2) if np.isfinite(e) else None,
               "chosen": cname == sel, "plateau_k": len(info["plateau_members"]),
               "pool_ess": round(info["pool_ess"], 1),
               "kde_ess": round(info.get("kde_ess", 0.0), 1)}
        se = info.get("score_ses", {}).get(cname)
        if se is not None and np.isfinite(se):
            row["elbo_se"] = round(float(se), 3)
        if cname == sel and "tiebreak" in info:
            row["tiebreak"] = {k: round(v, 4) if isinstance(v, float) else v
                               for k, v in info["tiebreak"].items()}
        ref_rows.append(row)
    monkeypatch.setattr(workloads, "BBH_BOUNDS", BURST_BOUNDS)
    rows = bbh_postproc_eval.library_rows(
        "r", lib, t_synth, measured, N_SIG, None, tgp.sample_grid_posterior(*tgrid, N_REF, seed=1),
        tgrid, draws=_select_draws(ksel, 900, N_OUT))
    tie = [r.pop("tiebreak", None) for r in rows], [r.pop("tiebreak", None) for r in ref_rows]
    assert [t is None for t in tie[0]] == [t is None for t in tie[1]]
    _close_rows(rows, ref_rows, ROW_PLACES)


# ---- (a) elbo_stack_eval ----------------------------------------------------

def _jax_stack(clouds, elbo_by_step, ks, measured, ref, grid, seed):
    """elbo_stack_eval.py:102-132 on the JAX package's functions."""
    ranked = sorted(clouds, key=lambda s: -elbo_by_step[s])
    rows, best = [], None
    for k in ks:
        if k > len(ranked):
            continue
        pool = np.concatenate([clouds[s] for s in ranked[:k]], axis=0)
        if len(pool) > 8000:
            idx = np.random.default_rng(seed).choice(len(pool), 8000, replace=False)
            pool = pool[idx]
        beta = jov.beta_overlap(pool, ref) if pool[:, 0].var() > 0 else 0.0
        go = jgp.grid_overlap_score(pool, *grid)
        e = jpp.elbo_score(pool, j_synth, measured, N_SIG)
        row = {"run": "r", "k": k, "steps": ranked[:k], "beta": round(float(beta), 4),
               "grid_overlap": round(float(go), 4),
               "elbo_pooled": round(float(e), 2) if np.isfinite(e) else None}
        rows.append(row)
        if best is None or (row["elbo_pooled"] is not None
                            and row["elbo_pooled"] > best["elbo_pooled"]):
            best = row
    return rows, best


def test_elbo_stack_rows_match(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    measured, rng = _event(2)
    # three clouds of 2700 rows: the pool of K = 3 is cut to 8000 rows
    clouds = {st: _cloud(rng, 2700, shift=(0.0, 0.002 * i), spread=(0.002, 0.002))
              for i, st in enumerate((500, 1000, 1500))}
    elbo_by_step = {500: -300.5, 1000: -290.25, 1500: -310.0}
    jgrid, tgrid = _grid(measured)
    ks = [1, 3, 50]
    ref_rows, ref_best = _jax_stack(clouds, elbo_by_step, ks, measured,
                                    jgp.sample_grid_posterior(*jgrid, N_REF, seed=2), jgrid, 2)
    rows, best = elbo_stack_eval.stack_rows("r", clouds, elbo_by_step, ks, t_synth, measured,
                                            N_SIG, tgp.sample_grid_posterior(*tgrid, N_REF, seed=2),
                                            tgrid, 2)
    assert [r["k"] for r in rows] == [1, 3]   # K 50 > 3 clouds: skipped, as in the script
    _close_rows(rows, ref_rows, {"beta": 4, "grid_overlap": 4, "elbo_pooled": 2})
    assert best["k"] == ref_best["k"]
    assert [json.loads(x)["k"] for x in open(elbo_stack_eval.OUT)] == [1, 3]


def test_elbo_stack_best_k_comparison_is_the_scripts(tmp_path, monkeypatch):
    # elbo_stack_eval.py:129-131 (ADVICE.md): a first K whose pooled ELBO is
    # not finite leaves None as the best; a later finite one then compares
    # a float with None. The port keeps the comparison (ROADMAP queue 3).
    monkeypatch.chdir(tmp_path)
    measured, rng = _event(3)
    clouds = {1: _cloud(rng, 200), 2: _cloud(rng, 200)}
    clouds[1][:, 1] = -1.0   # τ < 0: every template of cloud 1 overflows to inf

    def synth(s):
        wf = t_synth(s)
        return torch.where(torch.as_tensor(s)[:, 1:2] < 0, torch.inf, wf)

    jgrid, tgrid = _grid(measured)
    with pytest.raises(TypeError):
        elbo_stack_eval.stack_rows("r", clouds, {1: 0.0, 2: -1.0}, [1, 2], synth, measured, N_SIG,
                                   tgp.sample_grid_posterior(*tgrid, 100, seed=0), tgrid, 0)
    with pytest.raises(TypeError):   # the script's own comparison, with its first row's None
        best = {"elbo_pooled": None}
        row = {"elbo_pooled": -1.0}
        assert best is None or (row["elbo_pooled"] is not None
                                and row["elbo_pooled"] > best["elbo_pooled"])


# ---- (a) the D probes and the sampler cell, on tiny JAX-initialized nets ------

G_FEAT, D_FEAT, PE_FEAT = (16, 16, 32, 32, 64), (16, 32), (8, 8, 16, 16)
NP = 64


def _nets(norm, pair, seed):
    """Tiny G and D initialized by the JAX package's init_gan (BatchNorm
    statistics moved off their init), and the port's twins carrying the
    same weights: (JAX G, JAX D, JAX cfg, JAX state, port G, port cfg,
    port state)."""
    jg, jd = JG(n_out=NP, features=G_FEAT, norm=norm), JD(features=D_FEAT)
    jcfg = jgan.GANConfig(n_pix=NP, pair_discriminator=pair)
    js = jgan.init_gan(jax.random.PRNGKey(seed), jg, jd, jcfg)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.3 * np.abs(
        rng.normal(size=np.shape(x))).astype(np.float32), js.g_stats)
    js = js.replace(g_stats=stats)
    tg = BBHGenerator(n_out=NP, features=G_FEAT, norm=norm)
    td = PairDiscriminator(features=D_FEAT, n_pix=NP, in_ch=2 if pair else 1)
    tcfg = tgan.GANConfig(n_pix=NP, pair_discriminator=pair)
    ts = tgan.init_gan(torch.Generator().manual_seed(0), tg, td, tcfg, "cpu")
    tg.load_state_dict(convert.flax_to_torch_generator(js.g_params, stats or None))
    td.load_state_dict(convert.flax_to_torch_discriminator(js.d_params))
    return jg, jd, jcfg, js, tg, tcfg, ts


def _latents(key, n, jcfg):
    """sample_generator's latents from ``key`` (train/gan.py's splits)."""
    zs = []
    for _ in range(-(-n // 256)):
        key, kz, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.uniform(kz, (256, jcfg.latent_dim),
                                                minval=jcfg.latent_low, maxval=jcfg.latent_high)))
    return np.concatenate(zs)


def test_twin_cue_matches():
    jg, jd, jcfg, js, tg, tcfg, ts = _nets("group", False, 3)
    rng = np.random.default_rng(4)
    bank = rng.normal(size=(40, NP)).astype(np.float32)
    signal = rng.normal(size=NP).astype(np.float32)
    # twin_cue_probe.py:64-90
    k_idx, k_z = jax.random.split(jax.random.PRNGKey(123))
    ridx = jax.random.randint(k_idx, (256,), 0, bank.shape[0])
    gz = jgan.sample_generator(jg, js, k_z, 256, jcfg, dropout=False,
                               bn_mode="eval").reshape(256, -1)

    def score(x2d):
        return np.asarray(jd.apply({"params": js.d_params}, x2d[..., None],
                                   train=False)).reshape(-1)

    l_bank, l_sig = score(jnp.asarray(bank)[ridx]), score(
        jnp.broadcast_to(jnp.asarray(signal)[None, :], (256, NP)))
    l_gz = score(gz)
    penalty = float(l_bank.mean() - l_sig.mean())
    out = twin_cue_probe.twin_cue(tg, ts, tcfg, torch.tensor(bank), torch.tensor(signal), None,
                                  idx=np.asarray(ridx), z=_latents(k_z, 256, jcfg))
    scale = 1e-4 * max(np.abs(x).max() for x in (l_bank, l_sig, l_gz))
    for k, ref in (("logit_bank", l_bank.mean()), ("logit_signal", l_sig.mean()),
                   ("logit_g", l_gz.mean()), ("twin_penalty", penalty)):
        np.testing.assert_allclose(out[k], ref, rtol=0, atol=scale, err_msg=k)
    assert twin_cue_probe.verdict(out["twin_penalty"]) == (
        f"twin_penalty = {penalty:+.3f} "
        f"({'anti-truth cue present' if penalty > 0.5 else 'cue absent'})")


def test_memorization_families_match():
    jg, jd, jcfg, js, tg, tcfg, ts = _nets("batch", True, 5)
    rng = np.random.default_rng(6)
    bank = rng.normal(size=(40, NP)).astype(np.float32)
    signal = rng.normal(size=NP).astype(np.float32)
    measured = (signal + 0.7 * rng.normal(size=NP)).astype(np.float32)
    n_sig, B = 1.0, d_memorization_probe.B
    # d_memorization_probe.py:67-132
    k_idx, k_f1, k_f2, k_f3, k_z = jax.random.split(jax.random.PRNGKey(123), 5)
    ridx = jax.random.randint(k_idx, (B,), 0, bank.shape[0])
    tmpl = jnp.asarray(bank)[ridx]
    f1 = jax.random.normal(k_f1, tmpl.shape) * n_sig
    f2 = jax.random.normal(k_f2, (B, NP)) * n_sig
    f3 = jax.random.normal(k_f3, (B, NP)) * n_sig
    gz = jgan.sample_generator(jg, js, k_z, B, jcfg, dropout=False, bn_mode="eval").reshape(B, -1)
    sig = jnp.broadcast_to(jnp.asarray(signal)[None, :], (B, NP))
    meas = jnp.broadcast_to(jnp.asarray(measured)[None, :], (B, NP))
    true_res = np.asarray(meas[0] - sig[0])
    k_p, k_f4 = jax.random.split(jax.random.PRNGKey(7))
    perm = jax.random.permutation(k_p, NP)
    shuf = jnp.broadcast_to(jnp.asarray(true_res)[perm][None, :], (B, NP))
    f4 = jax.random.normal(k_f4, (B, NP)) * float(true_res.std())
    pair = lambda a, b: jnp.stack([a, b], axis=-1)  # noqa: E731
    xs = [pair(tmpl, f1), pair(sig, meas - sig), pair(sig, f2), pair(sig, f4), pair(sig, shuf),
          pair(gz, meas - gz), pair(gz, f3)]
    ref = {}
    for name, x in zip(d_memorization_probe.FAMILIES, xs):
        logits = np.asarray(jd.apply({"params": js.d_params}, x, train=False)).reshape(-1)
        ref[name] = logits
    draws = {"idx": np.asarray(ridx), "fresh1": np.asarray(f1) / n_sig,
             "fresh2": np.asarray(f2) / n_sig, "fresh3": np.asarray(f3) / n_sig,
             "z": _latents(k_z, B, jcfg), "perm": np.asarray(perm),
             "fresh4": _normal(k_f4, (B, NP))}
    pairs, true_std = d_memorization_probe.families(
        tg, ts, tcfg, torch.tensor(bank), torch.tensor(signal), torch.tensor(measured), n_sig,
        None, None, draws=draws)
    np.testing.assert_allclose(true_std, float(true_res.std()), rtol=1e-6)
    stats = d_memorization_probe.family_stats(ts, pairs)
    assert list(stats) == list(d_memorization_probe.FAMILIES)
    scale = 1e-4 * max(np.abs(v).max() for v in ref.values())
    for name, (mean, p, frac) in stats.items():
        logits = ref[name]
        np.testing.assert_allclose(mean, logits.mean(), rtol=0, atol=scale, err_msg=name)
        np.testing.assert_allclose(p, (1 / (1 + np.exp(-logits))).mean(), rtol=0, atol=scale)
        assert frac == (logits > 0).mean(), name
    results = {name.split()[0]: float(ref[name].mean()) for name in ref}
    assert d_memorization_probe.verdict({k: v[0] for k, v in zip(
        results, stats.values())}) == _script_verdict(results)


def _script_verdict(results):
    """d_memorization_probe.py:120-132's branch, by its first words."""
    if results["B"] < 0 and results["C"] > 0 and results["C2"] < 0:
        return d_memorization_probe.verdict({"B": -1, "C": 1, "C2": -1})
    if results["B"] < 0 and results["C2"] > 0:
        return d_memorization_probe.verdict({"B": -1, "C": 0, "C2": 1})
    return "Mixed cue: see per-family logits above."


def test_memorization_verdicts_are_the_scripts():
    v = d_memorization_probe.verdict
    assert v({"B": -4.87, "C": 0.5, "C2": -1.0}).startswith("VARIANCE CUE: B (true residual)")
    assert v({"B": -4.87, "C": -0.09, "C2": 0.2}).startswith("MEMORIZATION CONFIRMED: fresh")
    assert v({"B": 1.0, "C": -0.09, "C2": 0.2}) == "Mixed cue: see per-family logits above."


def test_sampler_cell_matches():
    jg, jd, jcfg, js, tg, tcfg, ts = _nets("batch", True, 7)
    jpe = JCPE(features=PE_FEAT)
    pe_cfg = jcnn.CNNConfig(n_pix=NP)
    jpe_state = jcnn.init_cnn(jax.random.PRNGKey(8), jpe, pe_cfg)
    tpe = CombinedPE(n_pix=NP, features=PE_FEAT)
    tpe_state = tcnn.init_cnn(torch.Generator().manual_seed(0), tpe, tcnn.CNNConfig(n_pix=NP),
                              "cpu")
    tpe.load_state_dict(convert.flax_to_torch_combined_pe(jpe_state.params,
                                                          jpe_state.stats))
    n, pn, n_sig = 256, 0.5, 0.8
    # bbh_sampler_calibration.py:89-93, the cell (batch, no dropout, 0.5)
    _, kz, kn = jax.random.split(jax.random.PRNGKey(9), 3)
    wf = jgan.sample_generator(jg, js, kz, n, jcfg, dropout=False, bn_mode="batch")
    noise = jax.random.normal(kn, wf.shape, wf.dtype)
    ref = np.asarray(jcnn.predict(jpe, jpe_state, wf + pn * n_sig * noise))
    s = bbh_sampler_calibration.cell_cloud(tg, ts, tcfg, tpe_state, n, "batch", False, pn, n_sig,
                                           None, z=_latents(kz, n, jcfg), noise=np.asarray(noise))
    assert s.shape == ref.shape == (n, 2)
    np.testing.assert_allclose(s, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    # its row, on a grid posterior about the cloud
    mu, sd = ref.mean(0) + ref.std(0), ref.std(0)   # a posterior one σ off the cloud
    gx, gy = (np.linspace(mu[i] - 4 * sd[i], mu[i] + 4 * sd[i], 21) for i in (0, 1))
    L = np.exp(-0.5 * (((gx[None, :] - mu[0]) / sd[0]) ** 2 + ((gy[:, None] - mu[1]) / sd[1]) ** 2))
    ref_samples = jgp.sample_grid_posterior(L, gx, gy, 500, seed=0)
    gm = jgp.grid_moments(L, gx, gy)
    row = bbh_sampler_calibration.cell_row(s, "batch", False, pn, ref_samples, (L, gx, gy), gm)
    want = {"bn_mode": "batch", "dropout": False, "posterior_noise": pn,
            "beta": jov.beta_overlap(ref, ref_samples),
            "grid_overlap": jgp.grid_overlap_score(ref, L, gx, gy),
            "bias_mc": (ref[:, 0].mean() - gm[0]) / max(gm[2], 1e-12),
            "disp_mc": ref[:, 0].std() / max(gm[2], 1e-12),
            "disp_q": ref[:, 1].std() / max(gm[3], 1e-12)}
    assert list(row) == list(want)
    for k in ("beta", "grid_overlap", "bias_mc", "disp_mc", "disp_q"):
        _close(row[k], want[k])
    assert list(bbh_sampler_calibration.rounded(row)) == list(want)
    assert len(bbh_sampler_calibration.CELLS) == 16


# ---- (a) the burst studies -----------------------------------------------------

def test_burst_pool_row_matches(small_library):
    measured, rng = _event(4)
    clouds = {250 * (i + 1): _cloud(rng, 300, shift=(0.0005 * i, 0.0), spread=(0.001, 0.002))
              for i in range(3)}
    clouds[1000] = np.full((300, 2), TRUTH)   # collapsed: left out, as in the script
    jgrid, tgrid = _grid(measured)
    # burst_pool_study.py:49-97, key PRNGKey(seed + 7)
    key = jax.random.PRNGKey(4 + 7)
    live = {s: c for s, c in clouds.items() if c[:, 0].var() > 0 and c[:, 1].var() > 0}
    name, chosen, info = jpp.select_final_cloud(live, j_synth, measured, N_SIG, key,
                                                bounds=BURST_BOUNDS, n_out=N_OUT)
    per = {s: jpp.elbo_score(c, j_synth, measured, N_SIG) for s, c in live.items()}
    plat, _ = jpp.plateau_pool(live, per, delta=0.1)
    pool = np.concatenate(list(live.values()), axis=0)
    rows = {}
    for cand, c in (("argmax", live[info["argmax_step"]]), ("plateau", plat), ("pool", pool)):
        rows[cand] = {"elbo": round(float(info["scores"][cand]), 2)
                      if cand in info["scores"] else None,
                      "overlap": round(float(jgp.grid_overlap_score(c, *jgrid)), 4),
                      "n": int(c.shape[0])}
    ov_chosen = float(jgp.grid_overlap_score(chosen, *jgrid))
    ref = {"run": "d", "argmax_step": info["argmax_step"],
           "plateau_k": len(info["plateau_members"]), "pool_ess": round(info["pool_ess"], 1),
           "kde_ess": round(info.get("kde_ess", 0.0), 1),
           "scores": {k: round(v, 2) for k, v in info["scores"].items()},
           "candidates": rows, "chosen": name, "chosen_overlap": round(ov_chosen, 4)}
    rows[name] = {"overlap": round(ov_chosen, 4)}
    out = burst_pool_study.pool_row("d", clouds, t_synth, measured, N_SIG, tgrid, None,
                                    draws=_select_draws(key, 900, N_OUT))
    assert list(out) == list(ref)
    for k in ("run", "argmax_step", "plateau_k", "chosen"):
        assert out[k] == ref[k], k
    for k, places in (("pool_ess", 1), ("kde_ess", 1), ("chosen_overlap", 4)):
        _close(out[k], ref[k], places)
    assert list(out["scores"]) == list(ref["scores"])
    _close([out["scores"][k] for k in ref["scores"]], list(ref["scores"].values()), 2)
    assert {k: list(v) for k, v in out["candidates"].items()} == {
        k: list(v) for k, v in ref["candidates"].items()}
    for cand, v in ref["candidates"].items():
        _close(out["candidates"][cand]["overlap"], v["overlap"], 4)
        if v.get("elbo") is not None:
            _close(out["candidates"][cand]["elbo"], v["elbo"], 2)


def _script_rescore_row(spearman, clouds, rows, grid):
    """burst_rescore_study.py:90-119 on per-cloud ``rows``."""
    ov = np.array([r["overlap"] for r in rows])
    out = {"run": "d", "n": len(rows)}
    for name in ("elbo_g", "elbo_k", "mlogl", "white", "w_elbo"):
        v = np.array([r[name] for r in rows])
        finite = np.isfinite(v)
        if not finite.any():
            continue
        rho = spearman(v[finite], ov[finite])
        best = int(np.argmax(np.where(finite, v, -np.inf)))
        mx = v[best]
        members = [r["step"] for r, vi, f in zip(rows, v, finite)
                   if f and vi >= mx - 0.1] or [rows[best]["step"]]
        pool = np.concatenate([clouds[s] for s in members], axis=0)
        sg = jgp.grid_overlap_score(pool, *grid)
        out[name] = {"spearman": round(rho, 3), "argmax_step": rows[best]["step"],
                     "argmax_overlap": round(rows[best]["overlap"], 4),
                     "stack_overlap": round(float(sg), 4), "stack_k": len(members)}
    out["best_overlap"] = round(float(ov.max()), 4)
    out["final_overlap"] = round(float(ov[-1]), 4)
    return out


def test_burst_rescore_row_matches():
    measured, rng = _event(5)
    clouds = {250 * (i + 1): _cloud(rng, 300, shift=(0.001 * (i - 1), 0.003 * (i - 1)))
              for i in range(4)}
    # two tight clouds whose mean residual is white: w_elbo finite on them
    # only, and white's plateau holds both
    clouds[1125] = _cloud(rng, 300, spread=(1e-5, 1e-5))
    clouds[1150] = _cloud(rng, 300, shift=(2e-4, 0.0), spread=(1e-4, 1e-4))
    clouds[1250] = np.column_stack([np.full(300, 0.5), rng.uniform(0.03, 0.05, 300)])
    jgrid, tgrid = _grid(measured)
    # burst_rescore_study.py:74-89
    jrows = []
    for step, s in clouds.items():
        if s[:, 0].var() <= 0 or s[:, 1].var() <= 0:
            continue
        wf = np.asarray(j_synth(s))
        ws = j_whiteness(measured / N_SIG, wf.mean(axis=0, keepdims=True) / N_SIG, 1.0)
        eg = jpp.elbo_score(s, j_synth, measured, N_SIG)
        ek = jpp.elbo_score(s, j_synth, measured, N_SIG, entropy="knn")
        d = measured[None, :] - wf
        jrows.append({"step": step, "elbo_g": eg, "elbo_k": ek,
                      "mlogl": float(np.mean(-0.5 * np.sum(d**2, axis=1) / N_SIG**2)),
                      "white": ws["overall"],
                      "w_elbo": eg if ws["overall"] >= 0.5 else float("-inf"),
                      "overlap": float(jgp.grid_overlap_score(s, *jgrid))})
    trows = burst_rescore_study.cloud_scores(clouds, t_synth, torch.tensor(measured), N_SIG,
                                             tgrid)
    assert [r["step"] for r in trows] == [r["step"] for r in jrows] == [
        250, 500, 750, 1000, 1125, 1150]
    for tr, jr in zip(trows, jrows):
        assert list(tr) == list(jr)
        for k in ("elbo_g", "elbo_k", "mlogl", "overlap"):
            _close(tr[k], jr[k])
        assert tr["white"] == jr["white"]
    assert [r["white"] >= 0.5 for r in jrows] == [False] * 4 + [True] * 2
    # the run's row (:90-119), on all the clouds and on the four loose ones
    # (w_elbo −inf on each: the score is left out), against the script's
    # arithmetic on the JAX rows with the script's own spearman
    spearman = _load_script("burst_rescore_study").spearman
    for n in (6, 4):
        out = burst_rescore_study.rescore_row("d", clouds, trows[:n], tgrid)
        ref = _script_rescore_row(spearman, clouds, jrows[:n], jgrid)
        assert list(out) == list(ref)
        assert ("w_elbo" in out) == (n == 6)
        for name in (k for k in burst_rescore_study.SCORES if k in ref):
            assert list(out[name]) == list(ref[name])
            assert (out[name]["argmax_step"], out[name]["stack_k"]) == (
                ref[name]["argmax_step"], ref[name]["stack_k"])
            _close(out[name]["spearman"], ref[name]["spearman"], 3)
            for k in ("argmax_overlap", "stack_overlap"):
                _close(out[name][k], ref[name][k], 4)
        for k in ("best_overlap", "final_overlap"):
            _close(out[k], ref[k], 4)
    assert out["white"]["stack_k"] == 4 and ref["white"]["stack_k"] == 4
    assert burst_rescore_study.spearman([1, 2, 3], [3, 2, 1]) == -1.0


def test_burst_debias_diag_matches():
    n_pix, grain = 256, 31
    measured = {}
    for seed in (0, 1, 2):
        _, _, k_noise, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
        measured[seed] = np.asarray(j_sg(0.5, 1.0 / 25.0, N=n_pix)
                                    + 0.25 * jax.random.normal(k_noise, (n_pix,)))
    jitter = _normal(jax.random.PRNGKey(9), (4, 2))
    out = burst_debias_diag.diagnose({s: torch.tensor(m) for s, m in measured.items()},
                                     n_pix=n_pix, grain=grain, jitter=jitter)
    # burst_debias_diag.py, on the JAX package's functions at n_pix 256
    for seed, m in measured.items():
        L, gx, gy = jgp.burst_grid_posterior(jnp.asarray(m), 0.25, grain)
        mx, my, sx, sy = jgp.grid_moments(L, gx, gy)
        np.testing.assert_allclose(out["seeds"][seed]["moments"], (mx, my, sx, sy), rtol=1e-5)
        Ln = np.asarray(L, np.float64)
        Ln /= Ln.sum()
        assert out["seeds"][seed]["tau_nodes"] == int((Ln.sum(axis=1) > 0.01).sum())
        if seed == 1:
            rng = np.random.default_rng(0)
            b_t0, b_tau, d_t0, d_tau = -1093.28, -4.30, 1829.88, 0.5656
            cloud = np.stack([mx + b_t0 * sx + rng.normal(0, d_t0 * sx, 1000),
                              my + b_tau * sy + rng.normal(0, abs(d_tau) * sy, 1000)], -1)
            row = out["seeds"][1]
            np.testing.assert_allclose(row["reconstructed"],
                                       jgp.grid_overlap_score(cloud, L, gx, gy), rtol=1e-5)
            cloud_db = cloud - cloud.mean(0) + np.array([mx, my])
            np.testing.assert_allclose(row["oracle"], jgp.grid_overlap_score(cloud_db, L, gx, gy),
                                       rtol=1e-5)
            x = np.arange(n_pix)[None, :] / 512.0 - cloud[:, 0:1]
            templ = np.sin(2 * np.pi * 100.0 * x + 2 * np.pi) * np.exp(-(x**2) / cloud[:, 1:2]**2)
            logl = -0.5 * np.sum(((np.asarray(m, np.float64)[None, :] - templ) / 0.25) ** 2, -1)
            for temper in (1.0, 0.5, 0.1):
                w = np.exp(temper * (logl - logl.max()))
                w /= w.sum()
                idx = rng.choice(1000, 1000, p=w)
                np.testing.assert_allclose(row["resample"][temper], (
                    1.0 / np.sum(w**2), jgp.grid_overlap_score(cloud[idx], L, gx, gy)), rtol=1e-5)
            fixed = jpp.ml_recenter(cloud, lambda s: j_sg(s[:, 0], s[:, 1], N=n_pix),
                                    jnp.asarray(m), jax.random.PRNGKey(9))
            np.testing.assert_allclose(out["ml_recenter"],
                                       jgp.grid_overlap_score(fixed, L, gx, gy), rtol=1e-5)
            np.testing.assert_allclose(out["raw"], jgp.grid_overlap_score(cloud, L, gx, gy),
                                       rtol=1e-5)
    assert len(out["tolerance"]) == 10


# ---- (b) each main on tiny port run directories, (c) the scripts' faults ------

ML_STEPS = 30
TINY = dict(training_num=24, pe_iters=1, gan_iters=2, cadence=1, pe_cadence=10, eval_cadence=2,
            n_posterior=8, grid_grain=5, ckpt_every=10_000, plots=False, comb_pe_model=True)
NARROW = {"BBHGenerator": functools.partial(BBHGenerator, features=G_FEAT),
          "PairDiscriminator": functools.partial(PairDiscriminator, features=D_FEAT),
          "CombinedPE": functools.partial(CombinedPE, features=PE_FEAT)}
STUDY_MODULES = (workloads, bbh_postproc_eval, bbh_sampler_calibration, twin_cue_probe,
                 d_memorization_probe)


@pytest.fixture(scope="module")
def narrow():
    """The tiny runs and the mains on them, cut where the CPU spends its
    time: narrow G, D and PE in the workload and the studies; N_REF grid
    reference draws (the workload's and the studies' 3907, so also the
    CNN sanity set); ML recentering at ``ML_STEPS`` Adam steps (300;
    tests/test_torch_posterior_post.py holds it); the postproc library's
    candidates at N_OUT rows and its KDE resample at 2048 draws (4000 and
    16,384), in the runs' selection too; two sampler cells (16;
    test_sampler_cell_matches holds one)."""
    sample_grid = tgp.sample_grid_posterior
    with pytest.MonkeyPatch.context() as mp:
        for mod in STUDY_MODULES:
            for name, cls in NARROW.items():
                if hasattr(mod, name):
                    mp.setattr(mod, name, cls)
        mp.setattr(tgp, "sample_grid_posterior",
                   lambda L, x, y, n, seed=0: sample_grid(L, x, y, min(n, N_REF), seed=seed))
        mp.setattr(tpp, "ml_recenter", functools.partial(tpp.ml_recenter, steps=ML_STEPS))
        mp.setattr(tpp, "kde_is_resample", functools.partial(tpp.kde_is_resample, n_draw=2048))
        mp.setattr(tpp, "select_final_cloud",
                   functools.partial(tpp.select_final_cloud, n_out=N_OUT))
        mp.setattr(bbh_sampler_calibration, "CELLS", bbh_sampler_calibration.CELLS[::9])
        yield


@pytest.fixture(scope="module")
def runs(narrow, tmp_path_factory):
    """Tiny runs of the port's workload: P at n_pix 1024 with the pair D
    and a CNN cache; Q, the same run as a cache-less run leaves it (the
    cache entry is the ``ckpt_pe`` such a run writes: the same manager
    and payload); S at n_pix 256 with the ch1-only D and ELBO selection."""
    root = tmp_path_factory.mktemp("study_runs")
    cfgs = {"P": dict(n_pix=1024, cnn_cache=str(root / "cnn_cache")),
            "S": dict(n_pix=256, pair_d=False, res_loss_weight=1.0, g_norm="group",
                      select_best="elbo", eval_cadence=1)}
    out = {}
    for name, kw in cfgs.items():
        cfg = workloads.BBHConfig(**{**TINY, **kw}, out_dir=str(root / f"{name}_s0"))
        workloads.run_bbh(cfg, device="cpu")
        out[name] = cfg.out_dir
    out["Q"] = str(root / "Q_s0")
    shutil.copytree(out["P"], out["Q"])
    cfg = json.load(open(os.path.join(out["P"], "config.json")))
    shutil.copytree(os.path.join(cfg["cnn_cache"], workloads.bbh_cnn_cache_tag(
        workloads.BBHConfig(**cfg))), os.path.join(out["Q"], "ckpt_pe"))
    json.dump({**cfg, "cnn_cache": None, "out_dir": out["Q"]},
              open(os.path.join(out["Q"], "config.json"), "w"))
    return out


def _rows(path):
    return [json.loads(line) for line in open(path)]


POSTPROC_ROUTE = ["run", "route", "beta", "grid_overlap", "elbo", "cloud"]
POSTPROC_LIBRARY = ["run", "route", "beta", "grid_overlap", "elbo", "chosen", "plateau_k",
                    "pool_ess", "kde_ess"]


def test_postproc_main_writes_the_scripts_rows(runs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rows = bbh_postproc_eval.main([runs["P"], "--device", "cpu"])
    assert rows == _rows(bbh_postproc_eval.OUT)
    routes = [r["route"] for r in rows]
    assert routes[:9] == ["raw", "debias1", "debias2", "bootcal", "debias1_bootcal", "mlrc",
                          "mlrc_reweight1", "reweight1", "reweight05"]
    assert sorted(routes[9:]) == sorted(f"library:{c}" for c in (
        "argmax", "plateau", "plat_is", "pool", "pool_is", "kde_is"))
    for r in rows[:9]:
        want = POSTPROC_ROUTE + (["ess"] if r["route"].startswith("reweight") else [])
        assert list(r) == want and r["cloud"] == "posterior_samples_00003.npz", r
    for r in rows[9:]:
        keys = POSTPROC_LIBRARY + (["elbo_se"] if "elbo_se" in r else [])
        keys += ["tiebreak"] if "tiebreak" in r else []
        assert list(r) == keys, r
    assert sum(r["chosen"] for r in rows[9:]) == 1
    assert all(0.0 <= r["grid_overlap"] <= 1.0 for r in rows)
    assert capsys.readouterr().out.count("POSTPROC: ") == len(rows)
    lib = bbh_postproc_eval.main(["--library-only", runs["P"], "--device", "cpu"])
    assert [r["route"] for r in lib] == routes[9:]
    # the script reads the PE from the run's CNN cache only: Q has none
    with pytest.raises(FileNotFoundError, match="no cnn_cache"):
        bbh_postproc_eval.main([runs["Q"], "--device", "cpu"])


def test_stack_and_twin_mains_write_the_scripts_rows(runs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rows, best = elbo_stack_eval.main([runs["S"], "--device", "cpu"])
    assert rows == _rows(elbo_stack_eval.OUT) and [r["k"] for r in rows] == [1, 2]
    for r in rows:
        assert list(r) == ["run", "k", "steps", "beta", "grid_overlap", "elbo_pooled"]
        assert r["run"] == "S_s0" and len(r["steps"]) == r["k"] and set(r["steps"]) <= {1, 2}
    assert best in rows
    assert "ELBO-argmax K: " in capsys.readouterr().out
    out = twin_cue_probe.main([runs["S"], "--device", "cpu"])
    assert _rows(twin_cue_probe.OUT) == [out]
    assert list(out) == ["run", "step", "twin_boost", "logit_bank", "logit_signal", "logit_g",
                         "twin_penalty"]
    # the last training state, not the best-whiteness one parked at step 3
    assert out["step"] == 2 and all(np.isfinite(out[k]) for k in list(out)[3:])
    with pytest.raises(ValueError, match="ch1-only"):
        twin_cue_probe.main([runs["Q"], "--device", "cpu"])


def test_memorization_and_sampler_mains(runs, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    results = d_memorization_probe.main([runs["Q"], "--device", "cpu"])
    assert list(results) == ["A", "B", "C", "C2", "C3", "D", "E"]
    assert all(np.isfinite(v) for v in results.values())
    printed = capsys.readouterr().out
    # the newest checkpoint, as the script restores it: after evaluations,
    # the best-whiteness state parked at gan_iters + 1 (ROADMAP queue 3)
    assert "(checkpoint index 3; the run trained 2 steps)" in printed
    assert d_memorization_probe.verdict(results) in printed
    rows = bbh_sampler_calibration.main([runs["Q"], "8", "--device", "cpu"])
    assert [(r["bn_mode"], r["dropout"], r["posterior_noise"]) for r in rows] == list(
        bbh_sampler_calibration.CELLS)
    for r in rows:
        assert list(r) == ["bn_mode", "dropout", "posterior_noise", "beta", "grid_overlap",
                           "bias_mc", "disp_mc", "disp_q"]
    printed = capsys.readouterr().out
    assert "restored GAN step 3" in printed
    assert [json.loads(x) for x in printed.splitlines() if x.startswith("{")] == rows
    assert not os.path.exists("out")   # the script writes no file


def test_the_scripts_geometry_and_model_faults_are_refused(runs, tmp_path):
    from gennet_tpu.data import template_bank as jtb
    from gennet_tpu.physics import psd as jpsd

    # bbh_postproc_eval.py:74-78 and bbh_sampler_calibration.py:59-65 build
    # the grid on tb.BankConfig() (n_pix 1024) whatever the run's config:
    # for an event at n_pix 256 the JAX grid's templates do not fit it
    with pytest.raises(TypeError, match="incompatible shapes"):
        jgp.bbh_grid_posterior(jnp.zeros(256), jpsd.analytic_advligo_psd(256, 4),
                               jtb.BankConfig(), 1.0, 1.0, grain=2)
    for study in (bbh_postproc_eval, bbh_sampler_calibration):
        with pytest.raises(ValueError, match="n_pix 256"):
            study.main([runs["S"], "--device", "cpu"])
    # bbh_sampler_calibration.py:73-82 restores into the default batch-norm
    # G, the pair D and ckpt_pe whatever the run's config: refused
    cfg = json.load(open(os.path.join(runs["Q"], "config.json")))
    for change, match in (({"g_norm": "group"}, "g_norm='group'"),
                          ({"pair_d": False}, "pair_d=False")):
        d = tmp_path / f"bad_{len(match)}"
        d.mkdir()
        json.dump({**cfg, **change}, open(d / "config.json", "w"))
        with pytest.raises(ValueError, match=match):
            bbh_sampler_calibration.main([str(d), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no ckpt_pe"):
        bbh_sampler_calibration.main([runs["P"], "4", "--device", "cpu"])


def test_a_study_refuses_a_run_whose_event_it_does_not_draw(runs, tmp_path):
    """A study draws the run's event again from its seed, on its own
    device, and holds it against the event the run kept."""
    run = tmp_path / "S_s0"
    shutil.copytree(runs["S"], run)
    record = run / workloads.EVENT_RECORD
    kept = np.load(record)
    assert str(kept["device"]) == "cpu" and kept["measured"].shape == (256,)
    np.savez(record, measured=kept["measured"], device=np.array("cuda"))
    with pytest.raises(ValueError, match="drew its event on cuda .* pass --device cuda"):
        twin_cue_probe.main([str(run), "--device", "cpu"])
    planted = kept["measured"].copy()
    planted[7] += 1e-3 * np.abs(planted).max()
    np.savez(record, measured=planted, device=np.array("cpu"))
    with pytest.raises(ValueError, match="not the one"):
        twin_cue_probe.main([str(run), "--device", "cpu"])
    record.unlink()
    with pytest.raises(FileNotFoundError, match="no event.npz"):
        elbo_stack_eval.main([str(run), "--device", "cpu"])


def test_sample_generator_on_given_latents_is_its_own_draw():
    """``sample_generator(z=...)``, the path the JAX-parity tests take, is
    the draw from ``gen`` when given that draw's latents: batch statistics,
    temperature and the EMA weights included."""
    _, _, _, _, tg, tcfg, ts = _nets("batch", True, 11)
    tcfg = tgan.GANConfig(n_pix=NP, pair_discriminator=True, g_ema_decay=0.9)
    ts.g_ema = {k: v.detach() + 0.01 for k, v in ts.generator.named_parameters()}
    lo, hi = tcfg.latent_low, tcfg.latent_high
    g = torch.Generator().manual_seed(12)
    z = torch.cat([lo + (hi - lo) * torch.rand((256, tcfg.latent_dim), generator=g)
                   for _ in range(2)])
    for kw in ({"bn_mode": "batch", "temp": 0.7}, {"bn_mode": "eval", "use_ema": False}):
        drawn = tgan.sample_generator(tg, ts, torch.Generator().manual_seed(12), 300, tcfg, **kw)
        given = tgan.sample_generator(tg, ts, None, 300, tcfg, z=z.numpy(), **kw)
        assert torch.equal(drawn, given), kw
    with pytest.raises(ValueError, match="whole chunks of 256"):
        tgan.sample_generator(tg, ts, None, 300, tcfg, z=z[:300])


# ---- (b) the burst mains on saved clouds --------------------------------------

def _burst_run(root, seed, steps, rng):
    """A burst run directory as a CPU run of ``seed`` leaves it: its clouds
    at ``steps``, and the event it kept."""
    d = root / f"mlrc_sel_s{seed}" / "GAN_posterior_samples"
    d.mkdir(parents=True)
    for i, st in enumerate(steps):
        c = _cloud(rng, 300, shift=(0.0003 * i, 0.0), spread=(0.001, 0.003))
        np.savez(d / f"posterior_samples_{st:05d}.npz", samples=c.astype(np.float32))
    cfg = workloads.BurstSmokeConfig(seed=seed)
    workloads.write_event_record(str(d.parent), workloads.burst_event(
        cfg, torch.Generator().manual_seed(seed), "cpu")[3])
    return str(d.parent)


def test_burst_mains_write_the_scripts_rows(small_library, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(8)
    run = _burst_run(tmp_path, 1, (2500, 5000, 50001), rng)
    outs = burst_pool_study.main([run, "--device", "cpu"])
    assert outs == _rows(burst_pool_study.OUT)
    out = outs[0]
    assert list(out) == ["run", "argmax_step", "plateau_k", "pool_ess", "kde_ess", "scores",
                         "candidates", "chosen", "chosen_overlap"]
    assert list(out["scores"]) == ["argmax", "plateau", "plat_is", "pool", "pool_is", "kde_is"]
    assert set(out["candidates"]) >= {"argmax", "plateau", "pool"}
    assert "chosen-overlap median over 1 seeds" in capsys.readouterr().out
    res = burst_rescore_study.main([run, "--device", "cpu"])
    assert res == _rows(burst_rescore_study.OUT)
    assert list(res[0]) == ["run", "n", *burst_rescore_study.SCORES, "best_overlap",
                            "final_overlap"]
    assert res[0]["n"] == 3
    # a run whose event was drawn on the card: the CPU stream differs, refused
    kept = np.load(os.path.join(run, workloads.EVENT_RECORD))
    np.savez(os.path.join(run, workloads.EVENT_RECORD), measured=kept["measured"],
             device=np.array("cuda"))
    for study in (burst_pool_study, burst_rescore_study):
        with pytest.raises(ValueError, match="drew its event on cuda and the study runs on cpu"):
            study.main([run, "--device", "cpu"])


def test_burst_debias_main(capsys):
    out = burst_debias_diag.main(["--device", "cpu"])
    assert sorted(out["seeds"]) == [0, 1, 2]
    assert set(out["seeds"][1]) >= {"reconstructed", "oracle", "resample"}
    assert all(0.0 <= v <= 1.0 for v in out["tolerance"].values())
    assert np.isfinite(out["ml_recenter"])
    printed = capsys.readouterr().out
    assert printed.count("seed ") >= 3 and "ml_recenter overlap: " in printed
