"""The port's workloads under data parallelism on the CPU.

- One world of 2 over gloo (spawned ranks, tests/torch_dp_worker.py) at
  narrow widths runs, with the counts of tests/test_workloads.py:129-168
  (``training_num`` 25, ``twin_boost`` 8): a tiny ``run_burst_smoke``; a
  tiny ``run_bbh``; the same ``run_bbh`` stopped after 2 GAN steps and
  resumed to 4, whose checkpoint must equal the uninterrupted run's bit for
  bit (states and every rank's generator state); the sharded bank, which
  must be the ranks' own ``make_template_batch`` rows in rank order; and
  what a world of 2 refuses before any work. Both ranks must end with
  bitwise-equal networks and Adam states.
- A world-2 checkpoint resumed without the mesh is refused by name.
- ``make-bank --data-parallel`` at world 1 (one process, no torchrun) is
  one ``make_template_batch`` of the requested rows from the seed, with no
  event twin, as the reference's sharded bank.
- ``sample-posterior`` has no ``--data-parallel``, as in the reference.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import torch_dp_worker as W
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.cli.main import main as cli
from gennet_tpu_torch.data import template_bank as tb
from gennet_tpu_torch.models import BBHGenerator, CombinedPE, PairDiscriminator
from gennet_tpu_torch.physics import psd as psd_mod
from gennet_tpu_torch.train.mesh import rank_generator

BBH = dict(n_pix=256, training_num=25, twin_boost=8, pe_iters=2, gan_iters=4, cadence=1,
           pe_cadence=1, eval_cadence=100, n_posterior=8, grid_grain=5, ckpt_every=10000,
           comb_pe_model=True, plots=False)
BURST = dict(n_pix=128, n_signals=512, gan_iters=6, pe_iters=6, cadence=5, batch_size=8,
             n_posterior=32, pe_grain=21, plots=False)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    return tmp, W.spawn(W.workload_suite, 2, tmp, str(tmp), BBH, BURST, timeout=240)


@pytest.mark.parametrize("case", ["burst", "bbh", "resumed"])
def test_world2_ranks_end_in_sync(suite, case):
    _, ranks = suite
    (out0, dig0), (out1, dig1) = (r[case] for r in ranks)
    assert out1 is None and out0 is not None  # rank 0 reports, as the reference runs once
    assert len(dig0) == len(dig1) > 0
    for a, b in zip(dig0, dig1):
        np.testing.assert_array_equal(a, b)


def test_world2_burst_smoke_summary(suite):
    out = suite[1][0]["burst"][0]
    assert np.isfinite(out["rms"]).all() and 0.0 <= out["grid_overlap"] <= 1.0
    assert set(out["whiteness"]) >= {"mean_pass", "var_pass", "ljung_box_pass"}


def test_world2_run_bbh_summary(suite):
    tmp, ranks = suite
    out = ranks[0]["bbh"][0]
    assert out["final_step"] == BBH["gan_iters"]
    assert 0.0 <= out["beta"] <= 1.0 and np.isfinite(out["pe_rms"]).all()
    lines = (tmp / "full" / "bbh_metrics.jsonl").read_text().splitlines()
    rows = [r for r in map(json.loads, lines) if "d_loss" in r]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]  # one writer: rank 0


def test_world2_resume_equals_the_uninterrupted_run(suite):
    full, resumed = suite[1][0]["ckpts"]
    assert full["world"] == resumed["world"] == 2 and full["step"] == resumed["step"]
    for part in ("state", "rank_extra"):
        assert full[part].keys() == resumed[part].keys()
        for k, v in full[part].items():
            np.testing.assert_array_equal(np.asarray(resumed[part][k]), np.asarray(v),
                                          err_msg=f"{part}{k}")
    # two ranks, two different generator states
    gens = [v for k, v in full["rank_extra"].items() if k.endswith(".gen")]
    assert len(gens) == 2 and not np.array_equal(*gens)


def test_world2_resume_at_world1_is_refused(suite, monkeypatch):
    tmp, _ = suite
    monkeypatch.setattr(twl, "BBHGenerator", functools.partial(BBHGenerator, features=W.G_FEAT))
    monkeypatch.setattr(twl, "PairDiscriminator",
                        functools.partial(PairDiscriminator, features=W.D_FEAT))
    monkeypatch.setattr(twl, "CombinedPE", functools.partial(CombinedPE, features=W.PE_FEAT))
    cfg = twl.BBHConfig(**dict(BBH, out_dir=str(tmp / "full"), resume=True))
    with pytest.raises(ValueError, match="world of 2 ranks.*world of 1 is refused"):
        twl.run_bbh(cfg, device="cpu")


def test_world2_sharded_bank_is_each_ranks_batch_in_rank_order(suite):
    (t0, p0), (t1, p1) = (r["bank"] for r in suite[1])
    np.testing.assert_array_equal(t0, t1)
    cfg = tb.BankConfig(fs=256)
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device="cpu")
    for r in range(2):
        t, p = tb.make_template_batch(rank_generator(1, r, "cpu"), 4, psd, cfg)
        np.testing.assert_array_equal(t0[4 * r : 4 * (r + 1)], t.numpy())
        for k, v in p.items():
            np.testing.assert_array_equal(p0[k][4 * r : 4 * (r + 1)], v.numpy(), err_msg=k)


@pytest.mark.parametrize("case", ["bbh_training_num", "bbh_bank_file", "burst_n_signals"])
def test_world2_refuses_rows_that_do_not_divide(suite, case):
    got = suite[1][0]["refusals"]
    rows = {"bbh_training_num": "23 rows", "bbh_bank_file": "7 rows",
            "burst_n_signals": "511 rows"}[case]
    assert got[case] is not None and rows in got[case] and "world of 2" in got[case]
    assert "shard_map" in got[case]
    assert got["dirs"] == ["odd.npz"]  # refused before any work: no out dir


def test_make_bank_data_parallel_at_world1_is_one_batch_without_twin(tmp_path):
    path = str(tmp_path / "b.npz")
    out = cli(["make-bank", "--device", "cpu", "-N", "9", "-f", "256", "-b", path,
               "--data-parallel"])
    assert out["templates"] == 9
    cfg = tb.BankConfig(fs=256)
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device="cpu")
    t, p = tb.make_template_batch(torch.Generator().manual_seed(1), 9, psd, cfg)
    data = np.load(path)
    np.testing.assert_array_equal(data["templates"], t.numpy())
    np.testing.assert_array_equal(data["q"], p["q"].numpy())
    assert not np.isclose(data["q"][-1], 29.0 / 36.0)  # no event twin


def test_sample_posterior_has_no_data_parallel_flag(capsys):
    with pytest.raises(SystemExit):
        cli(["sample-posterior", "--device", "cpu", "--data-parallel"])
    assert "unrecognized arguments: --data-parallel" in capsys.readouterr().err


def test_bbh_config_row_check_without_a_mesh_refuses_nothing():
    twl.check_bbh_rows(dataclasses.replace(twl.BBHConfig(), training_num=24), None)
