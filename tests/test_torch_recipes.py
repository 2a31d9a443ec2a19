"""The port's recipe runners (``gennet_tpu_torch/recipes/``) against the
JAX package's scripts (``scripts/bbh_sweep.py``, ``run_flagship.py``,
``burst_sweep.py``, imported by path).

(a) Configs: every BBH and burst recipe, and the flagship's overrides,
    give the same workload config in both packages (the workload stubbed
    out), apart from the output roots, which sit under ``out/torch/``.
(b) Rows: one tiny real run of each sweep runner in each package at the
    n_pix 256 (BBH) and 128 (burst) geometries, with the recipe's routes
    on: the rows have the same keys, in order, and None in the same places.
(c) The flagship's resume, tiny: the port resumes at the saved step, and a
    re-run after completion appends no row, where the JAX runner appends
    a row of nulls (ROADMAP queue 3, refused in the port).
(d) ``recipes.walls``: the printed lines of (b)'s port runs, stamped,
    split into their phases with each evaluation found, so a reworded
    print in either workload shows here.

Every case runs in its own ``tmp_path``: the runners append to relative
paths, and nothing under the repository's ``out/`` may change.
"""

import dataclasses
import functools
import importlib.util
import inspect
import json
import pathlib
import shutil
import sys
import tempfile

import pytest
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.eval import posterior_post as jpp
from gennet_tpu_torch.cli import workloads
from gennet_tpu_torch.eval import posterior_post as tpp
from gennet_tpu_torch.recipes import bbh_sweep as tbs
from gennet_tpu_torch.recipes import burst_sweep as tbu
from gennet_tpu_torch.recipes import run_flagship as tfl
from gennet_tpu_torch.recipes import walls

REPO = pathlib.Path(__file__).resolve().parent.parent

# the JAX runners' results files, relative to the working directory; each
# port row is held to the JAX row of the same run, key for key
JAX_BBH_RESULTS = "out/bbh_sweeps/results.jsonl"  # bbh_sweep.py and run_flagship.py
JAX_BURST_RESULTS = "out/sweeps/results.jsonl"
# the keys of run_burst_smoke's summary that the JAX runner reads by index
BURST_SUMMARY = ("grid_overlap", "grid_overlap_best", "whiteness", "rms")

# ML recentering's Adam steps in the tiny runs (the reference's 300 in the
# recipes); tests/test_torch_posterior_post.py holds ml_recenter itself
ML_STEPS = 30

TINY_BBH = dict(n_pix=256, training_num=24, pe_iters=1, cadence=1, pe_cadence=10,
                n_posterior=8, grid_grain=5, ckpt_every=10_000)
# the flagship's resume needs no posterior score: no grid, so no sanity set
TINY_FLAGSHIP = dict(TINY_BBH, grid_grain=0)
TINY_BURST = dict(n_pix=128, n_signals=512, pe_iters=6, cadence=5, batch_size=8,
                  n_posterior=32, pe_grain=21, eval_every=1)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_recipe_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return {name: _load_script(name) for name in ("bbh_sweep", "run_flagship", "burst_sweep")}


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _recorder(got, side, summary):
    def run(cfg, **kw):
        got[side] = cfg
        return dict(summary)
    return run


def _assert_same_config(jax_cfg, port_cfg):
    j, t = dataclasses.asdict(jax_cfg), dataclasses.asdict(port_cfg)
    assert list(j) == list(t)
    for root in ("out_dir", "cnn_cache"):
        assert j[root].startswith("out/"), j[root]
        assert t.pop(root) == "out/torch/" + j.pop(root).removeprefix("out/")
    assert t == j


def test_the_variant_tables_have_the_same_names(jax_scripts):
    assert list(tbs.VARIANTS) == list(jax_scripts["bbh_sweep"].VARIANTS)
    assert list(tbu.VARIANTS) == list(jax_scripts["burst_sweep"].VARIANTS)
    assert (len(tbs.VARIANTS), len(tbu.VARIANTS)) == (40, 78)


# ---- (a) configs ------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(tbs.VARIANTS))
def test_bbh_variant_config(jax_scripts, monkeypatch, name):
    jbs, got = jax_scripts["bbh_sweep"], {}
    monkeypatch.setattr(jbs, "run_bbh", _recorder(got, "jax", {}))
    monkeypatch.setattr(tbs, "run_bbh", _recorder(got, "port", {}))
    jbs.run_one(name, 3, 1234)
    row = tbs.run_one(name, 3, 1234, device="cpu")
    _assert_same_config(got["jax"], got["port"])
    assert list(row) == list(_rows(JAX_BBH_RESULTS)[0])


@pytest.mark.parametrize("name", list(tbu.VARIANTS))
def test_burst_variant_config(jax_scripts, monkeypatch, name):
    jbu, got = jax_scripts["burst_sweep"], {}
    summary = dict.fromkeys(BURST_SUMMARY)
    monkeypatch.setattr(jbu, "run_burst_smoke", _recorder(got, "jax", summary))
    monkeypatch.setattr(tbu, "run_burst_smoke", _recorder(got, "port", summary))
    jbu.run_one(name, 3, 1234)
    row = tbu.run_one(name, 3, 1234, device="cpu")
    _assert_same_config(got["jax"], got["port"])
    assert list(row) == list(_rows(JAX_BURST_RESULTS)[0])


@pytest.mark.parametrize("variant", ["r4flag", "r5_tw500"])
def test_flagship_config(jax_scripts, monkeypatch, variant):
    jfl, got = jax_scripts["run_flagship"], {}
    monkeypatch.setattr(jfl, "run_bbh", _recorder(got, "jax", {"final_step": 777}))
    monkeypatch.setattr(tfl, "run_bbh", _recorder(got, "port", {"final_step": 777}))
    monkeypatch.setattr(sys, "argv", ["run_flagship.py", variant, "777"])
    jfl.main()
    row = tfl.main([variant, "777", "--device", "cpu"])
    _assert_same_config(got["jax"], got["port"])
    _assert_same_config(got["jax"], tfl.flagship_config(variant, 777))
    assert list(row) == list(_rows(JAX_BBH_RESULTS)[0])
    assert row["variant"] == f"{variant}_flagship" and row["out_dir"] == "out/torch/bbh_r5"


def test_flagship_variant_defaults(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(tfl, "run", lambda cfg, variant, device: seen.append(variant))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tfl.main(["--device", "cpu"])
    (tmp_path / "flagship_variant").write_text("r5_tw500\n")
    tfl.main(["--device", "cpu"])
    tfl.main(["r4_grp", "--device", "cpu"])
    assert seen == ["r4flag", "r5_tw500", "r4_grp"]


def test_sweep_command_lines(monkeypatch):
    runs = []
    monkeypatch.setattr(tbs, "run_one", lambda *a, device: runs.append((*a, device)))
    tbs.main(["r4flag", "--device", "cpu"])
    tbs.main(["r4_grp", "2", "500", "--device", "cpu"])
    tbs.main(["--queue", "r4flag,r4_grp:1,r5_tw500:2:300", "--device", "cpu"])
    assert runs == [("r4flag", 0, 50_000, "cpu"), ("r4_grp", 2, 500, "cpu"),
                    ("r4flag", 0, 50_000, "cpu"), ("r4_grp", 1, 50_000, "cpu"),
                    ("r5_tw500", 2, 300, "cpu")]
    with pytest.raises(SystemExit):
        tbs.main(["--queue", "r4flag,nosuch", "--device", "cpu"])
    assert len(runs) == 5  # an unknown name is refused before any run


# ---- (b) rows of tiny real runs ---------------------------------------------------------

def _fewer_ml_steps(monkeypatch):
    monkeypatch.setattr(jpp, "ml_recenter", functools.partial(jpp.ml_recenter, steps=ML_STEPS))
    monkeypatch.setattr(tpp, "ml_recenter", functools.partial(tpp.ml_recenter, steps=ML_STEPS))


def _assert_rows_agree(jax_row, port_row):
    assert list(jax_row) == list(port_row)
    assert [jax_row[k] for k in ("variant", "seed", "iters")] == \
        [port_row[k] for k in ("variant", "seed", "iters")]
    assert {k: v is None for k, v in jax_row.items()} == \
        {k: v is None for k, v in port_row.items()}


def _rows(path):
    return [json.loads(line) for line in pathlib.Path(path).read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_r4flag(jax_scripts, tmp_path_factory):
    """One tiny run of the JAX ``bbh_sweep.run_one("r4flag", 0, 2)``: its
    working directory and its row (shared by (b) and (c): a JAX run is the
    file's largest cost)."""
    jbs, d = jax_scripts["bbh_sweep"], tmp_path_factory.mktemp("jax_r4flag")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        _fewer_ml_steps(mp)
        mp.setattr(jbs, "BASE", dataclasses.replace(jbs.BASE, **TINY_BBH))
        jbs.run_one("r4flag", 0, 2)
    (row,) = _rows(d / JAX_BBH_RESULTS)
    return d, row


def _assert_walls(printed: str, n_evals: int):
    """``walls.split`` of a run's printed lines, stamped one second apart,
    finds every phase and ``n_evals`` evaluations."""
    w = walls.split(f"{i}.0 {line}\n" for i, line in enumerate(printed.splitlines()))
    assert w["n_evals"] == n_evals, w
    assert min(w["to_pe_end"], w["gan_train"], w["final"]) > 0 and w["evals"] >= n_evals, w


def test_walls_markers_are_the_workloads_prints():
    """Each line ``walls.split`` looks for starts a print of the port's
    workloads or runners (an f-string's or a label's first characters)."""
    src = "".join(inspect.getsource(m) for m in (workloads, tbs, tbu, tfl))
    for marker in (walls.PE_END, *walls.EVAL_END, *walls.FINAL, *walls.RESULT):
        assert f'"{marker}' in src, marker


def test_bbh_sweep_rows(jax_r4flag, monkeypatch, capsys):
    _fewer_ml_steps(monkeypatch)
    monkeypatch.setattr(tbs, "BASE", dataclasses.replace(tbs.BASE, **TINY_BBH))
    capsys.readouterr()
    port = tbs.run_one("r4flag", 0, 2, device="cpu")
    # (d): the recipe evaluates every 5000 steps, so none in 2
    _assert_walls(capsys.readouterr().out, n_evals=0)
    assert _rows(tbs.RESULTS) == [port]
    _assert_rows_agree(jax_r4flag[1], port)
    # the recipe's library selection ran: its candidate is named
    assert port["selected_route"] is not None and port["beta"] is not None


def test_burst_sweep_rows(jax_scripts, monkeypatch, capsys):
    jbu = jax_scripts["burst_sweep"]
    _fewer_ml_steps(monkeypatch)
    monkeypatch.setattr(jbu, "BASE", dataclasses.replace(jbu.BASE, **TINY_BURST))
    monkeypatch.setattr(tbu, "BASE", dataclasses.replace(tbu.BASE, **TINY_BURST))
    jbu.run_one("mlrc_sel", 0, 10)
    capsys.readouterr()
    port = tbu.run_one("mlrc_sel", 0, 10, device="cpu")
    _assert_walls(capsys.readouterr().out, n_evals=2)  # (d)
    (jax_row,) = _rows(JAX_BURST_RESULTS)
    assert _rows(tbu.RESULTS) == [port]
    _assert_rows_agree(jax_row, port)
    # two evaluations (steps 5 and 10) ran, and the library chose among them
    assert port["selected_at"] in (5, 10) and port["selected_route"] is not None


# ---- (c) the flagship's resume ----------------------------------------------------------

def test_flagship_resumes_and_appends_no_row_when_complete(jax_scripts, jax_r4flag,
                                                            monkeypatch, capsys):
    _fewer_ml_steps(monkeypatch)
    monkeypatch.setattr(tbs, "BASE", dataclasses.replace(tbs.BASE, **TINY_FLAGSHIP))
    gan_steps = pathlib.Path(tfl.OUT_DIR) / "bbh_metrics.jsonl"

    first = tfl.main(["r4flag", "2", "--device", "cpu"])
    second = tfl.main(["r4flag", "4", "--device", "cpu"])
    assert (first["iters"], second["iters"]) == (2, 4)
    # the second run went on from the step-2 checkpoint: each GAN step
    # logged once, in order
    steps = [r["step"] for r in _rows(gan_steps) if "d_loss" in r]
    assert steps == [1, 2, 3, 4]
    assert tfl.resume_step(tfl.OUT_DIR) == 4
    capsys.readouterr()
    assert tfl.main(["r4flag", "4", "--device", "cpu"]) is None
    assert "already complete at step 4" in capsys.readouterr().out
    assert _rows(tbs.RESULTS) == [first, second]  # no third row

    # the JAX runner, given the finished 2-step r4flag run's checkpoint and
    # CNN cache (the same state as its own run to 2 would leave), trains
    # nothing and appends a row of nulls
    jfl, (done_dir, done) = jax_scripts["run_flagship"], jax_r4flag
    shutil.copytree(done_dir / "out/bbh_sweeps/r4flag_s0/ckpt_gan", "out/bbh_r5/ckpt_gan")
    shutil.copytree(done_dir / "out/bbh_sweeps/cnn_cache", "out/bbh_sweeps/cnn_cache")
    monkeypatch.setattr(jfl, "BASE", dataclasses.replace(jfl.BASE, **TINY_FLAGSHIP))
    monkeypatch.setattr(sys, "argv", ["run_flagship.py", "r4flag", "2"])
    jfl.main()
    (rerun,) = _rows(JAX_BBH_RESULTS)
    assert list(rerun) == list(first) and done["whiteness"] is not None
    # every column of the run is null (all but the name, seed and iters and
    # the out_dir and wall_s): whiteness is scored with or without a grid,
    # so its null shows that the final block never ran
    assert all(rerun[k] is None for k in list(rerun)[3:-2])
