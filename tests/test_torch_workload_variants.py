"""The gen-1 image workloads, ``blob-toy`` and ``image-gan``, as whole runs
of the port on the CPU, against the JAX package's.

- Tiny ``run_blob_toy`` and ``run_image_gan`` runs in both packages at the
  counts of tests/test_workloads.py:61-107 (n_pix 16, ≤ 6 steps, cadence
  5): the same summary keys, the same jsonl steps and keys (the random
  streams differ, so the values do not). Neither runs a kernel.
- ``image-gan`` with plots on writes ``image_gan_recovery.png``;
  ``blob-toy`` draws nothing, with plots on, as in the reference.
- The two CLI subcommands with ``--device cpu``; ``--data-parallel`` at a
  world of 1 equals the run without it bit for bit (summary and rows);
  without ``--device`` on a machine with no card they raise; a bank whose
  rows do not divide over the ranks is refused before any work, and so is
  an image glob no reader can read.
"""

import json
import os
import sys

import numpy as np
import pytest
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.cli.main import main as cli
from gennet_tpu_torch.ops import conv1d as conv_ops
from gennet_tpu_torch.ops import phasor_dft
from gennet_tpu_torch.train.mesh import DataMesh

IMAGES = os.path.join(os.path.dirname(__file__), "data", "images", "*.jpg")
BLOB = dict(n_pix=16, n_signals=256, pe_iters=6, mc_pe_iters=6, gan_iters=6, cadence=5,
            batch_size=8, n_mc_draws=16)
IMAGE = dict(image_glob=IMAGES, n_pix=16, gan_iters=6, cadence=5, batch_size=8)


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _shape(rows):
    """(step, keys) of each row: what both packages must agree on."""
    return [(r["step"], sorted(r)) for r in rows]


def _flags(kw):
    return [a for k, v in kw.items() for a in ("--" + k.replace("_", "-"), str(v))]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's tiny runs: (summary, rows) per workload."""
    from gennet_tpu.cli import workloads as jwl

    d = tmp_path_factory.mktemp("jax")
    blob = jwl.run_blob_toy(jwl.BlobToyConfig(**BLOB, out_dir=str(d / "blob"), plots=False))
    img = jwl.run_image_gan(jwl.ImageGANConfig(**IMAGE, out_dir=str(d / "img"), plots=False))
    return {"blob": (blob, _rows(d / "blob" / "blob_metrics.jsonl")),
            "image": (img, _rows(d / "img" / "image_gan_metrics.jsonl"))}


def test_blob_toy_matches_the_reference_summary_and_rows(tmp_path, jax_runs):
    launches = (conv_ops.LAUNCHES, phasor_dft.LAUNCHES)
    out = twl.run_blob_toy(twl.BlobToyConfig(**BLOB, out_dir=str(tmp_path / "b")), device="cpu")
    assert (conv_ops.LAUNCHES, phasor_dft.LAUNCHES) == launches
    want, want_rows = jax_runs["blob"]
    assert set(out) == set(want) == {"pe_rms", "mc_overlap", "gan_d_loss"}
    assert np.isfinite(out["pe_rms"]).all() and len(out["pe_rms"]) == 2
    assert 0.0 <= out["mc_overlap"] <= 1.0 and np.isfinite(out["gan_d_loss"])
    rows = _rows(tmp_path / "b" / "blob_metrics.jsonl")
    assert _shape(rows) == _shape(want_rows)
    assert [r["step"] for r in rows] == [5, 5, 5]  # PE, MC-dropout PE, GAN
    # plots are on by default, and the blob toy draws none, as in the reference
    assert sorted(os.listdir(tmp_path / "b")) == ["blob_metrics.jsonl"]


def test_image_gan_matches_the_reference_summary_and_rows(tmp_path, jax_runs):
    out = twl.run_image_gan(twl.ImageGANConfig(**IMAGE, out_dir=str(tmp_path / "i")),
                            device="cpu")
    want, want_rows = jax_runs["image"]
    assert set(out) == set(want) == {"n_images", "recovery_corr", "gan_d_loss", "gan_g_loss"}
    assert out["n_images"] == want["n_images"] == 32  # 16 fixtures and their flips
    assert -1.0 <= out["recovery_corr"] <= 1.0
    assert np.isfinite(out["gan_d_loss"]) and np.isfinite(out["gan_g_loss"])
    assert _shape(_rows(tmp_path / "i" / "image_gan_metrics.jsonl")) == _shape(want_rows)
    assert (tmp_path / "i" / "image_gan_recovery.png").stat().st_size > 0


@pytest.mark.parametrize("cmd,kw,summary", [
    ("blob-toy", {**BLOB, "plots": "false"}, "blob"),
    ("image-gan", {**IMAGE, "plots": "false"}, "image_gan"),
])
def test_cli_data_parallel_at_world1_equals_the_plain_run(tmp_path, cmd, kw, summary):
    runs = {}
    for tag, extra in (("plain", []), ("dp", ["--data-parallel"])):
        out = cli([cmd, "--device", "cpu", *_flags(kw), "--out-dir", str(tmp_path / tag), *extra])
        runs[tag] = (out, _rows(tmp_path / tag / f"{summary}_metrics.jsonl"))
    assert runs["plain"] == runs["dp"]
    assert runs["plain"][1]  # the runs logged rows


@pytest.mark.parametrize("cmd", ["blob-toy", "image-gan"])
def test_cli_without_device_refuses_the_cpu(tmp_path, cmd, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli([cmd, "--out-dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("case", ["blob", "image"])
def test_rows_that_do_not_divide_over_the_ranks_are_refused(tmp_path, case):
    # the row check runs before any collective, so a rank's view of a world
    # of 2 (or 3) is enough to show the refusal
    out_dir = str(tmp_path / "x")
    with pytest.raises(ValueError, match="shard_map"):
        if case == "blob":
            twl.run_blob_toy(twl.BlobToyConfig(**{**BLOB, "n_signals": 255}, out_dir=out_dir),
                             device="cpu", mesh=DataMesh(2, 0, "cpu", "gloo"))
        else:
            twl.run_image_gan(twl.ImageGANConfig(**IMAGE, out_dir=out_dir, plots=False),
                              device="cpu", mesh=DataMesh(3, 0, "cpu", "gloo"))
    assert not os.path.exists(out_dir)


def test_image_gan_without_a_reader_refuses_a_jpeg_before_any_work(tmp_path, monkeypatch):
    for name in ("PIL", "matplotlib", "matplotlib.image"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="PIL.*matplotlib"):
        cli(["image-gan", "--device", "cpu", "--image-glob", IMAGES, "--plots", "false",
             "--out-dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()
