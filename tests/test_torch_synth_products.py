"""The port's product writer (``gennet_tpu_torch.data.synth_products``)
against the JAX package's, and the port's ``--lalinf-dir`` route on the
directory it writes.

Both writers get seed 3 and ``BankConfig(fs=256)`` (200 posterior rows from
a 12×12 grid). Tolerances: the ASCII files 1e-6·max per column (measured
≤ 3.7e-7: the float32 PSD and gain of two libraries, written with 18
digits; the frequency column exactly); the whitened signal and measured
second 1e-4·max (measured 2.4e-5: float32 PhenomD, as tests/
test_torch_physics.py holds it); the norm constant rtol 1e-6 (measured
5.0e-7); the posterior rows rtol 1e-6 (measured equal: the same numpy
draws from grids that agree to float32 rounding); the truth exactly. The
loader reads the writer's norm back at rtol 1e-6 and its event at
1e-5·max (measured 1.6e-9 and ~1e-7: the loader whitens with the float64
PSD read from the file, the writer with the float32 gain).
"""

import functools
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu.data import synth_products as jsp
from gennet_tpu.data import template_bank as jtb
from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.cli.main import main as cli
from gennet_tpu_torch.data import lalinf_io
from gennet_tpu_torch.data import synth_products as tsp
from gennet_tpu_torch.data import template_bank as ttb
from gennet_tpu_torch.models import BBHGenerator, CombinedPE, PairDiscriminator
from gennet_tpu_torch.ops import phasor_dft

KW = dict(seed=3, n_posterior=200, grid_grain=12)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("products")
    out_j = jsp.write_synthetic_products(str(d / "j"), cfg=jtb.BankConfig(fs=256), **KW)
    out_t = tsp.write_synthetic_products(str(d / "t"), cfg=ttb.BankConfig(fs=256), device="cpu",
                                         **KW)
    yield d, out_j, out_t
    shutil.rmtree(d, ignore_errors=True)


def test_writer_matches_reference(written):
    d, out_j, out_t = written
    names = sorted(os.listdir(d / "j"))
    assert sorted(os.listdir(d / "t")) == names
    assert "posterior_samples.hdf5" in names and sum(n.endswith(".dat") for n in names) == 3
    for name in names:
        if name.endswith(".dat"):
            a, b = np.loadtxt(d / "t" / name), np.loadtxt(d / "j" / name)
            assert a.shape == b.shape
            np.testing.assert_array_equal(a[:, 0], b[:, 0])  # the frequency grid
            for col in range(1, a.shape[1]):
                assert _rel(a[:, col], b[:, col]) <= 1e-6, (name, col)
    assert out_t.keys() == out_j.keys()
    for k in ("signal_whitened", "measured_whitened"):
        assert out_t[k].dtype == np.float32 and _rel(out_t[k], out_j[k]) <= 1e-4, k
    np.testing.assert_allclose(out_t["norm_constant"], out_j["norm_constant"], rtol=1e-6)
    assert out_t["truth"] == out_j["truth"]
    np.testing.assert_allclose(out_t["posterior_mc_q"], out_j["posterior_mc_q"], rtol=1e-6)
    # the posterior file reads back as written, in either package's reader
    np.testing.assert_allclose(lalinf_io.load_posterior_mc_q(
        str(d / "t" / "posterior_samples.hdf5"))[0], out_t["posterior_mc_q"], rtol=1e-12)


def test_posterior_false_writes_no_hdf5_and_needs_no_h5py(tmp_path, written, monkeypatch):
    d, _, out_t = written
    monkeypatch.setitem(sys.modules, "h5py", None)
    out = tsp.write_synthetic_products(str(tmp_path), cfg=ttb.BankConfig(fs=256),
                                       posterior=False, **KW)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(n for n in os.listdir(d / "t") if n.endswith(".dat"))
    for name in names:  # the same files as with the posterior
        assert (tmp_path / name).read_bytes() == (d / "t" / name).read_bytes(), name
    assert out["posterior_mc_q"] is None
    for k in ("signal_whitened", "measured_whitened", "norm_constant", "truth"):
        np.testing.assert_array_equal(out[k], out_t[k], err_msg=k)
    # the loader's round trip: the writer's event and norm
    prod = lalinf_io.load_event_products(str(tmp_path), fs=256, T_safe=4)
    assert "posterior_mc_q" not in prod
    assert prod["norm_constant"] == pytest.approx(out["norm_constant"], rel=1e-6)
    assert _rel(prod["measured_whitened"], out["measured_whitened"]) <= 1e-5
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_lalinf_route_runs_on_the_ports_products(tmp_path, monkeypatch):
    """``make-bank --lalinf-dir`` and ``run_bbh --lalinf-dir`` on a
    directory without a posterior file (the card's case): the bank carries
    the products' norm, and the run scores against the exact grid."""
    monkeypatch.setattr(twl, "BBHGenerator", functools.partial(BBHGenerator,
                                                               features=(16, 16, 32, 32, 64)))
    monkeypatch.setattr(twl, "PairDiscriminator", functools.partial(PairDiscriminator,
                                                                    features=(16, 32)))
    monkeypatch.setattr(twl, "CombinedPE", functools.partial(CombinedPE, features=(8, 8, 16, 16)))
    prod_dir = str(tmp_path / "prod")
    written = tsp.write_synthetic_products(prod_dir, cfg=ttb.BankConfig(fs=256),
                                           posterior=False, **KW)
    plain, lal = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    cli(["make-bank", "--device", "cpu", "-N", "8", "-f", "256", "-b", plain])
    cli(["make-bank", "--device", "cpu", "-N", "8", "-f", "256", "-b", lal,
         "--lalinf-dir", prod_dir])
    a, b = np.load(plain)["templates"], np.load(lal)["templates"]
    # the products carry the analytic PSD: the same bank, scaled by their norm
    np.testing.assert_allclose(b, a * written["norm_constant"], rtol=0,
                               atol=1e-4 * np.abs(b).max())
    cfg = twl.BBHConfig(n_pix=256, training_num=24, pe_iters=2, gan_iters=2, cadence=1,
                        pe_cadence=10, eval_cadence=2, n_posterior=8, grid_grain=5,
                        ckpt_every=10_000, comb_pe_model=True, plots=False, lalinf_dir=prod_dir,
                        out_dir=str(tmp_path / "run"))
    launches = phasor_dft.LAUNCHES
    out = twl.run_bbh(cfg, device="cpu")
    assert phasor_dft.LAUNCHES == launches  # CPU tensors take the plain version
    assert out["final_step"] == 2 and all(np.isfinite(out["pe_rms"]))
    # no posterior file: the exact grid is the reference posterior
    assert out["grid_overlap"] is not None and 0.0 <= out["grid_overlap"] <= 1.0
    assert out["beta"] is not None and 0.0 <= out["beta"] <= 1.0
    measured, norm = twl._prepare_bbh_data(cfg, torch.Generator().manual_seed(0), "cpu",
                                           skip_bank=True)[3:5]
    assert norm == pytest.approx(written["norm_constant"], rel=1e-6)
    assert _rel(measured.numpy(), written["measured_whitened"]) <= 1e-5
    shutil.rmtree(tmp_path, ignore_errors=True)
