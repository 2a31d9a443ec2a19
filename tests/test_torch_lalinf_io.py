"""lalinference product interop of the port (``gennet_tpu_torch.data.
lalinf_io``) against ``gennet_tpu.data.lalinf_io`` on the fixture of
tests/test_lalinf_io.py (FD data, data with injection, PSD ASCII and a
posterior HDF5 in the reference's layout).

numpy runs on both sides, so every loader agrees to rtol 1e-12. The bank
``.npz`` each package writes is read by the other. ``h5py`` and
``pandas`` are imported only when a posterior is read (the card's machine
has neither).
"""

import subprocess
import sys

import numpy as np
import pytest
from test_lalinf_io import lalinf_dir  # noqa: F401 (the reference's fixture)

from gennet_tpu.data import lalinf_io as jio
from gennet_tpu_torch.data import lalinf_io as tio

BASE = "lalinferencenest-0-H1-1126259462.0-0.hdf5H1"


def _same(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["freqData", "freqDataWithInjection"])
def test_load_freq_data_matches(lalinf_dir, name):  # noqa: F811
    d, _, _ = lalinf_dir
    path = f"{d}/{BASE}-{name}.dat"
    z = tio.load_freq_data(path)
    _same(z, jio.load_freq_data(path))
    assert np.isfinite(z).all()


def test_load_psd_and_whiten_match(lalinf_dir):  # noqa: F811
    d, _, _ = lalinf_dir
    psd = tio.load_psd_txt(f"{d}/{BASE}-PSD.dat")
    _same(psd, jio.load_psd_txt(f"{d}/{BASE}-PSD.dat"))
    z = jio.load_freq_data(f"{d}/{BASE}-freqDataWithInjection.dat") * 1e21
    for fs in (1024, 256):
        _same(tio.whiten_fd_np(z, psd, fs), jio.whiten_fd_np(z, psd, fs))


def test_load_posterior_matches(lalinf_dir):  # noqa: F811
    d, mc, q = lalinf_dir
    got = tio.load_posterior_mc_q(f"{d}/posterior_samples.hdf5")
    want = jio.load_posterior_mc_q(f"{d}/posterior_samples.hdf5")
    for a, b in zip(got, want):
        _same(a, b)
    _same(got[0][:, 0], mc)
    assert (got[1][:, 0] >= got[1][:, 1]).all()


@pytest.mark.parametrize("layout", ["q_above_one", "structured"])
def test_posterior_layouts_match(tmp_path, layout):
    import h5py

    rng = np.random.default_rng(1)
    mc, q = rng.normal(30, 1, 20), rng.uniform(1.05, 1.6, 20)  # m1/m2 convention
    path = str(tmp_path / "p.h5")
    with h5py.File(path, "w") as hf:
        if layout == "q_above_one":
            hf.create_dataset("mc", data=mc)
            hf.create_dataset("q", data=q)
        else:
            rec = np.zeros(20, dtype=[("chirpmass", "f8"), ("q", "f8")])
            rec["chirpmass"], rec["q"] = mc, q
            hf.create_group("lalinference").create_dataset("posterior_samples", data=rec)
    got, want = tio.load_posterior_mc_q(path), jio.load_posterior_mc_q(path)
    for a, b in zip(got, want):
        _same(a, b)
    _same(got[0][:, 1], 1.0 / q)


def test_missing_posterior_columns_raise(tmp_path):
    import h5py

    with h5py.File(tmp_path / "p.h5", "w") as hf:
        hf.create_dataset("chi", data=np.zeros(3))
    with pytest.raises(ValueError, match="could not locate"):
        tio.load_posterior_mc_q(str(tmp_path / "p.h5"))


@pytest.mark.parametrize("fs,T_safe", [(1024, 4), (256, 4)])
def test_load_event_products_matches(lalinf_dir, fs, T_safe):  # noqa: F811
    d, _, _ = lalinf_dir
    got = tio.load_event_products(d, fs=fs, T_safe=T_safe)
    want = jio.load_event_products(d, fs=fs, T_safe=T_safe)
    assert got.keys() == want.keys() == {"psd", "measured_whitened", "signal_whitened",
                                         "norm_constant", "posterior_mc_q", "posterior_m1_m2"}
    for k in want:
        if k == "norm_constant":
            assert got[k] == pytest.approx(want[k], rel=1e-12)
        else:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            _same(got[k], want[k])
    assert got["measured_whitened"].shape == (fs,)


@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio)])
def test_bank_npz_read_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    t = rng.normal(size=(8, 64)).astype(np.float32)
    p = {"mc": rng.uniform(20, 35, 8).astype(np.float32), "q": np.linspace(0.5, 1, 8),
         "idx": np.arange(8)}
    writer.save_bank_npz(str(tmp_path / "b.npz"), t, p)
    t2, p2 = reader.load_bank_npz(str(tmp_path / "b.npz"))
    np.testing.assert_array_equal(t2, t)
    assert p2.keys() == p.keys()
    for k in p:
        np.testing.assert_array_equal(p2[k], p[k])
        assert p2[k].dtype == p[k].dtype


def test_h5py_and_pandas_are_imported_lazily():
    code = ("import sys, gennet_tpu_torch.data.lalinf_io; "
            "print(sorted(m for m in ('h5py', 'pandas') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "[]"
