"""``make-mdc`` and the waveform text files of the port against the JAX
package (mirrors tests/test_variants.py:145-175).

- ``make-mdc`` of both kinds: the port's CLI and the JAX CLI, with the
  same flags and seed, write the same sim_burst XML and the same ASCII
  strain files, byte for byte, and return the same dict.
- The port's ``mdc_xml`` reads back what it wrote.
- ``load_txt_waveforms`` equals the JAX function (both numpy and scipy).
- ``make_sine_gaussian_mdc`` draws from a ``torch.Generator``: its
  waveforms equal the formula on the returned (f0, t0) in float64 to 1e-5
  of the peak (float32 synthesis), and hrss² holds within the JAX test's
  5 %.
"""

import json
import os

import numpy as np
import pytest
import torch

from gennet_tpu.cli.main import main as jax_cli
from gennet_tpu.data import waveform_txt as jtxt
from gennet_tpu_torch.cli.main import main as cli
from gennet_tpu_torch.data import mdc_xml as M
from gennet_tpu_torch.data import waveform_txt as ttxt


def _files(d) -> dict:
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("kind", ["sine-gaussian", "wnb"])
def test_make_mdc_writes_the_reference_files(tmp_path, capsys, kind):
    outs = {}
    for tag, main in (("jax", jax_cli), ("port", cli)):
        d = tmp_path / tag
        argv = ["make-mdc", "--kind", kind, "-n", "3", "--xml", str(d / "set.xml"),
                "--render-dir", str(d / "txt"), "--seed", "5"]
        main(argv)
        outs[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs[tag]["xml"] = os.path.relpath(outs[tag]["xml"], d)
    assert outs["port"] == outs["jax"] == {"injections": 3, "xml": "set.xml", "files": 6}
    assert (open(tmp_path / "port" / "set.xml", "rb").read()
            == open(tmp_path / "jax" / "set.xml", "rb").read())
    assert _files(tmp_path / "port" / "txt") == _files(tmp_path / "jax" / "txt")


def test_mdc_xml_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    s = M.MDCSet(["H1", "L1"])
    for t in M.uniform_time(1126620016, 1126630016, 4, rng=rng):
        s + M.sine_gaussian(q=15.0, frequency=150.0, hrss=1e-21, time=float(t))
    path = str(tmp_path / "set.xml.gz")
    s.save_xml(path)
    back = M.MDCSet.load_xml(path, detectors=("H1", "L1"))
    assert len(back.injections) == 4
    for a, b in zip(s.injections, back.injections):
        assert a.waveform == b.waveform and a.q == b.q and a.hrss == b.hrss
        assert abs(a.time - b.time) < 1e-6
    h = M.render_injection(back.injections[0], fs=4096)
    np.testing.assert_allclose(np.sqrt(np.sum(h**2) / 4096), 1e-21, rtol=1e-9)


def test_load_txt_waveforms_matches_jax(tmp_path):
    t = np.linspace(0, 1, 700)
    for i in range(3):
        np.savetxt(tmp_path / f"wf{i}.txt", np.stack([t, np.sin(40 * t + i)], -1))
    pattern = str(tmp_path / "wf*.txt")
    out = ttxt.load_txt_waveforms(pattern, n_out=512, seed=2)
    np.testing.assert_array_equal(out, jtxt.load_txt_waveforms(pattern, n_out=512, seed=2))
    assert out.shape == (3, 512) and np.abs(out).max() <= 1.0 + 1e-6
    with pytest.raises(FileNotFoundError):
        ttxt.load_txt_waveforms(str(tmp_path / "none*.txt"))


def test_sine_gaussian_mdc_set(tmp_path):
    fs, duration, q, hrss = 2048, 0.5, 15.0, 1e-22
    h, pars = ttxt.make_sine_gaussian_mdc(torch.Generator().manual_seed(0), 4, fs=fs,
                                          duration=duration)
    assert h.shape == (4, 1024) and h.dtype == torch.float32
    f0, t0 = pars["f0"].numpy().astype(np.float64), pars["t0"].numpy().astype(np.float64)
    assert ((f0 >= 100) & (f0 <= 200)).all() and ((t0 >= 0.2) & (t0 <= 0.3)).all()
    # the formula on the drawn (f0, t0), in float64
    t = np.arange(1024)[None, :] / fs
    tau = q / (np.sqrt(2.0) * np.pi * f0[:, None])
    peak = hrss * 1e21 / np.sqrt(tau * np.sqrt(np.pi / 2.0) / 2.0)
    x = t - t0[:, None]
    ref = peak * np.sin(2 * np.pi * f0[:, None] * x) * np.exp(-((x / tau) ** 2))
    np.testing.assert_allclose(h.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # hrss² = Σh²/fs (scaled units: × 1e42), the JAX test's 5 %
    np.testing.assert_allclose((h.numpy() ** 2).sum(axis=1) / fs, (hrss * 1e21) ** 2, rtol=0.05)
    ttxt.save_mdc_npz(str(tmp_path / "mdc" / "set.npz"), h, pars)
    data = np.load(tmp_path / "mdc" / "set.npz")
    assert data["waveforms"].shape == (4, 1024) and set(data.files) == {
        "waveforms", "f0", "t0", "q", "hrss"}
