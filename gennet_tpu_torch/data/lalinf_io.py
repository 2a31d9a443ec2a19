"""lalinference product interop (port of ``gennet_tpu.data.lalinf_io``).

Host-side ingestion of the files the reference consumes:
- frequency-domain event data / data-with-injection ASCII
  (``*-freqData.dat`` / ``*-freqDataWithInjection.dat``,
  ref: gw_template_maker.py:753-767)
- measured PSD ASCII (``*-PSD.dat``, ref: :767)
- nested-sampling posterior HDF5 → (mc, q) and (m1, m2) sample arrays
  (ref: BBH_version/data/get_lalinf_pars.py), with the closed-form
  inversion of :func:`gennet_tpu_torch.physics.priors.mc_q_to_m1m2`;
- the template-bank ``.npz`` writer and reader.

Everything here is numpy on the host, the same code as the JAX package's,
so both packages read each other's files. ``pandas`` and ``h5py`` are
imported only when a posterior file is read.
"""

import os

import numpy as np

from gennet_tpu_torch.physics import priors
from gennet_tpu_torch.physics.constants import STRAIN_SCALE


def load_freq_data(path: str) -> np.ndarray:
    """Load a lalinference FD ASCII series (freq, re, im) → complex array
    with NaNs zeroed (ref: :753-763)."""
    raw = np.loadtxt(path)
    z = raw[:, 1] + 1j * raw[:, 2]
    z[~np.isfinite(z)] = 0.0
    return z


def load_psd_txt(path: str) -> np.ndarray:
    """Measured PSD ASCII (freq, psd) → PSD array in scaled strain units
    (× STRAIN_SCALE²) (ref: :767,787)."""
    raw = np.loadtxt(path)
    return raw[:, 1] * STRAIN_SCALE**2


def whiten_fd_np(data_fd: np.ndarray, psd: np.ndarray, fs: float) -> np.ndarray:
    """Host-side FD whitening, the reference's formula (ref: :243-286)."""
    n = min(len(data_fd), len(psd))
    data_fd, psd = data_fd[:n], psd[:n]
    inv = np.where(psd > 0, 1.0 / np.where(psd > 0, psd, 1.0), 0.0)
    out = data_fd * np.sqrt(2.0 * inv / fs)
    out[0] = 0.0
    return out


def load_posterior_mc_q(path: str, mc_key: str = "mc", q_key: str = "q"):
    """Posterior HDF5 → (n, 2) array of (mc, q) plus (n, 2) of (m1, m2)
    (replaces get_lalinf_pars.py:39-91).

    Reads a pandas-written HDF5 (as the reference's ``pd.read_hdf``) or a
    plain h5py layout with the named datasets anywhere in its groups, or a
    structured ``posterior_samples`` dataset.
    """
    mc = q = None
    try:
        import pandas as pd

        df = pd.read_hdf(path)
        mc, q = np.asarray(df[mc_key]), np.asarray(df[q_key])
    except Exception:  # not a pandas file (or no pandas): the h5py layouts
        import h5py

        with h5py.File(path, "r") as f:
            def find(name):
                hits = []
                f.visititems(lambda k, v: hits.append(v[...])
                             if k.split("/")[-1] == name and hasattr(v, "shape") else None)
                return hits[0] if hits else None

            mc, q = find(mc_key), find(q_key)
            if mc is None or q is None:
                # structured posterior dataset (lalinference convention)
                post = find("posterior_samples")
                if post is not None and post.dtype.names:
                    names = {n.lower(): n for n in post.dtype.names}
                    mc = post[names.get("mc", names.get("chirpmass", "mc"))]
                    q = post[names.get("q", "q")]
    if mc is None or q is None:
        raise ValueError(f"could not locate ({mc_key}, {q_key}) in {path}")
    mc = np.asarray(mc, np.float64).ravel()
    q = np.asarray(q, np.float64).ravel()
    q = np.where(q > 1.0, 1.0 / q, q)  # normalise to q = m2/m1 ≤ 1
    m1, m2 = priors.mc_q_to_m1m2(mc, q)
    return np.stack([mc, q], -1), np.stack([np.asarray(m1), np.asarray(m2)], -1)


def load_event_products(directory: str, fs: int = 1024, T_safe: int = 4,
                        event_time: str = "1126259462", det: str = "H1"):
    """Load a lalinference engine output directory into what the pipelines
    need (ref: gw_template_maker.main, :743-795): the whitened measured data
    and noise-free signal (central 1 s), the PSD, the normalisation constant
    1/std(whitened measured, safe window), and the posterior (mc, q) and
    (m1, m2) samples when a posterior file is present."""
    base = f"lalinferencenest-0-{det}-{event_time}.0-0.hdf5{det}"
    fd_data = load_freq_data(os.path.join(directory, f"{base}-freqData.dat")) * STRAIN_SCALE
    fd_inj = load_freq_data(os.path.join(directory, f"{base}-freqDataWithInjection.dat")) \
        * STRAIN_SCALE
    psd = load_psd_txt(os.path.join(directory, f"{base}-PSD.dat"))

    h_t_fd = fd_inj - fd_data          # noise-free event (ref: :766)
    N = fs * T_safe
    wht_meas = np.fft.irfft(whiten_fd_np(fd_inj, psd, fs), N)
    wht_sig = np.fft.irfft(whiten_fd_np(h_t_fd, psd, fs), N)

    norm = 1.0 / np.std(wht_meas)      # ref: :779-784
    c0 = N // 2 - fs // 2
    out = {
        "psd": psd[: N // 2 + 1],
        "measured_whitened": (wht_meas * norm)[c0 : c0 + fs].astype(np.float32),
        "signal_whitened": (wht_sig * norm)[c0 : c0 + fs].astype(np.float32),
        "norm_constant": float(norm),
    }
    for cand in os.listdir(directory):
        if cand.endswith((".hdf5", ".h5")) and "posterior" in cand.lower():
            try:
                out["posterior_mc_q"], out["posterior_m1_m2"] = load_posterior_mc_q(
                    os.path.join(directory, cand))
                break
            except Exception:  # an unreadable candidate: try the next file
                continue
    return out


def save_bank_npz(path: str, templates: np.ndarray, params: dict):
    """Bank writer (replaces the reference's cPickle block dumps,
    ref: :842-863): one compressed npz with templates and the parameter
    arrays."""
    np.savez_compressed(path, templates=templates, **{k: np.asarray(v) for k, v in params.items()})


def load_bank_npz(path: str):
    data = np.load(path)
    params = {k: data[k] for k in data.files if k != "templates"}
    return data["templates"], params
