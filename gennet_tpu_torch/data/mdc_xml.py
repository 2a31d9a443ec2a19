"""Hardware-injection MDC sets: LIGOLW sim_burst XML and ASCII rendering
(port of ``gennet_tpu.data.mdc_xml``, the port's own copy: numpy and
``xml`` only).

The native replacement for the reference's minke tooling (ref:
make_hw-xml.py: a minke MDCSet of SineGaussian q=15 f∈[100,200] /
WhiteNoiseBurst sources with log-uniform hrss over uniform GPS times,
saved as LIGOLW XML; ref: make-hw-frames.py: reads the XML back and
renders per-injection hardware-injection strain files). The LIGOLW
``sim_burst`` table is a documented XML schema and the burst waveforms are
analytic, so this module writes and parses interchange-compatible
sim_burst XML (gzip-transparent) and renders the injections to ASCII
strain series on the host. Frame (GWF) containers stay out of scope (a
binary format that needs frameCPP).
"""

import gzip
import math
from dataclasses import dataclass, field
from xml.etree import ElementTree as ET

import numpy as np

_DOCTYPE = ('<!DOCTYPE LIGO_LW SYSTEM '
            '"http://ldas-sw.ligo.caltech.edu/doc/ligolwAPI/html/'
            'ligolw_dtd.txt">')

# sim_burst column schema (glue.ligolw.lsctables.SimBurstTable ordering)
_COLUMNS = [
    ("process_id", "int_8s"),
    ("simulation_id", "int_8s"),
    ("time_slide_id", "int_8s"),
    ("waveform", "lstring"),
    ("ra", "real_8"),
    ("dec", "real_8"),
    ("psi", "real_8"),
    ("time_geocent_gps", "int_4s"),
    ("time_geocent_gps_ns", "int_4s"),
    ("duration", "real_8"),
    ("frequency", "real_8"),
    ("bandwidth", "real_8"),
    ("q", "real_8"),
    ("pol_ellipse_angle", "real_8"),
    ("pol_ellipse_e", "real_8"),
    ("amplitude", "real_8"),
    ("hrss", "real_8"),
    ("egw_over_rsquared", "real_8"),
    ("waveform_number", "int_8u"),
]


@dataclass
class BurstInjection:
    """One sim_burst row. ``waveform`` selects the morphology:
    'SineGaussian' (ref sources.SineGaussian: q, frequency, hrss,
    linear polarisation) or 'BTLWNB' (ref sources.WhiteNoiseBurst:
    duration, bandwidth, frequency, hrss, seed→waveform_number)."""

    waveform: str
    time: float                    # geocentric GPS seconds
    hrss: float
    frequency: float = 0.0
    q: float = 0.0
    duration: float = 0.0
    bandwidth: float = 0.0
    ra: float = 0.0
    dec: float = 0.0
    psi: float = 0.0
    pol_ellipse_angle: float = 0.0
    pol_ellipse_e: float = 1.0     # linear polarisation (minke default)
    amplitude: float = 0.0
    egw_over_rsquared: float = 0.0
    seed: int = 0


def sine_gaussian(q: float, frequency: float, hrss: float, time: float,
                  **kw) -> BurstInjection:
    return BurstInjection("SineGaussian", time, hrss, frequency=frequency,
                          q=q, duration=q / (math.sqrt(2.0) * math.pi * frequency),
                          **kw)


def white_noise_burst(duration: float, bandwidth: float, frequency: float,
                      hrss: float, time: float, seed: int = 0,
                      **kw) -> BurstInjection:
    return BurstInjection("BTLWNB", time, hrss, frequency=frequency,
                          duration=duration, bandwidth=bandwidth, seed=seed,
                          **kw)


def uniform_time(start: float, stop: float, number: int,
                 rng=None) -> np.ndarray:
    """GPS times uniform in [start, stop) (ref: distribution.uniform_time)."""
    rng = rng or np.random.default_rng(0)
    return np.sort(rng.uniform(start, stop, number))


def log_uniform(lower: float, upper: float, number: int,
                rng=None) -> np.ndarray:
    """log-uniform amplitudes (ref: distribution.log_uniform); degenerate
    lower==upper returns the constant (the reference uses both forms)."""
    if lower == upper:
        return np.full(number, lower)
    rng = rng or np.random.default_rng(0)
    return np.exp(rng.uniform(np.log(lower), np.log(upper), number))


@dataclass
class MDCSet:
    """Injection set over a detector list (ref: mdctools.MDCSet).
    ``mdcset + source`` appends, as in minke."""

    detectors: list
    injections: list = field(default_factory=list)

    def __add__(self, inj: BurstInjection):
        self.injections.append(inj)
        return self

    # -- LIGOLW XML ------------------------------------------------------
    def save_xml(self, path: str):
        rows = []
        for i, inj in enumerate(self.injections):
            gps = int(inj.time)
            gps_ns = int(round((inj.time - gps) * 1e9))
            if gps_ns >= 1_000_000_000:  # round-up at an integer-second edge
                gps, gps_ns = gps + 1, gps_ns - 1_000_000_000
            vals = {
                "process_id": 0, "simulation_id": i, "time_slide_id": 0,
                "waveform": f'"{inj.waveform}"',
                "ra": inj.ra, "dec": inj.dec, "psi": inj.psi,
                "time_geocent_gps": gps, "time_geocent_gps_ns": gps_ns,
                "duration": inj.duration, "frequency": inj.frequency,
                "bandwidth": inj.bandwidth, "q": inj.q,
                "pol_ellipse_angle": inj.pol_ellipse_angle,
                "pol_ellipse_e": inj.pol_ellipse_e,
                "amplitude": inj.amplitude, "hrss": inj.hrss,
                "egw_over_rsquared": inj.egw_over_rsquared,
                "waveform_number": inj.seed,
            }
            rows.append(",".join(repr(vals[c]) if isinstance(vals[c], float)
                                 else str(vals[c]) for c, _ in _COLUMNS))

        root = ET.Element("LIGO_LW")
        table = ET.SubElement(root, "Table", Name="sim_burst:table")
        for col, typ in _COLUMNS:
            ET.SubElement(table, "Column", Name=f"sim_burst:{col}", Type=typ)
        stream = ET.SubElement(table, "Stream", Name="sim_burst:table",
                               Type="Local", Delimiter=",")
        stream.text = "\n\t\t\t" + ",\n\t\t\t".join(rows) + "\n\t\t"

        body = ET.tostring(root, encoding="unicode")
        doc = f"<?xml version='1.0' encoding='utf-8'?>\n{_DOCTYPE}\n{body}"
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as fh:
            fh.write(doc)

    @classmethod
    def load_xml(cls, path: str, detectors=("H1",)) -> "MDCSet":
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            text = fh.read()
        # strip the SYSTEM doctype (ElementTree has no external-DTD support)
        text = "\n".join(l for l in text.splitlines()
                         if not l.lstrip().startswith("<!DOCTYPE"))
        root = ET.fromstring(text)
        table = next(t for t in root.iter("Table")
                     if "sim_burst" in t.get("Name", ""))
        cols = [c.get("Name").split(":")[-1] for c in table.iter("Column")]
        stream = next(iter(table.iter("Stream")))
        out = cls(list(detectors))
        for line in (stream.text or "").strip().splitlines():
            parts = [p.strip() for p in line.strip().rstrip(",").split(",")]
            if not parts or parts == [""]:
                continue
            d = dict(zip(cols, parts))
            wf = d["waveform"].strip('"')
            t = int(d["time_geocent_gps"]) + int(d["time_geocent_gps_ns"]) / 1e9
            out + BurstInjection(
                wf, t, float(d["hrss"]), frequency=float(d["frequency"]),
                q=float(d["q"]), duration=float(d["duration"]),
                bandwidth=float(d["bandwidth"]), ra=float(d["ra"]),
                dec=float(d["dec"]), psi=float(d["psi"]),
                pol_ellipse_angle=float(d["pol_ellipse_angle"]),
                pol_ellipse_e=float(d["pol_ellipse_e"]),
                amplitude=float(d["amplitude"]),
                egw_over_rsquared=float(d["egw_over_rsquared"]),
                seed=int(d["waveform_number"]))
        return out


def render_injection(inj: BurstInjection, fs: int = 16384,
                     pad: float = 0.5) -> np.ndarray:
    """Strain time series of one injection, centred in a 2·pad window
    (the per-injection content of the reference's hardware-injection files,
    ref make-hw-frames.py / HWFrameSet.generate_pcal)."""
    n = int(2 * pad * fs)
    t = (np.arange(n) - n // 2) / fs
    if inj.waveform == "SineGaussian":
        tau = inj.q / (math.sqrt(2.0) * math.pi * inj.frequency)
        env = np.exp(-t ** 2 / tau ** 2)
        h = env * np.sin(2 * math.pi * inj.frequency * t)
        # hrss normalization: ∫h²dt = hrss²
        norm = math.sqrt(np.sum(h ** 2) / fs)
        return inj.hrss / max(norm, 1e-300) * h
    if inj.waveform == "BTLWNB":
        rng = np.random.default_rng(inj.seed)
        x = rng.normal(size=n)
        X = np.fft.rfft(x)
        f = np.fft.rfftfreq(n, 1.0 / fs)
        band = ((f >= inj.frequency - inj.bandwidth / 2)
                & (f <= inj.frequency + inj.bandwidth / 2))
        h = np.fft.irfft(np.where(band, X, 0.0), n)
        h *= np.exp(-t ** 2 / (inj.duration / 2) ** 2)
        norm = math.sqrt(np.sum(h ** 2) / fs)
        return inj.hrss / max(norm, 1e-300) * h
    raise ValueError(f"unknown waveform {inj.waveform!r}")


def render_injection_files(mdcset: MDCSet, out_dir: str, fs: int = 16384):
    """Write one two-column (t, h) ASCII file per injection per detector —
    the hardware-injection file set make-hw-frames.py produced through
    minke's HWFrameSet, minus the GWF container."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, inj in enumerate(mdcset.injections):
        h = render_injection(inj, fs=fs)
        t = np.arange(h.size) / fs
        for det in mdcset.detectors:
            p = os.path.join(
                out_dir, f"{det}-{inj.waveform}_{i:05d}_"
                f"{int(inj.time)}.txt")
            np.savetxt(p, np.column_stack([t, h]))
            paths.append(p)
    return paths
