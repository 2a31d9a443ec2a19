"""The PyTorch port imports no JAX: importing every module of
``gennet_tpu_torch`` in a fresh interpreter leaves jax, flax, optax, orbax,
the JAX package and its ``scripts`` (the recipes are ported to
``gennet_tpu_torch.recipes``) out of ``sys.modules``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import gennet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gennet_tpu_torch.__path__, "gennet_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "gennet_tpu",
                                      "scripts"))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    n_modules, bad = int(lines[0]), lines[1]
    assert n_modules >= 20, out.stdout
    assert bad == "", f"gennet_tpu_torch pulled in: {bad}"


def test_no_import_line_names_jax_or_the_jax_package():
    # every module of the port (the burst workload's and the recipes'
    # included) and the two card scripts: no import or from line names jax,
    # flax, optax, orbax, gennet_tpu (gennet_tpu_torch is the port itself)
    # or the JAX package's scripts
    import glob
    import re

    files = sorted(glob.glob(os.path.join(REPO, "gennet_tpu_torch", "**", "*.py"), recursive=True))
    files += [os.path.join(REPO, name) for name in ("chip_smoke.py", "kernel_times.py")]
    assert os.path.join(REPO, "gennet_tpu_torch", "physics", "burst.py") in files
    assert os.path.join(REPO, "gennet_tpu_torch", "recipes", "bbh_sweep.py") in files
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|gennet_tpu|scripts)"
                     r"\b(?!_torch)")
    hits = [f"{os.path.relpath(f, REPO)}:{i}: {line.strip()}"
            for f in files for i, line in enumerate(open(f), 1) if bad.match(line)]
    assert hits == []


_STUDIES_PROBE = r"""
import contextlib, importlib, io, pkgutil, sys
import gennet_tpu_torch.studies as studies
names = sorted(m.name for m in pkgutil.iter_modules(studies.__path__) if not m.name.startswith("_"))
for n in names:
    mod = importlib.import_module("gennet_tpu_torch.studies." + n)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        try:
            mod.main(["--help"])
        except SystemExit as e:
            assert e.code == 0, (n, e.code)
    assert "--device" in out.getvalue(), n
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "gennet_tpu",
                                      "scripts"))
print(",".join(names))
print(",".join(bad))
"""


def test_the_studies_import_no_jax():
    # gennet_tpu_torch.studies, the ports of the offline studies of
    # scripts/: each of the eight modules imports in a fresh interpreter
    # without jax or the JAX package, and its command line answers --help
    # with its --device option
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _STUDIES_PROBE], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.split("\n")[:2]
    assert names.split(",") == sorted([
        "bbh_postproc_eval", "bbh_sampler_calibration", "burst_debias_diag", "burst_pool_study",
        "burst_rescore_study", "d_memorization_probe", "elbo_stack_eval", "twin_cue_probe"])
    assert bad == "", f"gennet_tpu_torch.studies pulled in: {bad}"
