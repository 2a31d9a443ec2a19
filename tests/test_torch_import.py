"""The PyTorch port imports no JAX: importing every module of
``gennet_tpu_torch`` in a fresh interpreter leaves jax, flax, optax, orbax
and the JAX package out of ``sys.modules``."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "gennet_tpu"))
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
    # every module of the port (the burst workload's included) and the two
    # card scripts: no import or from line names jax, flax, optax, orbax or
    # gennet_tpu (gennet_tpu_torch is the port itself)
    import glob
    import re

    files = sorted(glob.glob(os.path.join(REPO, "gennet_tpu_torch", "**", "*.py"), recursive=True))
    files += [os.path.join(REPO, name) for name in ("chip_smoke.py", "kernel_times.py")]
    assert os.path.join(REPO, "gennet_tpu_torch", "physics", "burst.py") in files
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|gennet_tpu)\b(?!_torch)")
    hits = [f"{os.path.relpath(f, REPO)}:{i}: {line.strip()}"
            for f in files for i, line in enumerate(open(f), 1) if bad.match(line)]
    assert hits == []
