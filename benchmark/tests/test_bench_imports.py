"""The harness, every metric, phase and family file, a tiny CPU run of every
cell and the reference load no module whose top-level name (the part before the first dot) is
JAX's or the JAX package's; the reference loads nothing of the program
either. Each check runs in a fresh interpreter, so it sees only what
those files import."""

import json
import os
import subprocess
import sys

from benchmark.harness import cell
from benchmark.harness.env import FORBIDDEN

LOAD_ALL = """
import glob, importlib.util, json, os, sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.calibrate, benchmark.harness.cell
from benchmark.harness import compare, convtime, costs, env, flops, loops, readers, spans, trace
for d in ("families", "metrics", "phases"):
    for p in sorted(glob.glob(os.path.join({bench!r}, d, "*.py"))):
        spec = importlib.util.spec_from_file_location("m_" + os.path.basename(p)[:-3].replace(".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
import torch
from benchmark.tests import small
torch.set_num_threads(2)
for w in small.CELLS:  # what a run loads: a tiny run of every cell on the CPU
    benchmark.harness.cell.run_cell(w, 5, 0.01, False, device="cpu", overrides=small.overrides(w))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import glob, importlib, os
import benchmark.reference.steps, benchmark.reference.nets
for p in sorted(glob.glob(os.path.join({bench!r}, "reference", "*.py"))):
    importlib.import_module("benchmark.reference." + os.path.basename(p)[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=cell.ROOT, bench=cell.BENCH)],
                         capture_output=True, text=True, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(LOAD_ALL)
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert "gennet_tpu_torch" in names  # the program, whose name begins with the JAX package's


def test_reference_loads_neither_jax_nor_the_program():
    names = _top_level(LOAD_REFERENCE)
    assert not names & (set(FORBIDDEN) | {"gennet_tpu_torch"})
