"""Narrow copies of the configurations, for CPU tests: every branch the
full cell takes, at widths and sizes a CPU step holds."""

import copy

import torch

from benchmark.harness import cell

CELLS = ("bbh_r4flag-gan", "burst_mlrc_sel-gan", "bbh_r4flag-pe", "burst_mlrc_sel-pe")


def overrides(workload: str) -> dict:
    spec = cell.cell_spec(cell.load_json(cell.ROOT, "BENCHMARK.json"), workload)
    cfg = copy.deepcopy(cell.load_json(cell.BENCH, "configs", spec["config"] + ".json"))
    if cfg["family"] == "bbh":
        small = {"n_pix": 256, "bank": {**cfg["bank"], "fs": 256, "n_templates": 64},
                 "generator": {**cfg["generator"], "features": [16, 16, 32, 32, 32]},
                 "discriminator": {**cfg["discriminator"], "features": [32, 32]},
                 "gan": {**cfg["gan"], "batch_size": 4}, "pe": {**cfg["pe"], "batch_size": 8}}
    else:
        small = {"n_pix": 128, "bank": {**cfg["bank"], "n_templates": 64},
                 "generator": {**cfg["generator"], "features": [16, 16, 32, 32]},
                 "gan": {**cfg["gan"], "batch_size": 8}, "pe": {**cfg["pe"], "batch_size": 8}}
    # a chunk other than the checked calls' (1, 3), so the window's step is a step of its own
    return {"config": small, "traffic": {"chunk": 4}}


def few_threads():
    torch.set_num_threads(2)
