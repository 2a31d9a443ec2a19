"""The one home of each posterior and chunk-loop decision of the port's
workload layer (``gennet_tpu_torch.cli.workloads``): the route chain
(``apply_routes``), the chunk rule and the chunked step (``_chunk_size``,
``_chunk_step``), and the lister of the saved clouds beside their writer
(``train.checkpoints.list_posterior_snapshots``).

The route chain is held against the explicit calls of
:mod:`gennet_tpu_torch.eval.posterior_post` it replaced, on a toy forward
model (sine-Gaussians at 64 samples) and a toy linear CNN, with
``ml_recenter`` at a few Adam steps: the cloud, the route, its ELBO and the
generator's state after must all be equal, bit for bit. The whole runs that
call these homes are covered by tests/test_torch_workload_*.py.
"""

import functools
import glob
import os

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from gennet_tpu_torch.cli import workloads as twl
from gennet_tpu_torch.eval import posterior_post as tpp
from gennet_tpu_torch.train.checkpoints import list_posterior_snapshots, save_posterior_snapshot

N_PIX = 64
N_SIG = 0.2
CENTRE = np.array([0.5, 0.04], np.float32)

ROUTES = {
    "none": {},
    "debias": {"pe_debias": 2},
    "bootcal": {"pe_bootcal": 1},
    "mlrc": {"pe_mlrc": 1},
    "reweight": {"reweight_temper": 0.5},
    "chained": {"pe_debias": 1, "pe_bootcal": 1, "pe_mlrc": 1, "reweight_temper": 1.0},
    "select_route": {"select_route": "elbo"},
    "select_route_tempered": {"select_route": "elbo", "reweight_temper": 0.5},
}


def _toy():
    """(cloud, synth, cnn, measured): a CNN cloud around the event's (t0, τ)."""
    rng = np.random.default_rng(3)
    synth = twl.burst_synth(N_PIX, "cpu")
    weights = torch.as_tensor(rng.normal(0.0, 1e-3, (N_PIX, 2)), dtype=torch.float32)

    def cnn(w):
        return torch.as_tensor(CENTRE) + w @ weights

    measured = synth(CENTRE[None, :])[0] + N_SIG * torch.as_tensor(
        rng.normal(size=N_PIX), dtype=torch.float32)
    cloud = (CENTRE + rng.normal(0.0, [0.01, 0.002], (32, 2))).astype(np.float32)
    return cloud, synth, cnn, measured


def _explicit(samples, synth, cnn, measured, gen, cfg):
    """The chain as each caller wrote it out before it had one home."""
    if cfg.select_route == "elbo":
        route, samples, scores = tpp.select_route(
            samples, synth, cnn, measured, N_SIG, gen,
            temper=cfg.reweight_temper if cfg.reweight_temper > 0 else 1.0)
        return samples, route, scores[route], route.endswith("reweight"), []
    lines = []
    if cfg.pe_debias > 0:
        samples = tpp.self_calibrate(samples, synth, cnn, gen, N_SIG, rounds=cfg.pe_debias)
    if cfg.pe_bootcal > 0:
        samples = tpp.bootstrap_calibrate(samples, synth, cnn, gen, N_SIG)
    if cfg.pe_mlrc > 0:
        samples = tpp.ml_recenter(samples, synth, measured, gen)
    if cfg.reweight_temper > 0:
        ess = tpp.effective_sample_size(samples, synth, measured, N_SIG, cfg.reweight_temper)
        samples = tpp.likelihood_resample(samples, synth, measured, N_SIG, gen,
                                          temper=cfg.reweight_temper)
        lines.append(f"likelihood resample ESS: {ess:.1f}/{len(samples)}")
    return samples, None, None, cfg.reweight_temper > 0, lines


@pytest.mark.parametrize("report", [True, False], ids=["report", "quiet"])
@pytest.mark.parametrize("routes", list(ROUTES))
def test_apply_routes_equals_the_explicit_chain(monkeypatch, capsys, routes, report):
    monkeypatch.setattr(tpp, "ml_recenter", functools.partial(tpp.ml_recenter, steps=4))
    cloud, synth, cnn, measured = _toy()
    cfg = twl.BurstSmokeConfig(**ROUTES[routes])
    ref_gen, gen = (torch.Generator().manual_seed(11) for _ in range(2))
    ref, ref_route, ref_elbo, ref_resampled, lines = _explicit(cloud, synth, cnn, measured,
                                                               ref_gen, cfg)
    got, route, elbo, resampled = twl.apply_routes(cloud, synth, cnn, measured, N_SIG, gen, cfg,
                                                   report=report)

    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert (route, elbo, resampled) == (ref_route, ref_elbo, ref_resampled)
    assert torch.equal(gen.get_state(), ref_gen.get_state())  # the same draws, no more
    if routes == "none":
        assert got is cloud  # run_bbh's test of "post-processed?"
    if route is not None:
        lines = [f"auto route: {route} (ELBO {elbo:.1f})"]
    assert capsys.readouterr().out.splitlines() == (lines if report else [])


# (operands of each loop's call) → chunk: the schedule, and where the loop
# has them the evals, the checkpoints and the start, must all divide
CHUNKS = {
    "bbh_pe": ((10, 100, 50, 0), 10),          # pe_cadence; pe_iters, ckpt_every, start
    "bbh_pe_cadence_1": ((1, 100, 50, 0), 1),
    "bbh_pe_schedule": ((10, 105, 50, 0), 1),
    "bbh_pe_ckpt": ((10, 100, 55, 0), 1),
    "bbh_pe_start": ((10, 100, 50, 5), 1),
    "bbh_gan": ((5, 100, 20, 50, 40), 5),      # cadence; gan_iters, eval, ckpt_every, start
    "bbh_gan_cadence_1": ((1, 100, 20, 50, 0), 1),
    "bbh_gan_schedule": ((5, 102, 20, 50, 0), 1),
    "bbh_gan_eval": ((5, 100, 22, 50, 0), 1),
    "bbh_gan_ckpt": ((5, 100, 20, 52, 0), 1),
    "bbh_gan_start": ((5, 100, 20, 50, 3), 1),
    "burst_pe": ((3, 6), 3),                   # cadence; pe_iters
    "burst_pe_schedule": ((5, 6), 1),
    "burst_gan": ((100, 50_000), 100),         # cadence; gan_iters
    "burst_gan_cadence_0": ((0, 6), 1),
    "burst_gan_schedule": ((4, 6), 1),
}


@pytest.mark.parametrize("case", list(CHUNKS))
def test_chunk_size_rule(case):
    operands, chunk = CHUNKS[case]
    assert twl._chunk_size(*operands) == chunk


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunk_step_returns_the_last_row(chunk):
    made = []

    def make_step(a, b, mesh=None):
        made.append(("step", a, b, mesh))
        return lambda state, x: (state + 1, {"loss": torch.tensor(float(x))})

    def make_scan(a, b, n, mesh=None):
        made.append(("scan", a, b, n, mesh))
        return lambda state, x: (state + n, {"loss": torch.arange(float(x), float(x + n))})

    step = twl._chunk_step(make_step, make_scan, chunk, "a", "b", mesh="m")
    state, m = step(0, 7)
    assert made == ([("step", "a", "b", "m")] if chunk == 1 else [("scan", "a", "b", 3, "m")])
    assert state == chunk and float(m["loss"]) == 7 + chunk - 1


def test_list_posterior_snapshots_reads_what_the_writer_wrote(tmp_path):
    gan_iters = 4
    directory = str(tmp_path / "GAN_posterior_samples")
    assert list_posterior_snapshots(directory) == []
    written = {step: save_posterior_snapshot(directory, step, np.full((3, 2), step))
               for step in (2, 4, gan_iters + 1, 123_456)}
    (tmp_path / "GAN_posterior_samples" / "notes.npz").write_bytes(b"")
    listed = list_posterior_snapshots(directory)
    assert dict(listed) == written  # the final (gan_iters + 1) cloud among them
    assert [p for _, p in listed] == glob.glob(os.path.join(directory, "posterior_samples_*.npz"))
