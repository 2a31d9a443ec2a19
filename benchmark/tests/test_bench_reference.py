"""The plain reference against the program, and the comparison's power.

- On the CPU, at narrow widths, the reference's checked iterations agree
  with the program's (gaps of float32 rounding).
- A whole run, the look for a card skipped, with the program's step broken
  underneath, comes out not correct: once for a step that returns its
  state unchanged, once for half of each batch left out (the mean taken
  over the rest). The exchange between cards is no fault here (one card).
- So does a run in which only the window's own step is broken (returns its
  state unchanged, or alters a metric where it is produced), the checked
  iterations sound.
- On the card (``-m gpu``), the control (the reference with TF32 on, the
  precision below the configurations' float32) fails a cell's limits.
"""

import importlib

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import cell
from benchmark.tests.small import CELLS, few_threads, overrides


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_program(workload):
    few_threads()
    r = calibrate.readings_for(workload, 11, "cpu", overrides(workload))
    p = r["program"]
    # change and ema: float32 rounding carried through ReLU kinks and Adam's
    # normalisation (measured up to 9e-4 at these sizes)
    assert p["loss"] < 1e-5 and p["grad"] < 1e-5 and p["change"] < 1e-2, r
    assert p.get("ema", 0.0) < 1e-2, r
    assert max(v for k, v in r["half_batch"].items() if k != "loss_by_iteration") > 0.05, r


def _unchanged(monkeypatch, phase):
    """The program's update computes its metrics and leaves the state
    (parameters, buffers, optimizer state) as it was."""
    from gennet_tpu_torch.train import cnn, gan

    mod, name, tensors = ((gan, "gan_update", gan.state_tensors) if phase == "gan"
                          else (cnn, "cnn_update", cnn.state_tensors))
    real = getattr(mod, name)

    def update(state, *a, **k):
        from gennet_tpu_torch.runtime.optim import init_adam_state

        for opt in ((state.g_opt, state.d_opt, state.g_res_opt) if phase == "gan"
                    else (state.opt,)):
            init_adam_state(opt)
        kept = [t.detach().clone() for t in tensors(state)]
        out = real(state, *a, **k)
        with torch.no_grad():
            for t, b in zip(tensors(state), kept):
                t.copy_(b)
        return out

    monkeypatch.setattr(mod, name, update)


def _half_batch(monkeypatch, phase):
    """The program's batch loses its second half before the update."""
    from gennet_tpu_torch.train import cnn, gan

    if phase == "gan":
        real = gan.draw_gan_batch

        def draw(*a, **k):
            b = real(*a, **k)
            h = b.z1.shape[0] // 2
            for f in ("z1", "real", "fresh", "in_real", "in_fake", "y_real", "y_fake", "z2"):
                v = getattr(b, f)
                if v is not None:
                    setattr(b, f, v[:h])
            b.z3 = b.z3[:, :h]
            b.in_g = None if b.in_g is None else b.in_g[:, :h]
            return b

        monkeypatch.setattr(gan, "draw_gan_batch", draw)
    else:
        real = cnn.draw_cnn_batch

        def draw(*a, **k):
            x, y = real(*a, **k)
            return x[: x.shape[0] // 2], y[: y.shape[0] // 2]

        monkeypatch.setattr(cnn, "draw_cnn_batch", draw)


@pytest.mark.parametrize("fault", ("unchanged", "half_batch"))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    few_threads()
    phase = "gan" if workload.endswith("-gan") else "pe"
    (_unchanged if fault == "unchanged" else _half_batch)(monkeypatch, phase)
    result = cell.run_cell(workload, 13, 0.01, False, device="cpu", overrides=overrides(workload))
    assert result["correct"] is False, result["checks"]


def _window_step_broken(monkeypatch, phase, fault):
    """Only the window's step (the one of ``chunk`` iterations) is broken."""
    loop = importlib.import_module(f"benchmark.phases.{phase}").Loop
    real = loop.make_step

    def make_step(self, n):
        step = real(self, n)
        if n != self.chunk:
            return step

        def broken(state, *a, **k):
            if fault == "unchanged":
                kept = [t.detach().clone() for t in self.tensors()]
                out = step(state, *a, **k)
                with torch.no_grad():
                    for t, b in zip(self.tensors(), kept):
                        t.copy_(b)
                return out
            state, m = step(state, *a, **k)
            key = sorted(m)[0]
            m = {**m, key: m[key].clone()}
            m[key][1] += 1.0  # an answer altered where it is produced
            return state, m

        return broken

    monkeypatch.setattr(loop, "make_step", make_step)


@pytest.mark.parametrize("fault", ("unchanged", "altered"))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_window_step_is_not_correct(workload, fault, monkeypatch):
    few_threads()
    _window_step_broken(monkeypatch, "gan" if workload.endswith("-gan") else "pe", fault)
    result = cell.run_cell(workload, 17, 0.01, False, device="cpu", overrides=overrides(workload))
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["replay"]["value"] > 0, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_tf32_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    ov = {"config": {"bank": {**cell.load_json(cell.BENCH, "configs", workload.split("-")[0]
                                               + ".json")["bank"], "n_templates": 2048}}}
    limits = cell.load_json(cell.BENCH, "limits", workload + ".json")
    for seed in (1, 2, 3):
        r = calibrate.readings_for(workload, seed, "cuda", ov)
        compared = [k for k in limits if k in r["program"]]  # all but the replay check
        assert all(r["program"][k] <= limits[k] for k in compared), r
        assert any(r["control"][k] > limits[k] for k in compared), r
