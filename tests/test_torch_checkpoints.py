"""Checkpoint restore (``gennet_tpu_torch.train.checkpoints``).

- A CNN and a GAN training state, each after a few updates, restore
  bitwise into freshly initialised states: weights, BatchNorm statistics,
  every Adam moment and count, the learning-rate schedule, the EMA and the
  step; the ``extra`` dict carries a ``torch.Generator`` state, so the next
  update after a restore equals the next update without one.
- ``restore`` takes the newest step (or the one asked for), returns
  (None, None) on an empty directory and keeps ``max_to_keep`` files.
- A directory of the JAX package's orbax checkpoints is refused, not read
  as empty.
- A PE saved with its cosine schedule restores into the schedule-free PE
  that ``train-gan`` and ``sample-posterior`` build. The reference cannot:
  its orbax restore of the same pair of states raises (ROADMAP queue 3).
- A checkpoint of a data-parallel world of 2 restores at a world of 1
  only without its per-rank generator states (the CNN cache): asked for
  them, the restore is refused by name.
- Posterior snapshots read the same in both packages.
"""

import copy
import shutil

import numpy as np
import pytest
import torch

from gennet_tpu_torch.models import BBHGenerator, DualBranchPE, PairDiscriminator
from gennet_tpu_torch.train import cnn as tcnn
from gennet_tpu_torch.train import gan as tgan
from gennet_tpu_torch.train.checkpoints import (CheckpointManager, load_posterior_snapshot,
                                                save_posterior_snapshot, state_dict_of)

N = 64
G_FEAT, D_FEAT = (16, 16, 32, 32, 64), (16, 32)


@pytest.fixture(autouse=True)
def delete_checkpoints(tmp_path):
    yield  # a full-width PE checkpoint with its Adam state takes ~50 MB
    shutil.rmtree(tmp_path, ignore_errors=True)


def _pe(decay_steps=10):
    cfg = tcnn.CNNConfig(n_pix=N, ema_decay=0.9, lr_decay_steps=decay_steps)
    return tcnn.init_cnn(torch.Generator().manual_seed(1), DualBranchPE(n_pix=N), cfg, "cpu"), cfg


def _gan():
    cfg = tgan.GANConfig(n_pix=N, batch_size=4, label_smoothing=True, d_instance_noise=0.3,
                         residual_route=True, res_loss_weight=1.0, g_ema_decay=0.9)
    G = BBHGenerator(n_out=N, features=G_FEAT, drate=0.2)
    D = PairDiscriminator(n_pix=N, features=D_FEAT)
    return tgan.init_gan(torch.Generator().manual_seed(2), G, D, cfg, "cpu"), cfg


def _data():
    g = torch.Generator().manual_seed(0)
    return torch.randn(32, N, generator=g), torch.rand(32, 2, generator=g), torch.randn(N,
                                                                                      generator=g)


def _flat(state) -> dict:
    """Every tensor and number of a state (or of its state dict), by path."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, w in v.items():
                walk(f"{prefix}.{k}", w)
        elif isinstance(v, (list, tuple)):
            for i, w in enumerate(v):
                walk(f"{prefix}.{i}", w)
        else:
            out[prefix] = v

    walk("", state if isinstance(state, dict) else state_dict_of(state))
    return out


def _assert_equal_states(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_cnn_state_restores_bitwise_and_resumes(tmp_path):
    bank, targets, _ = _data()
    state, cfg = _pe()
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        tcnn.cnn_step(state, bank, targets, gen, cfg=cfg)
    mgr = CheckpointManager(str(tmp_path / "pe"))
    mgr.save(3, state, extra={"gen": gen.get_state()})

    fresh, _ = _pe()
    restored, extra = mgr.restore(fresh)
    assert restored is fresh and fresh.step == 3 and fresh.ema is not None
    _assert_equal_states(fresh, state)
    # the next update, with the restored generator, equals the live one
    gen2 = torch.Generator().manual_seed(99)
    gen2.set_state(extra["gen"])
    _, m1 = tcnn.cnn_step(state, bank, targets, gen, cfg=cfg)
    _, m2 = tcnn.cnn_step(fresh, bank, targets, gen2, cfg=cfg)
    assert torch.equal(m1["pe_loss"], m2["pe_loss"])
    _assert_equal_states(fresh, state)


def test_gan_state_restores_bitwise_and_resumes(tmp_path):
    bank, _, measured = _data()
    state, cfg = _gan()
    gen = torch.Generator().manual_seed(6)
    for _ in range(2):
        tgan.gan_step(state, bank, measured, gen, cfg=cfg)
    mgr = CheckpointManager(str(tmp_path / "gan"))
    mgr.save(2, state, extra={"gen": gen.get_state()})

    fresh, _ = _gan()
    _, extra = mgr.restore(fresh)
    _assert_equal_states(fresh, state)
    gen.set_state(extra["gen"])
    gen2 = torch.Generator()
    gen2.set_state(extra["gen"])
    _, m1 = tgan.gan_step(state, bank, measured, gen, cfg=cfg)
    _, m2 = tgan.gan_step(fresh, bank, measured, gen2, cfg=cfg)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    _assert_equal_states(fresh, state)


def test_a_copied_state_dict_restores_like_the_state(tmp_path):
    # run_bbh keeps the best-whiteness state as a deep copy of its state
    # dict and saves it at gan_iters + 1
    bank, _, measured = _data()
    state, cfg = _gan()
    tgan.gan_step(state, bank, measured, torch.Generator().manual_seed(7), cfg=cfg)
    snapshot = copy.deepcopy(state_dict_of(state))
    tgan.gan_step(state, bank, measured, torch.Generator().manual_seed(8), cfg=cfg)
    mgr = CheckpointManager(str(tmp_path / "gan"))
    mgr.save(5, snapshot)
    fresh, _ = _gan()
    _, extra = mgr.restore(fresh)
    assert extra is None and fresh.step == 1
    _assert_equal_states(fresh, snapshot)


def test_steps_latest_and_pruning(tmp_path):
    state, _ = _pe()
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    assert mgr.restore(state) == (None, None)
    for step in (1, 5, 3):
        state.step = step
        mgr.save(step, state)
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5  # step 1 pruned
    fresh, _ = _pe()
    assert mgr.restore(fresh)[0].step == 5
    assert mgr.restore(fresh, step=3)[0].step == 3


def test_orbax_directory_is_refused(tmp_path):
    from gennet_tpu.train.checkpoints import CheckpointManager as JaxManager

    JaxManager(str(tmp_path / "ckpt_gan")).save(4, {"w": np.zeros(3, np.float32)})
    mgr = CheckpointManager(str(tmp_path / "ckpt_gan"))
    with pytest.raises(ValueError, match="orbax"):
        mgr.restore(_pe()[0])
    with pytest.raises(ValueError, match="orbax"):
        mgr.latest_step()


def test_scheduled_pe_restores_into_the_schedule_free_pe(tmp_path):
    """train-gan and sample-posterior build the PE with ``lr_decay_steps``
    0 (pe_iters = 0, or CNNConfig's default) while the run that saved it
    had the default cosine schedule."""
    import jax

    from gennet_tpu.models import DualBranchPE as JPE
    from gennet_tpu.train import cnn as jcnn
    from gennet_tpu.train.checkpoints import CheckpointManager as JaxManager

    # the reference: orbax refuses the optimiser tree without the schedule
    saved = jcnn.init_cnn(jax.random.PRNGKey(1), JPE(), jcnn.CNNConfig(n_pix=N, lr_decay_steps=10))
    jm = JaxManager(str(tmp_path / "jax_pe"))
    jm.save(3, saved)
    with pytest.raises(ValueError):
        jm.restore(jcnn.init_cnn(jax.random.PRNGKey(1), JPE(), jcnn.CNNConfig(n_pix=N)))

    # the port: weights, EMA, moments and step restore; the schedule the
    # live state lacks is skipped
    bank, targets, _ = _data()
    state, cfg = _pe(decay_steps=10)
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        tcnn.cnn_step(state, bank, targets, gen, cfg=cfg)
    mgr = CheckpointManager(str(tmp_path / "pe"))
    mgr.save(3, state)
    fresh, _ = _pe(decay_steps=0)
    assert fresh.sched is None
    mgr.restore(fresh)
    assert fresh.sched is None and fresh.step == 3
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in state.ema:
        assert torch.equal(state.ema[k], fresh.ema[k]), k
    x = bank[:8, :, None]
    assert torch.equal(tcnn.predict(state, x, use_ema=True), tcnn.predict(fresh, x, use_ema=True))


class _World2Rank0:
    """Rank 0 of a world of 2 as the manager's save sees it: rank 1's extra
    is this rank's with another generator state."""

    world, rank, is_main = 2, 0, True

    def gather_objects(self, extra):
        return [extra, {"gen": torch.Generator().manual_seed(9).get_state()}]

    def barrier(self):
        pass


@pytest.mark.parametrize("any_world", [False, True])
def test_a_world2_checkpoint_at_world1(tmp_path, any_world):
    state, _ = _pe()
    state.step = 7
    CheckpointManager(str(tmp_path / "c"), mesh=_World2Rank0()).save(
        7, state, extra={"gen": torch.Generator().manual_seed(5).get_state()})
    fresh, _ = _pe()
    mgr = CheckpointManager(str(tmp_path / "c"))
    if not any_world:
        with pytest.raises(ValueError, match="world of 2 ranks.*world of 1 is refused"):
            mgr.restore(fresh)
        assert fresh.step == 0
        return
    restored, extra = mgr.restore(fresh, any_world=True)
    assert restored is fresh and extra is None
    _assert_equal_states(fresh, state)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_posterior_snapshots_read_in_both_packages(tmp_path, writer):
    from gennet_tpu.train import checkpoints as jck

    samples = np.random.default_rng(0).normal(size=(16, 2))
    save = jck.save_posterior_snapshot if writer == "jax" else save_posterior_snapshot
    path = save(str(tmp_path), 7, samples)
    assert path.endswith("posterior_samples_00007.npz")
    np.testing.assert_array_equal(load_posterior_snapshot(path), samples)
    np.testing.assert_array_equal(jck.load_posterior_snapshot(path), samples)
