"""Spawned ranks for the port's data-parallel tests on the CPU.

:func:`spawn` starts ``world`` processes (the ``spawn`` start method),
joins them into a gloo world through a ``file://`` store under the
caller's temporary directory (no port is taken, so parallel test workers
never collide), runs one of this module's case functions on each rank and
returns the ranks' results by rank. The collectives time out after
``timeout`` seconds and the join after a little more, so a rank that
hangs fails the test in seconds. Each child runs torch on two threads.

This module imports the port only: a child re-imports it, and JAX has no
place there.
"""

import functools
import os
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.multiprocessing as mp

G_FEAT, D_FEAT, PE_FEAT = (16, 16, 32, 32, 64), (16, 32), (8, 8, 16, 16)


def _child(fn, rank, world, store, timeout, args, queue):
    from gennet_tpu_torch.train.mesh import init_data_mesh

    torch.set_num_threads(2)
    try:
        mesh = init_data_mesh("cpu", world=world, rank=rank, init_method=f"file://{store}",
                              timeout=timedelta(seconds=timeout))
        try:
            queue.put((rank, "ok", fn(mesh, *args)))
        finally:
            mesh.close()
    except BaseException as e:  # reported to the parent, which raises
        queue.put((rank, "error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def spawn(fn, world: int, tmp_path, *args, timeout: float = 60.0) -> list:
    """``fn(mesh, *args)`` on each of ``world`` spawned ranks; returns the
    results by rank. Raises ``RuntimeError`` with a rank's traceback if one
    failed, or if a rank did not answer within ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{os.getpid()}")
    procs = [ctx.Process(target=_child, args=(fn, r, world, store, timeout, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:  # drain before joining
            rank, status, value = queue.get(timeout=timeout + 30)
            (results.__setitem__(rank, value) if status == "ok" else errors.append(value))
    except Exception as e:  # queue.Empty: a rank hung or died
        errors.append(f"no answer from every rank within {timeout + 30:.0f} s ({e!r})")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def narrow_models():
    """Narrow the flagship networks the workloads build (this process only)."""
    from gennet_tpu_torch.cli import workloads as twl
    from gennet_tpu_torch.models import (BBHGenerator, BurstGenerator, CombinedPE,
                                         PairDiscriminator)

    twl.BBHGenerator = functools.partial(BBHGenerator, features=G_FEAT)
    twl.PairDiscriminator = functools.partial(PairDiscriminator, features=D_FEAT)
    twl.CombinedPE = functools.partial(CombinedPE, features=PE_FEAT)
    twl.BurstGenerator = functools.partial(BurstGenerator, features=(8, 8, 16, 16))


def state_digest(*modules) -> list:
    """Every parameter and floating buffer of ``modules``, as numpy."""
    return [t.detach().cpu().numpy().copy() for m in modules
            for t in list(m.parameters()) + [b for b in m.buffers() if b.is_floating_point()]]


def opt_digest(*opts) -> list:
    """Every tensor of the optimisers' states, as numpy."""
    out = []
    for o in opts:
        for s in o.state.values():
            out += [v.detach().cpu().numpy().copy() for _, v in sorted(s.items())]
    return out


# ------------------------------------------------------------ step cases


def _batch(np_batch: dict):
    from gennet_tpu_torch.train import gan as tgan

    t = {k: (None if v is None else torch.tensor(v)) for k, v in np_batch.items()}
    return tgan.GANBatch(z1=t["z1"], real=t["real"], fresh=t["fresh"], in_real=t["in_real"],
                         in_fake=t["in_fake"], in_g=t["in_g"], y_real=t["y_real"],
                         y_fake=t["y_fake"], z3=t["z3"], z2=t["z2"])


def gan_and_cnn_updates(mesh, gan_case: dict, cnn_case: dict, n_pix: int):
    """One data-parallel GAN update and one CNN update from given weights
    on this rank's given batch; returns the metrics, the weights, the BN
    running statistics and the Adam states."""
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.train import cnn as tcnn
    from gennet_tpu_torch.train import gan as tgan

    cfg = tgan.GANConfig(**gan_case["cfg"])
    G = BBHGenerator(n_out=n_pix, features=G_FEAT, drate=0.0)
    D = PairDiscriminator(features=D_FEAT, drate=0.0, n_pix=n_pix)
    state = tgan.init_gan(torch.Generator().manual_seed(mesh.rank), G, D, cfg, "cpu")
    if mesh.is_main:  # the reference's weights on rank 0 only: the broadcast carries them
        G.load_state_dict(gan_case["g_sd"])
        D.load_state_dict(gan_case["d_sd"])
    mesh.broadcast_modules_(G, D)
    batch = _batch(gan_case["batches"][mesh.rank])
    state, m = tgan.gan_update(state, batch, torch.tensor(gan_case["measured"]), cfg=cfg,
                               mesh=mesh)
    gan_out = {"metrics": {k: float(v) for k, v in m.items()},
               "g": {k: v.numpy().copy() for k, v in G.state_dict().items()},
               "d": {k: v.numpy().copy() for k, v in D.state_dict().items()},
               "opt": [opt_digest(o) for o in (state.g_opt, state.d_opt, state.g_res_opt)]}

    ccfg = tcnn.CNNConfig(**cnn_case["cfg"])
    pe = BNPE(n_pix)
    cstate = tcnn.init_cnn(torch.Generator().manual_seed(mesh.rank), pe, ccfg, "cpu")
    if mesh.is_main:
        pe.load_state_dict(cnn_case["sd"])
    mesh.broadcast_modules_(pe)
    x, y = cnn_case["batches"][mesh.rank]
    cstate, cm = tcnn.cnn_update(cstate, torch.tensor(x), torch.tensor(y), cfg=ccfg, mesh=mesh)
    cnn_out = {"pe_loss": float(cm["pe_loss"]),
               "sd": {k: v.numpy().copy() for k, v in pe.state_dict().items()},
               "opt": opt_digest(cstate.opt)}
    return gan_out, cnn_out


# ------------------------------------------------------------ workload cases


def run_workload(mesh, which: str, cfg_dict: dict):
    """``run_bbh`` or ``run_burst_smoke`` at narrow widths on this rank;
    returns (summary or None, digest of the final networks)."""
    from gennet_tpu_torch.cli import workloads as twl

    narrow_models()
    captured = {}
    init_gan = twl.init_gan

    def keep(*a, **k):
        captured["state"] = init_gan(*a, **k)
        return captured["state"]

    twl.init_gan = keep
    if which == "bbh":
        out = twl.run_bbh(twl.BBHConfig(**cfg_dict), device="cpu", mesh=mesh)
    else:
        out = twl.run_burst_smoke(twl.BurstSmokeConfig(**cfg_dict), device="cpu", mesh=mesh)
    st = captured["state"]
    return out, state_digest(st.generator, st.discriminator) + opt_digest(st.g_opt, st.d_opt)


def refusals(mesh, tmp: str):
    """What a world of 2 refuses before any work; returns the messages and
    what ``tmp`` holds afterwards."""
    from gennet_tpu_torch.cli import workloads as twl

    os.makedirs(tmp, exist_ok=True)
    if mesh.is_main:
        rng = np.random.default_rng(0)
        np.savez(os.path.join(tmp, "odd.npz"), templates=rng.normal(size=(7, 256)).astype("f4"),
                 mc=np.full(7, 30.0, "f4"), q=np.full(7, 0.8, "f4"))
    mesh.barrier()
    got = {}
    cases = {
        "bbh_training_num": lambda: twl.run_bbh(
            twl.BBHConfig(training_num=24, n_pix=256, plots=False,
                          out_dir=os.path.join(tmp, "r1")), device="cpu", mesh=mesh),
        "bbh_bank_file": lambda: twl.run_bbh(
            twl.BBHConfig(bank_file=os.path.join(tmp, "odd.npz"), n_pix=256, plots=False,
                          out_dir=os.path.join(tmp, "r2")), device="cpu", mesh=mesh),
        "burst_n_signals": lambda: twl.run_burst_smoke(
            twl.BurstSmokeConfig(n_signals=511, n_pix=128, plots=False,
                                 out_dir=os.path.join(tmp, "r3")), device="cpu", mesh=mesh),
    }
    for name, fn in cases.items():
        try:
            fn()
            got[name] = None
        except ValueError as e:
            got[name] = str(e)
    got["dirs"] = sorted(os.listdir(tmp))
    return got


def sharded_bank(mesh, n: int, fs: int, seed: int):
    """``make_bank_sharded`` of ``n`` rows at ``fs``; returns the gathered
    bank and params as numpy."""
    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.physics import psd as psd_mod
    from gennet_tpu_torch.train.mesh import rank_generator

    cfg = tb.BankConfig(fs=fs)
    psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device="cpu")
    t, p = tb.make_bank_sharded(rank_generator(seed, mesh.rank, "cpu"), n, psd, mesh, cfg)
    return t.numpy(), {k: v.numpy() for k, v in p.items()}


class BNPE(torch.nn.Module):
    """A PE with BatchNorm and no dropout, for the CNN step's parity: Conv(8,
    5, s2, SAME) → tanh → BatchNorm(0.9) → Dense(2) on (B, n_pix, 1), the
    flatten channels-last as flax's. Its flax twin is in the test."""

    def __init__(self, n_pix: int):
        from gennet_tpu_torch.models.layers import BatchNorm, Conv1d, Dense

        super().__init__()
        self.conv = Conv1d(1, 8, 5, stride=2)
        self.bn = BatchNorm(8, 0.9)
        self.dense = Dense(8 * (n_pix // 2), 2)

    def forward(self, x, train: bool = False, gen=None):
        h = self.bn(torch.tanh(self.conv(x.transpose(1, 2))), batch_stats=train, commit=train)
        return self.dense(h.transpose(1, 2).reshape(h.shape[0], -1))


def _ckpt_digest(path: str) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return {"world": payload["world"], "step": payload["step"],
            "state": _flat(payload["state"]), "rank_extra": _flat(payload["rank_extra"])}


def _flat(tree, prefix="") -> dict:
    """A nested state as {path: numpy array or plain value}."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}.{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}.{i}").items()}
    return {prefix: tree.numpy().copy() if torch.is_tensor(tree) else tree}


def workload_suite(mesh, tmp: str, bbh: dict, burst: dict):
    """The workloads at narrow widths on every rank of the world: a burst
    ``smoke``; ``train-bbh`` for 4 GAN steps; the same stopped after 2
    and resumed to 4; the sharded bank; and the refusals. Returns, by
    case, rank 0's summary (None elsewhere), this rank's digest of its
    final networks, and the resumed and uninterrupted checkpoints."""
    out = {"burst": run_workload(mesh, "burst", dict(burst, out_dir=os.path.join(tmp, "burst")))}
    full = dict(bbh, out_dir=os.path.join(tmp, "full"))
    out["bbh"] = run_workload(mesh, "bbh", full)
    part = dict(bbh, out_dir=os.path.join(tmp, "part"), gan_iters=2)
    run_workload(mesh, "bbh", part)
    out["resumed"] = run_workload(mesh, "bbh", dict(part, gan_iters=bbh["gan_iters"],
                                                    resume=True))
    step = bbh["gan_iters"]
    if mesh.is_main:
        out["ckpts"] = [_ckpt_digest(os.path.join(tmp, d, "ckpt_gan", f"ckpt_{step}.pt"))
                        for d in ("full", "part")]
    out["bank"] = sharded_bank(mesh, 8, 256, 1)
    out["refusals"] = refusals(mesh, os.path.join(tmp, "refuse"))
    return out
