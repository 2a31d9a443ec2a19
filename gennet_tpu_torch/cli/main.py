"""gennet-tpu-torch CLI: ``make-bank``, ``train-cnn``, ``train-gan``,
``train-bbh``, ``sample-posterior``, ``smoke``, ``blob-toy``, ``image-gan``
and ``make-mdc``.

The flags are the JAX CLI's: every ``BBHConfig`` / ``BurstSmokeConfig`` /
``BlobToyConfig`` / ``ImageGANConfig`` field is a flag (``--pe-iters``,
``--grid-grain``, …), ``make-bank`` takes
``-N -f -T -m -z -b --beta --lalinf-dir``, ``sample-posterior`` adds
``--n-samples`` and ``--out``, and ``make-mdc`` (host only) takes the JAX
CLI's flags. The port adds ``--device`` (default ``cuda``; the run fails
rather than fall back when CUDA is unavailable).

``--data-parallel`` (``make-bank``, ``train-cnn``, ``train-gan``,
``train-bbh``, ``smoke``, ``blob-toy``, ``image-gan``; the last two take it
to their GAN step only, as the reference does) runs the reference's data
parallelism over ``torch.distributed`` (:mod:`gennet_tpu_torch.train.mesh`):
one process per card under ``torchrun``,

    torchrun --standalone --nproc_per_node=8 -m gennet_tpu_torch.cli.main train-bbh --data-parallel

or, without torchrun, a world of one process, which equals the run
without the flag bit for bit (``make-bank`` excepted: the sharded bank is
one synthesis per rank, with no event twin, as in the reference).

The reference's staged workflow (plots are on by default and need
matplotlib; ``--plots false`` turns them off):

    python -m gennet_tpu_torch.cli.main make-bank -b templates/bank.gntb
    python -m gennet_tpu_torch.cli.main train-cnn --bank-file templates/bank.gntb
    python -m gennet_tpu_torch.cli.main train-gan --bank-file templates/bank.gntb
    python -m gennet_tpu_torch.cli.main sample-posterior --out posterior.npz
"""

import argparse
import dataclasses
import json
import os

from gennet_tpu_torch.cli.workloads import (BBHConfig, BlobToyConfig, BurstSmokeConfig,
                                            ImageGANConfig)


def _add_dataclass_args(parser, dc_type):
    for f in dataclasses.fields(dc_type):
        arg = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=f.default)
        elif f.default is None:
            parser.add_argument(arg, type=str, default=None)
        else:
            parser.add_argument(arg, type=type(f.default), default=f.default)


def _build_dataclass(args, dc_type):
    names = {f.name for f in dataclasses.fields(dc_type)}
    return dc_type(**{k: v for k, v in vars(args).items() if k in names})


def make_bank(args, mesh=None):
    """Write a whitened template bank (ref: gennet_tpu/cli/main.py:119-152):
    ``.gntb`` through the native bank store, anything else as ``.npz``.
    Under a ``mesh`` the bank is cut to a multiple of the world size and
    synthesized by :func:`~gennet_tpu_torch.data.template_bank.
    make_bank_sharded`; rank 0 writes it."""
    import torch

    from gennet_tpu_torch.data import lalinf_io
    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.physics import psd as psd_mod
    from gennet_tpu_torch.train.mesh import rank_generator

    device = args.device if mesh is None else mesh.device
    cfg = tb.BankConfig(fs=args.fsample, T_obs=args.tobs, mdist=args.mdist, beta=tuple(args.beta))
    norm = 1.0
    if args.lalinf_dir:
        prod = lalinf_io.load_event_products(args.lalinf_dir, fs=cfg.fs,
                                             T_safe=cfg.T_obs * cfg.safe)
        psd = torch.as_tensor(prod["psd"], dtype=torch.float32, device=device)
        norm = prod["norm_constant"]
    else:
        psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device=device)
    if mesh is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        t, p = tb.make_bank(gen, args.nsamp, psd, cfg, norm)
    else:
        n = args.nsamp - args.nsamp % mesh.world
        gen = rank_generator(args.seed, mesh.rank, device)
        t, p = tb.make_bank_sharded(gen, n, psd, mesh, cfg, norm)
        if not mesh.is_main:
            return None
    t, p = t.cpu().numpy(), {k: v.cpu().numpy() for k, v in p.items()}
    p["idx"] = p["idx"].astype("int32")  # the JAX bank's index dtype
    os.makedirs(os.path.dirname(args.basename) or ".", exist_ok=True)
    if args.basename.endswith(".gntb"):
        from gennet_tpu_torch.data import bankstore

        bankstore.write_bank(args.basename, t, p)
    else:
        lalinf_io.save_bank_npz(args.basename, t, p)
    return {"templates": int(t.shape[0]), "file": args.basename}


def make_mdc(args):
    """A hardware-injection MDC set (ref: gennet_tpu/cli/main.py:187-215):
    sim_burst XML, and with ``--render-dir`` one ASCII strain file per
    injection per detector. Host numpy, from ``--seed``: the same files as
    the JAX CLI's."""
    import numpy as np

    from gennet_tpu_torch.data import mdc_xml as M

    rng = np.random.default_rng(args.seed)
    mdcset = M.MDCSet(args.detectors.split(","))
    times = M.uniform_time(args.gps_start, args.gps_stop, args.number, rng=rng)
    hrss = M.log_uniform(args.hrss[0], args.hrss[1], args.number, rng=rng)
    for h, t in zip(hrss, times):
        if args.kind == "sine-gaussian":
            # ref make_hw-xml.py (sineGauss variant): q=15, f ~ U[100,200]
            mdcset + M.sine_gaussian(q=args.q, frequency=float(rng.uniform(*args.f_range)),
                                     hrss=float(h), time=float(t))
        else:
            # ref make_hw-xml.py (wnb variant): 0.1 s, 10 Hz bw @ 1 kHz
            mdcset + M.white_noise_burst(duration=0.1, bandwidth=10.0, frequency=1000.0,
                                         hrss=float(h), time=float(t), seed=args.seed)
    os.makedirs(os.path.dirname(args.xml) or ".", exist_ok=True)
    mdcset.save_xml(args.xml)
    out = {"injections": len(mdcset.injections), "xml": args.xml}
    if args.render_dir:
        out["files"] = len(M.render_injection_files(mdcset, args.render_dir))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="gennet-tpu-torch",
                                     description="GAN-based GW parameter estimation (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_bank = sub.add_parser("make-bank", help="generate a whitened template bank")
    p_bank.add_argument("-N", "--nsamp", type=int, default=50_000)
    p_bank.add_argument("-f", "--fsample", type=int, default=1024)
    p_bank.add_argument("-T", "--tobs", type=int, default=2)
    p_bank.add_argument("-m", "--mdist", type=str, default="hunt_constrain")
    p_bank.add_argument("-z", "--seed", type=int, default=1)
    p_bank.add_argument("-b", "--basename", type=str, default="templates/bank.npz")
    p_bank.add_argument("--beta", type=float, nargs=2, default=[0.45, 0.55])
    p_bank.add_argument("--data-parallel", action="store_true")
    p_bank.add_argument("--lalinf-dir", type=str, default=None)

    for name, help_, dc in (("train-cnn", "train the CNN point estimator", BBHConfig),
                            ("train-gan", "train the GAN waveform estimator", BBHConfig),
                            ("train-bbh", "full flagship pipeline (CNN then GAN)", BBHConfig),
                            ("smoke", "sine-Gaussian burst smoke workload", BurstSmokeConfig),
                            ("blob-toy", "gen-1 blob-image toy (PE + MC-dropout + image GAN)",
                             BlobToyConfig),
                            ("image-gan", "gen-1 image-directory GAN (face-image mode)",
                             ImageGANConfig)):
        p = sub.add_parser(name, help=help_)
        _add_dataclass_args(p, dc)
        p.add_argument("--data-parallel", action="store_true")

    p_mdc = sub.add_parser("make-mdc", help="build a hardware-injection MDC set "
                           "(sim_burst XML + per-injection ASCII strain files)")
    p_mdc.add_argument("--kind", choices=("sine-gaussian", "wnb"), default="sine-gaussian")
    p_mdc.add_argument("-n", "--number", type=int, default=1000)
    p_mdc.add_argument("--gps-start", type=int, default=1126620016)
    p_mdc.add_argument("--gps-stop", type=int, default=1136995216)
    p_mdc.add_argument("--hrss", type=float, nargs=2, default=[5e-23, 1e-20])
    p_mdc.add_argument("--f-range", type=float, nargs=2, default=[100.0, 200.0])
    p_mdc.add_argument("-q", type=float, default=15.0)
    p_mdc.add_argument("--detectors", type=str, default="H1,L1")
    p_mdc.add_argument("--xml", type=str, default="mdc/set.xml.gz")
    p_mdc.add_argument("--render-dir", type=str, default=None,
                       help="also write per-injection ASCII strain files here")
    p_mdc.add_argument("--seed", type=int, default=3)

    p_samp = sub.add_parser("sample-posterior", help="draw posterior samples from trained models")
    _add_dataclass_args(p_samp, BBHConfig)
    p_samp.add_argument("--n-samples", type=int, default=4000)
    p_samp.add_argument("--out", type=str, default="posterior.npz")

    for p in sub.choices.values():
        if p is not p_mdc:
            p.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.cmd == "make-mdc":
        out = make_mdc(args)
        print(json.dumps(out))
        return out

    from gennet_tpu_torch import runtime
    from gennet_tpu_torch.cli import workloads

    info = runtime.setup(args.device)
    mesh = None
    if getattr(args, "data_parallel", False):
        from gennet_tpu_torch.train.mesh import init_data_mesh

        mesh = init_data_mesh(args.device, command=args.cmd)
        info = runtime.setup(str(mesh.device))  # this rank's card
    try:
        main_rank = mesh is None or mesh.is_main
        device = args.device if mesh is None else mesh.device
        if main_rank:
            print(json.dumps({"runtime": info}))
        if args.cmd == "make-bank":
            out = make_bank(args, mesh)
        elif args.cmd == "smoke":
            out = workloads.run_burst_smoke(_build_dataclass(args, BurstSmokeConfig),
                                            device=device, mesh=mesh)
        elif args.cmd == "blob-toy":
            out = workloads.run_blob_toy(_build_dataclass(args, BlobToyConfig), device=device,
                                         mesh=mesh)
        elif args.cmd == "image-gan":
            out = workloads.run_image_gan(_build_dataclass(args, ImageGANConfig), device=device,
                                          mesh=mesh)
        elif args.cmd == "sample-posterior":
            out = workloads.sample_posterior(_build_dataclass(args, BBHConfig),
                                             n_samples=args.n_samples, out=args.out,
                                             device=device)
        else:
            cfg = _build_dataclass(args, BBHConfig)
            if args.cmd == "train-cnn":
                cfg = dataclasses.replace(cfg, gan_iters=0)
            elif args.cmd == "train-gan":
                cfg = dataclasses.replace(cfg, pe_iters=0, resume=True)
            out = workloads.run_bbh(cfg, device=device, mesh=mesh)
    finally:
        if mesh is not None:
            mesh.close()
    if main_rank:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
