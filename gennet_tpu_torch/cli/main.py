"""gennet-tpu-torch CLI: ``make-bank``, ``train-cnn``, ``train-gan``,
``train-bbh``, ``sample-posterior`` and ``smoke``.

The flags are the JAX CLI's: every ``BBHConfig`` / ``BurstSmokeConfig``
field is a flag (``--pe-iters``, ``--grid-grain``, …), ``make-bank`` takes
``-N -f -T -m -z -b --beta --lalinf-dir``, and ``sample-posterior`` adds
``--n-samples`` and ``--out``. The port adds ``--device`` (default
``cuda``; the run fails rather than fall back when CUDA is unavailable).
``--data-parallel`` is accepted where the JAX CLI has it and refused when
given: data parallelism is not ported yet.

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

from gennet_tpu_torch.cli.workloads import BBHConfig, BurstSmokeConfig


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


def make_bank(args):
    """Write a whitened template bank (ref: gennet_tpu/cli/main.py:119-152):
    ``.gntb`` through the native bank store, anything else as ``.npz``."""
    import torch

    from gennet_tpu_torch.data import lalinf_io
    from gennet_tpu_torch.data import template_bank as tb
    from gennet_tpu_torch.physics import psd as psd_mod

    cfg = tb.BankConfig(fs=args.fsample, T_obs=args.tobs, mdist=args.mdist, beta=tuple(args.beta))
    norm = 1.0
    if args.lalinf_dir:
        prod = lalinf_io.load_event_products(args.lalinf_dir, fs=cfg.fs,
                                             T_safe=cfg.T_obs * cfg.safe)
        psd = torch.as_tensor(prod["psd"], dtype=torch.float32, device=args.device)
        norm = prod["norm_constant"]
    else:
        psd = psd_mod.analytic_advligo_psd(cfg.fs, cfg.T_obs * cfg.safe, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    t, p = tb.make_bank(gen, args.nsamp, psd, cfg, norm)
    t, p = t.cpu().numpy(), {k: v.cpu().numpy() for k, v in p.items()}
    p["idx"] = p["idx"].astype("int32")  # the JAX bank's index dtype
    os.makedirs(os.path.dirname(args.basename) or ".", exist_ok=True)
    if args.basename.endswith(".gntb"):
        from gennet_tpu_torch.data import bankstore

        bankstore.write_bank(args.basename, t, p)
    else:
        lalinf_io.save_bank_npz(args.basename, t, p)
    return {"templates": int(t.shape[0]), "file": args.basename}


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
                            ("smoke", "sine-Gaussian burst smoke workload", BurstSmokeConfig)):
        p = sub.add_parser(name, help=help_)
        _add_dataclass_args(p, dc)
        p.add_argument("--data-parallel", action="store_true")

    p_samp = sub.add_parser("sample-posterior", help="draw posterior samples from trained models")
    _add_dataclass_args(p_samp, BBHConfig)
    p_samp.add_argument("--n-samples", type=int, default=4000)
    p_samp.add_argument("--out", type=str, default="posterior.npz")

    for p in sub.choices.values():
        p.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if getattr(args, "data_parallel", False):
        raise NotImplementedError("--data-parallel: not ported yet (ROADMAP queue 1 #11)")

    from gennet_tpu_torch import runtime
    from gennet_tpu_torch.cli import workloads

    info = runtime.setup(args.device)
    print(json.dumps({"runtime": info}))
    if args.cmd == "make-bank":
        out = make_bank(args)
    elif args.cmd == "smoke":
        out = workloads.run_burst_smoke(_build_dataclass(args, BurstSmokeConfig),
                                        device=args.device)
    elif args.cmd == "sample-posterior":
        out = workloads.sample_posterior(_build_dataclass(args, BBHConfig),
                                         n_samples=args.n_samples, out=args.out,
                                         device=args.device)
    else:
        cfg = _build_dataclass(args, BBHConfig)
        if args.cmd == "train-cnn":
            cfg = dataclasses.replace(cfg, gan_iters=0)
        elif args.cmd == "train-gan":
            cfg = dataclasses.replace(cfg, pe_iters=0, resume=True)
        out = workloads.run_bbh(cfg, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
