"""gennet-tpu-torch CLI: ``train-bbh``, ``train-cnn`` and ``smoke``.

Every ``BBHConfig`` / ``BurstSmokeConfig`` field is a flag, exactly as in
the JAX CLI (``--pe-iters``, ``--grid-grain``, …), plus ``--device``
(default ``cuda``; the run fails rather than fall back when CUDA is
unavailable). ``--data-parallel`` is accepted as in the JAX CLI and
refused when given: data parallelism is not ported yet.

    python -m gennet_tpu_torch.cli.main train-bbh --plots false
    python -m gennet_tpu_torch.cli.main smoke --plots false
"""

import argparse
import dataclasses
import json

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


def main(argv=None):
    parser = argparse.ArgumentParser(prog="gennet-tpu-torch",
                                     description="GAN-based GW parameter estimation (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, help_, dc in (("train-cnn", "train the CNN point estimator", BBHConfig),
                            ("train-bbh", "full flagship pipeline (CNN then GAN)", BBHConfig),
                            ("smoke", "sine-Gaussian burst smoke workload", BurstSmokeConfig)):
        p = sub.add_parser(name, help=help_)
        _add_dataclass_args(p, dc)
        p.add_argument("--device", type=str, default="cuda")
        p.add_argument("--data-parallel", action="store_true")
    args = parser.parse_args(argv)
    if args.data_parallel:
        raise NotImplementedError("--data-parallel: not ported yet (ROADMAP queue 1 #11)")

    from gennet_tpu_torch import runtime
    from gennet_tpu_torch.cli.workloads import run_bbh, run_burst_smoke

    info = runtime.setup(args.device)
    print(json.dumps({"runtime": info}))
    if args.cmd == "smoke":
        out = run_burst_smoke(_build_dataclass(args, BurstSmokeConfig), device=args.device)
        print(json.dumps(out))
        return out
    cfg = _build_dataclass(args, BBHConfig)
    if args.cmd == "train-cnn":
        cfg = dataclasses.replace(cfg, gan_iters=0)
    out = run_bbh(cfg, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
