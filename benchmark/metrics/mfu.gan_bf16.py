"""``mfu.gan_bf16``: % of the BF16 dense peak (989 TFLOP/s,
:mod:`benchmark.harness.costs_bf16`): the model FLOPs of one iteration
times the traced run's untraced iterations per second, as
:func:`benchmark.harness.readers.mfu` takes them against the TF32 peak.
``None`` in an untraced run."""

from benchmark.harness.costs_bf16 import PEAK_FLOPS_BF16


def read(run):
    if not run.untraced_rate:
        return None
    return 100.0 * run.step_flops * run.untraced_rate / PEAK_FLOPS_BF16
