"""Run one cell of the benchmark of ``gennet_tpu_torch`` on a CUDA card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It prints the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``) as one JSON object,
the last line of standard output, and each number compared with the plain
reference beside its limit as the last lines of standard error. It exits
with a code other than 0, and prints no result, without a card (or with
fewer than the cell asks for), where the program is missing, or where JAX
or the JAX package has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import env

    env.pin_caches(ROOT)
    try:
        from benchmark.harness import cell

        spec = cell.cell_spec(cell.load_json(ROOT, "BENCHMARK.json"), args.workload)
        env.require_cards(spec["chips"])
        result = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    except env.NoCard as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 3
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        print("benchmark: the run failed; no result", file=sys.stderr)
        return 1
    found = env.forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6e} (limit {c['limit']:.6e})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
