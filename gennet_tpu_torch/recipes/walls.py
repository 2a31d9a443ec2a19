"""Where a recipe run's time went, read from its time-stamped log.

``stamp`` copies standard input to standard output with each line
prefixed by the seconds since the stamp began; ``split`` reads such a log
of one ``run_bbh`` or ``run_burst_smoke`` run and prints one JSON object
of walls, in seconds:

- ``to_pe_end``: from the first line to the end of the PE phase
  (``Completed CNN PE``): process start, kernel builds, bank, grid and
  the PE loop;
- ``pe_loop``: the first PE status line to the last (a cached PE has none);
- ``gan_train``: the GAN phase less its evaluations;
- ``evals``: each evaluation, from the status line of its step to its
  last score line (``beta result:``; the burst's ``grid overlap:`` or
  ``cloud ELBO:``), summed (``n_evals`` of them);
- ``final``: from the last status line, or the end of its evaluation, to
  the result line (the final draw, the library selection, the scoring);
- ``total``: the first line to the result line.

Status lines are ``<step>: [...]`` lines; PE ones carry ``[PE loss``.

Usage: python -u -m gennet_tpu_torch.recipes.bbh_sweep r4flag 0 50000 2>&1 \\
         | python -u -m gennet_tpu_torch.recipes.walls stamp > run.log
       python -m gennet_tpu_torch.recipes.walls split run.log
"""

import json
import re
import sys
import time

# the starts of the lines a split looks for, as the workloads print them
# (tests/test_torch_recipes.py holds each against their source)
_STATUS = re.compile(r"^\d+:\s+\[")
PE_END = "Completed CNN PE"
FINAL = ("library-selected posterior", "final-state", "residual whiteness")
RESULT = ("SWEEP RESULT:", "FLAGSHIP RESULT:")
# the last line an evaluation prints: run_bbh's, then run_burst_smoke's
EVAL_END = ("beta result:", "grid overlap:", "cloud ELBO:")


def stamp(src=sys.stdin, dst=sys.stdout):
    t0 = time.perf_counter()
    for line in src:
        dst.write(f"{time.perf_counter() - t0:.3f} {line}")
        dst.flush()


def split(lines) -> dict:
    """The walls of one run from its stamped ``lines`` (see the module)."""
    rows = []
    for line in lines:
        t, _, text = line.rstrip("\n").partition(" ")
        try:
            rows.append((float(t), text))
        except ValueError:
            continue
    t_first = rows[0][0]
    t_pe_end = next(t for t, x in rows if x.startswith(PE_END))
    t_end = next((t for t, x in rows if x.startswith(RESULT)), rows[-1][0])
    pe = [t for t, x in rows if _STATUS.match(x) and "[PE loss" in x]
    evals, n_evals = 0.0, 0
    t_status, t_eval_end, t_final_start = None, None, t_pe_end
    for t, x in rows:
        if t < t_pe_end:
            continue
        closes = _STATUS.match(x) or x.startswith(FINAL + RESULT)
        if closes and t_eval_end is not None:
            evals += t_eval_end - t_status
            n_evals += 1
            t_final_start = t_eval_end
        if _STATUS.match(x):
            t_status, t_eval_end, t_final_start = t, None, t
        elif closes:
            break
        elif t_status is not None and x.startswith(EVAL_END):
            t_eval_end = t
    return {"to_pe_end": t_pe_end - t_first,
            "pe_loop": pe[-1] - pe[0] if pe else 0.0,
            "gan_train": t_final_start - t_pe_end - evals,
            "evals": evals, "n_evals": n_evals,
            "final": t_end - t_final_start,
            "total": t_end - t_first}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["stamp"]:
        stamp()
    elif argv[:1] == ["split"] and len(argv) == 2:
        with open(argv[1]) as fh:
            print(json.dumps(split(fh)))
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main()
