"""What the per-layer metrics of the program's own spans read: the records
of ``gennet_tpu_torch.runtime.trace`` in the process that ran the cell,
``(id, name, start_ns, end_ns, parent_id, attrs)`` each, on the clock of
:mod:`benchmark.harness.spans`. Each reader returns ``None`` where there
is nothing to read: a program without the recorder, or a run without the
spans (on the CPU no graph span exists)."""

import statistics


def records():
    """The program's span records, or ``None`` where it keeps none."""
    try:
        from gennet_tpu_torch.runtime import trace
    except ImportError:
        return None
    return trace.spans()


def _seconds(names) -> float | None:
    recs = [r for r in records() or () if r[1] in names]
    return sum(r[3] - r[2] for r in recs) * 1e-9 if recs else None


def chunk_prep_ms(run):
    """Median ms from a window chunk's ``chunk`` span to the start of its
    ``graph.replay`` child: the host's work before the card gets the
    chunk's replays. The window's chunks are the first ``len(run.call_s)``
    of ``run.chunk`` iterations that replay and capture nothing (which
    leaves out the checked calls, the warm-up chunk and the calls after
    the window)."""
    recs = records()
    if not recs:
        return None
    kids = {}
    for r in recs:
        if r[4] is not None:
            kids.setdefault(r[4], {}).setdefault(r[1], r)
    preps = []
    for c in sorted(recs, key=lambda r: r[2]):
        if c[1] != "chunk" or c[5].get("n") != run.chunk:
            continue
        k = kids.get(c[0], {})
        if "graph.replay" in k and "graph.capture" not in k:
            preps.append((k["graph.replay"][2] - c[2]) * 1e-6)
    preps = preps[:len(run.call_s)]
    return statistics.median(preps) if preps else None


def graph_setup_s(run):
    """Seconds of every ``graph.warmup`` and ``graph.capture`` span: the
    eager iterations before each capture, and the captures."""
    return _seconds(("graph.warmup", "graph.capture"))


def optim_init_s(run):
    """Seconds of every ``optim.adam`` span: the optimizers' construction."""
    return _seconds(("optim.adam",))
