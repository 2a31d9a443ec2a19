"""What the training phases share (``benchmark/phases/gan.py``, ``pe.py``):
the program's chunk step called back to back, each chunk's last metrics
row fetched to the host, as ``run_bbh``/``run_burst_smoke`` do at their
cadence, and the checks of what that step computes.

One state object lives through the run: set-up builds it from the
benchmark's weights, drives it through its first iterations (the checked
ones, :meth:`TrainLoop.checked_steps`) and through one warm-up chunk of
the window's own step, which captures its CUDA graph; the window then calls
that same step on that same state. Once the window has closed,
:meth:`TrainLoop.replay_check` holds the window's step against the same
iterations run eagerly, and :func:`numbers` holds the checked iterations
against the plain reference.

A phase file gives a subclass (``Loop``), its networks (``NETS``), the
calls of one iteration (``calls``, for the operation counts) and the
reference's run of it (``reference_run``).
"""

import torch

# the checked iterations: one call of one iteration (the optimizers' first
# step, read back from their state), then one of three, whose last
# iteration is a replay of its captured graph
CHECK_CALLS = (1, 3)


class Loop:
    """What :func:`benchmark.harness.cell.run_cell` drives, whatever the
    phase: ``step``, ``chunk`` (the iterations one call completes),
    :meth:`call`, :meth:`fetch`, :meth:`checked_steps` (in set-up; what the
    phase's ``numbers`` reads) and :meth:`replay_check` (after the window).
    The defaults below serve a phase on one card; a phase across cards
    gives its own."""

    def peak_bytes(self, chips: int) -> int:
        """The peak of device memory on the fullest card."""
        return max(torch.cuda.max_memory_allocated(i) for i in range(chips))

    def tracer(self, spans):
        """The profiler of the window's second half (this process's card)."""
        from benchmark.harness.trace import DeviceTrace

        return DeviceTrace(spans)

    def after_window(self, run, traced: bool):
        """Add what the phase's own per-layer metrics read to ``run``."""


class TrainLoop(Loop):
    """``models``: the program's modules, already holding the weights;
    a subclass sets ``self.state`` before calling this constructor."""

    loss_keys = ()

    def __init__(self, cfg, data, models, loop_seed, chunk, device):
        self.cfg, self.data, self.models, self.chunk = cfg, data, models, chunk
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(loop_seed)
        self.step = self.make_step(chunk)

    def make_step(self, n):
        """The program's step of ``n`` iterations a call."""
        raise NotImplementedError

    def call(self, step) -> dict:
        """One call of a chunk step: its metrics, stacked over the chunk."""
        raise NotImplementedError

    def tensors(self) -> list:
        """Every tensor the step keeps between iterations."""
        raise NotImplementedError

    def host_state(self):
        """What the step keeps between iterations outside its tensors."""
        return self.state.step

    def set_host_state(self, kept):
        self.state.step = kept

    def fetch(self, metrics: dict) -> dict:
        """The chunk's last metrics row on the host, as the recipes' loops
        fetch it."""
        from gennet_tpu_torch.train.metrics import fetch_metrics

        return fetch_metrics({k: v[-1] for k, v in metrics.items()})

    def checked_steps(self) -> dict:
        """Run the checked iterations through the window's factory and
        feed, and keep what the comparison reads: the losses of each
        iteration, the optimizers' first gradients (after one) and the
        parameters after the last."""
        rows = []
        first = None
        for n in CHECK_CALLS:
            m = self.call(self.make_step(n))
            rows.append({k: v.detach().float().cpu() for k, v in m.items()})
            if first is None:
                first = self.first_grads()
        losses = {k: torch.cat([r[k] for r in rows]).tolist() for k in self.loss_keys}
        return {"losses": losses, "grad1": first, "params": self.params()}

    def replay_check(self) -> dict:
        """``replay``: the window's own step against the same iterations
        run one at a time, eagerly. From the state the window left, one
        more call of the window's step (on a card, replays of the graph it
        captured in set-up); then, from that state put back (every tensor
        of the step, the generator and what the step keeps on the host),
        as many iterations of a step of one; the largest absolute
        difference of any metric row or state tensor between the two. The
        program's replays equal its eager steps bit for bit, so this reads
        0."""
        tensors = self.tensors()
        kept = [t.detach().clone() for t in tensors]
        gen_state, host = self.gen.get_state(), self.host_state()
        replayed = self.call(self.step)
        after = [t.detach().clone() for t in tensors]
        with torch.no_grad():
            for t, k in zip(tensors, kept):
                t.copy_(k)
        self.gen.set_state(gen_state)
        self.set_host_state(host)
        one = self.make_step(1)
        rows = [self.call(one) for _ in range(self.chunk)]
        gap = 0.0
        for k, v in replayed.items():
            eager = torch.cat([r[k].detach().float().reshape(-1) for r in rows])
            gap = max(gap, float((v.detach().float() - eager).abs().max()))
        for a, t in zip(after, self.tensors()):
            gap = max(gap, float((a.float() - t.detach().float()).abs().max()))
        return {"replay": gap}

    def named(self, module, prefix):
        return {f"{prefix}.{k}": p for k, p in module.named_parameters()}

    def _moments(self, opt, names: dict) -> dict:
        """An optimizer's first gradients: its first moment over (1 − β1)."""
        by_id = {id(p): k for k, p in names.items()}
        b1 = opt.param_groups[0]["betas"][0]
        return {by_id[id(p)]: (st["exp_avg"] / (1.0 - b1)).detach().clone()
                for p, st in opt.state.items() if "exp_avg" in st}


def reference(ctx, fault=None, tf32=False) -> dict:
    """The plain reference's checked iterations (``tf32``: with TF32 on,
    the control's precision)."""
    from benchmark.harness.compare import reference_run

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return reference_run(ctx.phase.reference_run(ctx.net), ctx.net, ctx.cfg, ctx.weights,
                             ctx.net.reference_data(ctx.cfg, ctx.inputs), ctx.loop_seed,
                             sum(CHECK_CALLS), ctx.dev, fault=fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def initial(ctx) -> dict:
    """The weights both sides started from, by leaf."""
    return {f"{n}.{k}": v for n, w in ctx.weights.items() for k, v in w.items()}


def numbers(ctx, checked: dict) -> dict:
    """The readings of the program's checked iterations against the plain
    reference (:func:`benchmark.harness.compare.readings`)."""
    from benchmark.harness.compare import readings

    return readings(checked, reference(ctx), initial(ctx))
