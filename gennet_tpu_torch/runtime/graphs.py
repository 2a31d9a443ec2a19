"""Fused step loops as CUDA-graph replays: the port's counterpart of the
JAX package's ``jax.jit`` of a ``lax.scan`` body (``make_gan_step_scan``,
``make_cnn_step_scan`` and ``ml_recenter``'s scan; there is no JAX module of
this name).

A :class:`StepGraph` runs ``n`` iterations of a step function that updates
its tensors in place and returns a dict of 0-d metric tensors, and returns
those metrics stacked over the iterations, ``(n,)`` each.

- On a CUDA device it runs the first :data:`WARMUP` iterations eagerly on a
  side stream (they are real iterations of the chunk, not thrown away),
  captures one iteration into a ``torch.cuda.CUDAGraph`` with every
  ``torch.Generator`` the step draws from registered, and replays that
  graph for the rest. Inside the graph each iteration writes its metrics
  into row ``i`` of a stacked buffer, ``i`` a counter on the device. The
  graph is kept for the next call and captured again when a tensor it
  captured has been replaced (a restore, a re-initialisation). A capture
  that fails raises, naming the line that failed; it never carries on
  eagerly.
- Elsewhere (a CPU tensor, or a mesh whose reductions go through the host)
  every iteration runs eagerly: the same function, the same numbers.

What Python does during a capture happens once, not at each replay, so
the graph keeps the books the step's Python would have kept: the kernel
launches it recorded are taken back out of the wrappers' ``LAUNCHES`` and
added again at each replay, and after the replays the version counter of
every tensor the step updates is bumped, so that no weight pack cached
from their old values is served (:func:`gennet_tpu_torch.ops.tf32.cached_pack`).
The caller advances its own step count. A capture records the
``graph.warmup`` and ``graph.capture`` spans, the replays ``graph.replay``
(:mod:`gennet_tpu_torch.runtime.trace`); ``graph.capture`` carries how far
each of the trace's counters moved while the one recorded iteration ran
(``casts``: its dtype conversions).
"""

import traceback

import torch

from gennet_tpu_torch.ops import conv1d as conv_ops
from gennet_tpu_torch.ops import conv1d_dw as conv_dw_ops
from gennet_tpu_torch.ops import conv1d_dx as conv_dx_ops
from gennet_tpu_torch.ops import phasor_dft as phasor_ops
from gennet_tpu_torch.ops import tf32
from gennet_tpu_torch.runtime import trace

# eager iterations before a capture: optimizer state, cuBLAS workspaces
# and the kernels' one-time attributes are set up outside the graph
WARMUP = 2

# the kernel wrappers with a LAUNCHES count
_COUNTED = (conv_ops, conv_dx_ops, conv_dw_ops, phasor_ops)


def graphable(device, mesh=None, what: str = "the step") -> bool:
    """Whether a loop on ``device`` (under ``mesh``) may run as graph
    replays: on a card, unless the mesh reduces through the host (gloo on
    a card), which no graph can record; that case is printed once."""
    if torch.device(device).type != "cuda":
        return False
    if mesh is not None and mesh.backend != "nccl":
        print(f"{what}: a {mesh.backend} mesh reduces through the host, so its chunks run as "
              f"eager steps, not CUDA-graph replays", flush=True)
        return False
    return True


def module_tensors(*modules) -> list:
    """The parameters and buffers of ``modules``."""
    return [t for m in modules for t in (*m.parameters(), *m.buffers())]


def optimizer_tensors(*opts) -> list:
    """The state tensors of ``opts`` and their tensor hyperparameters (a
    capturable Adam's ``lr``)."""
    return [t for opt in opts for t in (
        *(v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)),
        *(v for g in opt.param_groups for v in g.values() if torch.is_tensor(v)))]


def _stack(rows: list) -> dict:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]} if rows else {}


def _signature(tensors, generators) -> tuple:
    return tuple((id(t), t.data_ptr()) for t in tensors) + tuple(id(g) for g in generators)


def _failed_line(err: BaseException) -> str:
    """The innermost frame of ``err`` in this package (else the innermost)."""
    frames = traceback.extract_tb(err.__traceback__)
    ours = [f for f in frames if "gennet_tpu_torch" in f.filename] or frames
    if not ours:
        return "?"
    f = ours[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


class StepGraph:
    """One iteration of a step loop, captured once and replayed; see the
    module docstring. ``graphable``: whether the loop may run as graph
    replays (a CUDA device, and no host-side reductions)."""

    def __init__(self, name: str, graphable: bool):
        self.name = name
        self.graphable = graphable
        self.launches = {}       # kernel wrapper → launches one replay makes
        # seconds of the last ``graph.capture`` span, from the card idle
        # after the warm-up (its sync closes ``graph.warmup``) to the card
        # idle after the capture
        self.capture_s = None
        self.replays = 0
        self._graph = None
        self._sig = None
        self._keys = None
        self._buf = None         # (capacity, n_metrics) rows written inside the graph
        self._row = None         # (1,) int64: the row the next replay writes

    def _drop(self):
        """Forget the graph (its memory pool is freed with it)."""
        self._graph = self._sig = self._buf = self._row = None

    def run(self, n: int, step, tensors, generators=()) -> dict:
        """``n`` iterations of ``step()`` → its metrics stacked, (n,) each.
        ``tensors()``: every tensor the step reads or updates in place and
        keeps between iterations (parameters, buffers, optimizer state, its
        inputs), asked for again after the warm-up, which may create some
        (Adam's state, an EMA); ``generators``: every generator it draws
        from."""
        if not self.graphable or n <= WARMUP:
            return _stack([step() for _ in range(n)])
        rows = []
        sig = _signature(tensors(), generators)
        if self._graph is None or sig != self._sig or n > self._buf.shape[0]:
            self._drop()
            with trace.span("graph.warmup"):
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    rows = [step() for _ in range(WARMUP)]
                torch.cuda.current_stream().wait_stream(side)
                graph = self._new_graph(list(rows[0]), generators, n)
                torch.cuda.synchronize()
            with trace.span("graph.capture") as took:
                before = trace.counts()
                self._capture(graph, step)
                torch.cuda.synchronize()
                took.attrs.update({k: v - before.get(k, 0) for k, v in trace.counts().items()})
            self.capture_s = took.seconds
            sig = self._sig = _signature(tensors(), generators)
        buf, n_eager = self._buf, len(rows)
        if rows:
            buf[:n_eager] = torch.stack([self._vector(r) for r in rows])
        self._row.fill_(n_eager)
        with trace.span("graph.replay", replays=n - n_eager):
            for _ in range(n - n_eager):
                self._graph.replay()
        self.replays += n - n_eager
        for mod, k in self.launches.items():
            mod.LAUNCHES += k * (n - n_eager)
        # the replays changed these tensors behind autograd's back
        torch.autograd.graph.increment_version(tensors())
        out = buf[:n].clone()  # the next replay overwrites the buffer
        return {k: out[:, j] for j, k in enumerate(self._keys)}

    def _vector(self, metrics: dict) -> torch.Tensor:
        return torch.stack([metrics[k].detach().to(torch.float32).reshape(()) for k in self._keys])

    def _new_graph(self, keys, generators, capacity) -> torch.cuda.CUDAGraph:
        """The metric rows' buffer and counter, and a graph that will
        record every generator in ``generators``."""
        dev = torch.cuda.current_device()
        self._keys = keys
        self._buf = torch.zeros((capacity, len(keys)), dtype=torch.float32, device=dev)
        self._row = torch.zeros((1,), dtype=torch.int64, device=dev)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        return graph

    def _capture(self, graph, step):
        """Record one iteration of ``step`` into ``graph``; called with the
        card idle."""
        before = {mod: mod.LAUNCHES for mod in _COUNTED}
        try:
            with tf32.capturing(), torch.cuda.graph(graph):
                vec = self._vector(step())
                self._buf.index_copy_(0, self._row, vec[None])
                self._row.add_(1)
        except Exception as err:
            self._drop()
            raise RuntimeError(f"{self.name}: CUDA graph capture failed at "
                               f"{_failed_line(err)}: {type(err).__name__}: {err}") from err
        finally:
            # a capture records launches, it runs none
            captured = {mod: mod.LAUNCHES - before[mod] for mod in _COUNTED}
            for mod in _COUNTED:
                mod.LAUNCHES = before[mod]
        self.launches = {mod: k for mod, k in captured.items() if k}
        self._graph = graph
