"""The port's host spans (``gennet_tpu_torch.runtime.trace``) and the
benchmark's readers of them (``benchmark/harness/program_spans.py``).

- The recorder: nesting and ``parent_id``, a span recorded when its block
  raises, the ring keeping its newest records, and the clock it shares
  with the benchmark's own spans.
- Where the program records: one ``chunk`` span, with its ``n``, per call
  of a CPU chunk of ``make_gan_step_scan`` and ``make_cnn_step_scan``,
  with no ``graph.*`` child (the CPU runs eager steps); one ``optim.adam``
  span per ``runtime.optim.adam`` call.
- The four readers on synthetic records: the window rule of
  ``chunk_prep_ms``, its median, the sums, and ``None`` with nothing to
  read.
- On a card (``-m gpu``): a replayed chunk records ``graph.warmup`` and
  ``graph.capture`` once, then only ``graph.replay``. The card's machine
  has no JAX, so there the file runs with ``pytest --noconftest -m gpu``.
"""

import sys

import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

from benchmark.harness import program_spans
from benchmark.harness.spans import Spans
from gennet_tpu_torch.runtime import trace
from gennet_tpu_torch.runtime.optim import adam

N = 256


@pytest.fixture(autouse=True)
def fresh_records():
    trace.clear()
    yield
    trace.clear()


def _by_name(recs) -> dict:
    out = {}
    for r in recs:
        out.setdefault(r[1], []).append(r)
    return out


# ------------------------------------------------------------ the recorder


def test_spans_nest_and_name_their_parent():
    with trace.span("outer", k=1):
        with trace.span("first"):
            pass
        with pytest.raises(ValueError):
            with trace.span("second", n=2):
                raise ValueError("recorded all the same")
    with trace.span("after"):
        pass
    recs = trace.spans()
    assert [r[1] for r in recs] == ["first", "second", "outer", "after"]
    first, second, outer, after = recs
    assert len({r[0] for r in recs}) == 4
    assert first[4] == second[4] == outer[0]
    assert outer[4] is None and after[4] is None
    assert outer[5] == {"k": 1} and second[5] == {"n": 2} and first[5] == {}
    assert outer[2] <= first[2] <= first[3] <= second[2] <= second[3] <= outer[3] <= after[2]
    assert trace.spans() == recs and trace.spans() is not trace.spans()  # copies


def test_the_ring_keeps_its_newest_records():
    for i in range(trace.CAPACITY + 3):
        with trace.span("s", i=i):
            pass
    recs = trace.spans()
    assert len(recs) == trace.CAPACITY
    assert recs[0][5]["i"] == 3 and recs[-1][5]["i"] == trace.CAPACITY + 2
    trace.clear()
    assert trace.spans() == []


def test_program_spans_share_the_benchmarks_clock():
    spans = Spans()
    with spans.span("chunk_dispatch"):
        with trace.span("chunk") as inner:
            pass
    (_, a, b), = spans.spans
    assert a <= inner.start_ns <= inner.end_ns <= b
    assert spans.at(inner.start_ns) == "chunk_dispatch"
    assert inner.seconds == (inner.end_ns - inner.start_ns) * 1e-9


# ------------------------------------------------ where the program records


def _gan_chunk(n):
    from gennet_tpu_torch.models import BBHGenerator, PairDiscriminator
    from gennet_tpu_torch.train import gan as tgan

    cfg = tgan.GANConfig(n_pix=N, batch_size=4)
    state = tgan.init_gan(torch.Generator().manual_seed(3),
                          BBHGenerator(n_out=N, features=(16, 16, 16, 16, 16)),
                          PairDiscriminator(features=(16, 16), n_pix=N), cfg, "cpu")
    step = tgan.make_gan_step_scan(state.generator, state.discriminator, cfg, n)
    bank = torch.randn(16, N, generator=torch.Generator().manual_seed(1))
    measured = torch.randn(N, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(5)
    return "GAN step", lambda: step(state, bank, measured, gen)


def _cnn_chunk(n):
    from gennet_tpu_torch.models import DualBranchPE
    from gennet_tpu_torch.train import cnn as tcnn

    cfg = tcnn.CNNConfig(n_pix=N, batch_size=8)
    state = tcnn.init_cnn(torch.Generator().manual_seed(0), DualBranchPE(n_pix=N), cfg, "cpu")
    step = tcnn.make_cnn_step_scan(state.model, cfg, n)
    bank = torch.randn(32, N, generator=torch.Generator().manual_seed(1))
    targets = torch.rand(32, 2, generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(4)
    return "CNN step", lambda: step(state, bank, targets, gen)


@pytest.mark.parametrize("make", [_gan_chunk, _cnn_chunk], ids=["gan", "cnn"])
def test_a_cpu_chunk_is_one_chunk_span(make):
    name, call = make(3)
    trace.clear()
    for _ in range(2):
        _, m = call()
        assert all(v.shape == (3,) for v in m.values())
    recs = trace.spans()
    assert [(r[1], r[5]) for r in recs] == [("chunk", {"graph": name, "n": 3})] * 2
    assert all(r[4] is None for r in recs)  # eager steps: no graph.* child


def test_each_adam_construction_is_one_span():
    params = [torch.nn.Parameter(torch.zeros(3))]
    for _ in range(3):
        adam(params, 1e-3, 0.5)
    assert [r[1] for r in trace.spans()] == ["optim.adam"] * 3
    trace.clear()
    _gan_chunk(1)  # init_gan: the G, D and residual G optimizers
    assert [r[1] for r in trace.spans()] == ["optim.adam"] * 3


# ----------------------------------------- the benchmark's readers of them


class _Records:
    """Synthetic records, times in ms."""

    def __init__(self):
        self.recs, self.ids = [], 0

    def add(self, name, a, b, parent=None, **attrs):
        self.ids += 1
        self.recs.append((self.ids, name, int(a * 1e6), int(b * 1e6), parent, attrs))
        return self.ids

    def chunk(self, t, n, prep=None, capture=False):
        """A chunk call at ``t``: a warm-up and a capture when ``capture``,
        and its replays from ``t + prep``."""
        c = self.add("chunk", t, t + 50, graph="GAN step", n=n)
        if capture:
            self.add("graph.warmup", t + 1, t + 11, c)
            self.add("graph.capture", t + 11, t + 14, c)
        if prep is not None:
            self.add("graph.replay", t + prep, t + 40, c, replays=n)


@pytest.fixture
def synthetic(monkeypatch):
    recs = _Records()
    monkeypatch.setattr(trace, "spans", lambda: list(recs.recs))
    return recs


def _run(chunk=4, calls=3):
    from types import SimpleNamespace

    return SimpleNamespace(chunk=chunk, call_s=[0.05] * calls)


def test_chunk_prep_reads_only_the_windows_chunks(synthetic):
    synthetic.add("optim.adam", 0, 2)
    synthetic.chunk(100, 1)                              # checked call of 1: eager
    synthetic.chunk(200, 3, prep=20, capture=True)       # checked call of 3
    synthetic.chunk(300, 4, prep=20, capture=True)       # the warm-up chunk
    for t, prep in ((400, 2.5), (500, 0.5), (600, 1.5)):  # the window
        synthetic.chunk(t, 4, prep=prep)
    synthetic.chunk(700, 4, prep=90)                     # the replay check's call
    synthetic.chunk(800, 1)
    assert program_spans.chunk_prep_ms(_run()) == pytest.approx(1.5)
    assert program_spans.chunk_prep_ms(_run(calls=2)) == pytest.approx(1.5)  # 2.5, 0.5
    assert program_spans.chunk_prep_ms(_run(calls=1)) == pytest.approx(2.5)
    assert program_spans.chunk_prep_ms(_run(chunk=3)) is None  # its one call captures
    assert program_spans.chunk_prep_ms(_run(chunk=1)) is None  # no replay
    # the warm-up and capture of both captures; the optimizer
    assert program_spans.graph_setup_s(_run()) == pytest.approx(2 * 13e-3)
    assert program_spans.optim_init_s(_run()) == pytest.approx(2e-3)


@pytest.mark.parametrize("reader", ["chunk_prep_ms", "graph_setup_s", "optim_init_s"])
def test_readers_return_none_with_nothing_to_read(synthetic, monkeypatch, reader):
    read = getattr(program_spans, reader)
    assert read(_run()) is None                          # no records
    synthetic.chunk(100, 4)                              # a CPU chunk: no graph span
    assert read(_run()) is None
    monkeypatch.setitem(sys.modules, "gennet_tpu_torch.runtime.trace", None)
    monkeypatch.delattr(sys.modules["gennet_tpu_torch.runtime"], "trace")
    assert program_spans.records() is None               # a program without the recorder
    assert read(_run()) is None


# ------------------------------------------------------------------ card


@pytest.mark.gpu
def test_a_replayed_chunk_records_its_capture_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured only there")
    from gennet_tpu_torch import runtime
    from gennet_tpu_torch.models import DualBranchPE
    from gennet_tpu_torch.train import cnn as tcnn

    runtime.setup("cuda")
    dev = torch.device("cuda")
    cfg = tcnn.CNNConfig(n_pix=N, batch_size=8)
    state = tcnn.init_cnn(torch.Generator().manual_seed(0), DualBranchPE(n_pix=N), cfg, dev)
    step = tcnn.make_cnn_step_scan(state.model, cfg, 5)
    bank = torch.randn(32, N, device=dev)
    targets = torch.rand(32, 2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    trace.clear()
    for _ in range(3):
        step(state, bank, targets, gen)
    torch.cuda.synchronize()
    recs = trace.spans()
    chunks = [r for r in recs if r[1] == "chunk"]
    assert [r[5] for r in chunks] == [{"graph": "CNN step", "n": 5}] * 3
    kids = [[(r[1], r[5]) for r in recs if r[4] == c[0]] for c in chunks]
    assert kids[0] == [("graph.warmup", {}), ("graph.capture", {}),
                       ("graph.replay", {"replays": 3})]
    assert kids[1] == kids[2] == [("graph.replay", {"replays": 5})]
    warm, capture = _by_name(recs)["graph.warmup"][0], _by_name(recs)["graph.capture"][0]
    assert warm[3] <= capture[2] and step.graph.replays == 13
    assert step.graph.capture_s == pytest.approx((capture[3] - capture[2]) * 1e-9)
