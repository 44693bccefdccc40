"""The port's spans (``runtime.span``) on the CPU: which ``tdm.*`` spans the
chunk runner, ``graphs.Step``, the sampler and the decode open, how they
nest, that they lie on the profiler's clock inside a surrounding span, and
that with no profiler running a span is one flag read and creates no
``record_function``."""

import contextlib
import types

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from tinydiffusionmodels_torch import graphs, runtime
from tinydiffusionmodels_torch.core import make_schedule, rng
from tinydiffusionmodels_torch.models import (
    LearnedRounding,
    SimpleUNet,
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.sample.ancestral import Sampler
from tinydiffusionmodels_torch.sample.text import decode_embeddings
from tinydiffusionmodels_torch.train import mnist_train, text_train
from tinydiffusionmodels_torch.train.optim import adamw

torch.set_num_threads(1)

WINDOW = "test.window"


def _spans(fn) -> list:
    """(name, start, end) of every ``tdm.*`` span and of the ``WINDOW``
    span around ``fn()``, in a CPU profile, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith("tdm.") or e.name == WINDOW),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _names(spans) -> list:
    return [name for name, _, _ in spans if name != WINDOW]


def _mnist_steps(steps: int) -> mnist_train.MnistSteps:
    sched = make_schedule(40)
    model = SimpleUNet(40, key=rng.prng_key(0))
    data = torch.randn(2 * steps, 28, 28, 1,
                       generator=torch.Generator().manual_seed(0))
    runner = mnist_train.MnistSteps(
        model, adamw(model.parameters(), 1e-3, weight_decay=0.01), data,
        sched, batch_size=2, steps=steps,
        key=rng.substream(rng.prng_key(0), "train"))
    runner.start(np.arange(2 * steps).reshape(steps, 2))
    return runner


def _sampler() -> Sampler:
    sched = make_schedule(5)
    return Sampler(lambda x, t: 0.1 * x, sched, (2, 3), key=rng.prng_key(1))


def test_span_reads_the_profilers_flag():
    """With no profiler a span is the one shared no-op context; while a
    profiler runs, torch's flag is up and a span is a ``record_function``
    of that name."""
    assert not autograd_profiler._is_profiler_enabled
    assert runtime.span("tdm.a") is runtime.span("tdm.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled
        got = runtime.span("tdm.a")
        assert isinstance(got, record_function) and got.name == "tdm.a"
    assert not autograd_profiler._is_profiler_enabled
    assert runtime.span("tdm.a") is runtime.span("tdm.b")


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler the chunk runner, the sampler and the decode run
    without creating a ``record_function``."""
    def refuse(*args, **kwargs):
        raise AssertionError("a record_function with no profiler running")

    # torch's optimizers open their own record_function on every step
    # through torch.autograd.profiler; the spans go through torch.profiler.
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    losses = _mnist_steps(2).run(2)
    assert losses.shape == (2,) and np.all(np.isfinite(losses))
    x = _sampler()()
    assert x.shape == (2, 3)
    rounding = LearnedRounding(3, 5, key=rng.prng_key(2))
    tokens = decode_embeddings(x[None], rounding=rounding, embed_matrix=None,
                               use_learned_rounding=True)
    assert tokens.shape == (1, 2)


def test_a_chunk_opens_its_spans_in_order():
    """One 3-step MNIST chunk with eager steps: one ``tdm.train.chunk``
    holding three ``tdm.graph.eager`` and then its one ``tdm.train.read``,
    all inside the surrounding span on the same clock."""
    runner = _mnist_steps(3)
    spans = _spans(lambda: runner.run(3))
    assert _names(spans) == ["tdm.train.chunk"] + ["tdm.graph.eager"] * 3 \
        + ["tdm.train.read"]
    window, chunk, *steps, read = spans
    assert window[0] == WINDOW and _inside(chunk, window)
    assert all(_inside(s, chunk) for s in steps + [read])
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:] + [read]))


def test_a_sampler_call_opens_batch_around_init():
    """A ``Sampler`` call: ``tdm.sample.batch`` around ``tdm.sample.init``
    (on the CPU its steps run as plain calls, with no ``graphs.Step``)."""
    spans = _spans(_sampler())
    assert _names(spans) == ["tdm.sample.batch", "tdm.sample.init"]
    window, batch, init = spans
    assert _inside(batch, window) and _inside(init, batch)
    assert init[2] < batch[2]


def test_decode_opens_its_span():
    rounding = LearnedRounding(3, 5, key=rng.prng_key(2))
    spans = _spans(lambda: decode_embeddings(
        torch.zeros(1, 2, 3), rounding=rounding, embed_matrix=None,
        use_learned_rounding=True))
    assert _names(spans) == ["tdm.sample.decode"]
    assert _inside(spans[1], spans[0])


def test_text_steps_start_opens_the_epoch_span():
    dim, vocab = 8, 12
    cfg = TransformerConfig(dim=dim, n_heads=2, depth=1, ffn_dim=16,
                            timesteps=40)
    joint = torch.nn.ModuleDict({
        "diffusion_model": TinyTransformer(cfg, key=rng.prng_key(0)),
        "rounding_fn": LearnedRounding(dim, vocab, key=rng.prng_key(1)),
    })
    runner = text_train.TextSteps(
        joint, adamw(joint.parameters(), 1e-3, weight_decay=1e-4),
        torch.zeros(8, 4, dtype=torch.long), batch_size=2, steps=4,
        key=rng.substream(rng.prng_key(0), "train"),
        sched=make_schedule(40), use_learned_embeddings=False,
        pretrained_matrix=torch.zeros(vocab, dim))
    spans = _spans(lambda: runner.start(np.arange(8).reshape(4, 2), 1.0))
    assert _names(spans) == ["tdm.train.epoch"]
    assert _inside(spans[1], spans[0])


@pytest.fixture()
def fake_graphs(monkeypatch):
    """torch.cuda's graph API stood in for: a capture runs the step's
    Python, a replay counts itself."""
    replays = []

    class Graph:
        def capture_begin(self):
            pass

        def capture_end(self):
            pass

        def replay(self):
            replays.append(1)

    def stream(device=None):
        return types.SimpleNamespace(wait_stream=lambda other: None)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(torch.cuda, "current_stream", stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return replays


def test_a_graph_step_opens_a_span_a_call(fake_graphs):
    """On a CUDA device, five calls of a step with two warm-up calls: two
    ``tdm.graph.eager``, one ``tdm.graph.capture`` and three
    ``tdm.graph.replay``, one a replay."""
    step = graphs.Step(lambda: None, "cuda", warmup=2)
    spans = _spans(lambda: [step() for _ in range(5)])
    assert _names(spans) == ["tdm.graph.eager"] * 2 + ["tdm.graph.capture"] \
        + ["tdm.graph.replay"] * 3
    assert len(fake_graphs) == 3
    assert all(_inside(s, spans[0]) for s in spans[1:])
