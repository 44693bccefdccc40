"""CUDA graphs of the port's step loops: the counterpart of the JAX
package's K-step ``lax.scan``s (``make_train_step_multi[_ema]``,
``make_text_train_step_multi[_ema]`` and the reverse samplers).

A ``Step`` wraps a function that runs one step on device state: it reads
whatever changes from step to step (the batch row, the learning rate, the
timestep) from device buffers through a device step cursor, writes its
results into device buffers and advances the cursor, so that the same
launches do the work of every step. On the CPU, or with ``eager=True``,
every call runs the function. On the card the first ``warmup`` calls run
it on a side stream: they are real steps, and the lazy work of a first
call (cuBLAS and cuDNN handles, the kernel library and its
``cudaFuncSetAttribute`` calls, AdamW's state) happens there, outside a
capture. The next call captures the function into a
``torch.cuda.CUDAGraph`` and every call from then on replays it: one
launch for the step's hundreds of kernels. A step whose warm-up would be
a whole costly call (a guided decode's L positions) passes ``prime``
instead: a smaller piece of real work on the same shapes, run once on the
side stream just before the capture, so that the first call already
replays. A capture that fails raises; there is no eager fallback on the
card.

Randomness: each ``torch.Generator`` the step draws from is registered
with the graph (``CUDAGraph.register_generator_state``), so a replay
draws from the generator's current offset and advances it as the eager
step does: replays and eager steps give the same numbers in the same
order.

Garbage collection: Python's cycle collector is off while a step is
captured. Run there, it could free an unreachable ``CUDAGraph`` of an
earlier step, and destroying a graph is an operation CUDA refuses during a
capture: this capture would fail ("operation not permitted when stream is
capturing"). The garbage is freed by the next collection after it.

Launch counters: capturing runs the kernel wrappers once, which count
launches that did not happen. ``Step`` takes them back and adds the
capture's counts again on every replay, so the counters keep counting
launches on the card.
"""

from __future__ import annotations

import gc

import torch

from tinydiffusionmodels_torch.ops import (
    decode_kernel,
    flash_attention,
    resblock,
    single_block,
)

# Every kernel launch counter of the port: (module, attribute).
COUNTERS = (
    (flash_attention, "launches"),
    (flash_attention, "dq_launches"),
    (flash_attention, "dkv_launches"),
    (resblock, "launches"),
    (single_block, "launches"),
    (single_block, "bwd_launches"),
    (decode_kernel, "launches"),
)


def counts() -> list[int]:
    """The launch counters, in ``COUNTERS`` order."""
    return [getattr(module, name) for module, name in COUNTERS]


def _add_counts(delta: list[int]) -> None:
    for (module, name), d in zip(COUNTERS, delta):
        setattr(module, name, getattr(module, name) + d)


class Step:
    """One step function, run eagerly on the CPU (or with ``eager``) and on
    the card ``warmup`` times on a side stream, then captured once and
    replayed.

    ``fn()`` must read every input that changes between calls from device
    tensors it does not reallocate, and write its results into such
    tensors: a replay repeats the captured launches on the captured
    addresses. ``generators`` are the ``torch.Generator``s it draws from
    (the default CUDA generator is registered by torch itself).
    ``prime()``, with ``warmup=0``, runs on the side stream before the
    capture: work that sets up what ``fn`` needs lazily and leaves no
    state that ``fn``'s results depend on."""

    def __init__(self, fn, device, *, generators=(), warmup: int = 1,
                 eager: bool = False, prime=None):
        self.fn = fn
        self.device = torch.device(device)
        self.generators = tuple(g for g in generators if g is not None)
        self.warmup = warmup
        self.prime = prime
        self.eager = eager or self.device.type != "cuda"
        self.calls = 0
        self.graph = None
        self.delta = None
        self.stream = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        self.calls += 1
        if self.eager:
            self.fn()
        elif self.graph is None and self.calls <= self.warmup:
            self._on_side_stream(self.fn)
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            _add_counts(self.delta)

    def _on_side_stream(self, fn) -> None:
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            fn()
        main.wait_stream(self.stream)

    def _capture(self) -> None:
        if self.prime is not None:
            self._on_side_stream(self.prime)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = counts()

        def capture():
            graph.capture_begin()
            try:
                self.fn()
            except BaseException:
                # End the failed capture so the stream stays usable, then
                # raise the step's own error.
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()

        collecting = gc.isenabled()
        gc.disable()
        try:
            self._on_side_stream(capture)
            self.delta = [a - b for a, b in zip(counts(), before)]
        finally:
            if collecting:
                gc.enable()
            # Capturing launched nothing.
            _add_counts([b - a for a, b in zip(counts(), before)])
        self.graph = graph
