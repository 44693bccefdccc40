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

Randomness: a step draws from the JAX package's key tree (``core/rng.py``,
``ops.rng``), its key and counter read from device buffers like any other
input, so a replay draws what the eager step draws; no generator is
registered with a graph.

Garbage collection: Python's cycle collector is off while a step is
captured. Run there, it could free an unreachable ``CUDAGraph`` of an
earlier step, and destroying a graph is an operation CUDA refuses during a
capture: this capture would fail ("operation not permitted when stream is
capturing"). The garbage is freed by the next collection after it.

Launch counters: capturing runs the kernel wrappers once, which count
launches that did not happen. ``Step`` takes them back and adds the
capture's counts again on every replay, so the counters keep counting
launches on the card.

Inspection: with ``Step.keep_graph`` set (the per-op table tool,
``xprof_ops``, sets it in its own process) a capture keeps its
``cudaGraph_t`` and ``kernel_nodes()`` counts the kernels it holds.
"""

from __future__ import annotations

import ctypes
import gc

import torch

from tinydiffusionmodels_torch.ops import (
    decode_kernel,
    flash_attention,
    resblock,
    rng,
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
    (rng, "launches"),
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
    addresses, random draws included (their keys are such tensors).
    ``prime()``, with ``warmup=0``, runs on the side stream before the
    capture: work that sets up what ``fn`` needs lazily and leaves no
    state that ``fn``'s results depend on."""

    # Keep each capture's cudaGraph_t, for ``kernel_nodes``.
    keep_graph = False

    def __init__(self, fn, device, *, warmup: int = 1, eager: bool = False,
                 prime=None):
        self.fn = fn
        self.device = torch.device(device)
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

    def kernel_nodes(self) -> int:
        """The kernel nodes of the captured graph (``keep_graph`` must have
        been set before the capture), read through libcuda."""
        if self.graph is None or not self.keep_graph:
            raise RuntimeError("no kept graph: set Step.keep_graph before "
                               "the capture")
        return kernel_nodes(self.graph.raw_cuda_graph())

    def _capture(self) -> None:
        if self.prime is not None:
            self._on_side_stream(self.prime)
        graph = (torch.cuda.CUDAGraph(keep_graph=True) if self.keep_graph
                 else torch.cuda.CUDAGraph())
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
            if self.keep_graph:
                graph.instantiate()

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


_CU_GRAPH_NODE_TYPE_KERNEL = 0


def kernel_nodes(raw_graph: int) -> int:
    """The kernel nodes of a ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``),
    through libcuda's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``
    (memset, memcpy and empty nodes are not kernels)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    graph = ctypes.c_void_p(raw_graph)
    if cuda.cuGraphGetNodes(graph, None, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int()
    kernels = 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == _CU_GRAPH_NODE_TYPE_KERNEL
    return kernels
