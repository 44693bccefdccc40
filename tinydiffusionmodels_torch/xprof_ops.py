"""Per-op device table of the port's replayed steps (counterpart of the JAX
package's ``tools/xprof_ops.py``).

    python -m tinydiffusionmodels_torch.xprof_ops [--steps NAME,...]
        [--batches 512,2048] [--top 12] [--replays 20]

Builds each step the bench measures through the bench's own builders
(``bench.text_train_steps``, ``mnist_train_steps``, ``text_sampler``,
``mnist_sampler``, ``guided_decoder``: the bench's shapes, seeds and
random weights), runs it until its CUDA graph is captured, and then
reads it two ways over ``--replays`` replays: CUDA events around the
replays, and ``torch.profiler``. For each step it prints

- its coverage: the kernels the profiler recorded per replay against the
  kernels a replay launches: the kernel nodes the captured graph holds
  (``graphs.Step.keep_graph``, read through libcuda; no generator is
  registered, so ``CUDAGraph.replay`` launches nothing outside it); and
  the profiled
  device time per replay against the CUDA-event time. The profiler is
  known to miss eager kernels on the card (it once recorded 8 of 20 SDPA
  forward launches), so a table says how much of the step it saw;
- the kernels' device µs per replay bucketed by a stable category
  (``category``: GEMM by precision and algorithm, conv, flash, resblock,
  decode, elementwise, reduction, copy, collective, ...), and the top
  kernels by name;
- one ``XPROF {json}`` line with the same numbers, for scripts.

Steps (``--steps``, default all): ``text_f32_bs8`` (the headline text
step), ``text_bf16_bs512``, ``mnist_f32_bs128``, ``mnist_bf16`` (one step
per ``--batches`` entry: the JAX tool's question, bs 2048 against 512),
``text_sampler`` (n 8, one ancestral step), ``mnist_sampler`` (n 256, one
ancestral step) and ``guided`` (the plain scan of the guided decode at bs
8, per position: a replay is the L-position scan, divided by L).

Run it in a fresh process: torch.profiler has recorded no device time in
a process that had run other work first. On the CPU (``TDM_PLATFORM=cpu``)
the steps run eagerly with the kernels' plain versions, the table lists
CPU ops by CPU time and the coverage line says that there is no graph and
that the timer is the host clock; no number of such a run is a device
number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable

import torch

# Ordered (test on the lower-cased name, category) rules; the first match
# names the kernel's category.
_KERNEL_RULES = (
    ("flash_fwd_kernel", "flash fwd"),
    ("flash_bwd_dq_kernel", "flash dq"),
    ("flash_bwd_dkv_kernel", "flash dkv"),
    ("flash_wide_fwd_kernel", "flash fwd"),
    ("flash_wide_dq_kernel", "flash dq"),
    ("flash_wide_dkv_kernel", "flash dkv"),
    ("single_block_", "single-block attention"),
    ("fused_resblock_kernel", "resblock"),
    ("guided_decode_kernel", "decode"),
    ("draw_kernel", "rng"),
    ("nccl", "collective"),
    ("memcpy", "copy (memcpy)"),
    ("memset", "memset"),
)
_CONV_WORDS = ("fprop", "dgrad", "wgrad", "convol", "conv2d", "cudnn",
               "fft", "winograd", "cf32", "r2c", "c2r")
_GEMM_WORDS = ("gemm", "gemv", "nvjet", "splitkreduce", "cublaslt",
               "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
               "aten::linear", "aten::matmul")
_TAIL_RULES = (
    (("layer_norm", "layernorm", "gammabeta"), "norm"),
    (("softmax",), "softmax"),
    (("multi_tensor_apply", "foreach"), "multi-tensor (optimizer, EMA)"),
    (("distribution", "philox", "bernoulli", "aten::normal",
      "aten::randn", "aten::randint", "aten::uniform"), "rng"),
    (("index", "gather", "scatter", "embedding"), "index"),
    (("copy", "catarray", "transpose", "permute", "aten::cat",
      "aten::contiguous"), "copy"),
    (("reduce", "aten::sum", "aten::mean", "aten::max", "aten::argmax"),
     "reduction"),
    (("elementwise",), "elementwise"),
)
_NVJET_TYPES = {"t": "bf16", "h": "f16", "s": "f32", "e": "fp8"}


def _precision(name: str) -> str:
    if "bf16" in name:
        return "bf16"
    if "tf32" in name:
        return "tf32"
    if "f16" in name or "hmma" in name:
        return "f16"
    return "f32"


def category(kernel: str) -> str:
    """A kernel's (or, on the CPU, an op's) stable category: the same for
    every shape and instance of one kind of work, so tables of different
    steps or batches line up. GEMMs by precision and algorithm (FFMA,
    tensor cores, GEMV, split-K reduce, epilogue), convolutions by pass and
    precision, the port's own kernels by name."""
    name = kernel.lower()
    for word, cat in _KERNEL_RULES:
        if word in name:
            return cat
    if any(w in name for w in ("nchwtonhwc", "nhwctonchw")):
        return "conv layout transpose"
    if any(w in name for w in _CONV_WORDS):
        kind = next((k for k in ("fprop", "dgrad", "wgrad") if k in name),
                    "fft" if any(w in name for w in ("fft", "cf32", "r2c",
                                                     "c2r")) else
                    "winograd" if "winograd" in name else "other")
        return f"conv {kind} {_precision(name)}"
    if any(w in name for w in _GEMM_WORDS):
        if name.startswith("aten::"):
            return "gemm (cpu op)"
        if "splitkreduce" in name:
            return "gemm split-K reduce"
        if "epilogue" in name:
            return "gemm epilogue"
        if "nvjet_" in name:
            letter = name.split("nvjet_", 1)[1][:1]
            return f"gemm {_NVJET_TYPES.get(letter, 'f32')} tensor"
        precision = _precision(name)
        if "gemv" in name:
            return f"gemm {precision} gemv"
        simt = any(w in name for w in ("ffma", "simt", "sgemm"))
        return f"gemm {precision} {'ffma' if simt else 'tensor'}"
    for words, cat in _TAIL_RULES:
        if any(w in name for w in words):
            return cat
    return "other"


def _is_kernel(name: str) -> bool:
    """A launched kernel (the graph's kernel nodes), not a memcpy or
    memset."""
    return category(name) not in ("copy (memcpy)", "memset")


@dataclasses.dataclass
class Probe:
    """A built step: ``replay()`` runs one unit of work (one step, one
    reverse step or one guided scan), ``reset()`` rewinds its device
    cursor, ``steps`` are the graphs a unit replays and ``per`` the units
    of the table a replay holds (the scan's L positions)."""

    replay: Callable[[], None]
    reset: Callable[[], None]
    steps: list
    per: int = 1
    unit: str = "step"


def _chunked(build, window: int, kw: dict) -> Probe:
    """The bench's chunk runner ``build(chunk=..., **kw)``, its one step
    warmed up and captured; the chunk holds the warm-up steps and
    ``window`` more."""
    from tinydiffusionmodels_torch.train import chunks

    runner, order, _ = build(chunk=chunks.WARMUP + 1 + window, **kw)
    runner.start(order)
    runner.run(chunks.WARMUP + 1)
    (step,) = runner.kinds.values()
    return Probe(replay=step, reset=runner.cursor.zero_, steps=[step])


def _sampler(build, kw: dict) -> Probe:
    """The bench's sampler ``build(**kw)``, one reverse step."""
    sampler, _ = build(**kw)
    sampler()   # the whole loop: its first step runs eagerly, then replays
    run = sampler.schedule[0]

    def replay():
        with torch.inference_mode():
            run(0)

    def reset():
        with torch.inference_mode():
            sampler.i.zero_()

    return Probe(replay=replay, reset=reset, steps=sampler.steps)


def _guided(kw: dict) -> Probe:
    """The bench's plain-scan guided decoder, per position."""
    from tinydiffusionmodels_torch import bench

    decoder, diff = bench.guided_decoder(**kw)
    decoder(diff)   # primed, captured and replayed once

    def replay():
        with torch.inference_mode():
            decoder.draft_step()

    return Probe(replay=replay, reset=lambda: None,
                 steps=[decoder.draft_step], per=diff.shape[1],
                 unit="position")


def steps_by_name(batches: list[int], window: int,
                  shapes: dict | None = None) -> dict[str, Callable]:
    """name -> a function of the device that builds the step's probe,
    through the bench's builders at the bench's shapes. ``shapes`` maps
    ``text``, ``mnist``, ``text_sampler``, ``mnist_sampler`` and
    ``guided`` to keyword arguments of their builders that replace the
    bench's (tiny shapes for a run on the CPU)."""
    from tinydiffusionmodels_torch import bench

    shapes = shapes or {}
    text, mnist = shapes.get("text", {}), shapes.get("mnist", {})
    ts, ms = shapes.get("text_sampler", {}), shapes.get("mnist_sampler", {})
    guided = shapes.get("guided", {})

    def chunked(build, kw):
        return lambda dev: _chunked(build, window, {**kw, "device": dev})

    text_f32 = text.get("batch_size", bench.TEXT_BATCH)
    text_bf16 = text.get("batch_size", bench.BF16_BATCH)
    mnist_f32 = mnist.get("batch_size", bench.MNIST_BATCH)
    out = {
        f"text_f32_bs{text_f32}": chunked(bench.text_train_steps, {
            **text, "batch_size": text_f32}),
        f"text_bf16_bs{text_bf16}": chunked(bench.text_train_steps, {
            **text, "batch_size": text_bf16,
            "compute_dtype": torch.bfloat16}),
        f"mnist_f32_bs{mnist_f32}": chunked(bench.mnist_train_steps, {
            **mnist, "batch_size": mnist_f32}),
    }
    for b in batches:
        out[f"mnist_bf16_bs{b}"] = chunked(bench.mnist_train_steps, {
            **mnist, "batch_size": b, "compute_dtype": torch.bfloat16})
    n = ts.get("n", bench.TEXT_N)
    out[f"text_sampler_n{n}"] = lambda dev: _sampler(
        bench.text_sampler, {**ts, "device": dev})
    n = ms.get("n_samples", bench.MNIST_N)
    out[f"mnist_sampler_n{n}"] = lambda dev: _sampler(
        bench.mnist_sampler, {**ms, "device": dev})
    n = guided.get("n", bench.GUIDED_N)
    out[f"guided_bs{n}"] = lambda dev: _guided({**guided, "device": dev})
    return out


def select(makers: dict, names: list[str] | None) -> dict:
    """The makers named by ``--steps`` entries: a full name, or its
    prefix before the shape (``mnist_bf16`` names every batch)."""
    if not names:
        return makers
    out = {}
    for want in names:
        hits = [n for n in makers if n == want or n.startswith(want + "_")]
        if not hits:
            raise ValueError(f"no step {want!r}; the steps: "
                             f"{', '.join(makers)}")
        out.update({n: makers[n] for n in hits})
    return out


def _window_us(probe: Probe, replays: int, cuda: bool) -> float:
    """µs per replay over ``replays`` replays: CUDA events on the card,
    the host clock on the CPU."""
    probe.reset()
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(replays):
            probe.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / replays
    t0 = time.perf_counter()
    for _ in range(replays):
        probe.replay()
    return (time.perf_counter() - t0) * 1e6 / replays


def _profiled(probe: Probe, replays: int, cuda: bool) -> list:
    """(name, µs, calls) of every kernel (on the CPU: op, by self time)
    over ``replays`` replays under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    probe.reset()
    with profile(activities=activities) as prof:
        for _ in range(replays):
            probe.replay()
        if cuda:
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue   # a host span's device side: not a kernel
        if cuda:
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.self_device_time_total
        else:
            if e.device_type != DeviceType.CPU or e.self_cpu_time_total <= 0:
                continue
            us = e.self_cpu_time_total
        rows.append((e.key, float(us), int(e.count)))
    return sorted(rows, key=lambda r: r[1], reverse=True)


def measure(name: str, probe: Probe, *, replays: int, top: int,
            cuda: bool, label: str, log=print) -> dict:
    """The coverage, the category table and the top kernels of one built
    step; prints them and returns the ``XPROF`` record."""
    probe.reset()
    for _ in range(2):
        probe.replay()
    timer_us = _window_us(probe, replays, cuda) / probe.per
    rows = _profiled(probe, replays, cuda)
    units = replays * probe.per
    profiled_us = sum(us for _, us, _ in rows) / units
    recorded = sum(n for key, _, n in rows if _is_kernel(key)) / units
    nodes = launches = None
    if cuda:
        # A replay launches the graph's kernel nodes and nothing else: no
        # generator is registered, so CUDAGraph.replay fills none.
        nodes = launches = sum(s.kernel_nodes()
                               for s in probe.steps) / probe.per
    cats: dict[str, list] = {}
    for key, us, n in rows:
        c = cats.setdefault(category(key), [0.0, 0])
        c[0] += us / units
        c[1] += n / units
    unit = probe.unit
    what = "kernels" if cuda else "CPU ops"
    log(f"\n== {name}, per {unit}, {replays} replays, on {label}")
    if cuda:
        log(f"coverage {name}: the profiler recorded {recorded:.2f} kernels "
            f"per {unit} of the {launches:.2f} a replay launches "
            f"(the graph's kernel nodes) "
            f"({recorded / launches:.3f}); profiled device "
            f"{profiled_us:.2f} us per {unit} against {timer_us:.2f} us by "
            f"CUDA events ({profiled_us / timer_us:.3f})")
    else:
        log(f"coverage {name}: the profiler recorded {recorded:.2f} CPU ops "
            f"per {unit}; no CUDA graph on the CPU (the step runs eagerly); "
            f"profiled CPU {profiled_us:.2f} us per {unit} against "
            f"{timer_us:.2f} us by the host clock")
    log(f"{'category':<34} {'us/' + unit:>12} {'share':>6} "
        f"{what + '/' + unit:>14}")
    for cat, (us, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        log(f"{cat:<34} {us:12.3f} {us / max(profiled_us, 1e-12):6.3f} "
            f"{n:14.2f}")
    log(f"top {what}:")
    for key, us, n in rows[:top]:
        log(f"  {us / units:12.3f} us  {n / units:8.2f}x  "
            f"[{category(key)}] {key[:100]}")
    record = {"step": name, "unit": unit, "replays": replays,
              "platform": "cuda" if cuda else "cpu",
              "recorded_kernels": recorded, "graph_kernel_nodes": nodes,
              "replay_launches": launches,
              "profiled_us": profiled_us, "timer_us": timer_us,
              "timer": "cuda events" if cuda else "host clock",
              "categories": {c: {"us": us, "calls": n}
                             for c, (us, n) in cats.items()}}
    log("XPROF " + json.dumps(record))
    return record


def run(names: list[str] | None = None, *, shapes: dict | None = None,
        batches=(512, 2048), replays: int = 20, top: int = 12,
        log=print) -> list[dict]:
    """Build and measure the named steps on ``runtime.device()``, one at a
    time (``shapes``: as ``steps_by_name``'s); their ``XPROF`` records."""
    from tinydiffusionmodels_torch import graphs, perf, runtime

    dev = runtime.device()
    cuda = dev.type == "cuda"
    label = perf.card_label() if cuda else "the CPU (plain versions)"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        graphs.Step.keep_graph = True
    records = []
    for name, build in select(steps_by_name(list(batches), replays, shapes),
                              names).items():
        probe = build(dev)
        records.append(measure(name, probe, replays=replays, top=top,
                               cuda=cuda, label=label, log=log))
        del probe
        if cuda:
            torch.cuda.empty_cache()
    return records


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="per-op device tables of the port's replayed steps")
    parser.add_argument("--steps", default="",
                        help="comma-separated step names or prefixes "
                             "(default: every step)")
    parser.add_argument("--batches", default="512,2048",
                        help="the bf16 MNIST step's batches")
    parser.add_argument("--replays", type=int, default=20)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    run([s for s in args.steps.split(",") if s] or None,
        batches=[int(b) for b in args.batches.split(",") if b],
        replays=args.replays, top=args.top)


if __name__ == "__main__":
    main()
