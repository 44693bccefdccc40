#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Runs from the root of a checkout, imports nothing of jax and only the
``tinydiffusionmodels_torch`` package of the repo, and fails (exit code != 0,
no result line) on any error; no phase catches its own failure.

1. Environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA and nvcc versions. Fails when CUDA is not available.
2. Build: compiles the CUDA kernels from ``tinydiffusionmodels_torch/csrc``.
3. Kernel vs plain: the flash-attention kernel against its plain PyTorch
   version on the card, TF32 off, on O and lse: f32 atol = rtol = 1e-4;
   bf16 atol = rtol = 2e-2 on O and 1e-2 on lse. Times both at the text
   sampler's shape with CUDA events.
4. Main path: writes a full-width random checkpoint (dim 256, 4 heads,
   depth 3, FFN 2048, learned embeddings and rounding, char vocabulary of
   the built-in corpus) and runs
   ``tinydiffusionmodels_torch.shakespeare.main(["--sample", ...])``: 1000
   ancestral steps, n 8, seq 64. Asserts the kernel ran 1000 x 3 times,
   the embeddings are finite and 8 sample files were written. Then runs
   the sampler RATE_RUNS more times and prints steps/s as all their steps
   over all their time, with every run's time.
5. Device vs CPU: one denoiser forward at full width on the card (kernel)
   and on the CPU (plain version), same weights and inputs, within 1e-3.
6. Profile: ``torch.profiler`` over a short window of the same sampler;
   device time and kernels per step, the device's busy share, and the
   kernels by device time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

DIM, HEADS, DEPTH, FFN = 256, 4, 3, 2048
N, SEQ, STEPS = 8, 64, 1000
RATE_RUNS = 3       # timed 1000-step sampler runs after the CLI's
PROFILE_STEPS = 100  # the profiled window


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def environment():
    import torch

    phase("environment")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    if not (REPO / "tinydiffusionmodels_torch").is_dir():
        raise SystemExit("chip_smoke: run it from a checkout of the repo "
                         "(tinydiffusionmodels_torch/ not found)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    from tinydiffusionmodels_torch.ops import flash_attention as fa

    nvcc = subprocess.run([fa._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print("nvcc: " + nvcc.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build():
    from tinydiffusionmodels_torch.ops import flash_attention as fa

    phase("build")
    t0 = time.perf_counter()
    fa.library()
    print(f"built {fa.library_path().name} in {time.perf_counter() - t0:.2f}"
          f" s (nvcc {fa.build_seconds:.2f} s)")
    for line in fa.build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print("  " + line.strip())


def _qkv(b, h, lq, lk, dh, dv, dtype, layout, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (lambda l, d: (b, h, l, d)) if layout == "bhld" else (
        lambda l, d: (b, l, h, d))
    return tuple(
        torch.randn(shape(l, d), generator=g, device="cuda").to(dtype)
        for l, d in ((lq, dh), (lk, dh), (lk, dv))
    )


def _device_ms(fn, iters=200):
    """Mean device time of ``fn`` over a burst queued behind a sleep
    kernel, so the host's enqueue cost stays out of the reading."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_vs_plain():
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    phase("kernel vs plain (TF32 off)")
    f32, bf16 = torch.float32, torch.bfloat16
    # name: (B, H, Lq, Lk, Dh, Dv, dtype, causal, layout, k_offset)
    cases = {
        "slice_f32": (8, 4, 64, 64, 64, 64, f32, False, "bhld", 0),
        "slice_bf16": (8, 4, 64, 64, 64, 64, bf16, False, "bhld", 0),
        "ragged_causal_L100": (8, 4, 100, 100, 64, 64, f32, True, "bhld", 0),
        # Rows 0-39 see no key and Lk is ragged: both average V over Lk.
        "fully_masked_rows": (8, 4, 100, 100, 64, 64, f32, True, "bhld", 40),
        "dh32_dv64": (8, 4, 64, 64, 32, 64, f32, False, "bhld", 0),
        "blhd_strided": (8, 4, 64, 64, 64, 64, f32, False, "blhd", 0),
        "dh128_L200": (2, 4, 200, 200, 128, 128, f32, False, "bhld", 0),
    }
    errors = {}
    for seed, (name, (b, h, lq, lk, dh, dv, dtype, causal, layout, k_off)) \
            in enumerate(cases.items()):
        q, k, v = _qkv(b, h, lq, lk, dh, dv, dtype, layout, seed)
        if layout == "blhd":
            # The model's case: q, k, v are strided views of one fused
            # (B, L, 3, H, Dh) projection output, never copied.
            qkv = torch.stack([q, k, v], dim=2)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            assert not q.is_contiguous()
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                               layout=layout, k_offset=k_off)
        ref_out, ref_lse = reference.attention(q, k, v, causal=causal,
                                               layout=layout, k_offset=k_off)
        torch.cuda.synchronize()
        tol_o = 2e-2 if dtype == bf16 else 1e-4
        tol_l = 1e-2 if dtype == bf16 else 1e-4
        torch.testing.assert_close(out, ref_out, atol=tol_o, rtol=tol_o)
        torch.testing.assert_close(lse, ref_lse, atol=tol_l, rtol=tol_l)
        err_o = float((out.float() - ref_out.float()).abs().max())
        err_l = float((lse - ref_lse).abs().max())
        errors[name] = err_o
        print(f"{name:20s} max|dO| {err_o:.3e} (tol {tol_o:g})  "
              f"max|dlse| {err_l:.3e} (tol {tol_l:g})")

    q, k, v = _qkv(8, 4, 64, 64, 64, 64, f32, "blhd", 99)
    kernel = lambda: fa.flash_attention(q, k, v, layout="blhd")  # noqa: E731
    plain = lambda: reference.attention(q, k, v, layout="blhd")  # noqa: E731
    # In turns (plain, kernel, kernel, plain) within this one call.
    plain_ms = [_device_ms(plain)]
    kernel_ms = [_device_ms(kernel), _device_ms(kernel)]
    plain_ms.append(_device_ms(plain))
    ms, p_ms = sum(kernel_ms) / 2, sum(plain_ms) / 2
    print(f"slice shape (8, 64, 4, 64) f32 blhd, device time per call: "
          f"kernel {kernel_ms} ms, plain {plain_ms} ms")
    return errors["slice_f32"], ms, p_ms


def _full_width_modules():
    import torch

    from tinydiffusionmodels_torch.data import CharTokenizer, load_text_corpus
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )

    corpus, source = load_text_corpus(WORK / "data")
    tok = CharTokenizer(corpus)
    print(f"corpus: {source}, {len(corpus)} chars, vocab {tok.vocab_size}")
    gen = torch.Generator().manual_seed(0)
    cfg = TransformerConfig(dim=DIM, n_heads=HEADS, depth=DEPTH, ffn_dim=FFN,
                            max_len=max(512, SEQ))
    model = TinyTransformer(cfg, generator=gen).eval()
    rounding = LearnedRounding(DIM, tok.vocab_size, generator=gen).eval()
    embedding = LearnedEmbedding(tok.vocab_size, DIM, generator=gen)
    return tok, model, rounding, embedding


def main_path(card: str):
    import torch

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.io import save_checkpoint, text_checkpoint_dict
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.sample.text import (
        sample_diffusion_embeddings,
    )

    phase("main path: shakespeare --sample (1000 ancestral steps)")
    WORK.mkdir(parents=True, exist_ok=True)
    os.chdir(WORK)
    os.environ["TDM_PLATFORM"] = "cuda"
    os.environ.pop("AIP_MODEL_DIR", None)
    for old in (WORK / "samples").glob("sample_*.txt"):
        old.unlink()
    tok, model, rounding, embedding = _full_width_modules()
    ckpt = WORK / "smoke_ckpt.pth"
    save_checkpoint(
        text_checkpoint_dict(model, rounding, embedding,
                             tokenizer_state=tok.state()),
        str(ckpt),
    )

    # --model_id char: the checkpoint carries its own char tokenizer, and the
    # default Hugging Face id would only make the CLI probe for a local cache.
    argv = ["--sample", "--ckpt", str(ckpt), "--n", str(N),
            "--seq_len", str(SEQ), "--model_id", "char",
            "--data_root", str(WORK / "data")]
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    z = shakespeare.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = fa.launches

    expect = STEPS * DEPTH
    if launches != expect:
        raise AssertionError(f"flash kernel launched {launches} times on the "
                             f"main path, expected {expect}")
    if tuple(z.shape) != (N, SEQ, DIM) or z.device.type != "cuda":
        raise AssertionError(f"embeddings {tuple(z.shape)} on {z.device}")
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("sampled embeddings are not finite")
    written = sorted((WORK / "samples").glob("sample_*.txt"))
    if len(written) != N:
        raise AssertionError(f"{len(written)} sample files, expected {N}")
    print(f"main path: {launches} kernel launches, embeddings finite, "
          f"{len(written)} samples, CLI call {cli_s:.3f} s "
          f"(includes corpus, checkpoint load and model setup)")

    # Steady-state sampler rate: the same loop again, model already built.
    model = model.to("cuda")
    sched = make_schedule(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    times = []
    for _ in range(RATE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_diffusion_embeddings(model, sched, n=N, seq_len=SEQ,
                                    embed_dim=DIM, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = STEPS * len(times) / sum(times)
    print(f"sampler: {rate} steps/s ({STEPS * len(times)} steps over "
          f"{sum(times)} s; runs of {STEPS} steps took {times} s), "
          f"n={N} seq={SEQ} dim={DIM} depth={DEPTH}, on {card}")
    return launches, model, sum(times) / (STEPS * len(times))


def profile_sampler(model, wall_s_per_step: float, card: str) -> None:
    """torch.profiler over a PROFILE_STEPS-step window of the same ancestral
    loop (a PROFILE_STEPS-step schedule: the per-step work is the same):
    device time and kernels per step, the device's busy share of the
    unprofiled step, and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.sample.text import (
        sample_diffusion_embeddings,
    )

    phase(f"profile: {PROFILE_STEPS} ancestral steps under torch.profiler")
    sched = make_schedule(PROFILE_STEPS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    sample_diffusion_embeddings(model, sched, n=N, seq_len=SEQ, embed_dim=DIM,
                                generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sample_diffusion_embeddings(model, sched, n=N, seq_len=SEQ,
                                    embed_dim=DIM, generator=gen)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    per_step_us = device_us / PROFILE_STEPS
    print(f"on {card}: profiled wall {profiled_s / PROFILE_STEPS * 1e6} us "
          f"per step; unprofiled wall {wall_s_per_step * 1e6} us per step "
          f"(sampler runs above); device {per_step_us} us per step; "
          f"{sum(e.count for e in kernels) / PROFILE_STEPS} kernels per step; "
          f"device busy {per_step_us / (wall_s_per_step * 1e6)} of the "
          f"unprofiled step")
    print("device us/step  share  calls/step  kernel")
    for e in kernels[:12]:
        print(f"{e.self_device_time_total / PROFILE_STEPS:14.3f}  "
              f"{e.self_device_time_total / device_us:5.3f}  "
              f"{e.count / PROFILE_STEPS:10.2f}  {e.key[:90]}")


def device_vs_cpu(model_gpu):
    import copy

    import torch

    phase("device vs CPU: one full-width denoiser forward")
    model_cpu = copy.deepcopy(model_gpu).to("cpu")
    g = torch.Generator().manual_seed(2)
    x = torch.randn(N, SEQ, DIM, generator=g)
    t = torch.randint(0, STEPS, (N,), generator=g)
    with torch.inference_mode():
        out_gpu = model_gpu(x.cuda(), t.cuda()).cpu()
        out_cpu = model_cpu(x, t)
    err = float((out_gpu - out_cpu).abs().max())
    print(f"max |cuda - cpu| = {err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"device and CPU forwards differ by {err}")


def main() -> None:
    card = environment()
    build()
    err, ms, plain_ms = kernel_vs_plain()
    launches, model, wall_s_per_step = main_path(card)
    device_vs_cpu(model)
    profile_sampler(model, wall_s_per_step, card)
    import torch

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("jax was imported")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "tinydiffusionmodels_torch/csrc/flash_attention_fwd.cu",
        "replaces": "tinydiffusionmodels_tpu/ops/pallas_kernels.py:295",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
