#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Runs from the root of a checkout, imports nothing of jax and nothing of the
JAX package (only ``tinydiffusionmodels_torch``), and fails (exit code != 0,
no result line) on any error; no phase catches its own failure.

1. Environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA and nvcc versions. Fails when CUDA is not available.
2. Build: compiles every CUDA source in ``tinydiffusionmodels_torch/csrc``
   (one nvcc per source, all started together) and prints ptxas' registers
   and spills of every kernel instance.
3. Forward kernel vs plain: the flash-attention forward against its plain
   PyTorch version, TF32 off, on O and lse: f32 atol = rtol = 1e-4; bf16
   atol = rtol = 2e-2 on O and 1e-2 on lse.
4. Training kernels vs plain: the forward with attention-weight dropout and
   the recompute backward (dq; dk and dv; with an lse cotangent) against
   autograd of the plain version, same seed, same tolerances on O and lse.
   Gradients: f32 atol = rtol = 2e-4, bf16 2e-2. The gradients are looser
   than O because ds = p (dp - D) subtracts two sums of Dv products that
   nearly cancel, so their rounding (summed in another order by the kernel
   than by cuBLAS) is amplified; in bf16, D is formed from the bf16-rounded
   O. Then v = I and dO = I probes read the mask the forward and the dkv
   kernel realise, and hold it against ``reference.dropout_scale``.
5. Main path, training: ``shakespeare.main(["--train", ...])`` at the JAX
   bench's headline width (dim 256, 4 heads, depth 3, FFN 2048, dropout
   0.1, batch 8, seq 64, f32, eps, learned embeddings and rounding, AdamW
   with cosine warmup), one epoch of the built-in corpus cut to
   TRAIN_CHARS characters. Asserts forward launches = (training + validation
   batches) x depth, dq and dkv launches = training steps x depth, finite
   losses, a lower mean loss over the last 50 steps than over the first 50,
   and the checkpoints written. Prints training steps/s.
6. Main path, sampling: ``shakespeare.main(["--sample", ...])`` from the
   trained checkpoint: 1000 ancestral steps, n 8, seq 64. Asserts 3000
   forward launches and no backward launch, finite embeddings and 8 sample
   files. Then RATE_RUNS more sampler runs give steps/s.
7. Guided-decode kernel vs plain: the persistent kernel
   (``csrc/guided_decode.cu``) against its plain version on the same bf16
   weights and N(0, 1) logits: B in {1, 8, 13, 256}, V in {97, 4096}, depth
   2 and 4, raw and normalized mixing, temperature != 1. Every row's first
   divergence from the plain tokens, and every position of the kernel's
   decode scored by the plain version teacher-forced on the kernel's
   tokens, must be a near-tie (DECODE_TIE_RTOL of the best score); each
   case's mean first divergence must be past L/2.
8. Main path, guided CLI: ``shakespeare.main(["--guided_sample",
   "--base_lm", "tinygpt", ...])`` from the trained checkpoint, n 8, seq
   64: trains TinyGPT (dim 256, depth 4) for LM_EPOCHS and writes
   lm_ckpt.pth and 8 guided samples; asserts forward = 1000 x 3 (sampler)
   + 64 x 4 (decode steps) + steps x 4, dq = dkv = steps x 4, no decode
   launch. A second call reuses lm_ckpt.pth: no training launch.
9. Main path, exact guided decode: ``guided_generate_verified(draft=
   "fused")`` on that TinyGPT and the trained rounding head's logits of
   phase 6's embeddings: one decode-kernel launch, forward = Jacobi rounds
   x 4, the output equal to its own fixpoint, >= 95 % agreement with the
   plain f32 scan. Outside the counted run, the kernel's decode of the same
   TinyGPT and logits is held against its plain version by phase 7's
   criteria: the main path's own shape and trained weights.
10. Device vs CPU: one full-width denoiser forward on the card (kernel) and
   on the CPU (plain version), same weights and inputs, within 1e-3.
11. Timing at the training shape (B 8, L 64, H 4, Dh 64, f32, the model's
   strided views of one QKV projection): CUDA-event device times of the
   forward with dropout, the dq kernel and the dkv kernel, each beside its
   plain version and a PyTorch yardstick the port never calls
   (``scaled_dot_product_attention`` forward, and forward plus backward, at
   dropout 0), and beside its bound (bytes over 3.35 TB/s or FLOPs over
   67 TFLOP/s FP32, the larger).
12. Timing of the guided decode at the bench shape (V 4096, D 256, depth 4,
   L 64, alpha 0.3) at bs 8 and 256: the kernel's CUDA-event time beside its
   plain version and its bound (bytes over 3.35 TB/s or the matmul FLOPs,
   bf16 products with f32 sums, over the bf16 tensor-core peak of 989
   TFLOP/s plus the attention's f32 FLOPs over 67 TFLOP/s, the larger; no
   single PyTorch call computes it), the
   cost of its grid barriers alone at its grid, and tokens/s of the exact
   decode with the fused draft against the plain f32 scan.
13. Profiles: ``torch.profiler`` over a window of the sampler and over
   PROFILE_TRAIN_STEPS training steps: device time and kernels per step, the
   device's busy share, the kernels by device time.
14. Resblock kernel vs plain: the fused UNet residual block
   (``csrc/fused_resblock.cu``) against its plain version (cuDNN convs, TF32
   off) at the four block shapes of the UNet, batch 1, 3, 25 and 128, random
   weights and a nonzero time bias: f32 atol = rtol = 1e-4, the max error
   per shape printed. One autograd backward per block through the wrapper's
   Function against autograd of the plain version (1e-4), and one UNet
   forward on the card against the CPU (1e-4).
15. Main path, MNIST training: ``mnist.main(["--train", "--epochs", "1",
   "--batch_size", "128", ...])`` on the synthetic 60 000 digits (the card
   machine has no MNIST files and no network), with the per-epoch grid of 25
   samples: asserts resblock launches = 468 x 4 + 1000 x 4, finite losses,
   a lower mean loss over the last 50 steps than over the first 50, the
   checkpoint and ``epoch_001.png`` written. Prints steps/s.
16. Main path, MNIST sampling: ``mnist.main(["--sample", ...])`` from that
   checkpoint (25 digits, 1000 ancestral steps; 4000 launches,
   ``samples.png``), then ``--sampler ddim --steps 50`` (200 launches).
   Prints the wall time of the 1000-step loop and samples/s.
17. Resblock timing: each block at n 25 and 128, the kernel's CUDA-event
   time beside the plain version's (cuDNN convs, TF32 off: no single
   PyTorch call computes the block) and the bound (FLOPs at 67 TFLOP/s
   against bytes at 3.35 TB/s), and their sums over a UNet forward; then
   ``torch.profiler`` over PROFILE_STEPS MNIST sampler steps and over
   PROFILE_TRAIN_STEPS MNIST training steps.

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
BATCH, DROPOUT = 8, 0.1
TRAIN_CHARS = 160_000   # ~280 training steps and ~30 validation batches
RATE_RUNS = 3           # timed 1000-step sampler runs after the CLI's
PROFILE_STEPS = 100     # the profiled sampler window
PROFILE_TRAIN_STEPS = 20
LM_DEPTH, LM_EPOCHS, LM_BATCH = 4, 1, 64   # the guided CLI's TinyGPT
ALPHA = 0.3
DECODE_BATCHES = (8, 256)
# Near-tie tolerance of the decode kernel against its plain version: the
# plain version's score gap between its best token and the kernel's, over
# the best score's magnitude. Both round the same activations to bf16, so
# they differ only where an f32 sum taken in another order flips a bf16
# rounding (a relative 2^-8 step of one activation), which moves the scores
# by a fraction of a bf16 step.
DECODE_TIE_RTOL = 1e-2

# H100 SXM peaks (NVIDIA data sheet, 700 W, dense): HBM3 bytes/s, f32
# FLOP/s outside the tensor cores (the flash kernels' f32 operands), bf16
# tensor-core FLOP/s (the decode's bf16 weight products).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

_CSRC = "tinydiffusionmodels_torch/csrc/"
_PALLAS = "tinydiffusionmodels_tpu/ops/pallas_kernels.py"
# name: (source of the kernel body, the TPU kernel it replaces)
KERNELS = {
    "flash_attention_fwd": (_CSRC + "flash_attention_fwd.cu",
                            _PALLAS + ":295"),
    "flash_attention_bwd_dq": (_CSRC + "flash_attention_bwd.cuh",
                               _PALLAS + ":431"),
    "flash_attention_bwd_dkv": (_CSRC + "flash_attention_bwd.cuh",
                                _PALLAS + ":484"),
}
DROPOUT_HASH = (_CSRC + "dropout_hash.cuh", _PALLAS + ":266")
KERNELS["guided_decode"] = (_CSRC + "guided_decode.cu",
                            "tinydiffusionmodels_tpu/ops/decode_kernel.py:67")
KERNELS["fused_resblock"] = (_CSRC + "fused_resblock.cu", _PALLAS + ":809")

# The MNIST paths: the UNet as it is (channel plan of models/unet.py, 28x28,
# the 1000-step schedule) on the 60 000 synthetic training digits.
MNIST_BATCH, MNIST_N, MNIST_IMAGES = 128, 25, 60_000
MNIST_DDIM_STEPS = 50
RESBLOCK_BATCHES = (1, 3, 25, 128)


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
    from tinydiffusionmodels_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print("nvcc: " + nvcc.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build():
    from tinydiffusionmodels_torch.ops import _build

    phase("build")
    t0 = time.perf_counter()
    _build.library()
    print(f"built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("---", "entry function", "registers",
                                   "spill", "error")):
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


def _device_ms(fn, iters=200, warmup=10):
    """Mean device time of ``fn`` over a burst queued behind a sleep
    kernel, so the host's enqueue cost stays out of the reading."""
    import torch

    for _ in range(warmup):
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


def _max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def kernel_vs_plain():
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    phase("forward kernel vs plain (TF32 off)")
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
        errors[name] = _max_err(out, ref_out)
        print(f"{name:20s} max|dO| {errors[name]:.3e} (tol {tol_o:g})  "
              f"max|dlse| {_max_err(lse, ref_lse):.3e} (tol {tol_l:g})")
    return errors


def _seed(value: int):
    import torch

    return torch.tensor([value], dtype=torch.int32, device="cuda")


def training_kernels():
    """Forward with dropout and both backward kernels against autograd of
    the plain version; then the realised masks against dropout_scale.
    Returns the largest O, dq and dk/dv errors of the f32 slice cases, and
    the number of mask decisions that differ (0)."""
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    phase("training kernels vs plain: forward with dropout, dq, dk, dv "
          "(TF32 off)")
    f32, bf16 = torch.float32, torch.bfloat16
    # name: (B, H, Lq, Lk, Dh, Dv, dtype, causal, layout, k_offset, rate)
    cases = {
        "slice_f32_p0": (8, 4, 64, 64, 64, 64, f32, False, "blhd", 0, 0.0),
        "slice_f32_p0.1": (8, 4, 64, 64, 64, 64, f32, False, "blhd", 0,
                           DROPOUT),
        "slice_bf16_p0": (8, 4, 64, 64, 64, 64, bf16, False, "blhd", 0, 0.0),
        "slice_bf16_p0.1": (8, 4, 64, 64, 64, 64, bf16, False, "blhd", 0,
                            DROPOUT),
        "blhd_strided_p0.1": (8, 4, 64, 64, 64, 64, f32, False, "qkv", 0,
                              DROPOUT),
        "ragged_causal_L100": (8, 4, 100, 100, 64, 64, f32, True, "bhld", 0,
                               DROPOUT),
        "fully_masked_rows": (8, 4, 100, 100, 64, 64, f32, True, "bhld", 40,
                              DROPOUT),
        "dh32_dv64": (8, 4, 64, 64, 32, 64, f32, False, "bhld", 0, DROPOUT),
        "dh128_L200": (2, 4, 200, 200, 128, 128, f32, False, "bhld", 0,
                       DROPOUT),
    }
    seed = _seed(-1_234_567_890)  # negative: the same 32 bits as uint32
    worst = {"out": 0.0, "dq": 0.0, "dkv": 0.0}
    for i, (name, (b, h, lq, lk, dh, dv, dtype, causal, layout, k_off,
                   rate)) in enumerate(cases.items()):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        if layout == "qkv":
            # The model's operands: views of one (B, L, 3, H, Dh) tensor,
            # whose gradient the three views' gradients fill.
            qkv = torch.randn(b, lq, 3, h, dh, generator=g, device="cuda")
            leaves = (qkv.to(dtype).requires_grad_(),)
            views = lambda t: (t[:, :, 0], t[:, :, 1], t[:, :, 2])  # noqa: E731
            layout = "blhd"
        else:
            leaves = tuple(x.requires_grad_() for x in _qkv(
                b, h, lq, lk, dh, dv, dtype, layout, 100 + i))
            views = lambda q, k, v: (q, k, v)  # noqa: E731
        dv_dim = views(*leaves)[2].shape[-1]
        out_shape = (b, h, lq, dv_dim) if layout == "bhld" else (
            b, lq, h, dv_dim)
        g_out = torch.randn(out_shape, generator=g, device="cuda").to(dtype)
        g_lse = torch.randn(b, h, lq, generator=g, device="cuda")
        kw = dict(causal=causal, layout=layout, k_offset=k_off,
                  dropout_rate=rate, dropout_seed=seed if rate else None)
        results = []
        for fn in (fa.flash_attention_with_lse, reference.attention):
            out, lse = fn(*views(*leaves), **kw)
            grads = torch.autograd.grad((out, lse), leaves, (g_out, g_lse))
            results.append((out, lse, grads))
        torch.cuda.synchronize()
        (out, lse, grads), (r_out, r_lse, r_grads) = results
        bf = dtype == bf16
        tol_o, tol_l, tol_g = (2e-2, 1e-2, 2e-2) if bf else (1e-4, 1e-4, 2e-4)
        torch.testing.assert_close(out, r_out, atol=tol_o, rtol=tol_o)
        torch.testing.assert_close(lse, r_lse, atol=tol_l, rtol=tol_l)
        if len(leaves) == 1:
            grads, r_grads = grads[0].unbind(2), r_grads[0].unbind(2)
        for x, r in zip(grads, r_grads):
            torch.testing.assert_close(x, r, atol=tol_g, rtol=tol_g)
        errs = [_max_err(x, r) for x, r in zip(grads, r_grads)]
        e_out = _max_err(out, r_out)
        print(f"{name:20s} max|dO| {e_out:.3e} max|dlse| "
              f"{_max_err(lse, r_lse):.3e} (tol {tol_o:g}/{tol_l:g})  "
              f"max|ddq| {errs[0]:.3e} max|ddk| {errs[1]:.3e} "
              f"max|ddv| {errs[2]:.3e} (tol {tol_g:g})")
        if name.startswith("slice_f32"):
            worst["out"] = max(worst["out"], e_out)
            worst["dq"] = max(worst["dq"], errs[0])
            worst["dkv"] = max(worst["dkv"], errs[1], errs[2])
    mismatches = _mask_probes(seed)
    return worst, mismatches


def _mask_probes(seed) -> int:
    """The realised dropout masks of the forward (v = I: O = mask * P) and
    of the dkv kernel (dO = I: dV^T = mask * P), against dropout_scale.
    Returns the number of weights whose keep/drop differs (asserted 0)."""
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    b, h, l = 2, 4, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    # Small scores keep every P near 1/64, far from 0, so the ratio is exact
    # to rounding.
    q = 0.3 * torch.randn(b, h, l, 64, generator=g, device="cuda")
    k = 0.3 * torch.randn(b, h, l, 64, generator=g, device="cuda")
    eye = torch.eye(l, device="cuda").expand(b, h, l, l).contiguous()
    p = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1)
    keep_scale = 1.0 / (1.0 - DROPOUT)
    want = reference.dropout_scale(
        seed, torch.arange(b * h, device="cuda").reshape(b, h, 1, 1),
        torch.arange(l, device="cuda")[:, None],
        torch.arange(l, device="cuda")[None, :], DROPOUT) > 0

    fwd = fa.flash_attention(q, k, eye, dropout_rate=DROPOUT,
                             dropout_seed=seed) / p
    v = eye.clone().requires_grad_()
    out = fa.flash_attention(q, k, v, dropout_rate=DROPOUT, dropout_seed=seed)
    (dv,) = torch.autograd.grad(out, v, eye)
    bwd = dv.transpose(-1, -2) / p
    bad = 0
    for what, ratio in (("forward", fwd), ("dkv", bwd)):
        got = ratio > keep_scale / 2
        torch.testing.assert_close(ratio, got * keep_scale, atol=1e-4,
                                   rtol=1e-4)
        n_bad = int((got != want).sum())
        bad += n_bad
        print(f"mask probe ({what}): {n_bad} of {want.numel()} keep/drop "
              f"decisions differ from dropout_scale; kept share "
              f"{float(got.float().mean()):.4f} (expect {1 - DROPOUT})")
    if bad:
        raise AssertionError(f"{bad} dropout decisions differ")
    return bad


def _tiny_gpt(vocab: int, depth: int, seed: int):
    """A TinyGPT at the bench's width on the card, random weights from seed."""
    import torch

    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig

    cfg = TinyGPTConfig(vocab_size=vocab, dim=DIM, n_heads=HEADS, depth=depth,
                        max_len=SEQ + 1)
    return TinyGPT(cfg, generator=torch.Generator().manual_seed(seed)).to(
        "cuda").eval()


def _decode_agreement(tokens, w, diff, kw, bos: int = 0):
    """The kernel's tokens against the plain version's on the same inputs.
    First divergence: per row, the first position where the tokens differ
    (L where they never do); both runs share the prefix up to there, so the
    plain version's scores of its own and the kernel's token there must be
    a near-tie. Teacher-forced: the plain version fed the kernel's tokens
    scores every position of the kernel's decode; each chosen token must be
    within the tolerance of that position's best. Gaps are relative to the
    best score's magnitude. Returns (first divergences, worst first-
    divergence gap, worst forced gap, worst forced absolute gap, positions
    off, positions)."""
    import torch

    from tinydiffusionmodels_torch.ops import reference

    ref_tokens, ref_scores = reference.fused_guided_decode(
        w, diff, bos, return_scores=True, **kw)
    _, forced = reference.fused_guided_decode(
        w, diff, bos, return_scores=True, forced_tokens=tokens, **kw)
    b, seq_len = tokens.shape
    differ = tokens != ref_tokens
    first = torch.where(differ.any(1), differ.int().argmax(1),
                        torch.full((b,), seq_len, device=tokens.device))
    rows = torch.arange(b, device=tokens.device)
    at = first.clamp(max=seq_len - 1)
    s = ref_scores[rows, at]
    best = s.gather(1, ref_tokens[rows, at].long()[:, None])[:, 0]
    mine = s.gather(1, tokens[rows, at].long()[:, None])[:, 0]
    gap_first = torch.where(first < seq_len, (best - mine) / best.abs(), 0.0)
    top = forced.max(-1).values
    off = top - forced.gather(-1, tokens.long()[..., None])[..., 0]
    return (first.tolist(), float(gap_first.max()),
            float((off / top.abs()).max()), float(off.max()),
            int((off > 0).sum()), off.numel())


def decode_kernel_vs_plain():
    """The guided-decode kernel against its plain version on the card, same
    bf16 weights and N(0, 1) logits. Criteria: every first divergence of a
    row is a near-tie of the plain version's scores, and every position of
    the kernel's decode, scored by the plain version teacher-forced on the
    kernel's tokens, picks a token within DECODE_TIE_RTOL of the best
    (relative gaps); and the mean first divergence of each case is past L/2
    (tests/test_fused_decode.py's rule). The batch-1 case is four launches
    of one row each (four seeds), so its mean is over four rows. Returns
    the worst absolute forced gap and the per-case stats."""
    import torch

    from tinydiffusionmodels_torch.ops import decode_kernel as dk

    phase("guided-decode kernel vs plain (TF32 off)")
    # name: (B, V, depth, normalize, temperature, launches)
    cases = {
        "b1_v97_d2": (1, 97, 2, False, 1.0, 4),
        "b8_v4096_d4": (8, 4096, 4, False, 1.0, 1),
        "b8_v4096_d4_norm": (8, 4096, 4, True, 1.0, 1),
        "b13_v97_d4_norm_t0.7": (13, 97, 4, True, 0.7, 1),
        "b13_v4096_d2_t1.5": (13, 4096, 2, False, 1.5, 1),
        "b256_v4096_d4": (256, 4096, 4, False, 1.0, 1),
        "b256_v97_d2_norm": (256, 97, 2, True, 1.0, 1),
    }
    worst_abs, stats = 0.0, {}
    for i, (name, (b, v, depth, norm, temp, n)) in enumerate(cases.items()):
        firsts, gap_first, gap_forced, off, positions = [], 0.0, 0.0, 0, 0
        for j in range(n):
            seed = 20 + 10 * i + j
            w = dk.pack_weights(_tiny_gpt(v, depth, seed=seed))
            g = torch.Generator(device="cuda").manual_seed(seed)
            diff = torch.randn(b, SEQ, v, generator=g, device="cuda")
            kw = dict(alpha=ALPHA, temperature=temp, normalize=norm)
            tokens, grid = dk._launch(w, diff, 0, **kw)
            f, g1, g2, g_abs, o, p = _decode_agreement(tokens, w, diff, kw)
            torch.cuda.synchronize()
            firsts += f
            gap_first, gap_forced = max(gap_first, g1), max(gap_forced, g2)
            worst_abs, off, positions = max(worst_abs, g_abs), off + o, \
                positions + p
        equal = sum(x == SEQ for x in firsts)
        mean_first = sum(firsts) / len(firsts)
        print(f"{name:22s} rows equal {equal}/{len(firsts)}; worst gap at a "
              f"first divergence {gap_first:.3e}; teacher-forced: {off} of "
              f"{positions} positions off the best, worst gap {gap_forced:.3e}"
              f" (relative tol {DECODE_TIE_RTOL:g}); mean first divergence "
              f"{mean_first:.2f} of L={SEQ}; grid {grid} CTAs")
        if max(gap_first, gap_forced) > DECODE_TIE_RTOL or \
                not mean_first > SEQ / 2:
            raise AssertionError(f"{name}: the kernel leaves the plain "
                                 "version beyond a near-tie")
        stats[name] = {"rows_equal": equal, "rows": len(firsts),
                       "worst_first_divergence_gap": gap_first,
                       "worst_forced_gap": gap_forced,
                       "positions_off": off, "positions": positions,
                       "mean_first_divergence": mean_first}
    return worst_abs, stats


def _reset_counts():
    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import resblock as rb

    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    dk.launches = rb.launches = 0


def _counts() -> dict:
    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import resblock as rb

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "guided_decode": dk.launches,
            "fused_resblock": rb.launches}


def _prepare_workdir():
    WORK.mkdir(parents=True, exist_ok=True)
    os.chdir(WORK)
    os.environ["TDM_PLATFORM"] = "cuda"
    os.environ["TDM_DATA_LIMIT"] = str(TRAIN_CHARS)
    os.environ["TDM_PROGRESS_EVERY"] = "100"
    for var in ("AIP_MODEL_DIR", "TDM_METRICS_PATH"):
        os.environ.pop(var, None)


def main_path_train(card: str):
    import numpy as np
    import torch

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.data import (
        CharTokenizer,
        load_text_corpus,
        num_batches,
        tokenize_corpus,
    )

    phase("main path: shakespeare --train (full width, one epoch)")
    _prepare_workdir()
    ckpt = WORK / "train_ckpt.pth"
    best = WORK / "train_ckpt_best.pth"
    for old in (ckpt, best):
        old.unlink(missing_ok=True)
    # The work the run must do, counted independently of the trainer.
    corpus, source = load_text_corpus(WORK / "data")
    corpus = corpus[:TRAIN_CHARS]
    train_chunks, val_chunks = tokenize_corpus(corpus, CharTokenizer(corpus),
                                               SEQ, 0.1)
    steps = num_batches(len(train_chunks), BATCH)
    val_batches = num_batches(len(val_chunks), BATCH)
    print(f"corpus: {source}, {len(corpus)} chars -> {steps} training steps "
          f"and {val_batches} validation batches of {BATCH}")

    argv = ["--train", "--ckpt", str(ckpt), "--epochs", "1",
            "--batch_size", str(BATCH), "--seq_len", str(SEQ),
            "--embed_dim", str(DIM), "--depth", str(DEPTH),
            "--dropout", str(DROPOUT), "--model_id", "char",
            "--use_learned_embeddings", "--data_root", str(WORK / "data")]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    result = shakespeare.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()

    expect = {"flash_attention_fwd": (steps + val_batches) * DEPTH,
              "flash_attention_bwd_dq": steps * DEPTH,
              "flash_attention_bwd_dkv": steps * DEPTH, "guided_decode": 0,
              "fused_resblock": 0}
    if counts != expect:
        raise AssertionError(f"launches {counts} on the training path, "
                             f"expected {expect}")
    losses = result.step_losses
    if losses.shape != (steps, 3) or result.steps != steps:
        raise AssertionError(f"{losses.shape} step losses, {result.steps} "
                             f"steps; expected {steps}")
    record = result.epochs[0]
    val = [record[k] for k in ("val_diff", "val_round", "val_total")]
    if not (np.isfinite(losses).all() and np.isfinite(val).all()):
        raise AssertionError("a training or validation loss is not finite")
    first, last = losses[:50, 2].mean(), losses[-50:, 2].mean()
    if not last < first:
        raise AssertionError(f"mean loss of the last 50 steps {last} is not "
                             f"below that of the first 50 ({first})")
    for path in (ckpt, best):
        if not path.is_file():
            raise AssertionError(f"{path.name} was not written")
    rate = result.steps / result.seconds
    print(f"training path: launches {counts}; losses finite; mean total "
          f"loss first 50 steps {first}, last 50 {last}; val total "
          f"{val[2]}; {ckpt.name} and {best.name} written; CLI call "
          f"{cli_s:.3f} s (includes corpus, model setup, validation and "
          f"checkpoints)")
    print(f"training: {rate} steps/s ({result.steps} steps over "
          f"{result.seconds} s of step loop), bs={BATCH} seq={SEQ} dim={DIM} "
          f"depth={DEPTH} dropout={DROPOUT} f32, on {card}")
    return result, ckpt, counts, rate


def main_path_sample(card: str, ckpt: Path, model):
    import torch

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.sample.text import (
        sample_diffusion_embeddings,
    )

    phase("main path: shakespeare --sample from the trained checkpoint "
          "(1000 ancestral steps)")
    _prepare_workdir()
    for old in (WORK / "samples").glob("sample_*.txt"):
        old.unlink()
    # --model_id char: the checkpoint carries its own char tokenizer, and the
    # default Hugging Face id would only make the CLI probe for a local cache.
    argv = ["--sample", "--ckpt", str(ckpt), "--n", str(N),
            "--seq_len", str(SEQ), "--model_id", "char",
            "--data_root", str(WORK / "data")]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    z = shakespeare.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()

    expect = {"flash_attention_fwd": STEPS * DEPTH,
              "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
              "guided_decode": 0, "fused_resblock": 0}
    if counts != expect:
        raise AssertionError(f"launches {counts} on the sampling path, "
                             f"expected {expect}")
    if tuple(z.shape) != (N, SEQ, DIM) or z.device.type != "cuda":
        raise AssertionError(f"embeddings {tuple(z.shape)} on {z.device}")
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("sampled embeddings are not finite")
    written = sorted((WORK / "samples").glob("sample_*.txt"))
    if len(written) != N:
        raise AssertionError(f"{len(written)} sample files, expected {N}")
    print(f"sampling path: launches {counts}, embeddings finite, "
          f"{len(written)} samples, CLI call {cli_s:.3f} s (includes corpus, "
          f"checkpoint load and model setup)")

    # Steady-state sampler rate: the same loop again, model already built.
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
    return counts, sum(times) / (STEPS * len(times)), z


def main_path_guided(card: str, ckpt: Path):
    """``shakespeare.main(["--guided_sample", "--base_lm", "tinygpt", ...])``
    from the trained checkpoint: trains TinyGPT for LM_EPOCHS, writes
    lm_ckpt.pth and the guided samples; then a second call reuses
    lm_ckpt.pth and trains nothing. Returns the first call's launches."""
    import torch

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.data import (
        CharTokenizer,
        load_text_corpus,
        num_batches,
        tokenize_corpus,
    )

    phase("main path: shakespeare --guided_sample --base_lm tinygpt from the "
          "trained checkpoint (TinyGPT trained, then reused)")
    _prepare_workdir()
    lm_ckpt = WORK / "lm_ckpt.pth"
    lm_ckpt.unlink(missing_ok=True)
    for old in (WORK / "samples").glob("guided_sample_*.txt"):
        old.unlink()
    corpus, _ = load_text_corpus(WORK / "data")
    corpus = corpus[:TRAIN_CHARS]
    lm_chunks, _ = tokenize_corpus(corpus, CharTokenizer(corpus), SEQ + 1, 0.0)
    lm_steps = num_batches(len(lm_chunks), LM_BATCH) * LM_EPOCHS
    argv = ["--guided_sample", "--base_lm", "tinygpt", "--ckpt", str(ckpt),
            "--n", str(N), "--seq_len", str(SEQ), "--model_id", "char",
            "--lm_epochs", str(LM_EPOCHS), "--lm_ckpt", str(lm_ckpt),
            "--alpha", str(ALPHA), "--data_root", str(WORK / "data")]
    runs = []
    for i in range(2):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        tokens = shakespeare.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = _counts()
        steps = lm_steps if i == 0 else 0
        expect = {"flash_attention_fwd": STEPS * DEPTH + SEQ * LM_DEPTH
                  + steps * LM_DEPTH,
                  "flash_attention_bwd_dq": steps * LM_DEPTH,
                  "flash_attention_bwd_dkv": steps * LM_DEPTH,
                  "guided_decode": 0, "fused_resblock": 0}
        if counts != expect:
            raise AssertionError(f"launches {counts} on the guided CLI path "
                                 f"(call {i + 1}), expected {expect}")
        if tuple(tokens.shape) != (N, SEQ) or tokens.device.type != "cuda":
            raise AssertionError(f"guided tokens {tuple(tokens.shape)} on "
                                 f"{tokens.device}")
        written = sorted((WORK / "samples").glob("guided_sample_*.txt"))
        if len(written) != N or not lm_ckpt.is_file():
            raise AssertionError(f"{len(written)} guided samples, lm_ckpt "
                                 f"written: {lm_ckpt.is_file()}")
        print(f"guided CLI call {i + 1} ({'trains' if steps else 'reuses'} "
              f"TinyGPT, {steps} steps): launches {counts}, {len(written)} "
              f"guided samples, {lm_ckpt.name} present, CLI call {cli_s:.3f} s "
              f"(includes the 1000-step sampler), on {card}")
        runs.append(counts)
    return runs[0], lm_ckpt


def _fixpoint(lm, tokens, diff, bos: int):
    """verify(tokens): the mixed greedy tokens of the f32 full-context
    forward with ``tokens`` as context (_assert_verified_contract)."""
    import torch

    from tinydiffusionmodels_torch.sample.guided import mix_logits

    ids = torch.cat([torch.full((tokens.shape[0], 1), bos, device="cuda",
                                dtype=torch.long), tokens[:, :-1].long()], 1)
    with torch.inference_mode():
        mixed = mix_logits(lm(ids), diff, ALPHA)
    return torch.argmax(mixed, -1).to(torch.int32)


def guided_exact(card: str, lm_ckpt: Path, ckpt: Path, z, rounding):
    """Path (B), the exact guided decode: ``guided_generate_verified`` with
    the fused draft on the TinyGPT the CLI phase trained and the diffusion
    logits of the trained text checkpoint (its rounding head on the --sample
    phase's embeddings), n 8, L 64. Asserts one decode-kernel launch, the
    output equal to its own fixpoint and >= 95 % agreement with the plain
    f32 scan. Then, outside the counted run, the kernel's decode of the
    same TinyGPT and logits against its plain version (phase 7's criteria).
    Returns (launches, rounds, agreement, worst absolute forced gap,
    agreement stats)."""
    import torch

    from tinydiffusionmodels_torch.data import tokenizer_from_state
    from tinydiffusionmodels_torch.io import (
        load_checkpoint,
        tiny_gpt_state_from_jax,
    )
    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig
    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.sample.guided import (
        guided_generate_verified,
    )

    phase("main path: exact guided decode (fused kernel draft + Jacobi "
          "verify) on the trained TinyGPT")
    params = load_checkpoint(lm_ckpt)["params"]
    v, _ = params["tok_emb"].shape
    lm = TinyGPT(TinyGPTConfig(vocab_size=int(v), dim=DIM, n_heads=HEADS,
                               depth=LM_DEPTH,
                               max_len=int(params["pos_emb"].shape[0])))
    lm.load_state_dict(tiny_gpt_state_from_jax(params))
    lm.to("cuda").eval()
    tok = tokenizer_from_state(load_checkpoint(ckpt)["tokenizer"])
    bos = tok.bos_token_id or tok.eos_token_id or 0
    with torch.inference_mode():
        diff = rounding(z)
    torch.cuda.synchronize()
    _reset_counts()
    tokens, rounds = guided_generate_verified(lm, diff, bos, alpha=ALPHA,
                                              draft="fused",
                                              return_rounds=True)
    torch.cuda.synchronize()
    counts = _counts()
    expect = {"flash_attention_fwd": rounds * LM_DEPTH,
              "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
              "guided_decode": 1, "fused_resblock": 0}
    if counts != expect:
        raise AssertionError(f"launches {counts} on the exact guided path, "
                             f"expected {expect}")
    if not torch.equal(tokens, _fixpoint(lm, tokens, diff, bos)):
        raise AssertionError("the verified decode is not its own fixpoint")
    plain = guided_generate_verified(lm, diff, bos, alpha=ALPHA, draft="plain")
    agree = float((tokens == plain).float().mean())
    if not agree >= 0.95:
        raise AssertionError(f"fused+verify agrees with the plain scan on "
                             f"{agree} of tokens (must be >= 0.95)")
    print(f"exact guided decode: launches {counts}; {rounds} Jacobi rounds "
          f"(verify forwards); output equals its fixpoint; agreement with "
          f"the plain f32 scan {agree}; on {card}")

    # The draft this path launched, held against its plain version at the
    # path's own shape (B 8, L 64, the char vocab) and trained weights.
    w = dk.pack_weights(lm)
    kw = dict(alpha=ALPHA, temperature=1.0, normalize=False)
    draft = dk.fused_guided_decode(w, diff, bos, **kw)
    firsts, gap_first, gap_forced, worst_abs, off, positions = \
        _decode_agreement(draft, w, diff, kw, bos)
    mean_first = sum(firsts) / len(firsts)
    equal = sum(x == SEQ for x in firsts)
    print(f"draft kernel vs plain on this path (B {diff.shape[0]}, V {v}): "
          f"rows equal {equal}/{len(firsts)}; worst gap at a first "
          f"divergence {gap_first:.3e}; teacher-forced: {off} of {positions} "
          f"positions off the best, worst gap {gap_forced:.3e} (relative tol "
          f"{DECODE_TIE_RTOL:g}), absolute {worst_abs:.3e}; mean first "
          f"divergence {mean_first:.2f} of L={SEQ}")
    if max(gap_first, gap_forced) > DECODE_TIE_RTOL or \
            not mean_first > SEQ / 2:
        raise AssertionError("the kernel's draft on the exact guided path "
                             "leaves the plain version beyond a near-tie")
    stats = {"rows_equal": equal, "rows": len(firsts),
             "worst_first_divergence_gap": gap_first,
             "worst_forced_gap": gap_forced, "positions_off": off,
             "positions": positions, "mean_first_divergence": mean_first}
    return counts, rounds, agree, worst_abs, stats


def _decode_bound(b: int, seq_len: int, vocab: int, depth: int):
    """(bytes, matmul FLOPs, attention FLOPs) of one guided decode at the
    bench width: every bf16 weight once, the token-table rows gathered, the
    bf16 diffusion logits once, the int32 tokens written; the matmuls (bf16
    weights times bf16-rounded activations, f32 sums: the bf16 tensor-core
    operation) and the attention over slots <= pos (f32 queries and
    probabilities against the bf16 cache: f32 operations), at 2 FLOPs per
    multiply-add."""
    d, f = DIM, 4 * DIM
    layer = 3 * d * d + d * d + 2 * d * f
    weights = depth * (layer + 3 * d + d + f + d + 4 * d) + d * vocab + 2 * d
    weights += (seq_len + 1) * d + min(b * seq_len, vocab) * d
    nbytes = 2 * weights + 2 * b * seq_len * vocab + 4 * b * seq_len
    attn = 2 * 2 * d * depth * sum(p + 1 for p in range(seq_len))
    return nbytes, b * seq_len * 2 * (depth * layer + d * vocab), b * attn


def decode_timing(card: str) -> dict:
    """The decode kernel at the bench shape (TinyGPT V 4096, D 256, depth
    4, max_len 65, L 64, alpha 0.3, random weights and N(0, 1) logits), at
    batch 8 and 256: CUDA-event device time of one launch beside the plain
    version (plain, kernel, kernel, plain), the bound, the grid barrier's
    cost at the launch's grid, and host-clock tokens/s of the exact decode
    with the fused draft against the plain f32 scan."""
    import torch

    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.sample.guided import (
        guided_generate_verified,
    )

    phase("timing: guided decode at the bench shape (V 4096, D 256, depth 4, "
          "L 64, alpha 0.3)")
    vocab, depth = 4096, 4
    model = _tiny_gpt(vocab, depth, seed=0)
    w = dk.pack_weights(model)
    out = {}
    for b in DECODE_BATCHES:
        g = torch.Generator(device="cuda").manual_seed(1)
        diff = torch.randn(b, SEQ, vocab, generator=g, device="cuda")
        kw = dict(alpha=ALPHA, temperature=1.0, normalize=False)

        def kernel():
            dk.fused_guided_decode(w, diff, 0, **kw)

        def plain():
            reference.fused_guided_decode(w, diff, 0, **kw)

        p_ms = [_device_ms(plain, iters=2, warmup=1)]
        k_ms = [_device_ms(kernel, iters=10, warmup=2),
                _device_ms(kernel, iters=10, warmup=2)]
        p_ms.append(_device_ms(plain, iters=2, warmup=1))
        grid = dk._launch(w, diff, 0, **kw)[1]
        syncs = SEQ * (5 * depth + 2) + 1
        sync_ms = _device_ms(lambda: dk._grid_sync_probe(syncs, grid),
                             iters=10, warmup=2)
        nbytes, mm_flops, attn_flops = _decode_bound(b, SEQ, vocab, depth)
        bound_ms, bound_by = _bound(nbytes, [(mm_flops, BF16_FLOPS_PER_S),
                                             (attn_flops, FP32_FLOPS_PER_S)])
        # The roof of the kernel as written (plain FP32 FMA, no tensor
        # cores), beside the card's bound; not the bound.
        fma_roof_ms = (mm_flops + attn_flops) / FP32_FLOPS_PER_S * 1e3
        rates = {}
        for draft in ("fused", "plain"):
            guided_generate_verified(model, diff, 0, alpha=ALPHA, draft=draft,
                                     weights=w)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RATE_RUNS):
                _, rounds = guided_generate_verified(
                    model, diff, 0, alpha=ALPHA, draft=draft, weights=w,
                    return_rounds=True)
            torch.cuda.synchronize()
            rates[draft] = (b * SEQ * RATE_RUNS / (time.perf_counter() - t0),
                            rounds)
        k_mean = sum(k_ms) / 2
        out[b] = dict(ms=k_mean, plain_ms=sum(p_ms) / 2, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None,
                      fp32_fma_roof_ms=fma_roof_ms, grid=grid,
                      barrier_ms=sync_ms, barrier_share=sync_ms / k_mean,
                      fused_verify_tokens_s=rates["fused"][0],
                      jacobi_rounds=rates["fused"][1],
                      plain_scan_tokens_s=rates["plain"][0])
        print(f"bs {b}: kernel {k_ms} ms, plain {p_ms} ms; bound {bound_ms} "
              f"ms by {bound_by} ({nbytes} B, {mm_flops} bf16 matmul FLOP, "
              f"{attn_flops} f32 attention FLOP), {k_mean / bound_ms:.0f}x; "
              f"FP32-FMA roof {fma_roof_ms} ms; grid {grid} "
              f"CTAs, {syncs} barriers alone {sync_ms} ms = "
              f"{sync_ms / k_mean:.3f} of the kernel; exact decode tokens/s: "
              f"fused+verify {rates['fused'][0]} ({rates['fused'][1]} Jacobi "
              f"rounds), plain f32 scan {rates['plain'][0]}; no single "
              f"PyTorch call computes this (library —); on {card}")
    return out


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


def _bound(nbytes: int, ops) -> tuple[float, str]:
    """(least time in ms, what bounds it) for work that moves ``nbytes`` and
    does, for each (flops, rate) of ``ops``, ``flops`` operations of a type
    whose peak on one H100 is ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(flops / rate for flops, rate in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_timing(card: str) -> dict:
    """CUDA-event device times at the training shape, on the model's
    operands (strided views of one QKV projection), in turns within this
    call: plain, kernel, kernel, plain. Returns per kernel ms, plain_ms,
    library_ms, bound_ms and bound_by."""
    import torch
    import torch.nn.functional as F

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    phase("timing at the training shape (B 8, L 64, H 4, Dh 64, f32, blhd "
          "views of one QKV projection)")
    b, l, h, d = BATCH, SEQ, HEADS, DIM // HEADS
    g = torch.Generator(device="cuda").manual_seed(11)
    qkv = torch.randn(b, l, 3, h, d, generator=g, device="cuda")
    q, k, v = (qkv[:, :, i].requires_grad_() for i in range(3))
    g_out = torch.randn(b, l, h, d, generator=g, device="cuda")
    seed = _seed(12345)
    kw = dict(layout="blhd", dropout_rate=DROPOUT, dropout_seed=seed)
    params = dict(causal=False, layout="blhd", q_offset=0, k_offset=0,
                  dropout_rate=DROPOUT, dropout_seed=seed)

    with torch.no_grad():
        out, lse = fa.forward(q, k, v, **params)
        delta = fa.backward_delta(out, g_out, None, "blhd")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    plain_out = reference.attention(q, k, v, **kw)[0]

    def plain_dq():
        torch.autograd.grad(plain_out, q, g_out, retain_graph=True)

    def plain_dkv():
        torch.autograd.grad(plain_out, (k, v), g_out, retain_graph=True)

    # The yardstick: PyTorch's fused attention on the same (bhld-strided)
    # views, at dropout 0 (its dropout draws another stream).
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    g_t = g_out.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt)
        torch.autograd.grad(o, (qt, kt, vt), g_t)

    def plain_fwd():
        with torch.no_grad():
            reference.attention(q, k, v, **kw)

    # name: (kernel, plain version, library yardstick); the SDPA forward
    # runs with grad enabled, so it also keeps its logsumexp, as the kernel
    # does.
    runs = {
        "flash_attention_fwd": (
            lambda: fa.forward(q, k, v, **params), plain_fwd,
            lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        "flash_attention_bwd_dq": (
            lambda: fa.backward_dq(q, k, v, g_out, lse, delta, dq, **params),
            plain_dq, sdpa_fwd_bwd),
        "flash_attention_bwd_dkv": (
            lambda: fa.backward_dkv(q, k, v, g_out, lse, delta, dk, dv,
                                    **params),
            plain_dkv, sdpa_fwd_bwd),
    }

    f32 = 4
    n_qkv = b * l * h * d          # elements of each of q, k, v, O, dO
    n_row = b * h * l              # lse and D
    pairs = b * h * l * l          # (query, key) pairs
    work = {  # (bytes read once and written once, FP32 FLOPs of the matmuls)
        "flash_attention_fwd": ((4 * n_qkv + n_row) * f32 + 4,
                                2 * pairs * (d + d)),
        "flash_attention_bwd_dq": ((5 * n_qkv + 2 * n_row) * f32 + 4,
                                   2 * pairs * (d + d + d)),
        "flash_attention_bwd_dkv": ((6 * n_qkv + 2 * n_row) * f32 + 4,
                                    2 * pairs * (d + d + d + d)),
    }
    timings = {}
    for name, (kernel, plain, library) in runs.items():
        p_ms = [_device_ms(plain)]
        k_ms = [_device_ms(kernel), _device_ms(kernel)]
        p_ms.append(_device_ms(plain))
        lib_ms = _device_ms(library)
        nbytes, flops = work[name]
        bound_ms, bound_by = _bound(nbytes, [(flops, FP32_FLOPS_PER_S)])
        timings[name] = dict(ms=sum(k_ms) / 2, plain_ms=sum(p_ms) / 2,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        lib_name = ("SDPA forward" if library is not sdpa_fwd_bwd
                    else "SDPA forward+backward")
        print(f"{name}: kernel {k_ms} ms, plain {p_ms} ms, library "
              f"({lib_name}, dropout 0) {lib_ms} ms; bound {bound_ms} ms by "
              f"{bound_by} ({work[name][0]} B, {work[name][1]} FLOP); on "
              f"{card}")
    return timings


def _profile_table(prof, steps: int, wall_s_per_step: float, card: str,
                   what: str) -> None:
    from torch.autograd import DeviceType

    # Device-side spans of host annotations (Optimizer.step#...) are not
    # kernels: they cover the host's launch time and would double count.
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.self_device_time_total, reverse=True,
    )
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    per_step_us = device_us / steps
    print(f"{what} on {card}: unprofiled wall {wall_s_per_step * 1e6} us per "
          f"step; device {per_step_us} us per step; "
          f"{sum(e.count for e in kernels) / steps} kernels per step; "
          f"device busy {per_step_us / (wall_s_per_step * 1e6)} of the "
          f"unprofiled step")
    print("device us/step  share  calls/step  kernel")
    for e in kernels[:14]:
        print(f"{e.self_device_time_total / steps:14.3f}  "
              f"{e.self_device_time_total / device_us:5.3f}  "
              f"{e.count / steps:10.2f}  {e.key[:90]}")


def profile_sampler(model, wall_s_per_step: float, card: str) -> None:
    """torch.profiler over a PROFILE_STEPS-step window of the same ancestral
    loop (a PROFILE_STEPS-step schedule: the per-step work is the same)."""
    import torch
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
        sample_diffusion_embeddings(model, sched, n=N, seq_len=SEQ,
                                    embed_dim=DIM, generator=gen)
        torch.cuda.synchronize()
    _profile_table(prof, PROFILE_STEPS, wall_s_per_step, card, "sampler")


def profile_training(joint, card: str) -> None:
    """torch.profiler over PROFILE_TRAIN_STEPS optimizer steps of the
    training path's own step function, after an unprofiled window of the
    same length that gives the wall time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.train import text_train
    from tinydiffusionmodels_torch.train.optim import adamw

    phase(f"profile: {PROFILE_TRAIN_STEPS} training steps under "
          "torch.profiler")
    optimizer = adamw(joint.parameters(), 1e-4, weight_decay=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    vocab = joint["embedding_fn"].embeddings.weight.shape[0]
    tokens = torch.randint(0, vocab, (BATCH, SEQ), generator=gen,
                           device="cuda")
    kw = dict(sched=make_schedule(device="cuda"), use_learned_embeddings=True,
              pretrained_matrix=None)

    def steps(n):
        for _ in range(n):
            text_train.train_step(joint, optimizer, tokens, 1.0, gen, **kw)
        torch.cuda.synchronize()

    steps(5)
    t0 = time.perf_counter()
    steps(PROFILE_TRAIN_STEPS)
    wall = (time.perf_counter() - t0) / PROFILE_TRAIN_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(PROFILE_TRAIN_STEPS)
    _profile_table(prof, PROFILE_TRAIN_STEPS, wall, card, "training")


def _resblock_args(name: str, b: int, seed: int, grad: bool = False):
    """Inputs of UNet block ``name`` at batch ``b`` on the card: N(0, 1)
    activations and time bias, weights at torch's init scale, biases 0.1."""
    import math

    import torch

    from tinydiffusionmodels_torch.models.unet import BLOCKS

    cin, cout = BLOCKS[name]
    hw = 28 if name in ("rb1", "rb4") else 14
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        t = scale * torch.randn(*shape, generator=g, device="cuda")
        return t.requires_grad_(grad)

    args = [r(b, hw, hw, cin), r(cout, cin, 3, 3, scale=1 / math.sqrt(9 * cin)),
            r(cout, scale=0.1), r(cout, cout, 3, 3,
                                  scale=1 / math.sqrt(9 * cout)),
            r(cout, scale=0.1), r(b, 1, 1, cout)]
    if cin != cout:
        return args + [r(cout, cin, 1, 1, scale=1 / math.sqrt(cin)),
                       r(cout, scale=0.1)]
    return args + [None, None]


def _resblock_work(args) -> tuple[int, int]:
    """(bytes, FP32 FLOPs) of one block: every input read once and the
    output written once; 2 FLOPs per multiply-add of both 3x3 convs and the
    1x1 skip."""
    x, w1 = args[0], args[1]
    b, h, w, cin = x.shape
    cout = w1.shape[0]
    macs = b * h * w * (9 * cin * cout + 9 * cout * cout
                        + (cin * cout if args[6] is not None else 0))
    elements = sum(t.numel() for t in args if t is not None) + b * h * w * cout
    return 4 * elements, 2 * macs


def resblock_kernel_vs_plain():
    """The kernel against its plain version at every block shape and the
    RESBLOCK_BATCHES; one backward per block through the Function against
    autograd of the plain version; one UNet forward, card against CPU.
    Returns the largest forward error."""
    import copy

    import torch

    from tinydiffusionmodels_torch.models import SimpleUNet
    from tinydiffusionmodels_torch.models.unet import BLOCKS
    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.ops import resblock as rb

    phase(f"fused resblock kernel vs plain (TF32 off, tile {rb.TILE})")
    worst = 0.0
    for i, name in enumerate(BLOCKS):
        for b in RESBLOCK_BATCHES:
            args = _resblock_args(name, b, seed=200 + 10 * i + b)
            x = args[0]
            out = rb._launch(*args)
            ref = reference.fused_resblock(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
            err = _max_err(out, ref)
            # The border ring alone: where conv2 must see 0, not time_bias.
            ring = torch.ones(x.shape[1:3], dtype=torch.bool, device="cuda")
            ring[1:-1, 1:-1] = False
            worst = max(worst, err)
            print(f"{name} (Cin {x.shape[-1]}, Cout {out.shape[-1]}, "
                  f"H {x.shape[1]}) batch {b:3d}: max|d| {err:.3e}, border "
                  f"ring {_max_err(out[:, ring], ref[:, ring]):.3e} (tol "
                  f"1e-4)")
    for i, name in enumerate(BLOCKS):
        args = _resblock_args(name, 3, seed=300 + i, grad=True)
        leaves = [t for t in args if t is not None]
        g = torch.randn(args[0].shape[:3] + (args[1].shape[0],),
                        device="cuda")
        grads = [torch.autograd.grad(fn(*args), leaves, g)
                 for fn in (rb.fused_resblock, reference.fused_resblock)]
        torch.cuda.synchronize()
        errs = []
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            errs.append(_max_err(got, want))
        print(f"{name} backward through the Function vs plain autograd, "
              f"batch 3: worst of {len(leaves)} gradients {max(errs):.3e} "
              f"(tol 1e-4)")
    model = SimpleUNet(generator=torch.Generator().manual_seed(4)).eval()
    x = torch.randn(2, 28, 28, 1, generator=torch.Generator().manual_seed(5))
    t = torch.tensor([10, 500])
    with torch.inference_mode():
        want = model(x, t)
        got = copy.deepcopy(model).cuda()(x.cuda(), t.cuda()).cpu()
    err = _max_err(got, want)
    print(f"UNet forward, card vs CPU (t = [10, 500]): {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"the UNet on the card leaves the CPU by {err}")
    return worst


def _prepare_mnist_workdir() -> Path:
    work = WORK / "mnist"
    work.mkdir(parents=True, exist_ok=True)
    os.chdir(work)
    os.environ["TDM_PLATFORM"] = "cuda"
    os.environ["TDM_PROGRESS_EVERY"] = "100"
    for var in ("AIP_MODEL_DIR", "TDM_METRICS_PATH", "TDM_DATA_LIMIT",
                "TDM_MNIST_DIR"):
        os.environ.pop(var, None)
    # load_mnist tries a torchvision download before it renders synthetic
    # digits; this machine has no network, so torchvision must not load.
    sys.modules["torchvision"] = None
    return work


def main_path_mnist_train(card: str):
    import numpy as np
    import torch

    from tinydiffusionmodels_torch import mnist
    from tinydiffusionmodels_torch.data import load_mnist

    phase("main path: mnist --train (one epoch, batch 128, synthetic 60 000 "
          "digits, the epoch's 25-sample grid)")
    work = _prepare_mnist_workdir()
    ckpt, grid = work / "mnist_ckpt.pth", work / "samples" / "epoch_001.png"
    for old in (ckpt, grid):
        old.unlink(missing_ok=True)
    t0 = time.perf_counter()
    images, _, source = load_mnist(work / "data")
    print(f"digits: {source}, {len(images)} (rendered or read from the cache "
          f"in {time.perf_counter() - t0:.2f} s)")
    if (source, len(images)) != ("synthetic", MNIST_IMAGES):
        raise AssertionError(f"expected {MNIST_IMAGES} synthetic digits")
    steps = MNIST_IMAGES // MNIST_BATCH
    argv = ["--train", "--epochs", "1", "--batch_size", str(MNIST_BATCH),
            "--ckpt", str(ckpt), "--data_root", str(work / "data")]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    result = mnist.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()
    expect = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0, "guided_decode": 0,
              "fused_resblock": steps * 4 + STEPS * 4}
    if counts != expect:
        raise AssertionError(f"launches {counts} on the MNIST training path, "
                             f"expected {expect}")
    losses = result.step_losses
    if losses.shape != (steps,) or not np.isfinite(losses).all():
        raise AssertionError(f"{losses.shape} step losses, finite: "
                             f"{np.isfinite(losses).all()}")
    first, last = losses[:50].mean(), losses[-50:].mean()
    if not last < first:
        raise AssertionError(f"mean loss of the last 50 steps {last} is not "
                             f"below that of the first 50 ({first})")
    for path in (ckpt, grid):
        if not path.is_file():
            raise AssertionError(f"{path.name} was not written")
    rate = result.steps / result.seconds
    print(f"MNIST training path: launches {counts}; losses finite; mean loss "
          f"first 50 steps {first}, last 50 {last}; {ckpt.name} and "
          f"{grid.name} written; CLI call {cli_s:.3f} s (includes loading the "
          f"digits and the 1000-step grid)")
    print(f"MNIST training: {rate} steps/s ({result.steps} steps over "
          f"{result.seconds} s of step loop), bs={MNIST_BATCH}, f32, on {card}")
    return result, ckpt, counts, rate


def main_path_mnist_sample(card: str, ckpt: Path):
    import torch

    from tinydiffusionmodels_torch import mnist
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.train.mnist_train import (
        load_unet,
        sample_images,
    )

    phase("main path: mnist --sample from the trained checkpoint (25 digits, "
          "1000 ancestral steps), then --sampler ddim --steps 50")
    work = _prepare_mnist_workdir()
    png = work / "samples" / "samples.png"
    runs = []
    for extra, expect_launches in (([], STEPS * 4),
                                   (["--sampler", "ddim", "--steps",
                                     str(MNIST_DDIM_STEPS)],
                                    MNIST_DDIM_STEPS * 4)):
        png.unlink(missing_ok=True)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        x = mnist.main(["--sample", "--ckpt", str(ckpt), *extra])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = _counts()
        expect = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                  "flash_attention_bwd_dkv": 0, "guided_decode": 0,
                  "fused_resblock": expect_launches}
        if counts != expect:
            raise AssertionError(f"launches {counts} on the MNIST sampling "
                                 f"path {extra}, expected {expect}")
        if tuple(x.shape) != (MNIST_N, 28, 28, 1) or x.device.type != "cuda":
            raise AssertionError(f"samples {tuple(x.shape)} on {x.device}")
        if not bool(torch.isfinite(x).all()) or not png.is_file():
            raise AssertionError("samples not finite, or samples.png missing")
        print(f"MNIST --sample {' '.join(extra) or '(ancestral)'}: launches "
              f"{counts}, {MNIST_N} finite digits in [{float(x.min()):.3f}, "
              f"{float(x.max()):.3f}], samples.png written, CLI call "
              f"{cli_s:.3f} s (includes the checkpoint load)")
        runs.append(counts)

    # Steady state: the 1000-step loop again, model already loaded.
    model = load_unet(str(ckpt), "cuda")
    sched = make_schedule(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_images(model, sched, n_samples=MNIST_N, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = min(times)
    print(f"MNIST sampler: 1000-step loop {times} s, {MNIST_N / wall} "
          f"samples/s ({STEPS / wall} steps/s), n={MNIST_N}, on {card}")
    return runs, wall / STEPS, model


def resblock_timing(card: str) -> dict:
    """CUDA-event device times of each block at n 25 and 128 (plain,
    kernel, kernel, plain), beside the bound; sums over a UNet forward.
    Returns, per batch, the sums and the per-block numbers."""
    import torch

    from tinydiffusionmodels_torch.models.unet import BLOCKS
    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.ops import resblock as rb

    phase("timing: fused resblock per UNet block at n 25 and 128 (f32, TF32 "
          "off)")
    out = {}
    for b in (MNIST_N, MNIST_BATCH):
        blocks = {}
        for i, name in enumerate(BLOCKS):
            args = _resblock_args(name, b, seed=400 + i)

            def plain():
                with torch.no_grad():
                    reference.fused_resblock(*args)

            p_ms = [_device_ms(plain)]
            k_ms = [_device_ms(lambda: rb._launch(*args)),
                    _device_ms(lambda: rb._launch(*args))]
            p_ms.append(_device_ms(plain))
            nbytes, flops = _resblock_work(args)
            bound_ms, bound_by = _bound(nbytes, [(flops, FP32_FLOPS_PER_S)])
            ms = sum(k_ms) / 2
            blocks[name] = dict(ms=ms, plain_ms=sum(p_ms) / 2,
                                bound_ms=bound_ms, bound_by=bound_by,
                                bytes=nbytes, flops=flops)
            print(f"{name} n {b}: kernel {k_ms} ms, plain (cuDNN convs) "
                  f"{p_ms} ms; bound {bound_ms} ms by {bound_by} ({nbytes} B,"
                  f" {flops} FLOP), {ms / bound_ms:.1f}x; "
                  f"{flops / ms / 1e9:.2f} TFLOP/s; on {card}")
        total = {k: sum(v[k] for v in blocks.values())
                 for k in ("ms", "plain_ms", "bound_ms")}
        print(f"UNet forward's four blocks at n {b}: kernel {total['ms']} ms, "
              f"plain {total['plain_ms']} ms, bound {total['bound_ms']} ms "
              f"({total['ms'] / total['bound_ms']:.1f}x); on {card}")
        out[b] = dict(total, blocks=blocks)
    return out


def profile_mnist_sampler(model, wall_s_per_step: float, card: str) -> None:
    """torch.profiler over PROFILE_STEPS steps of the MNIST ancestral loop
    at n 25 (a PROFILE_STEPS-step schedule: the per-step work is the
    same)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.train.mnist_train import sample_images

    phase(f"profile: {PROFILE_STEPS} MNIST ancestral steps (n {MNIST_N}) "
          "under torch.profiler")
    sched = make_schedule(PROFILE_STEPS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    sample_images(model, sched, n_samples=MNIST_N, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sample_images(model, sched, n_samples=MNIST_N, generator=gen)
        torch.cuda.synchronize()
    _profile_table(prof, PROFILE_STEPS, wall_s_per_step, card,
                   "MNIST sampler")


def profile_mnist_training(card: str) -> None:
    """torch.profiler over PROFILE_TRAIN_STEPS MNIST optimizer steps at
    batch 128 (the training path's own step function), after an unprofiled
    window of the same length that gives the wall time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.models import SimpleUNet
    from tinydiffusionmodels_torch.train import mnist_train
    from tinydiffusionmodels_torch.train.optim import adamw

    phase(f"profile: {PROFILE_TRAIN_STEPS} MNIST training steps (batch "
          f"{MNIST_BATCH}) under torch.profiler")
    model = SimpleUNet(generator=torch.Generator().manual_seed(6)).cuda()
    optimizer = adamw(model.parameters(), 1e-3, weight_decay=0.01)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = torch.rand(MNIST_BATCH, 28, 28, 1, generator=gen,
                       device="cuda") * 2 - 1
    sched = make_schedule(device="cuda")

    def steps(n):
        for _ in range(n):
            mnist_train.train_step(model, optimizer, batch, sched, gen)
        torch.cuda.synchronize()

    steps(5)
    t0 = time.perf_counter()
    steps(PROFILE_TRAIN_STEPS)
    wall = (time.perf_counter() - t0) / PROFILE_TRAIN_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(PROFILE_TRAIN_STEPS)
    _profile_table(prof, PROFILE_TRAIN_STEPS, wall, card, "MNIST training")


def main() -> None:
    card = environment()
    build()
    fwd_errors = kernel_vs_plain()
    train_errors, mask_mismatches = training_kernels()
    resblock_error = resblock_kernel_vs_plain()
    result, ckpt, train_counts, _ = main_path_train(card)
    model = result.joint["diffusion_model"].eval()
    sample_counts, wall_s_per_step, z = main_path_sample(card, ckpt, model)
    decode_worst_gap, decode_stats = decode_kernel_vs_plain()
    guided_counts, lm_ckpt = main_path_guided(card, ckpt)
    exact_counts, rounds, agree, exact_gap, exact_stats = guided_exact(
        card, lm_ckpt, ckpt, z, result.joint["rounding_fn"].eval())
    _, mnist_ckpt, mnist_train_counts, _ = main_path_mnist_train(card)
    mnist_sample_counts, mnist_wall_per_step, unet = main_path_mnist_sample(
        card, mnist_ckpt)
    device_vs_cpu(model)
    timings = kernel_timing(card)
    decode_times = decode_timing(card)
    resblock_times = resblock_timing(card)
    profile_sampler(model, wall_s_per_step, card)
    profile_training(result.joint, card)
    profile_mnist_sampler(unet, mnist_wall_per_step, card)
    profile_mnist_training(card)
    import torch

    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib",
                                             "tinydiffusionmodels_tpu"))
    if imported:
        raise AssertionError(f"the port imported {imported[:5]}")
    errors = {"flash_attention_fwd": max(fwd_errors["slice_f32"],
                                         train_errors["out"]),
              "flash_attention_bwd_dq": train_errors["dq"],
              "flash_attention_bwd_dkv": train_errors["dkv"],
              "guided_decode": max(decode_worst_gap, exact_gap),
              "fused_resblock": resblock_error}
    bs8, bs256 = (decode_times[b] for b in DECODE_BATCHES)
    timings["guided_decode"] = {
        **{k: bs8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "fp32_fma_roof_ms")},
        "at": "bs 8", "bs256": bs256,
        "barrier_share_bs8": bs8["barrier_share"],
        "jacobi_rounds_main_path": rounds, "agreement_with_plain": agree,
        "vs_plain": decode_stats, "vs_plain_main_path": exact_stats,
    }
    n25, n128 = (resblock_times[b] for b in (MNIST_N, MNIST_BATCH))
    timings["fused_resblock"] = {
        **{k: n25[k] for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "operations", "library_ms": None,
        "at": "sum of the four blocks of one UNet forward, n 25",
        "n128": {k: n128[k] for k in ("ms", "plain_ms", "bound_ms")},
        "blocks_n25": n25["blocks"], "blocks_n128": n128["blocks"],
        "plain": "cuDNN convs, TF32 off (no single PyTorch call computes "
                 "the block)",
    }
    if any(v["bound_by"] != "operations"
           for b in (n25, n128) for v in b["blocks"].values()):
        raise AssertionError("a resblock shape is bound by bytes")
    paths = (train_counts, sample_counts, guided_counts, exact_counts,
             mnist_train_counts, *mnist_sample_counts)
    record = []
    for name, (source, replaces) in KERNELS.items():
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in paths),
            "max_abs_err": errors[name],
            **timings[name],
        }
        if name.startswith("flash"):
            entry["dropout_hash"] = {"source": DROPOUT_HASH[0],
                                     "replaces": DROPOUT_HASH[1],
                                     "mask_mismatches": mask_mismatches}
        record.append(entry)
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
