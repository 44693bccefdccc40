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
   and spills of every kernel instance, the flash kernels' D 256 ones
   included.
3. Forward kernel vs plain: the flash-attention forward against its plain
   PyTorch version, TF32 off, on O and lse: f32 atol = rtol = 1e-4; bf16
   atol = rtol = 2e-2 on O and 1e-2 on lse. The cases include every flash
   shape of the kernel bench (phase 19) as it feeds them, one tensor as q,
   k and v: f32 at L 64, 512 and 2048, bf16 at its four shapes; and head
   widths WIDTHS (8, 12, 16, 24, 96, 160, 192, 256) in f32 and bf16 on
   strided views of one QKV tensor (bf16 Dh 12 rows on 8 bytes; a bf16 Dh
   9 case on 2 bytes), Dh 12 with Dv 24 and Dh 160 with Dv 256, causal,
   and Dh 256 with Dv 24; above 256, where the D 256 instances stage the
   head width, Dh 512 on the QKV views (the --embed_dim 2048 path's) and
   Dh 264 with Dv 320, causal, f32 and bf16.
4. Training kernels vs plain: the forward with attention-weight dropout and
   the recompute backward (dq; dk and dv; with an lse cotangent) against
   autograd of the plain version, same seed, same tolerances on O and lse.
   Gradients: f32 atol = rtol = 2e-4, bf16 2e-2. The gradients are looser
   than O because ds = p (dp - D) subtracts two sums of Dv products that
   nearly cancel, so their rounding (summed in another order by the kernel
   than by cuBLAS) is amplified; in bf16, D is formed from the bf16-rounded
   O. The cases include the kernel bench's: its grad mode (f32, L 64, 512
   and 2048) and its bf16 training (four shapes, dropout 0.1), q, k and v
   equal; dq, dk and dv are held apart, because in bf16 their sum, the
   bench's gradient, cancels and its rounding error scales with the parts.
   Their bf16 gradients are held to BF16_LONG_GRAD_TOL (4e-2, the reason
   beside it), and each has an f32 twin with dropout at 2e-4. The width
   cases of phase 3 run here too, with dropout, through the QKV tensor's
   gradient, and the Dh 512 and Dh 264 / Dv 320 cases at L 64 with and
   without dropout. Then v = I and dO = I probes read the mask the forward
   and the dkv kernel realise, and hold it against
   ``reference.dropout_scale``.
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
   files. Then RATE_RUNS more sampler runs give steps/s. Then the narrow
   text path, head width 12: ``--train --embed_dim 48`` on NARROW_CHARS
   characters (launches as phase 5, a falling loss), and ``--sample
   --sampler ddim --steps 50`` from it (150 forward launches, finite
   embeddings of width 48, 8 samples). Then the wide text path, head width
   192 (the D 256 instances of all three flash kernels): ``--train
   --embed_dim 768 --depth 2`` on NARROW_CHARS characters and ``--sample
   --sampler ddim --steps 50`` from it (100 forward launches), asserted the
   same way. Then the reference's default width, head width 512 (the
   staged D 256 instances): ``--train --embed_dim 2048`` (depth 3, the
   width of the CLI's default Gemma-2B embedding, which is not on the card
   machine, so learned embeddings) on NARROW_CHARS characters and DDIM 50
   from it (150 launches), asserted the same way.
7. Guided-decode kernel vs plain: the persistent kernel
   (``csrc/guided_decode.cu``) against its plain version on the same bf16
   weights and N(0, 1) logits: B in {1, 8, 13, 256, 257}, V in {97, 4096,
   4097}, depth 2 and 4, width 256 and the odd width 72 (H 4: Dh 18,
   F 288), raw and normalized mixing, temperature != 1. Every row's first
   divergence from the plain tokens, and every position of the kernel's
   decode scored by the plain version teacher-forced on the kernel's
   tokens, must be a near-tie (DECODE_TIE_RTOL of the best score); each
   case's mean first divergence must be past L/2.
8. Main path, guided CLI: ``shakespeare.main(["--guided_sample",
   "--base_lm", "tinygpt", ...])`` from the trained checkpoint, n 8, seq
   64: trains TinyGPT (dim 256, depth 4) for LM_EPOCHS and writes
   lm_ckpt.pth and 8 guided samples; the decode is a ``GuidedDecoder``'s
   replayed scan; asserts forward = 1000 x 3 (sampler) + 65 x 4 (the
   scan's 64 positions and its prime's one) + steps x 4, dq = dkv = steps
   x 4, no decode launch. A second call reuses lm_ckpt.pth (no training
   launch), samples by DDIM 10 and runs under ``--profile_dir``: its
   per-op table must list the flash forward kernel.
9. Main path, exact guided decode: a ``GuidedDecoder(draft="fused")`` on
   that TinyGPT and the trained rounding head's logits of phase 6's
   embeddings: one decode-kernel launch and forward = Jacobi rounds x 4,
   plus the primes' (one decode launch, 4 forwards), the output equal to
   its own fixpoint and to ``guided_generate_verified``'s (tokens and
   rounds), >= 95 % agreement with the plain f32 scan. Outside the counted
   run, the kernel's decode of the same TinyGPT and logits is held against
   its plain version by phase 7's criteria: the main path's own shape and
   trained weights. Then phase 28.
10. Device vs CPU: one full-width denoiser forward on the card (kernel) and
   on the CPU (plain version), same weights and inputs, within 1e-3.
11. Timing at the training shape (B 8, L 64, H 4, Dh 64, f32, the model's
   strided views of one QKV projection), at the kernel bench's L 512
   (B 8) and L 2048 (B 2), and at the training shape with Dh 512 (the
   --embed_dim 2048 path's): CUDA-event device times of the forward with
   dropout, the dq kernel and the dkv kernel, each beside its plain version,
   the device time of a PyTorch call the port never calls
   (``scaled_dot_product_attention`` at dropout 0, its own kernels' self
   device time from torch.profiler: the forward, and the backward for dq
   and dk/dv), and the bound (bytes over 3.35 TB/s or the products as
   3xTF32, three TF32 products at 495 TFLOP/s each, the larger), with the
   FP32-FMA roof (the FLOPs at 67 TFLOP/s) printed beside it.
12. Timing of the guided decode at the bench shape (V 4096, D 256, depth 4,
   L 64, alpha 0.3) at bs 8 and 256: the kernel's CUDA-event time beside its
   plain version and its bound (bytes over 3.35 TB/s or the matmul FLOPs,
   bf16 products with f32 sums, over the bf16 tensor-core peak of 989
   TFLOP/s plus the attention's f32 FLOPs over 67 TFLOP/s, the larger; no
   single PyTorch call computes it), the chain floor (its grid barriers
   alone, at its grid and count, with the kernel's own barrier and
   cooperative_groups' grid.sync beside it), and the mean time of each
   phase from CTA 0's %globaltimer stamps. (Tokens/s of the exact decodes:
   phase 27.)
13. Profiles: ``torch.profiler`` over a window of the sampler and over
   PROFILE_TRAIN_STEPS training steps, each eager and replayed (phase 26):
   device time and kernels per step, the device's busy share, the kernels
   by device time.
14. Resblock kernel vs plain: the fused UNet residual block
   (``csrc/fused_resblock.cu``) against its plain version (cuDNN convs, TF32
   off) at the four block shapes of the UNet, batch 1, 3, 25 and 128, both
   tile edges, random weights and a nonzero time bias: f32 atol = rtol =
   1e-4, bf16 2e-2 (both round h and the output to bf16), the max error
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
17. Resblock timing: each block at n 25 and 128, f32 and bf16, the
   kernel's CUDA-event time beside the plain version's (cuDNN convs, TF32
   off), its cuDNN kernels' self device time from torch.profiler (no
   single PyTorch call computes the block) and the bound (the products as
   3xTF32 in f32 or at the bf16 peak, against bytes at 3.35 TB/s; the
   FP32-FMA roof printed beside), and their sums over a UNet forward; then
   ``torch.profiler`` over PROFILE_STEPS MNIST sampler steps and over
   PROFILE_TRAIN_STEPS MNIST training steps; and over PROFILE_TRAIN_STEPS
   bf16 steps of each trainer at the bench's bf16 batch, BF16_BATCH (512):
   the text step at the bench's shape (vocab 4096) and the MNIST step.
18. Single-block kernels vs plain (run after phase 14): the forward and
   the recompute backward of ``csrc/attention_single_block.cu`` at the
   shapes of SINGLE_BLOCK_CASES (the JAX package's test shapes, the
   sampler's, a ragged L 100, Dh 128 at L 96 and 128, Dh 8, 24, 96 and 256,
   the last also at L 128), f32 and bf16, against
   ``reference.single_block_attention`` (f32
   atol = rtol = 1e-4, bf16 2e-2) and ``single_block_attention_bwd`` for a
   cos(arange) cotangent (f32 2e-4, for phase 4's reason; bf16 2e-2); in
   f32 also against ``reference.attention`` and its autograd; in bf16 the
   kernels must equal their plain versions in more elements than they
   equal ``reference.attention`` and its autograd (the rounding points).
   Two backward calls at the sampler's shape give identical bits. Shapes
   outside the kernels' domain (L 129, Dh 257) must raise before a launch.
19. Main path, kernel bench (run after phase 16): ``kernel_bench.main(
   ["all"])``, every mode and shape of the JAX tool. Asserts each kernel's
   launches equal what the tool's loops imply and a finite time on every
   line, and prints the lines.
20. Single-block timing (after phase 17): both kernels at the sampler
   shape (B 8, H 4, L 64, Dh 64, f32), CUDA-event times beside the plain
   versions, ``scaled_dot_product_attention`` (forward; forward and
   backward; its kernels' self device time from torch.profiler) and the
   bound (bytes over 3.35 TB/s or the products as 3xTF32, the backward's
   five L x L x Dh products; the FP32-FMA roof printed beside).

21. Main path, bf16 training (after phase 19): ``shakespeare.main([
   "--train", "--dtype", "bf16", ...])`` at phase 5's width, batch and
   corpus, asserted as phase 5 is, with every flash forward, dq and dk/dv
   launch on bf16 operands, the strided views of one QKV projection (the
   wrappers' launch functions wrapped to record dtype and layout); then ``mnist.main(["--train", "--dtype", "bf16",
   ...])`` for MNIST_BF16_STEPS steps of batch 128, every resblock launch
   bf16, the mean loss of the last quarter of the steps below the first's.
   Both runs' checkpoints hold float32 tensors only.
22. bf16 train step, card against CPU: one deterministic bf16 step of the
   text model at the bench's bf16 shape with the batch cut to 64 (dim 256,
   L 64, depth 3, vocab 4096; the same weights, tokens, t and noise) and
   one of the UNet at batch 32: losses within LOSS_RTOL_BF16 (2e-2)
   relative, each gradient within GRAD_RTOL_BF16 (5e-2) of the CPU bf16
   gradient's largest magnitude plus the CPU bf16 gradient's own distance
   from the CPU f32 one (``tests/test_torch_precision.py``'s rule, the CPU
   in the JAX package's place), and ``perf.compiled_flops`` of each step
   equal on both devices.
23. Main path, the bench (last): ``python -m tinydiffusionmodels_torch.
   bench --quick`` as a subprocess with TDM_BENCH_RETRIES=0 and
   TDM_BENCH_QUIET_WAIT=0: its last line has ``bench.py``'s keys, all 14
   metrics finite and > 0, mfu for every train and sample metric, and
   launches of every kernel of its paths; ``valid`` is printed, not
   asserted (the build raised the load average), and its provenance's
   Jacobi record for the three verified metrics. Its launches count with
   the main paths' in the kernels' record.

CUDA graphs (after phase 22). Every main path above runs its training
chunks and its reverse loops as CUDA graphs (``tinydiffusionmodels_torch/
graphs.py``): each kind of step runs eagerly twice (a sampler step once)
on a side stream, is captured and is replayed, and each replay adds the
capture's launches to the counters, so the launch counts asserted there
count replays.

24. Replay against eager: GRAPH_STEPS (25) steps of the trainers' chunk
   runners (``TextSteps``, ``MnistSteps``), replayed, against as many
   eager steps from the same seeds: the text step at the headline shape in
   f32 and bf16, with self-conditioning on and off, with an EMA
   (TEXT_GRAPH_CASES), and the MNIST step at bs 128 f32 with an EMA and
   bs 512 bf16 (MNIST_GRAPH_CASES). Every step loss, parameter and EMA
   parameter must be bit-equal, and the launches equal. Where two eager
   runs already differ (the MNIST f32 step: cuDNN's f32 weight-gradient
   convolutions), the replay's distance to the nearer of them is held to
   fixed tolerances of K f32 steps, REPLAY_F32_LOSS_ATOL on the losses and
   REPLAY_F32_TENSOR_ATOL on the parameters (PERF.md §2), and the op is
   named by running again with cuDNN's deterministic algorithms: then two
   eager runs and the replay must be bit-equal, the replay's gate. Then each captured sampler against its eager loop
   (``sample_loop(eager=True)``), bit for bit: text ancestral at n 8, text
   DDIM 50 with self-conditioning, MNIST ancestral, DDIM 50 and DPM++ 20
   at n 25.
25. The kernels inside the graphs: torch.profiler over one replay of each
   training graph must list the flash forward, dq and dk/dv kernels and
   the resblock kernel as many times as the capture counted; over a
   captured 10-step sampler loop, ten steps' worth. Where the profiler
   lists no kernel of a replay, that is printed, and the counters' deltas
   are the evidence.
26. Timing (phases 13 and 17's profiles): for the text step at bs 8 f32,
   the text sampler at n 8, the MNIST sampler at n 25, the MNIST step at
   bs 128 f32 and both steps at bs 512 bf16, eager and replayed: the wall
   time per step (unprofiled: a 1000-step loop, or GRAPH_WALL_STEPS
   training steps), the device time and kernels per step from
   torch.profiler, and the busy share, printed as one table beside the
   card's name and power limit.

27. The guided decoder (after phase 25): ``sample.guided.GuidedDecoder``
   at the bench's guided shape (V 4096, D 256, depth 4, L 64), cases
   DECODER_CASES: the plain scan at bs 8 and 256, the bf16-scan draft at
   256, the fused draft at 8 and 256. A decoder's first call (prime,
   capture, replay) and a later one, on other logits, must equal
   ``guided_generate_verified`` bit for bit, tokens and Jacobi rounds; the
   launches are a scan's 64 x 4 flash forwards, 4 a round, one decode
   launch, plus the primes' on the first call. Printed per case, beside
   the card's name and power limit: eager and replayed ms a call, device
   µs and busy share from torch.profiler (a replayed call's kernels by
   device time), and for the verified cases the ms of a round (its replay
   and flag read), its device µs and the flag read alone.
28. The Jacobi-rounds tool (after phase 9): ``python -m
   tinydiffusionmodels_torch.jacobi_rounds --lm_ckpt`` on phase 8's
   trained TinyGPT: rounds of the fused and bf16-scan drafts at bs 8 and
   256, random and trained weights; every case must converge within 65.

Data and sequence parallelism (after phase 27). One card cannot hold a
NCCL group of two ranks (NCCL refuses two ranks on one GPU), and gloo's
send and receive take CPU tensors, so no phase runs a ring of two
processes on the card; the CPU tests do (``tests/test_torch_parallel.py``,
``tests/test_torch_ring_attention.py``).

29. Ring attention on the card: ``parallel.ring_attention`` with 2 and 4
   shards in one process (the per-shard code of ``ring_attention_shard``;
   blocks move between shards in place of the process group's rotation):
   every block the flash forward at q_offset = r L / n and k_offset = src
   L / n, merged through its lse, and autograd's dq and dk/dv launches a
   block, at RING_SHAPES (B 8, H 4, L 64, Dh 64 and B 2, L 2048), f32 and
   bf16, RING_CONFIGS (plain; causal at dropout 0.1; bidirectional at
   dropout 0.1; causal and bidirectional). Out, lse and the q, k and v
   gradients (output and lse cotangents) against the kernels over the
   whole sequence: f32 1e-4 (out, lse) and 2e-4 (gradients), bf16 2e-2 and
   1e-2, gradients 2e-2 and 4e-2 past L 64. Launches asserted: n x n blocks
   (2 n x n bidirectional) of each kernel.
30. The CLIs under torchrun at world 1: ``python -m torch.distributed.run
   --standalone --nproc_per_node 1 chip_smoke.py --cli shakespeare|mnist
   ...`` (a real NCCL group: the gradient all-reduce is captured in every
   replayed chunk) against the same command without torchrun: the text
   CLI at the headline width on TORCHRUN_CHARS characters, plain and with
   ``--seq_parallel`` (a ring of one), and the MNIST CLI on
   TORCHRUN_MNIST_IMAGES digits under ``cudnn.deterministic``. The final
   (and best) checkpoints must be bit-equal, the launches as phase 5's and
   15's. The six runs share the card at once. Their launches count with
   the main paths'.
31. The replayed text step (headline shape, f32) with a world-1 NCCL group
   created in this process and without one, from one seed: bit-equal
   after 3 steps, then the wall per replayed step over GROUP_WALL_STEPS
   steps, two rounds each alternately, and torch.profiler's device time of
   the NCCL kernel per step, beside the card's name and power limit.

The peaks, the bound and the timer are ``tinydiffusionmodels_torch.perf``'s.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``; before them, the command's time.
"""

from __future__ import annotations

import contextlib
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
PROFILE_DDIM_STEPS = 10  # the profiled guided CLI call's sampler
ALPHA = 0.3
DECODE_BATCHES = (8, 256)
# The guided decoder's cases (phase 27): (draft, batch) at the bench shape,
# and the timed calls a mode.
DECODER_CASES = (("plain", 8), ("plain", 256), ("scan_bf16", 256),
                 ("fused", 8), ("fused", 256))
DECODER_RUNS = 5
# Near-tie tolerance of the decode kernel against its plain version: the
# plain version's score gap between its best token and the kernel's, over
# the best score's magnitude. Both round the same activations to bf16, so
# they differ only where an f32 sum taken in another order flips a bf16
# rounding (a relative 2^-8 step of one activation), which moves the scores
# by a fraction of a bf16 step.
DECODE_TIE_RTOL = 1e-2
# bf16 gradient tolerance of the flash kernels past L 64 (the kernel bench's
# bf16 training shapes), against autograd of the plain version. The kernels'
# D = rowsum(dO O) takes the stored bf16 O, autograd the f32 one; the error
# of D, about sqrt(Dh) |dO| |O| 2^-9, reaches dq and dk through p q scale, so
# it grows with the largest |dO|, |O| and |q| of a million elements and
# passes 2e-2 in a few of them. The JAX package's own bf16 gradient
# tolerance on its TPU is 4e-2 (tests/test_ops.py, _grad_tol); each such
# case has an f32 twin held to 2e-4, and the count beyond 2e-2 is printed.
# The same tolerance holds bf16 gradients with dropout at head widths above
# 256: there the forward rounds each kept weight p / (1 - rate) to bf16
# before P V, where the TPU kernel does (1 / 0.9 becomes 1.109375), D takes
# that output, and dP takes the f32 factor, so ds is off by about 0.0016
# |dp|, and |dp| grows as sqrt(Dv) (54 at a causal row 0 at Dv 512, where
# dq moved by 0.029). The plain version multiplies f32 weights.
BF16_LONG_GRAD_TOL = 4e-2
# Head widths checked beside the model's 64: one in each padded instance
# (16, 32, 64, 128, 256) and the text CLI's at --embed_dim 32, 48, 64, 96,
# 384, 640 and 768, and the widest.
WIDTHS = (8, 12, 16, 24, 96, 160, 192, 256)
# The narrow text path: --embed_dim 48 (head width 12) trained on
# NARROW_CHARS characters at lr 1e-3 with 10 warmup steps (so that ~70 steps
# move the loss), then sampled by DDIM in NARROW_SAMPLE_STEPS steps.
NARROW_DIM, NARROW_CHARS, NARROW_SAMPLE_STEPS = 48, 40_000, 50
NARROW_TRAIN_ARGS = ("--lr", "1e-3", "--warmup_steps", "10")
# The wide text path: --embed_dim 768 (head width 192, the D 256 instances)
# at depth WIDE_DEPTH, trained on NARROW_CHARS characters at lr 3e-4 with 10
# warmup steps, then sampled by DDIM in NARROW_SAMPLE_STEPS steps.
WIDE_DIM, WIDE_DEPTH = 768, 2
WIDE_TRAIN_ARGS = ("--lr", "3e-4", "--warmup_steps", "10")
# The reference's default width: the text CLI's --model_id google/gemma-2b-it
# gives the denoiser Gemma-2B's embedding width, 2048, so 4 heads of 512
# (the staged D 256 instances). Those weights are not on the card machine,
# so the path takes learned embeddings at --embed_dim 2048 and the CLI's
# depth 3, trained on NARROW_CHARS characters at the CLI's lr 1e-4 with 10
# warmup steps, then sampled by DDIM in NARROW_SAMPLE_STEPS steps.
GEMMA_DIM = 2048
GEMMA_TRAIN_ARGS = ("--lr", "1e-4", "--warmup_steps", "10")
# (B, L, Dh) of the flash kernels' timing (H 4): the training shape, the
# kernel bench's L 512 and 2048, and the training shape at GEMMA_DIM.
TIMING_SHAPES = ((BATCH, SEQ, DIM // HEADS), (8, 512, DIM // HEADS),
                 (2, 2048, DIM // HEADS), (BATCH, SEQ, GEMMA_DIM // HEADS))

_CSRC = "tinydiffusionmodels_torch/csrc/"
_PALLAS = "tinydiffusionmodels_tpu/ops/pallas_kernels.py"
# name: (source of the kernel body, the TPU kernel it replaces)
KERNELS = {
    "flash_attention_fwd": (_CSRC + "flash_attention_fwd.cu",
                            _PALLAS + ":295"),
    "flash_attention_bwd_dq": (_CSRC + "flash_attention_bwd_dq.cu",
                               _PALLAS + ":431"),
    "flash_attention_bwd_dkv": (_CSRC + "flash_attention_bwd_dkv.cu",
                                _PALLAS + ":484"),
}
DROPOUT_HASH = (_CSRC + "dropout_hash.cuh", _PALLAS + ":266")
KERNELS["guided_decode"] = (_CSRC + "guided_decode.cu",
                            "tinydiffusionmodels_tpu/ops/decode_kernel.py:67")
KERNELS["fused_resblock"] = (_CSRC + "fused_resblock.cu", _PALLAS + ":809")
KERNELS["attention_single_block_fwd"] = (_CSRC + "attention_single_block.cu",
                                         _PALLAS + ":49")
KERNELS["attention_single_block_bwd"] = (_CSRC + "attention_single_block.cu",
                                         _PALLAS + ":91")
# Paths other than the kernel bench launch no single-block kernel.
_SINGLE_BLOCK_IDLE = {"attention_single_block_fwd": 0,
                      "attention_single_block_bwd": 0}

# The MNIST paths: the UNet as it is (channel plan of models/unet.py, 28x28,
# the 1000-step schedule) on the 60 000 synthetic training digits.
MNIST_BATCH, MNIST_N, MNIST_IMAGES = 128, 25, 60_000
MNIST_DDIM_STEPS = 50
RESBLOCK_BATCHES = (1, 3, 25, 128)
# bf16 training (phase a): MNIST steps of MNIST_BATCH; phase (b)'s
# tolerances, those of tests/test_torch_precision.py: losses relative, and
# gradients GRAD_RTOL_BF16 of the largest magnitude plus the reference's
# own bf16 error.
MNIST_BF16_STEPS = 64
BF16_BATCH = 512        # the bench's bf16 training metrics, profiled
LOSS_RTOL_BF16, GRAD_RTOL_BF16 = 2e-2, 5e-2
# The bench (phase c): bench.py's schema, its 14 metrics, those with mfu.
BENCH_TIMEOUT_S = 600
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "valid", "extra"}
BENCH_EXTRA_KEYS = {
    "backend", "device_kind", "peak_flops_bf16", "mnist_train_it_s_bs128",
    "mnist_sample_samples_s_1000step_bs256", "mnist_train_vs_ref_t4_est",
    "mnist_sample_vs_ref_t4_est", "shakespeare_sample_steps_s_bs8",
    "shakespeare_sample_vs_t4_601", "guided_decode_tokens_s_bs8",
    "guided_decode_tokens_s_bs256", "guided_fused_tokens_s_bs8",
    "guided_fused_tokens_s_bs256", "guided_verified_tokens_s_bs8",
    "guided_verified_tokens_s_bs256", "guided_spec_tokens_s_bs256",
    "guided_exact_best_tokens_s_bs256",
    "mnist_sample_dpmpp20_samples_s_bs256", "mnist_train_bs512_bf16_it_s",
    "shakespeare_train_bs512_bf16_it_s", "mfu", "envelope", "provenance"}
BENCH_METRICS = (
    "shakespeare_train_it_s", "shakespeare_sample_steps_s",
    "mnist_train_it_s", "mnist_sample_samples_s", "mnist_sample_dpmpp20_s",
    "guided_tokens_s", "guided_tokens_s_bs256", "guided_fused_tokens_s",
    "guided_fused_tokens_s_bs256", "guided_verified_tokens_s_bs8",
    "guided_verified_tokens_s_bs256", "guided_spec_tokens_s_bs256",
    "mnist_train_bs512_bf16_it_s", "shakespeare_train_bs512_bf16_it_s")
BENCH_MFU_METRICS = {
    "shakespeare_train_it_s", "shakespeare_sample_steps_s",
    "mnist_train_it_s", "mnist_sample_samples_s", "mnist_sample_dpmpp20_s",
    "mnist_train_bs512_bf16_it_s", "shakespeare_train_bs512_bf16_it_s"}


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
    from tinydiffusionmodels_torch import perf
    from tinydiffusionmodels_torch.ops import _build

    smi = perf.card_label()
    print(smi)
    if None in (perf.device_hbm_bandwidth(), perf.device_peak_flops(
            dtype="f32"), perf.device_peak_flops(dtype="bf16")):
        raise SystemExit(f"chip_smoke: tinydiffusionmodels_torch/perf.py "
                         f"lists no peaks for {torch.cuda.get_device_name(0)}"
                         f", so no bound can be given")

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


def _max_err(a, b) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def kernel_vs_plain():
    import torch

    from tinydiffusionmodels_torch import kernel_bench as kb
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
    # Every width class of the kernels, on the model's strided views of one
    # fused QKV projection (bf16 Dh 12 rows start on 8 bytes, Dh 9 on 2),
    # and Dv != Dh.
    for d in WIDTHS:
        for dtype in (f32, bf16):
            cases[f"dh{d}_{str(dtype)[6:]}_qkv"] = (
                8, 4, 64, 64, d, d, dtype, False, "blhd", 0)
    cases["dh9_bfloat16_qkv"] = (8, 4, 64, 64, 9, 9, bf16, False, "blhd", 0)
    for dtype in (f32, bf16):
        cases[f"dh12_dv24_{str(dtype)[6:]}_causal"] = (
            2, 4, 100, 100, 12, 24, dtype, True, "bhld", 0)
        cases[f"dh160_dv256_{str(dtype)[6:]}_causal"] = (
            2, 2, 100, 100, 160, 256, dtype, True, "bhld", 0)
        cases[f"dh256_dv24_{str(dtype)[6:]}"] = (
            2, 2, 100, 80, 256, 24, dtype, False, "bhld", 0)
        # Above 256, the staged D 256 instances: the text CLI's
        # --embed_dim 2048 (Dh 512) on its QKV views, and a ragged last
        # chunk of 8 columns with Dv != Dh.
        cases[f"dh512_{str(dtype)[6:]}_qkv"] = (
            8, 4, 64, 64, 512, 512, dtype, False, "blhd", 0)
        cases[f"dh264_dv320_{str(dtype)[6:]}_causal"] = (
            2, 2, 64, 64, 264, 320, dtype, True, "bhld", 0)
    cases.update({name: case[:-1] for name, case in
                  _bench_attention_cases(kb, (0.0,)).items()})
    errors = {}
    for seed, (name, (b, h, lq, lk, dh, dv, dtype, causal, layout, k_off)) \
            in enumerate(cases.items()):
        q, k, v = _qkv(b, h, lq, lk, dh, dv, dtype,
                       "bhld" if layout == "self" else layout, seed)
        if layout == "self":
            k = v = q
            layout = "bhld"
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


def _bench_attention_cases(kb, bf16_rates) -> dict:
    """The flash kernels' shapes on the kernel bench's path, as it feeds
    them (q, k and v equal: layout "self"): f32 at every attention
    shape, and bf16 at every bf16 shape with each dropout rate of
    ``bf16_rates``. name: (B, H, Lq, Lk, Dh, Dv, dtype, causal, layout,
    k_offset, rate)."""
    import torch

    cases = {}
    for b, h, length, d in kb.ATTENTION_SHAPES:
        cases[f"bench_f32_B{b}_L{length}"] = (
            b, h, length, length, d, d, torch.float32, False, "self", 0, 0.0)
    for b, h, length, d in kb.BF16_SHAPES:
        for rate in bf16_rates:
            cases[f"bench_bf16_B{b}_L{length}_p{rate:g}"] = (
                b, h, length, length, d, d, torch.bfloat16, False, "self", 0,
                rate)
    return cases


def _seed(value: int):
    import torch

    return torch.tensor([value], dtype=torch.int32, device="cuda")


def training_kernels():
    """Forward with dropout and both backward kernels against autograd of
    the plain version; then the realised masks against dropout_scale.
    Returns the largest O, dq and dk/dv errors of the f32 slice cases, and
    the number of mask decisions that differ (0)."""
    import torch

    from tinydiffusionmodels_torch import kernel_bench as kb
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
    # Every width class on the model's views of one QKV tensor (bf16 Dh 12
    # rows start on 8 bytes, Dh 9 on 2), and Dv != Dh, with dropout.
    for d in WIDTHS:
        for dtype in (f32, bf16):
            cases[f"dh{d}_{str(dtype)[6:]}_qkv_p0.1"] = (
                8, 4, 64, 64, d, d, dtype, False, "qkv", 0, DROPOUT)
    cases["dh9_bfloat16_qkv_p0.1"] = (8, 4, 64, 64, 9, 9, bf16, False, "qkv",
                                      0, DROPOUT)
    for dtype in (f32, bf16):
        cases[f"dh12_dv24_{str(dtype)[6:]}_causal_p0.1"] = (
            2, 4, 100, 100, 12, 24, dtype, True, "bhld", 0, DROPOUT)
        cases[f"dh160_dv256_{str(dtype)[6:]}_causal_p0.1"] = (
            2, 2, 100, 100, 160, 256, dtype, True, "bhld", 0, DROPOUT)
        cases[f"dh256_dv24_{str(dtype)[6:]}_p0.1"] = (
            2, 2, 100, 80, 256, 24, dtype, False, "bhld", 0, DROPOUT)
        # Above 256 (the staged instances), with and without dropout; L 64,
        # so that bf16 gradients take the 2e-2 of the other widths.
        for rate in (0.0, DROPOUT):
            cases[f"dh512_{str(dtype)[6:]}_qkv_p{rate:g}"] = (
                8, 4, 64, 64, 512, 512, dtype, False, "qkv", 0, rate)
            cases[f"dh264_dv320_{str(dtype)[6:]}_causal_p{rate:g}"] = (
                2, 2, 64, 64, 264, 320, dtype, True, "bhld", 0, rate)
    # The kernel bench's grad mode (f32, no dropout) and bf16 training; and
    # the f32 twin of each bf16 training case, which holds the arithmetic
    # (dropout included) at those shapes to f32's tolerance.
    cases.update(_bench_attention_cases(kb, (kb.DROPOUT,)))
    for b, h, length, d in kb.BF16_SHAPES:
        cases[f"bench_f32_B{b}_L{length}_p{kb.DROPOUT:g}"] = (
            b, h, length, length, d, d, f32, False, "self", 0, kb.DROPOUT)
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
            split = lambda gr: gr[0].unbind(2)  # noqa: E731
            layout = "blhd"
        elif layout == "self":
            # The kernel bench's operands: q, k and v equal. Three leaves,
            # so that dq, dk and dv are held apart: the bench's gradient is
            # their sum, and in bf16 that sum of three rounded parts
            # cancels, so its rounding error scales with the parts, not
            # with the sum.
            x = torch.randn(b, h, lq, dh, generator=g, device="cuda")
            leaves = tuple(x.to(dtype, copy=True).requires_grad_()
                           for _ in range(3))
            views = lambda q, k, v: (q, k, v)  # noqa: E731
            split = lambda gr: gr  # noqa: E731
            layout = "bhld"
        else:
            leaves = tuple(x.requires_grad_() for x in _qkv(
                b, h, lq, lk, dh, dv, dtype, layout, 100 + i))
            views = lambda q, k, v: (q, k, v)  # noqa: E731
            split = lambda gr: gr  # noqa: E731
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
        if bf and (lq > 64 or (rate and max(dh, dv_dim) > 256)):
            tol_g = BF16_LONG_GRAD_TOL
        torch.testing.assert_close(out, r_out, atol=tol_o, rtol=tol_o)
        torch.testing.assert_close(lse, r_lse, atol=tol_l, rtol=tol_l)
        grads, r_grads = split(grads), split(r_grads)
        for x, r in zip(grads, r_grads):
            torch.testing.assert_close(x, r, atol=tol_g, rtol=tol_g)
        errs = [_max_err(x, r) for x, r in zip(grads, r_grads)]
        e_out = _max_err(out, r_out)
        line = (f"{name:20s} max|dO| {e_out:.3e} max|dlse| "
                f"{_max_err(lse, r_lse):.3e} (tol {tol_o:g}/{tol_l:g})  "
                f"max|ddq| {errs[0]:.3e} max|ddk| {errs[1]:.3e} "
                f"max|ddv| {errs[2]:.3e} (tol {tol_g:g})")
        if tol_g == BF16_LONG_GRAD_TOL:
            beyond = sum(int((~torch.isclose(x.float(), r.float(), atol=2e-2,
                                             rtol=2e-2)).sum())
                         for x, r in zip(grads, r_grads))
            line += f"; {beyond} of {3 * grads[0].numel()} beyond 2e-2"
        print(line)
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


def _tiny_gpt(vocab: int, depth: int, seed: int, dim: int = DIM,
              heads: int = HEADS):
    """A TinyGPT of width ``dim`` and ``heads`` heads (the bench's by
    default) on the card, random weights from seed."""
    import torch

    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig

    cfg = TinyGPTConfig(vocab_size=vocab, dim=dim, n_heads=heads, depth=depth,
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
    # name: (B, V, depth, normalize, temperature, launches, width, heads);
    # the odd width 72 (H 4: Dh 18, F 288) and B 257 cross the kernel's
    # tiles; width 2304 with one head takes its rows in several K tiles and
    # its head's output in 256-column passes
    cases = {
        "b1_v97_d2": (1, 97, 2, False, 1.0, 4, DIM, HEADS),
        "b8_v4096_d4": (8, 4096, 4, False, 1.0, 1, DIM, HEADS),
        "b8_v4096_d4_norm": (8, 4096, 4, True, 1.0, 1, DIM, HEADS),
        "b13_v97_d4_norm_t0.7": (13, 97, 4, True, 0.7, 1, DIM, HEADS),
        "b13_v4096_d2_t1.5": (13, 4096, 2, False, 1.5, 1, DIM, HEADS),
        "b256_v4096_d4": (256, 4096, 4, False, 1.0, 1, DIM, HEADS),
        "b256_v97_d2_norm": (256, 97, 2, True, 1.0, 1, DIM, HEADS),
        "b8_v4097_d2_w72": (8, 4097, 2, False, 1.0, 1, 72, HEADS),
        "b257_v4096_d4": (257, 4096, 4, False, 1.0, 1, DIM, HEADS),
        "b3_v97_d1_w2304_h1": (3, 97, 1, False, 1.0, 1, 2304, 1),
    }
    worst_abs, stats = 0.0, {}
    for i, (name, (b, v, depth, norm, temp, n, dim, heads)) in enumerate(
            cases.items()):
        firsts, gap_first, gap_forced, off, positions = [], 0.0, 0.0, 0, 0
        for j in range(n):
            seed = 20 + 10 * i + j
            w = dk.pack_weights(_tiny_gpt(v, depth, seed=seed, dim=dim,
                                          heads=heads))
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
    from tinydiffusionmodels_torch.ops import single_block as sb

    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    dk.launches = rb.launches = sb.launches = sb.bwd_launches = 0


def _counts() -> dict:
    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import resblock as rb
    from tinydiffusionmodels_torch.ops import single_block as sb

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "guided_decode": dk.launches,
            "fused_resblock": rb.launches,
            "attention_single_block_fwd": sb.launches,
            "attention_single_block_bwd": sb.bwd_launches}


def _prepare_workdir(chars: int = TRAIN_CHARS):
    WORK.mkdir(parents=True, exist_ok=True)
    os.chdir(WORK)
    os.environ["TDM_PLATFORM"] = "cuda"
    os.environ["TDM_DATA_LIMIT"] = str(chars)
    os.environ["TDM_PROGRESS_EVERY"] = "4"      # chunks
    for var in ("AIP_MODEL_DIR", "TDM_METRICS_PATH"):
        os.environ.pop(var, None)


def main_path_train(card: str, dim: int = DIM, chars: int = TRAIN_CHARS,
                    extra: tuple = (), name: str = "train_ckpt",
                    depth: int = DEPTH):
    """``shakespeare.main(["--train", ...])`` at width ``dim`` (4 heads)
    and ``depth`` on ``chars`` characters of the built-in corpus, with
    ``extra`` arguments; the checkpoint is ``name``.pth. Asserts the
    launches, finite losses falling from the first to the last quarter of
    the steps (at most 50 each) and the checkpoints written."""
    import numpy as np
    import torch

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.data import (
        CharTokenizer,
        load_text_corpus,
        num_batches,
        tokenize_corpus,
    )

    phase(f"main path: shakespeare --train (dim {dim}, head width "
          f"{dim // HEADS}, depth {depth}, one epoch of {chars} characters)")
    _prepare_workdir(chars)
    ckpt = WORK / f"{name}.pth"
    best = WORK / f"{name}_best.pth"
    for old in (ckpt, best):
        old.unlink(missing_ok=True)
    # The work the run must do, counted independently of the trainer.
    corpus, source = load_text_corpus(WORK / "data")
    corpus = corpus[:chars]
    train_chunks, val_chunks = tokenize_corpus(corpus, CharTokenizer(corpus),
                                               SEQ, 0.1)
    steps = num_batches(len(train_chunks), BATCH)
    val_batches = num_batches(len(val_chunks), BATCH)
    print(f"corpus: {source}, {len(corpus)} chars -> {steps} training steps "
          f"and {val_batches} validation batches of {BATCH}")

    argv = ["--train", "--ckpt", str(ckpt), "--epochs", "1",
            "--batch_size", str(BATCH), "--seq_len", str(SEQ),
            "--embed_dim", str(dim), "--depth", str(depth),
            "--dropout", str(DROPOUT), "--model_id", "char",
            "--use_learned_embeddings", "--data_root", str(WORK / "data"),
            *extra]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    result = shakespeare.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = _counts()

    expect = {"flash_attention_fwd": (steps + val_batches) * depth,
              "flash_attention_bwd_dq": steps * depth,
              "flash_attention_bwd_dkv": steps * depth, "guided_decode": 0,
              "fused_resblock": 0, **_SINGLE_BLOCK_IDLE}
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
    window = min(50, steps // 4)
    first, last = losses[:window, 2].mean(), losses[-window:, 2].mean()
    if not last < first:
        raise AssertionError(f"mean loss of the last {window} steps {last} "
                             f"is not below that of the first {window} "
                             f"({first})")
    for path in (ckpt, best):
        if not path.is_file():
            raise AssertionError(f"{path.name} was not written")
    rate = result.steps / result.seconds
    print(f"training path: launches {counts}; losses finite; mean total "
          f"loss first {window} steps {first}, last {window} {last}; val total "
          f"{val[2]}; {ckpt.name} and {best.name} written; CLI call "
          f"{cli_s:.3f} s (includes corpus, model setup, validation and "
          f"checkpoints)")
    print(f"training: {rate} steps/s ({result.steps} steps over "
          f"{result.seconds} s of step loop), bs={BATCH} seq={SEQ} dim={dim} "
          f"depth={depth} dropout={DROPOUT} "
          f"{'bf16' if 'bf16' in extra else 'f32'}, on {card}")
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
              "guided_decode": 0, "fused_resblock": 0,
              **_SINGLE_BLOCK_IDLE}
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


def main_path_sample_ddim(card: str, ckpt: Path, dim: int,
                         depth: int = DEPTH):
    """``shakespeare.main(["--sample", "--sampler", "ddim", "--steps",
    NARROW_SAMPLE_STEPS, ...])`` from the checkpoint of width ``dim`` and
    ``depth``: asserts NARROW_SAMPLE_STEPS x depth forward launches and no
    other, finite embeddings of width ``dim`` and N sample files."""
    import torch

    from tinydiffusionmodels_torch import shakespeare

    phase(f"main path: shakespeare --sample --sampler ddim --steps "
          f"{NARROW_SAMPLE_STEPS} (dim {dim}, head width {dim // HEADS})")
    _prepare_workdir(NARROW_CHARS)
    for old in (WORK / "samples").glob("sample_*.txt"):
        old.unlink()
    argv = ["--sample", "--ckpt", str(ckpt), "--n", str(N), "--seq_len",
            str(SEQ), "--model_id", "char", "--sampler", "ddim", "--steps",
            str(NARROW_SAMPLE_STEPS), "--data_root", str(WORK / "data")]
    torch.cuda.synchronize()
    _reset_counts()
    z = shakespeare.main(argv)
    torch.cuda.synchronize()
    counts = _counts()
    expect = {"flash_attention_fwd": NARROW_SAMPLE_STEPS * depth,
              "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
              "guided_decode": 0, "fused_resblock": 0, **_SINGLE_BLOCK_IDLE}
    if counts != expect:
        raise AssertionError(f"launches {counts} on the dim-{dim} sampling "
                             f"path, expected {expect}")
    if tuple(z.shape) != (N, SEQ, dim) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"embeddings {tuple(z.shape)}, finite: "
                             f"{bool(torch.isfinite(z).all())}")
    written = sorted((WORK / "samples").glob("sample_*.txt"))
    if len(written) != N:
        raise AssertionError(f"{len(written)} sample files, expected {N}")
    print(f"dim-{dim} sampling path: launches {counts}, embeddings finite, "
          f"{len(written)} samples, on {card}")
    return counts


def main_path_guided(card: str, ckpt: Path):
    """``shakespeare.main(["--guided_sample", "--base_lm", "tinygpt", ...])``
    from the trained checkpoint: trains TinyGPT for LM_EPOCHS, writes
    lm_ckpt.pth and the guided samples; then a second call reuses
    lm_ckpt.pth, trains nothing, samples by DDIM in PROFILE_DDIM_STEPS
    steps and profiles itself (``--profile_dir``), whose per-op table must
    list the flash forward kernel. The guided decode is the CLI's
    ``GuidedDecoder``: one scan and its prime. Returns both calls'
    launches."""
    import torch

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.data import (
        CharTokenizer,
        load_text_corpus,
        num_batches,
        tokenize_corpus,
    )

    phase("main path: shakespeare --guided_sample --base_lm tinygpt from the "
          "trained checkpoint (TinyGPT trained, then reused with "
          "--profile_dir)")
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
    profile_dir = WORK / "profile"
    for old in profile_dir.glob("*"):
        old.unlink()
    # The second call: the reused TinyGPT, DDIM 10 (a short trace) under
    # --profile_dir.
    second = ["--sampler", "ddim", "--steps", str(PROFILE_DDIM_STEPS),
              "--profile_dir", str(profile_dir)]
    runs = []
    for i in range(2):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        tokens = shakespeare.main(argv + (second if i else []))
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = _counts()
        steps = lm_steps if i == 0 else 0
        sampler = STEPS if i == 0 else PROFILE_DDIM_STEPS
        # The decoder's scan (SEQ positions) and its prime (one position).
        expect = {"flash_attention_fwd": sampler * DEPTH
                  + (SEQ + 1) * LM_DEPTH + steps * LM_DEPTH,
                  "flash_attention_bwd_dq": steps * LM_DEPTH,
                  "flash_attention_bwd_dkv": steps * LM_DEPTH,
                  "guided_decode": 0, "fused_resblock": 0,
              **_SINGLE_BLOCK_IDLE}
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
              f"(includes the {sampler}-step sampler), on {card}")
        runs.append(counts)
    ops = (profile_dir / "ops.txt").read_text()
    trace_mb = (profile_dir / "trace.json").stat().st_size / 2**20
    listed = [line for line in ops.splitlines()
              if GRAPH_KERNEL_NAMES["flash_attention_fwd"] in line]
    if not listed:
        raise AssertionError("the --profile_dir table lists no flash "
                             "forward kernel")
    print(f"--profile_dir: trace.json {trace_mb:.1f} MiB; ops.txt lists the "
          f"flash forward kernel on {len(listed)} lines; its top rows:")
    print("\n".join(ops.splitlines()[:8]))
    return {k: sum(r[k] for r in runs) for k in runs[0]}, lm_ckpt


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
    """Path (B), the exact guided decode with the fused draft through a
    ``GuidedDecoder`` (its graphs replayed from its first call), on the TinyGPT the CLI phase trained and the diffusion
    logits of the trained text checkpoint (its rounding head on the --sample
    phase's embeddings), n 8, L 64. Asserts one decode-kernel launch and
    the Jacobi rounds' forwards (plus the primes': one decode launch, one
    forward), the output equal to its own fixpoint and to the eager decode
    (tokens and rounds), and >= 95 % agreement with the plain f32 scan. Then, outside the counted run, the kernel's decode of the
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
        GuidedDecoder,
        guided_generate_verified,
    )

    phase("main path: exact guided decode (fused kernel draft + Jacobi "
          "verify, GuidedDecoder's graphs) on the trained TinyGPT")
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
    decoder = GuidedDecoder(lm, diff.shape[0], SEQ, bos, alpha=ALPHA,
                            draft="fused")
    tokens, rounds = decoder(diff, return_rounds=True)
    torch.cuda.synchronize()
    counts = _counts()
    # The rounds' replays and the draft's, plus the primes: one decode
    # launch on one position and one verify forward.
    expect = {"flash_attention_fwd": (rounds + 1) * LM_DEPTH,
              "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
              "guided_decode": 2, "fused_resblock": 0,
              **_SINGLE_BLOCK_IDLE}
    if counts != expect:
        raise AssertionError(f"launches {counts} on the exact guided path, "
                             f"expected {expect}")
    if not torch.equal(tokens, _fixpoint(lm, tokens, diff, bos)):
        raise AssertionError("the verified decode is not its own fixpoint")
    eager, eager_rounds = guided_generate_verified(
        lm, diff, bos, alpha=ALPHA, draft="fused", return_rounds=True)
    if not torch.equal(tokens, eager) or rounds != eager_rounds:
        raise AssertionError("the replayed exact decode differs from the "
                             "eager one")
    plain = guided_generate_verified(lm, diff, bos, alpha=ALPHA, draft="plain")
    agree = float((tokens == plain).float().mean())
    if not agree >= 0.95:
        raise AssertionError(f"fused+verify agrees with the plain scan on "
                             f"{agree} of tokens (must be >= 0.95)")
    print(f"exact guided decode: launches {counts}; {rounds} Jacobi rounds "
          f"(verify forwards); output equals its fixpoint and the eager "
          f"decode's, bit for bit; agreement with the plain f32 scan "
          f"{agree}; on {card}")

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


def _decode_phases(w, diff, kw, depth: int) -> dict:
    """Mean µs of each phase of one decode launch (QKV, attention,
    projection, FC, MLP, head, and normalize's reduce), from CTA 0's
    %globaltimer stamps: "total" from one barrier's release to the next
    (the slowest CTA's work plus the barrier), and inside CTA 0's first
    unit "stage" (its left factor), "mma" (the products), "epilogue" (to
    the phase's end) and "wait" (arrival to release)."""
    import torch

    from tinydiffusionmodels_torch.ops import decode_kernel as dk

    norm = kw["normalize"]
    n = dk.barriers(depth, SEQ, norm)
    stamps = torch.zeros(4 * (n + 1), dtype=torch.int64, device="cuda")
    dk._launch(w, diff, 0, trace=stamps, **kw)
    st = stamps.view(n + 1, 4).double().cpu()
    names = (["stats"] if norm else []) + SEQ * (
        ["qkv", "attn", "proj", "fc", "mlp"] * depth + ["head"]
        + (["reduce"] if norm else []))
    out = {}
    for i, name in enumerate(names):
        t0, (s1, s2, s3), t1 = st[i, 0], st[i, 1:].tolist(), st[i + 1, 0]
        parts = {"total": t1 - t0}
        if s1 > 0:
            parts.update(stage=s1 - t0, mma=s2 - s1, epilogue=s3 - s2,
                         wait=t1 - s3)
        acc = out.setdefault(name, {})
        for k, v in parts.items():
            acc.setdefault(k, []).append(float(v) / 1e3)
    res = {name: {k: round(sum(v) / len(v), 3) for k, v in parts.items()}
           for name, parts in out.items()}
    # CTA 0's SM clock over the launch: cycles over ns
    res["sm_ghz"] = round(float(st[n, 1]) / float(st[n, 2] - st[0, 0]), 3)
    return res


def decode_timing(card: str) -> dict:
    """The decode kernel at the bench shape (TinyGPT V 4096, D 256, depth
    4, max_len 65, L 64, alpha 0.3, random weights and N(0, 1) logits), at
    batch 8 and 256: CUDA-event device time of one launch beside the plain
    version (plain, kernel, kernel, plain), the bound, the grid barrier's
    cost at the launch's grid (phase 27 times the exact decodes)."""
    import torch

    from tinydiffusionmodels_torch import perf

    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.ops import reference

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

        p_ms = [perf.device_ms(plain, iters=2, warmup=1)]
        k_ms = [perf.device_ms(kernel, iters=10, warmup=2),
                perf.device_ms(kernel, iters=10, warmup=2)]
        p_ms.append(perf.device_ms(plain, iters=2, warmup=1))
        grid = dk._launch(w, diff, 0, **kw)[1]
        units = {ph: pp.units for ph, pp in dk.launch_plan(
            w, b, torch.cuda.get_device_properties(0)
            .multi_processor_count).phases.items()}
        syncs = dk.barriers(depth, SEQ)
        # The kernel's barrier alone, at its grid and count: the chain floor
        sync_ms = perf.device_ms(lambda: dk._grid_sync_probe(syncs, grid),
                                 iters=10, warmup=2)
        phases_us = _decode_phases(w, diff, kw, depth)
        nbytes, mm_flops, attn_flops = dk.work(w, b, SEQ)
        bound_ms, bound_by = perf.bound_ms(
            nbytes, [(mm_flops, "bf16"), (attn_flops, "f32")])
        # The same FLOPs at the FP32-FMA rate (the roof of a decode kernel
        # without tensor cores), beside the card's bound; not the bound.
        fma_roof_ms = ((mm_flops + attn_flops)
                       / perf.device_peak_flops(dtype="f32") * 1e3)
        k_mean = sum(k_ms) / 2
        out[b] = dict(ms=k_mean, plain_ms=sum(p_ms) / 2, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None,
                      fp32_fma_roof_ms=fma_roof_ms, grid=grid,
                      units=units, phase_us=phases_us, barriers=syncs,
                      barrier_ms=sync_ms,
                      barrier_share=sync_ms / k_mean)
        print(f"bs {b}: kernel {k_ms} ms, plain {p_ms} ms; bound {bound_ms} "
              f"ms by {bound_by} ({nbytes} B, {mm_flops} bf16 matmul FLOP, "
              f"{attn_flops} f32 attention FLOP), {k_mean / bound_ms:.0f}x; "
              f"FP32-FMA roof {fma_roof_ms} ms; grid {grid} "
              f"CTAs, units a phase {units}, mean us a phase (barrier "
              f"included) {phases_us}; chain floor: {syncs} barriers "
              f"alone {sync_ms} ms = {sync_ms / k_mean:.3f} of the kernel "
              f"({sync_ms / syncs * 1e3:.3f} us a barrier); no single "
              f"PyTorch call computes this (library —); on {card}")
    return out


def _wall_ms(fn, calls: int) -> float:
    """Host-clock ms a call of ``fn`` over ``calls`` calls, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def guided_decoder_replay(card: str) -> dict:
    """Phase 27: ``sample.guided.GuidedDecoder`` at the bench's guided shape
    (TinyGPT V 4096, D 256, 4 heads, depth 4, max_len 65, L 64, alpha 0.3,
    random weights, N(0, 1) logits) for DECODER_CASES. A new decoder's first
    call primes, captures and replays; it and a later call, each on other
    logits, must equal ``guided_generate_verified`` (the eager loops) bit
    for bit, tokens and Jacobi rounds. Launches: a call replays L x depth
    flash forwards for a scan, depth a round, one decode launch for the
    fused draft; the first call adds the primes' (depth for a scan
    position, depth for a verify forward, one decode launch on one
    position). Prints eager and replayed ms a call, device µs and busy
    share from torch.profiler, and for the verified cases the ms of a
    round (replay and flag read), its device µs and the flag read alone.
    Returns {case: row} and the launches of the counted calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.sample.guided import (
        GuidedDecoder,
        guided_generate_verified,
    )

    phase("CUDA graphs: the guided decoder, replayed against the eager "
          "decode (V 4096, D 256, depth 4, L 64, alpha 0.3)")
    vocab, depth = 4096, 4
    model = _tiny_gpt(vocab, depth, seed=0)
    w = dk.pack_weights(model)
    rows, total = {}, {}
    for draft, b in DECODER_CASES:
        what = f"{draft} bs {b}"
        g = torch.Generator(device="cuda").manual_seed(1)
        diffs = [torch.randn(b, SEQ, vocab, generator=g, device="cuda")
                 for _ in range(2)]

        def eager(diff, draft=draft):
            return guided_generate_verified(model, diff, 0, alpha=ALPHA,
                                            draft=draft, weights=w,
                                            return_rounds=True)

        want = [eager(d) for d in diffs]
        torch.cuda.synchronize()
        _reset_counts()
        decoder = GuidedDecoder(model, b, SEQ, 0, alpha=ALPHA, draft=draft,
                                weights=w)
        got = [decoder(d, return_rounds=True) for d in diffs]
        torch.cuda.synchronize()
        first = _counts()
        _reset_counts()
        got.append(decoder(diffs[0], return_rounds=True))
        torch.cuda.synchronize()
        later = _counts()
        for i, ((gt, gr), (wt, wr)) in enumerate(zip(got, want + want[:1])):
            if not torch.equal(gt, wt) or gr != wr:
                raise AssertionError(
                    f"{what}: replayed call {i + 1} differs from the eager "
                    f"decode ({int((gt != wt).sum())} tokens, rounds {gr} "
                    f"against {wr})")

        def launches(rounds, draft=draft):
            scan = SEQ * depth if draft != "fused" else 0
            return {"flash_attention_fwd": scan + rounds * depth,
                    "guided_decode": int(draft == "fused")}

        prime = {"flash_attention_fwd":
                 depth * (int(draft != "fused") + int(draft != "plain")),
                 "guided_decode": int(draft == "fused")}
        calls = [launches(r) for _, r in want]
        want_first = {k: calls[0][k] + calls[1][k] + prime[k] for k in prime}
        for counts, expect, which in ((first, want_first, "first two calls"),
                                      (later, calls[0], "a later call")):
            seen = {k: counts[k] for k in expect}
            rest = {k: v for k, v in counts.items() if k not in expect and v}
            if seen != expect or rest:
                raise AssertionError(f"{what}, {which}: launches {counts}, "
                                     f"expected {expect}")
        for k, v in first.items():
            total[k] = total.get(k, 0) + v + later[k]

        rounds = want[0][1]
        replay_ms = [_wall_ms(lambda: decoder(diffs[0]), DECODER_RUNS)]
        eager_ms = _wall_ms(lambda: eager(diffs[0]), DECODER_RUNS)
        replay_ms.append(_wall_ms(lambda: decoder(diffs[0]), DECODER_RUNS))
        row = {"rounds": rounds, "eager_ms": eager_ms,
               "replayed_ms": sum(replay_ms) / 2}
        for mode, fn in (("eager", lambda: eager(diffs[0])),
                         ("replayed", lambda: decoder(diffs[0]))):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            if mode == "replayed":   # the kernels of a call, by device time
                us = _profile_table(prof, 1, row["replayed_ms"] / 1e3, card,
                                    f"guided decoder {what}, a replayed "
                                    "call")["device_us"]
            else:
                us = _device_us(prof)
            row[f"{mode}_device_us"] = us
            row[f"{mode}_busy"] = us / (row[f"{mode}_ms"] * 1e3)
        if draft != "plain":
            row["round_ms"] = _wall_ms(decoder.verify_round, 20)
            row["flag_read_us"] = 1e3 * _wall_ms(
                lambda: bool(decoder.changed), 100)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    decoder.verify_round()
                torch.cuda.synchronize()
            row["round_device_us"] = _device_us(prof) / 5
        rows[what] = row
        print(f"{what}: replayed calls equal the eager decode bit for bit "
              f"(tokens, {rounds} rounds); launches first two calls {first}, "
              f"a later call {later}; {row}; on {card}")
        del decoder
    print(f"\nguided decoder, eager and replayed, on {card}:")
    print("case | rounds | eager ms | replayed ms | device us (eager / "
          "replayed) | busy (eager / replayed) | round ms | round device us "
          "| flag read us")
    for what, r in rows.items():
        print(f"{what} | {r['rounds']} | {r['eager_ms']:.3f} | "
              f"{r['replayed_ms']:.3f} | {r['eager_device_us']:.1f} / "
              f"{r['replayed_device_us']:.1f} | {r['eager_busy']:.3f} / "
              f"{r['replayed_busy']:.3f} | {r.get('round_ms', '—')} | "
              f"{r.get('round_device_us', '—')} | "
              f"{r.get('flag_read_us', '—')}")
    return rows, {**{k: 0 for k in _counts()}, **total}


def jacobi_rounds_on_card(card: str, lm_ckpt: Path) -> list:
    """Phase 28: ``python -m tinydiffusionmodels_torch.jacobi_rounds
    --lm_ckpt`` on the guided CLI phase's trained TinyGPT (no training
    again): the rounds of the fused and bf16-scan drafts at bs 8 and 256,
    random and trained weights, each converged or not within L + 1."""
    from tinydiffusionmodels_torch import jacobi_rounds

    phase("the Jacobi-rounds tool on the guided CLI's trained TinyGPT")
    records = jacobi_rounds.main(["--lm_ckpt", str(lm_ckpt)])
    if len(records) != 8 or not all(r["converged"] for r in records):
        raise AssertionError(f"jacobi_rounds: {records}")
    print(f"jacobi_rounds on {card}: {records}")
    return records


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


def _profiled_device_ms(fn, calls: int = 20) -> float:
    """Device time in ms of one call of ``fn``, read from torch.profiler:
    the self device time of every CUDA kernel launched in ``calls`` calls
    (host annotations dropped), over ``calls``. For PyTorch's own fused
    attention, whose CUDA-event time is bound by its host enqueue at small
    shapes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    if us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return us / calls / 1e3


def kernel_timing(card: str) -> dict:
    """The three flash kernels at TIMING_SHAPES on the model's operands
    (strided views of one QKV projection, f32, dropout 0.1): CUDA-event
    device times in turns within this call (plain, kernel, kernel, plain),
    beside the device time of PyTorch's fused attention
    (``scaled_dot_product_attention`` at dropout 0, its kernels' self device
    time from torch.profiler: the forward for the forward kernel, the
    backward for dq and dk/dv, which together compute what that backward
    does) and the bound (3xTF32 products, or bytes). Returns per kernel the
    training shape's ms, plain_ms, library_ms, bound_ms, bound_by and
    fp32_fma_roof_ms, and each shape's under "shapes"."""
    import torch
    import torch.nn.functional as F

    from tinydiffusionmodels_torch import perf
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    phase("timing: the flash kernels at the training shape, the kernel "
          "bench's L 512 and 2048 (H 4, Dh 64) and the training shape at "
          "Dh 512 (f32, blhd views of one QKV projection)")
    h = HEADS
    seed = _seed(12345)
    out = {}
    for b, l, d in TIMING_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(11)
        qkv = torch.randn(b, l, 3, h, d, generator=g, device="cuda")
        q, k, v = (qkv[:, :, i].requires_grad_() for i in range(3))
        g_out = torch.randn(b, l, h, d, generator=g, device="cuda")
        kw = dict(layout="blhd", dropout_rate=DROPOUT, dropout_seed=seed)
        params = dict(kw, causal=False, q_offset=0, k_offset=0)
        with torch.no_grad():
            o, lse = fa.forward(q, k, v, **params)
            delta = fa.backward_delta(o, g_out, None, "blhd")
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        plain_out = reference.attention(q, k, v, **kw)[0]
        # PyTorch's fused attention on the same (bhld-strided) views, at
        # dropout 0 (its dropout draws another stream).
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        g_t = g_out.transpose(1, 2)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)

        def plain_fwd():
            with torch.no_grad():
                reference.attention(q, k, v, **kw)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt)

        def sdpa_bwd():
            torch.autograd.grad(sdpa_out, (qt, kt, vt), g_t,
                                retain_graph=True)

        runs = {  # name: (kernel, plain version, library, its label)
            "flash_attention_fwd": (
                lambda: fa.forward(q, k, v, **params), plain_fwd, sdpa_fwd,
                "SDPA forward"),
            "flash_attention_bwd_dq": (
                lambda: fa.backward_dq(q, k, v, g_out, lse, delta, dq,
                                       **params),
                lambda: torch.autograd.grad(plain_out, q, g_out,
                                            retain_graph=True),
                sdpa_bwd, "SDPA backward"),
            "flash_attention_bwd_dkv": (
                lambda: fa.backward_dkv(q, k, v, g_out, lse, delta, dk, dv,
                                        **params),
                lambda: torch.autograd.grad(plain_out, (k, v), g_out,
                                            retain_graph=True),
                sdpa_bwd, "SDPA backward"),
        }
        # (bytes read once and written once, f32 product FLOPs)
        work = {name: fa.work(kind, q, k, v, **params)
                for name, kind in (("flash_attention_fwd", "fwd"),
                                   ("flash_attention_bwd_dq", "dq"),
                                   ("flash_attention_bwd_dkv", "dkv"))}
        iters = 200 if l <= SEQ else 20
        at = f"B {b}, H {h}, L {l}, Dh {d}, f32, dropout {DROPOUT}"
        print(f"-- {at}")
        out[(b, l, d)] = _time_against_plain(
            runs, work, card, "dropout 0, profiler self device time", at=at,
            iters=iters, library_timer=_profiled_device_ms)
        del plain_out, sdpa_out
    timings = {name: dict(row, shapes={
        f"B{b} L{l} Dh{d}": out[(b, l, d)][name]
        for b, l, d in TIMING_SHAPES[1:]})
        for name, row in out[TIMING_SHAPES[0]].items()}
    return timings


def _time_against_plain(runs: dict, work: dict, card: str, library_note: str,
                        iters: int = 200, library_timer=None,
                        **extra) -> dict:
    """For each name: (kernel, plain version, library yardstick, its label)
    of ``runs``, device times in turns within this call (plain, kernel,
    kernel, plain: CUDA events over ``iters`` calls), then the library's
    (``library_timer``, CUDA events by default), and the bound of
    ``work[name]`` = (bytes read once and written once, f32 product FLOPs):
    the FLOPs as 3xTF32 on the tensor cores, the least time for an f32
    product on the card. Returns per name ms, plain_ms, library_ms, bound_ms,
    bound_by, fp32_fma_roof_ms (the FLOPs at the FP32-FMA rate) and
    ``extra``."""
    from tinydiffusionmodels_torch import perf

    library_timer = library_timer or perf.device_ms
    timings = {}
    for name, (kernel, plain, library, lib_name) in runs.items():
        p_ms = [perf.device_ms(plain, iters)]
        k_ms = [perf.device_ms(kernel, iters), perf.device_ms(kernel, iters)]
        p_ms.append(perf.device_ms(plain, iters))
        lib_ms = library_timer(library)
        nbytes, flops = work[name]
        bound_ms, bound_by = perf.bound_ms(nbytes,
                                           perf.f32_tensor_core_ops(flops))
        roof_ms = perf.bound_ms(0, [(flops, "f32")])[0]
        timings[name] = dict(ms=sum(k_ms) / 2, plain_ms=sum(p_ms) / 2,
                             library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, fp32_fma_roof_ms=roof_ms,
                             **extra)
        print(f"{name}: kernel {k_ms} ms, plain {p_ms} ms, library "
              f"({lib_name}, {library_note}) {lib_ms} ms; bound {bound_ms} ms "
              f"by {bound_by} ({nbytes} B, {flops} FLOP as 3xTF32), "
              f"{timings[name]['ms'] / bound_ms:.1f}x; FP32-FMA roof "
              f"{roof_ms} ms; on {card}")
    return timings


def _kernel_events(prof) -> list:
    """The kernels of a torch.profiler window, by device time. Device-side
    spans of host annotations (Optimizer.step#...) are not kernels: they
    cover the host's launch time and would double count."""
    from torch.autograd import DeviceType

    return sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.self_device_time_total, reverse=True,
    )


def _device_us(prof) -> float:
    """Device µs of the kernels a torch.profiler window recorded."""
    return sum(e.self_device_time_total for e in _kernel_events(prof))


def _profile_table(prof, steps: int, wall_s_per_step: float, card: str,
                   what: str) -> dict:
    kernels = _kernel_events(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    per_step_us = device_us / steps
    row = {"wall_us": wall_s_per_step * 1e6, "device_us": per_step_us,
           "busy": per_step_us / (wall_s_per_step * 1e6),
           "kernels": sum(e.count for e in kernels) / steps}
    print(f"{what} on {card}: unprofiled wall {row['wall_us']} us per "
          f"step; device {per_step_us} us per step; {row['kernels']} kernels "
          f"per step; device busy {row['busy']} of the unprofiled step")
    print("device us/step  share  calls/step  kernel")
    for e in kernels[:14]:
        print(f"{e.self_device_time_total / steps:14.3f}  "
              f"{e.self_device_time_total / device_us:5.3f}  "
              f"{e.count / steps:10.2f}  {e.key[:90]}")
    return row


def _profile_sampler_modes(what: str, model, shape, card: str) -> dict:
    """The ancestral loop of ``model`` at ``shape``, eager and replayed:
    the wall time per step of a 1000-step loop (after a warm loop), and
    torch.profiler over a PROFILE_STEPS-step loop (a PROFILE_STEPS-step
    schedule: the per-step work is the same). {mode: row}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.sample.ancestral import sample_loop

    phase(f"profile: {what}, eager and replayed, under torch.profiler")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    for mode in ("eager", "replayed"):
        def loop(steps):
            with torch.inference_mode():
                sample_loop(model, make_schedule(steps, device="cuda"), shape,
                            generator=gen, eager=mode == "eager")
            torch.cuda.synchronize()

        loop(PROFILE_STEPS)
        t0 = time.perf_counter()
        loop(STEPS)
        wall = (time.perf_counter() - t0) / STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop(PROFILE_STEPS)
        rows[mode] = _profile_table(prof, PROFILE_STEPS, wall, card,
                                    f"{what}, {mode}")
    return rows


def _profile_runner_modes(what: str, make, card: str) -> dict:
    """A trainer's chunk runner from ``make(eager=...)``, eager and
    replayed: the wall time per step over GRAPH_WALL_STEPS steps (after 5,
    which capture), and torch.profiler over PROFILE_TRAIN_STEPS steps.
    {mode: row}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phase(f"profile: {PROFILE_TRAIN_STEPS} steps of {what}, eager and "
          "replayed, under torch.profiler")
    rows = {}
    for mode in ("eager", "replayed"):
        runner, _ = make(eager=mode == "eager",
                         steps=5 + GRAPH_WALL_STEPS + PROFILE_TRAIN_STEPS)
        runner.run(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(GRAPH_WALL_STEPS)
        wall = (time.perf_counter() - t0) / GRAPH_WALL_STEPS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner.run(PROFILE_TRAIN_STEPS)
            torch.cuda.synchronize()
        rows[mode] = _profile_table(prof, PROFILE_TRAIN_STEPS, wall, card,
                                    f"{what}, {mode}")
    return rows


def profile_sampler(model, card: str) -> dict:
    """The text sampler (n N, the trained model), eager and replayed."""
    return _profile_sampler_modes(f"text sampler n {N}", model,
                                  (N, SEQ, DIM), card)


def profile_training(card: str, batch: int = BATCH,
                     compute_dtype: str | None = None) -> dict:
    """The text trainer's step at ``batch`` in ``compute_dtype`` ('bf16'
    or None; the bench's shape: vocab 4096), eager and replayed."""
    return _profile_runner_modes(
        f"text training (batch {batch}, {compute_dtype or 'f32'})",
        lambda **kw: _text_runner(batch=batch, dtype=compute_dtype, **kw),
        card)


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


def resblock_kernel_vs_plain():
    """The kernel against its plain version at every block shape, the
    RESBLOCK_BATCHES and both tile edges, in f32 (1e-4) and bf16 (2e-2);
    one backward per block through the Function against autograd of the
    plain version; one UNet forward, card against CPU. Returns the largest
    f32 and bf16 forward errors."""
    import copy

    import torch

    from tinydiffusionmodels_torch.models import SimpleUNet
    from tinydiffusionmodels_torch.models.unet import BLOCKS
    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.ops import resblock as rb

    phase(f"fused resblock kernel vs plain (TF32 off; f32 1e-4, bf16 2e-2; "
          f"tiles {rb.TILES}, the wrapper's rule picks "
          f"{rb.TILES[1]} from {rb.WIDE_TILE_CTAS} CTAs)")
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, name in enumerate(BLOCKS):
        for b in RESBLOCK_BATCHES:
            args = _resblock_args(name, b, seed=200 + 10 * i + b)
            x = args[0]
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                typed = [None if t is None else t.to(dtype) for t in args]
                ref = reference.fused_resblock(*typed)
                line = []
                for tile in rb.TILES:
                    out = rb._launch(*typed, tile=tile)
                    torch.cuda.synchronize()
                    if out.dtype != dtype:
                        raise AssertionError(f"{out.dtype} output of {dtype}")
                    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
                    err = _max_err(out, ref)
                    # The border ring alone: where conv2 must see 0, not
                    # time_bias.
                    ring = torch.ones(x.shape[1:3], dtype=torch.bool,
                                      device="cuda")
                    ring[1:-1, 1:-1] = False
                    worst[dtype] = max(worst[dtype], err)
                    line.append(f"tile {tile}: max|d| {err:.3e}, border ring "
                                f"{_max_err(out[:, ring], ref[:, ring]):.3e}")
                print(f"{name} (Cin {x.shape[-1]}, Cout {args[1].shape[0]}, "
                      f"H {x.shape[1]}) {str(dtype)[6:]} batch {b:3d}: "
                      f"{'; '.join(line)} (tol {tol:g})")
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
    return worst[torch.float32], worst[torch.bfloat16]


def _prepare_mnist_workdir() -> Path:
    work = WORK / "mnist"
    work.mkdir(parents=True, exist_ok=True)
    os.chdir(work)
    os.environ["TDM_PLATFORM"] = "cuda"
    os.environ["TDM_PROGRESS_EVERY"] = "4"      # chunks
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
              "fused_resblock": steps * 4 + STEPS * 4,
              **_SINGLE_BLOCK_IDLE}
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
                  "fused_resblock": expect_launches,
                  **_SINGLE_BLOCK_IDLE}
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
    kernel, kernel, plain), f32 and bf16, at the wrapper's tile; beside
    them the plain version's cuDNN kernels' self device time from
    torch.profiler (no single PyTorch call computes the block) and the
    bound: bytes, or the products on the tensor cores (f32 as 3xTF32, bf16
    at its peak), the larger; the FP32-FMA roof printed beside. Returns,
    per batch, the f32 sums, the bf16 sums and the per-block numbers."""
    import torch

    from tinydiffusionmodels_torch import perf

    from tinydiffusionmodels_torch.models.unet import BLOCKS
    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.ops import resblock as rb

    phase("timing: fused resblock per UNet block at n 25 and 128 (f32 and "
          "bf16, TF32 off)")
    out = {}
    for b in (MNIST_N, MNIST_BATCH):
        blocks = {}
        for i, name in enumerate(BLOCKS):
            args = _resblock_args(name, b, seed=400 + i)
            row = {}
            for dtype in (torch.float32, torch.bfloat16):
                typed = [None if t is None else t.to(dtype) for t in args]

                def plain():
                    with torch.no_grad():
                        reference.fused_resblock(*typed)

                def kernel():
                    rb._launch(*typed)

                p_ms = [perf.device_ms(plain)]
                k_ms = [perf.device_ms(kernel), perf.device_ms(kernel)]
                p_ms.append(perf.device_ms(plain))
                cudnn_ms = _profiled_device_ms(plain)
                nbytes, flops = rb.work(*typed)
                f32 = dtype == torch.float32
                ops = (perf.f32_tensor_core_ops(flops) if f32
                       else [(flops, "bf16")])
                bound_ms, bound_by = perf.bound_ms(nbytes, ops)
                roof_ms = perf.bound_ms(0, [(flops, "f32")])[0]
                ms = sum(k_ms) / 2
                key = "f32" if f32 else "bf16"
                row[key] = dict(ms=ms, plain_ms=sum(p_ms) / 2,
                                library_ms=cudnn_ms, bound_ms=bound_ms,
                                bound_by=bound_by, fp32_fma_roof_ms=roof_ms,
                                bytes=nbytes, flops=flops)
                x = typed[0]
                tile = rb.tile_for(*x.shape[:3])
                print(f"{name} {key} n {b} (tile {tile}): kernel {k_ms} ms, "
                      f"plain {p_ms} ms, its cuDNN kernels {cudnn_ms} ms "
                      f"(profiler); bound {bound_ms} ms by {bound_by} "
                      f"({nbytes} B, {flops} FLOP as "
                      f"{'3xTF32' if f32 else 'bf16'}), "
                      f"{ms / bound_ms:.1f}x; FP32-FMA roof {roof_ms} ms; "
                      f"{flops / ms / 1e9:.2f} TFLOP/s; on {card}")
            blocks[name] = row
        sums = {}
        for key in ("f32", "bf16"):
            t = {k: sum(v[key][k] for v in blocks.values())
                 for k in ("ms", "plain_ms", "library_ms", "fp32_fma_roof_ms",
                           "bytes", "flops")}
            # The bound of the four blocks as one piece of work.
            t["bound_ms"], t["bound_by"] = perf.bound_ms(
                t["bytes"], perf.f32_tensor_core_ops(t["flops"])
                if key == "f32" else [(t["flops"], "bf16")])
            sums[key] = t
            print(f"UNet forward's four blocks at n {b}, {key}: kernel "
                  f"{t['ms']} ms, plain {t['plain_ms']} ms, cuDNN kernels "
                  f"{t['library_ms']} ms, bound {t['bound_ms']} ms by "
                  f"{t['bound_by']} ({t['ms'] / t['bound_ms']:.1f}x), "
                  f"FP32-FMA roof {t['fp32_fma_roof_ms']} ms; on {card}")
        out[b] = dict(sums["f32"], bf16=sums["bf16"], blocks=blocks)
    return out


def profile_mnist_sampler(model, card: str) -> dict:
    """The MNIST sampler (n MNIST_N, the trained UNet), eager and
    replayed."""
    return _profile_sampler_modes(f"MNIST sampler n {MNIST_N}", model,
                                  (MNIST_N, 28, 28, 1), card)


def profile_mnist_training(card: str, batch: int = MNIST_BATCH,
                           compute_dtype: str | None = None) -> dict:
    """The MNIST trainer's step at ``batch`` in ``compute_dtype`` ('bf16'
    or None), eager and replayed."""
    return _profile_runner_modes(
        f"MNIST training (batch {batch}, {compute_dtype or 'f32'})",
        lambda **kw: _mnist_runner(batch=batch, dtype=compute_dtype, **kw),
        card)


# name: ((B, H, L, Dh), whether the backward is checked) of the single-block
# check: the shapes of the JAX package's tests (tests/test_ops.py), the text
# sampler's, a ragged L, Dh 128 at L 96 and at the limit L 128, and head
# widths 8, 24, 96 and 256 (one in each padded instance below 256, and the
# widest).
SINGLE_BLOCK_CASES = {
    "L64": ((2, 4, 64, 64), True), "L128": ((2, 4, 128, 64), True),
    "L16_dh32": ((2, 4, 16, 32), True), "sampler": ((8, 4, 64, 64), True),
    "ragged_L100": ((3, 2, 100, 64), True),
    "dh128_L96": ((2, 2, 96, 128), True),
    "dh128_L128": ((1, 2, 128, 128), True),
    "dh8": ((2, 4, 40, 8), True), "dh24": ((2, 2, 64, 24), True),
    "dh96": ((2, 2, 64, 96), True), "dh256": ((2, 2, 48, 256), True),
    "dh256_L128": ((1, 2, 128, 256), True),
}


def _cos_cotangent(x):
    """A cotangent that is not all ones: cos(arange) in x's shape and
    dtype (tests/test_ops.py uses the same)."""
    import torch

    n = torch.arange(x.numel(), device=x.device, dtype=torch.float32)
    return torch.cos(n).reshape(x.shape).to(x.dtype)


def _closer(got, want, other, what: str) -> tuple[int, int]:
    """(elements where ``got`` differs from ``want``, from ``other``);
    fails unless the first is the smaller."""
    off_want = int((got != want).sum())
    off_other = int((got != other).sum())
    if not off_want < off_other:
        raise AssertionError(f"{what}: {off_want} elements off its plain "
                             f"version, {off_other} off plain attention")
    return off_want, off_other


def single_block_kernel_vs_plain():
    """Both single-block kernels against their plain versions, f32 and bf16:
    the forward (f32 atol = rtol = 1e-4, bf16 2e-2) and, through the
    wrapper's Function, dq, dk and dv for a cos(arange) cotangent (f32
    2e-4, for the reason of phase 4; bf16 2e-2). In f32 also against
    ``reference.attention`` and its autograd, a check of the formulas; in
    bf16 the kernels must equal their plain versions in more elements than
    they equal ``reference.attention`` and its autograd, which round p and
    ds at no point: a check of the rounding points.
    Two backward calls at the sampler's shape must give the same bits.
    Shapes outside the domain must raise before a launch. Returns the
    largest f32 forward and gradient errors."""
    import torch

    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.ops import single_block as sb

    phase("single-block attention kernels vs plain (TF32 off)")
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"fwd": 0.0, "bwd": 0.0}
    for i, (name, ((b, h, length, dh), grad)) in enumerate(
            SINGLE_BLOCK_CASES.items()):
        for dtype in (f32, bf16):
            q, k, v = (x.requires_grad_(grad) for x in _qkv(
                b, h, length, length, dh, dh, dtype, "bhld", 500 + i))
            out = sb.single_block_attention(q, k, v)
            with torch.no_grad():
                ref = reference.single_block_attention(q, k, v)
            bf = dtype == bf16
            tol_o, tol_g = (2e-2, 2e-2) if bf else (1e-4, 2e-4)
            torch.testing.assert_close(out, ref, atol=tol_o, rtol=tol_o)
            errs = [_max_err(out, ref)]
            line = (f"{name:12s} {str(dtype)[6:]:8s} max|dO| {errs[0]:.3e} "
                    f"(tol {tol_o:g})")
            grads = ref_grads = auto = ()
            if grad:
                g = _cos_cotangent(out)
                grads = torch.autograd.grad(out, (q, k, v), g)
                with torch.no_grad():
                    ref_grads = reference.single_block_attention_bwd(q, k, v,
                                                                     g)
                for got, want in zip(grads, ref_grads):
                    assert got.dtype == dtype
                    torch.testing.assert_close(got, want, atol=tol_g,
                                               rtol=tol_g)
                errs += [_max_err(x, r) for x, r in zip(grads, ref_grads)]
                line += (f"  max|ddq| {errs[1]:.3e} max|ddk| {errs[2]:.3e} "
                         f"max|ddv| {errs[3]:.3e} (tol {tol_g:g})")
            att = reference.attention(q, k, v)[0]
            if grad:
                auto = torch.autograd.grad(att, (q, k, v), g)
            if not bf:
                # The formulas: plain attention and its autograd.
                torch.testing.assert_close(out, att, atol=1e-4, rtol=1e-4)
                for got, want in zip(grads, auto):
                    torch.testing.assert_close(got, want, atol=2e-4,
                                               rtol=2e-4)
                if grad:
                    line += "; f32 matches autograd of attention (2e-4)"
                worst["fwd"] = max(worst["fwd"], errs[0])
                worst["bwd"] = max(worst["bwd"], *errs[1:], 0.0)
            else:
                # The rounding points: the kernels round p (and ds) to bf16
                # where the TPU kernels do, so they equal their plain
                # versions in more elements than they equal plain attention
                # (and its autograd), which does not round.
                tallies = [_closer(got, want, other, f"{name} bf16 {what}")
                           for what, got, want, other in zip(
                               ("O", "dq", "dk", "dv"), (out, *grads),
                               (ref, *ref_grads), (att, *auto))]
                line += "; elements off plain / off attention " + ", ".join(
                    f"{mine}/{other}" for mine, other in tallies)
            torch.cuda.synchronize()
            print(line)
    q, k, v = _qkv(N, HEADS, SEQ, SEQ, DIM // HEADS, DIM // HEADS,
                   f32, "bhld", 599)
    g = _cos_cotangent(q)
    first, second = sb.backward(q, k, v, g), sb.backward(q, k, v, g)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("two single-block backward calls differ")
    print("sampler shape: two backward calls give identical bits")
    refusals = {"L129": ((1, 1, 129, 64), False),
                "dh257": ((1, 1, 64, 257), False),
                "L129_dh128_grad": ((1, 1, 129, 128), True)}
    for name, (shape, grad) in refusals.items():
        x = torch.zeros(shape, device="cuda", requires_grad=grad)
        before = (sb.launches, sb.bwd_launches)
        try:
            sb.single_block_attention(x, x, x)
        except ValueError as err:
            print(f"{name}: refused before launch ({err})")
        else:
            raise AssertionError(f"{name}: a shape outside the domain ran")
        if (sb.launches, sb.bwd_launches) != before:
            raise AssertionError(f"{name}: a refused shape launched")
    return worst


def main_path_kernel_bench(card: str):
    """``kernel_bench.main(["all"])`` with the counters zeroed just before:
    every kernel's launches must equal what the tool's loops imply, and
    every line's time must be finite. Its outputs are not compared here:
    phases 3, 4 and 18 hold each kernel against its plain version at every
    shape the bench gives it."""
    import math

    import torch

    from tinydiffusionmodels_torch import kernel_bench as kb

    phase("main path: python -m tinydiffusionmodels_torch.kernel_bench all")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rows = kb.main(["all"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    calls = kb.WARMUP + kb.ITERS
    n_att, n_bf16 = len(kb.ATTENTION_SHAPES), len(kb.BF16_SHAPES)
    short = sum(s[2] <= kb.SINGLE_BLOCK_MAX_L for s in kb.ATTENTION_SHAPES)
    expect = {
        # attention and grad modes at every shape; bf16 forward and grad.
        "flash_attention_fwd": (2 * n_att + 2 * n_bf16) * calls,
        "flash_attention_bwd_dq": (n_att + n_bf16) * calls,
        "flash_attention_bwd_dkv": (n_att + n_bf16) * calls,
        "guided_decode": 0,
        "fused_resblock": len(kb.RESBLOCK_SHAPES) * calls,
        "attention_single_block_fwd": 2 * short * calls,
        "attention_single_block_bwd": short * calls,
    }
    if counts != expect:
        raise AssertionError(f"launches {counts} on the kernel bench, "
                             f"expected {expect}")
    lines = (2 * len(kb.RESBLOCK_SHAPES) + 2 * (2 * n_att + short)
             + 4 * n_bf16)
    if len(rows) != lines or not all(
            math.isfinite(r.us) and r.us > 0 for r in rows):
        raise AssertionError(f"{len(rows)} kernel-bench lines (expected "
                             f"{lines}), or a time that is not finite")
    print(f"kernel bench: {len(rows)} lines, launches {counts}, "
          f"{seconds:.2f} s, on {card}")
    return counts, rows, seconds


def single_block_timing(card: str) -> dict:
    """CUDA-event device times of both single-block kernels at the text
    sampler's shape (B 8, H 4, L 64, Dh 64, f32, distinct q, k, v), in
    turns within this call (plain, kernel, kernel, plain), beside a PyTorch
    yardstick the port never calls (``scaled_dot_product_attention``: the
    forward without grad, as the kernel keeps no logsumexp; forward and
    backward for the backward kernel; its kernels' profiler time) and the
    bound."""
    import torch
    import torch.nn.functional as F

    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.ops import single_block as sb

    phase("timing: single-block attention at the sampler shape (B 8, H 4, "
          "L 64, Dh 64, f32)")
    b, h, length, d = N, HEADS, SEQ, DIM // HEADS
    q, k, v = _qkv(b, h, length, length, d, d, torch.float32, "bhld", 21)
    g = _cos_cotangent(q)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg)
        torch.autograd.grad(o, (qg, kg, vg), g)

    runs = {  # name: (kernel, plain version, library yardstick, its label)
        "attention_single_block_fwd": (
            lambda: sb.forward(q, k, v),
            lambda: reference.single_block_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v), "SDPA forward"),
        "attention_single_block_bwd": (
            lambda: sb.backward(q, k, v, g),
            lambda: reference.single_block_attention_bwd(q, k, v, g),
            sdpa_fwd_bwd, "SDPA forward+backward"),
    }
    # (bytes read once and written once, FP32 FLOPs): q, k, v in, O out,
    # s = q k^T and p v; q, k, v, dO in, dq, dk, dv out, s, dp, dq, dk and
    # dv (no O: D = rowsum(dO O) = rowsum(round(p) dp)).
    work = {"attention_single_block_fwd": sb.work("fwd", q, k, v),
            "attention_single_block_bwd": sb.work("bwd", q, k, v)}
    # The bound takes the f32 products as 3xTF32, the least time for them
    # on the card, as the flash rows do (the FP32-FMA roof is printed
    # beside); SDPA's own kernels' device time from the profiler, as its
    # autograd call is bound by its host enqueue. The kernels' own profiler
    # time is recorded beside their CUDA-event time (which includes the gap
    # between back-to-back launches), to compare like with like.
    timings = _time_against_plain(runs, work, card,
                                  "distinct q, k, v, profiler self device "
                                  "time", library_timer=_profiled_device_ms,
                                  at="B 8, H 4, L 64, Dh 64, f32")
    for name, (kernel, _, _, _) in runs.items():
        timings[name]["profiler_ms"] = _profiled_device_ms(kernel)
        print(f"{name}: {timings[name]['profiler_ms']} ms of kernel time by "
              f"the profiler, on {card}")
    return timings


@contextlib.contextmanager
def _kernel_dtypes():
    """Records the operand dtype and layout of every flash and resblock
    kernel wrapper call made inside, eager or captured into a CUDA graph
    (the wrappers' launch functions, wrapped): yields a dict {(kernel,
    dtype, "strided" or "contiguous"): calls} keyed by the first operand
    (q, or the block's x). A graph's replays are not calls."""
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import resblock as rb

    seen = {}
    originals = {(fa, "forward"): "flash_attention_fwd",
                 (fa, "backward_dq"): "flash_attention_bwd_dq",
                 (fa, "backward_dkv"): "flash_attention_bwd_dkv",
                 (rb, "_launch"): "fused_resblock"}

    def spy(fn, name):
        def launch(x, *args, **kwargs):
            key = (name, str(x.dtype).split(".")[-1],
                   "contiguous" if x.is_contiguous() else "strided")
            seen[key] = seen.get(key, 0) + 1
            return fn(x, *args, **kwargs)
        return launch

    saved = {key: getattr(*key) for key in originals}
    try:
        for (module, attr), name in originals.items():
            setattr(module, attr, spy(saved[(module, attr)], name))
        yield seen
    finally:
        for (module, attr), fn in saved.items():
            setattr(module, attr, fn)


def _all_f32(tree, where: str) -> int:
    """Asserts every floating tensor of a checkpoint (nested dicts) is
    float32; returns how many there are."""
    import torch

    n = 0
    for key, value in tree.items():
        if isinstance(value, dict):
            n += _all_f32(value, f"{where}/{key}")
        elif torch.is_tensor(value) and value.is_floating_point():
            if value.dtype != torch.float32:
                raise AssertionError(f"{where}/{key} is {value.dtype}")
            n += 1
    return n


def main_path_bf16_train(card: str):
    """Phase (a): ``shakespeare --train --dtype bf16`` at the bench's width
    (dim 256, head width 64, batch 8) on the training corpus, asserted as
    the f32 run is (launches, a falling loss, checkpoints), and every
    flash launch on bf16 strided QKV views; then ``mnist --train --dtype
    bf16`` on MNIST_BF16_STEPS batches of 128, every resblock launch bf16,
    a falling loss. Both checkpoints hold float32 tensors only. Returns the launch
    counts of both runs."""
    import numpy as np
    import torch

    from tinydiffusionmodels_torch import mnist

    with _kernel_dtypes() as seen:
        _, ckpt, text_counts, _ = main_path_train(
            card, extra=("--dtype", "bf16"), name="bf16_ckpt")
    # q, k and v are the strided (B, L, H, Dh) views of one QKV projection.
    # ``seen`` counts the wrappers' eager and captured calls; a replay
    # relaunches what its capture recorded, so every launch is bf16 on
    # strided views when every recorded call is, and the counters (replays
    # included, asserted by main_path_train) give the numbers.
    want = {(k, "bfloat16", "strided") for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}
    if set(seen) != want:
        raise AssertionError(f"kernel calls by dtype {seen}, expected only "
                             f"{sorted(want)}")
    for path in (ckpt, ckpt.with_name("bf16_ckpt_best.pth")):
        n = _all_f32(torch.load(path, weights_only=False), path.name)
        print(f"{path.name}: {n} tensors, all float32")
    print(f"bf16 text training: eager and captured kernel calls by dtype "
          f"{seen}; launches {_nonzero(text_counts)}")

    phase(f"main path: mnist --train --dtype bf16 ({MNIST_BF16_STEPS} steps "
          f"of batch {MNIST_BATCH}, synthetic digits)")
    work = _prepare_mnist_workdir()
    os.environ["TDM_DATA_LIMIT"] = str(MNIST_BF16_STEPS * MNIST_BATCH)
    ckpt = work / "mnist_bf16_ckpt.pth"
    ckpt.unlink(missing_ok=True)
    torch.cuda.synchronize()
    _reset_counts()
    with _kernel_dtypes() as seen:
        result = mnist.main(["--train", "--dtype", "bf16", "--epochs", "1",
                             "--batch_size", str(MNIST_BATCH), "--ckpt",
                             str(ckpt), "--data_root", str(work / "data"),
                             "--no_epoch_samples"])
        torch.cuda.synchronize()
    os.environ.pop("TDM_DATA_LIMIT")
    mnist_counts = _counts()
    expect = {name: 0 for name in mnist_counts}
    expect["fused_resblock"] = MNIST_BF16_STEPS * 4
    if mnist_counts != expect or set(seen) != {
            ("fused_resblock", "bfloat16", "contiguous")}:
        raise AssertionError(f"launches {mnist_counts}, calls by dtype "
                             f"{seen}; expected {expect}, all bf16")
    losses = result.step_losses
    window = MNIST_BF16_STEPS // 4
    first, last = losses[:window].mean(), losses[-window:].mean()
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"bf16 MNIST losses: first {window} {first}, "
                             f"last {window} {last}")
    n = _all_f32(torch.load(ckpt, weights_only=False), ckpt.name)
    print(f"bf16 MNIST training: launches {_nonzero(mnist_counts)}, eager "
          f"and captured calls by dtype {seen}; "
          f"mean loss first {window} steps {first}, last {window} {last}; "
          f"{ckpt.name}: {n} tensors, all float32; "
          f"{result.steps / result.seconds} steps/s, bs={MNIST_BATCH} bf16, "
          f"on {card}")
    return text_counts, mnist_counts


def _close_bf16_grads(got: dict, want16: dict, want32: dict) -> float:
    """``tests/test_torch_precision.py``'s bf16 gradient rule with the CPU
    as the reference: each card gradient within GRAD_RTOL_BF16 of the CPU
    bf16 gradient's largest magnitude plus the CPU bf16 gradient's own
    distance from the CPU f32 one. Returns the worst error over its
    allowance."""
    worst = 0.0
    for name, g in got.items():
        g16, g32 = want16[name], want32[name]
        scale = max(float(g16.abs().max()), 1e-12)
        allowed = GRAD_RTOL_BF16 * scale + float((g16 - g32).abs().max())
        err = float((g.cpu() - g16).abs().max())
        if not err <= allowed:
            raise AssertionError(f"{name}: card bf16 gradient off the CPU's "
                                 f"by {err} > {allowed}")
        worst = max(worst, err / allowed)
    return worst


def bf16_step_vs_cpu(card: str) -> None:
    """Phase (b): one bf16 training step's losses and gradients on the card
    against the CPU (plain versions), the same weights, tokens, t and
    noise, no dropout: the text step at the bench's bf16 shape with the
    batch cut to 64 (dim 256, L 64, depth 3, vocab 4096), then the MNIST
    step at batch 32. Losses within LOSS_RTOL_BF16, gradients by
    ``_close_bf16_grads``. Also ``perf.compiled_flops`` of each step is the
    same on both devices."""
    import copy

    import torch
    from torch import nn

    from tinydiffusionmodels_torch import perf
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.core.diffusion import ddpm_loss
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        SimpleUNet,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.train import text_train
    from tinydiffusionmodels_torch.train.precision import in_dtype

    phase("bf16 train step, card vs CPU (text at B 64, L 64, dim 256, "
          "depth 3, vocab 4096; MNIST at B 32; no dropout)")
    bf16, vocab, b = torch.bfloat16, 4096, 64
    g = torch.Generator().manual_seed(21)
    cfg = TransformerConfig(dim=DIM, n_heads=HEADS, depth=DEPTH, dropout=0.0)
    joint = nn.ModuleDict({
        "diffusion_model": TinyTransformer(cfg, generator=g),
        "rounding_fn": LearnedRounding(DIM, vocab, generator=g),
        "embedding_fn": LearnedEmbedding(vocab, DIM, generator=g)})
    tokens = torch.randint(0, vocab, (b, SEQ), generator=g)
    t = torch.randint(0, STEPS, (b,), generator=g)
    noise = torch.randn(b, SEQ, DIM, generator=g)

    def text_step(model, dev, dtype):
        model.zero_grad(set_to_none=True)
        total, (diff, round_) = text_train._losses(
            model, tokens.to(dev), t.to(dev), noise.to(dev), 0.7,
            sched=make_schedule(device=dev), use_learned_embeddings=True,
            pretrained_matrix=None, deterministic=True, compute_dtype=dtype)
        total.backward()
        return (torch.stack([total, diff, round_]).detach().cpu(),
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()})

    x = torch.randn(32, 28, 28, 1, generator=g).clamp(-1, 1)
    t_img = torch.randint(0, STEPS, (32,), generator=g)
    noise_img = torch.randn(32, 28, 28, 1, generator=g)
    unet = SimpleUNet(generator=g)

    def mnist_step(model, dev, dtype):
        model.zero_grad(set_to_none=True)
        loss = ddpm_loss(make_schedule(device=dev), in_dtype(model, dtype),
                         x.to(dev), t_img.to(dev), noise_img.to(dev),
                         compute_dtype=dtype)
        loss.backward()
        return (loss.detach().cpu()[None],
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()})

    for what, model, step in (("text", joint, text_step),
                              ("MNIST", unet, mnist_step)):
        card_model = copy.deepcopy(model).cuda()
        t0 = time.perf_counter()
        losses, grads = step(card_model, "cuda", bf16)
        losses16, grads16 = step(model, "cpu", bf16)
        _, grads32 = step(model, "cpu", None)
        loss_err = float(((losses - losses16).abs()
                          / losses16.abs()).max())
        if not loss_err <= LOSS_RTOL_BF16:
            raise AssertionError(f"{what} bf16 losses {losses.tolist()} on "
                                 f"the card, {losses16.tolist()} on the CPU")
        worst = _close_bf16_grads(grads, grads16, grads32)
        flops = [perf.compiled_flops(step, m, dev, bf16)
                 for m, dev in ((card_model, "cuda"), (model, "cpu"))]
        if flops[0] != flops[1]:
            raise AssertionError(f"{what} step FLOPs {flops[0]} on the card,"
                                 f" {flops[1]} on the CPU")
        print(f"{what} bf16 step: losses card {losses.tolist()}, CPU "
              f"{losses16.tolist()} (max relative difference {loss_err:.2e}, "
              f"tol {LOSS_RTOL_BF16}); {len(grads)} gradients within the "
              f"bf16 rule (worst at {worst:.3f} of its allowance); "
              f"compiled_flops {flops[0]} on both devices; "
              f"{time.perf_counter() - t0:.1f} s")


def main_path_bench(card: str) -> dict:
    """Phase (c): ``python -m tinydiffusionmodels_torch.bench --quick`` as
    a subprocess with TDM_BENCH_RETRIES=0 and TDM_BENCH_QUIET_WAIT=0. Its
    last line must carry bench.py's keys and all 14 metrics finite and
    > 0, mfu for the train and sample metrics; ``valid`` is printed, not
    asserted (the kernel build just before raises the load average).
    Returns the bench's kernel launches (its provenance)."""
    import math

    phase("main path: python -m tinydiffusionmodels_torch.bench --quick")
    env = dict(os.environ, TDM_BENCH_RETRIES="0", TDM_BENCH_QUIET_WAIT="0")
    env.pop("TDM_PLATFORM", None)
    env.pop("TDM_DATA_LIMIT", None)
    env["PYTHONPATH"] = str(REPO)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tinydiffusionmodels_torch.bench", "--quick"],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines()[-20:]:
        print("  " + line)
    if proc.returncode != 0:
        raise AssertionError(f"the bench exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    keys, extra = set(line) - {"invalid_reasons", "loose_metrics"}, line[
        "extra"]
    if keys != BENCH_KEYS or set(extra) - {"metric_valid"} != (
            BENCH_EXTRA_KEYS):
        raise AssertionError(f"bench keys {sorted(line)}, extra "
                             f"{sorted(extra)}")
    envelope, mfu = extra["envelope"], extra["mfu"]
    if sorted(envelope) != sorted(BENCH_METRICS):
        raise AssertionError(f"bench metrics {sorted(envelope)}")
    for name, (lo, mid, hi) in envelope.items():
        if not all(math.isfinite(v) and v > 0 for v in (lo, mid, hi)):
            raise AssertionError(f"{name}: envelope {[lo, mid, hi]}")
    missing = BENCH_MFU_METRICS - set(mfu)
    if missing or not all(0 <= v < 1 for v in mfu.values()):
        raise AssertionError(f"mfu {mfu}, missing {sorted(missing)}")
    if extra["backend"] != "cuda" or extra["device_kind"] != card:
        raise AssertionError(f"bench backend {extra['backend']}, device "
                             f"{extra['device_kind']}")
    launches = extra["provenance"]["kernels"]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "fused_resblock",
                 "guided_decode"):
        if not launches[name] > 0:
            raise AssertionError(f"the bench launched no {name}: "
                                 f"{launches}")
    jacobi = extra["provenance"]["jacobi"]
    if sorted(jacobi) != ["guided_spec_tokens_s_bs256",
                          "guided_verified_tokens_s_bs256",
                          "guided_verified_tokens_s_bs8"] or not all(
            {"draft", "jacobi_rounds", "verify_ms_per_round"} <= set(v)
            for v in jacobi.values()):
        raise AssertionError(f"the bench's Jacobi record: {jacobi}")
    print(f"bench --quick: {seconds:.1f} s, valid {line['valid']} "
          f"(reasons {line.get('invalid_reasons', [])}, loose "
          f"{line.get('loose_metrics', [])}), kernel launches {launches}; "
          f"Jacobi record {jacobi}; on {card}")
    print(json.dumps(line))
    return launches


# --- CUDA graphs (phases 24-26) ----------------------------------------------

# K: the replayed steps held against as many eager ones, TDM_SCAN_CHUNK's
# default; a learning-rate schedule that moves within them.
GRAPH_STEPS, GRAPH_LR, GRAPH_WARMUP = 25, 1e-3, 10
GRAPH_VOCAB = 4096      # the bench's text vocabulary
# name: (compute dtype, self-conditioning, EMA decay) of the text step at
# the headline shape (dim 256, depth 3, batch 8, seq 64, dropout 0.1).
TEXT_GRAPH_CASES = {"f32": (None, False, None),
                    "f32_self_cond_ema": (None, True, 0.999),
                    "bf16_ema": ("bf16", False, 0.999),
                    "bf16_self_cond": ("bf16", True, None)}
# name: (batch, compute dtype, EMA decay) of the MNIST step.
MNIST_GRAPH_CASES = {"bs128_f32_ema": (MNIST_BATCH, None, 0.999),
                     "bs512_bf16": (BF16_BATCH, "bf16", None)}
# Kernel names in torch.profiler's tables, by launch counter.
GRAPH_KERNEL_NAMES = {"flash_attention_fwd": "flash_fwd_kernel",
                      "flash_attention_bwd_dq": "flash_bwd_dq_kernel",
                      "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel",
                      "fused_resblock": "fused_resblock_kernel"}
GRAPH_WALL_STEPS = 100  # steps a row's unprofiled wall time is taken over
# Where two eager runs differ (a nondeterministic op: the MNIST f32 step's
# weight-gradient convolutions sum in an order cuDNN picks per run), the
# replay's distance to the nearer eager run, after GRAPH_STEPS AdamW steps
# at GRAPH_LR: the losses (about 2.3) within 1e-4, and every parameter and
# EMA parameter within 5 steps' worth of AdamW's largest early move, lr
# (a coordinate whose gradient is near zero can take a +-lr step either
# way, so two runs part by up to 2 lr a step there; four eager and two
# replayed runs on the H100 parted by at most 1.24e-5 and 9.97e-4, PERF.md
# §2). A
# replay that skipped a step, read a stale batch or a wrong learning rate
# moves the losses by 1e-2 or more. Fixed numbers, not the spread of a few
# draws, which varied tenfold between calls.
REPLAY_F32_LOSS_ATOL = 1e-4
REPLAY_F32_TENSOR_ATOL = 5 * GRAPH_LR


def _text_runner(*, batch=BATCH, dtype=None, self_cond=False,
                 ema_decay=None, eager=False, steps=GRAPH_STEPS, seed=21,
                 mesh=None):
    """The text trainer's chunk runner (``text_train.TextSteps``) at the
    headline shape with ``batch``, random weights and tokens from
    ``seed``, an epoch of ``steps`` steps started; (runner, the tensors to
    compare: every parameter and EMA parameter)."""
    import copy

    import numpy as np
    import torch
    from torch import nn

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.train import text_train
    from tinydiffusionmodels_torch.train.optim import (
        adamw,
        cosine_warmup_lambda,
    )
    from tinydiffusionmodels_torch.train.precision import (
        resolve_compute_dtype,
    )

    sched = make_schedule(device="cuda")
    cfg = TransformerConfig(dim=DIM, n_heads=HEADS, depth=DEPTH,
                            dropout=DROPOUT, timesteps=sched.timesteps,
                            self_cond=self_cond)
    g = torch.Generator().manual_seed(seed)
    joint = nn.ModuleDict({
        "diffusion_model": TinyTransformer(cfg, generator=g),
        "rounding_fn": LearnedRounding(DIM, GRAPH_VOCAB, generator=g),
        "embedding_fn": LearnedEmbedding(GRAPH_VOCAB, DIM, generator=g),
    }).cuda()
    ema = copy.deepcopy(joint).requires_grad_(False) if ema_decay else None
    optimizer = adamw(joint.parameters(), GRAPH_LR, weight_decay=1e-4)
    lam = cosine_warmup_lambda(GRAPH_WARMUP, 4 * steps)
    tokens = torch.randint(0, GRAPH_VOCAB, (steps * batch, SEQ),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed + 1), device="cuda")
    runner = text_train.TextSteps(
        joint, optimizer, tokens, batch_size=batch, steps=steps,
        generator=torch.Generator(device="cuda").manual_seed(seed + 2),
        coin_rng=np.random.default_rng(seed + 3), ema=ema,
        ema_decay=ema_decay, lr_at=lambda s: GRAPH_LR * lam(s), eager=eager,
        mesh=mesh, sched=sched, use_learned_embeddings=True,
        pretrained_matrix=None,
        compute_dtype=resolve_compute_dtype(dtype))
    order = np.random.default_rng(seed + 4).permutation(steps * batch)
    runner.start(order.reshape(steps, batch), 0.7)
    tensors = {f"live.{n}": p for n, p in joint.named_parameters()}
    if ema is not None:
        tensors.update({f"ema.{n}": p for n, p in ema.named_parameters()})
    return runner, tensors


def _mnist_runner(*, batch=MNIST_BATCH, dtype=None, ema_decay=None,
                  eager=False, steps=GRAPH_STEPS, seed=31):
    """The MNIST trainer's chunk runner (``mnist_train.MnistSteps``) at
    ``batch``, random weights and images in [-1, 1] from ``seed``, an epoch
    of ``steps`` steps started; (runner, tensors to compare)."""
    import copy

    import numpy as np
    import torch

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.models import SimpleUNet
    from tinydiffusionmodels_torch.train import mnist_train
    from tinydiffusionmodels_torch.train.optim import adamw
    from tinydiffusionmodels_torch.train.precision import (
        resolve_compute_dtype,
    )

    sched = make_schedule(device="cuda")
    model = SimpleUNet(sched.timesteps,
                       generator=torch.Generator().manual_seed(seed)).cuda()
    ema = copy.deepcopy(model).requires_grad_(False) if ema_decay else None
    optimizer = adamw(model.parameters(), 1e-3, weight_decay=0.01)
    images = torch.rand((steps * batch, 28, 28, 1),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(seed + 1), device="cuda") * 2 - 1
    runner = mnist_train.MnistSteps(
        model, optimizer, images, sched, batch_size=batch, steps=steps,
        generator=torch.Generator(device="cuda").manual_seed(seed + 2),
        ema=ema, ema_decay=ema_decay,
        compute_dtype=resolve_compute_dtype(dtype), eager=eager)
    order = np.random.default_rng(seed + 3).permutation(steps * batch)
    runner.start(order.reshape(steps, batch))
    tensors = {f"live.{n}": p for n, p in model.named_parameters()}
    if ema is not None:
        tensors.update({f"ema.{n}": p for n, p in ema.named_parameters()})
    return runner, tensors


def _diff(a, b) -> float:
    import torch

    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return 0.0 if torch.equal(a, b) else float(
        (a.double() - b.double()).abs().max())


def _worst(a: dict, b: dict) -> tuple[float, float]:
    """The largest |a - b| of the losses and of every other tensor."""
    return (_diff(a["losses"], b["losses"]) if "losses" in a else 0.0,
            max((_diff(a[k], b[k]) for k in a if k != "losses"),
                default=0.0))


def _bit_equal(*runs: dict) -> bool:
    return all(_worst(runs[0], r) == (0.0, 0.0) for r in runs[1:])


def _run_steps(make, **kw):
    """K steps of a chunk runner from ``make``; (losses and tensors, the
    launches, the runner)."""
    import torch

    runner, tensors = make(**kw)
    torch.cuda.synchronize()
    _reset_counts()
    losses = runner.run(GRAPH_STEPS)
    torch.cuda.synchronize()
    out = {"losses": torch.as_tensor(losses)}
    out.update({k: v.detach().clone() for k, v in tensors.items()})
    return out, _counts(), runner


def _nondeterministic_rule(what: str, make, kw, eager_a, eager_b,
                           replayed) -> None:
    """Two eager runs differ: hold the replay to REPLAY_F32_LOSS_ATOL and
    REPLAY_F32_TENSOR_ATOL from the nearer of them, and name the op: with
    cuDNN's deterministic algorithms, two eager runs and the replay must
    be bit-equal."""
    import torch

    off = [min(_worst(replayed, e)[i] for e in (eager_a, eager_b))
           for i in (0, 1)]
    apart = _worst(eager_a, eager_b)
    print(f"{what}: two eager runs differ (losses {apart[0]:.3g}, tensors "
          f"{apart[1]:.3g}); replay - nearer eager run: losses "
          f"{off[0]:.3g} (tol {REPLAY_F32_LOSS_ATOL:g}), tensors "
          f"{off[1]:.3g} (tol {REPLAY_F32_TENSOR_ATOL:g})")
    if off[0] > REPLAY_F32_LOSS_ATOL or off[1] > REPLAY_F32_TENSOR_ATOL:
        raise AssertionError(f"{what}: the replay is {off} from the nearer "
                             f"eager run, beyond ({REPLAY_F32_LOSS_ATOL}, "
                             f"{REPLAY_F32_TENSOR_ATOL})")
    torch.backends.cudnn.deterministic = True
    try:
        det = [_run_steps(make, eager=eager, **kw)[0]
               for eager in (True, True, False)]
    finally:
        torch.backends.cudnn.deterministic = False
    if not _bit_equal(*det):
        raise AssertionError(f"{what}: with torch.backends.cudnn."
                             f"deterministic the runs still differ: "
                             f"{[_worst(det[0], d) for d in det[1:]]}")
    print(f"{what}: with torch.backends.cudnn.deterministic two eager runs "
          f"and the replay are bit-equal: the op is a cuDNN convolution "
          f"(the f32 weight gradients of the resblock backward)")


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def replay_vs_eager_training() -> dict:
    """Phase 24a: K replayed steps against K eager steps from one seed, for
    every case of TEXT_GRAPH_CASES and MNIST_GRAPH_CASES: every loss,
    parameter and EMA parameter bit for bit, equal launch counts. Where
    two eager runs already differ, ``_nondeterministic_rule``. Returns the
    replayed
    runners, their graphs captured."""
    phase(f"CUDA graphs: {GRAPH_STEPS} replayed training steps against "
          f"{GRAPH_STEPS} eager ones, bit for bit")
    runners = {}
    cases = [(f"text {name}", _text_runner,
              dict(dtype=d, self_cond=sc, ema_decay=e))
             for name, (d, sc, e) in TEXT_GRAPH_CASES.items()]
    cases += [(f"MNIST {name}", _mnist_runner,
               dict(batch=b, dtype=d, ema_decay=e))
              for name, (b, d, e) in MNIST_GRAPH_CASES.items()]
    for what, make, kw in cases:
        eager_a, counts_a, _ = _run_steps(make, eager=True, **kw)
        eager_b, _, _ = _run_steps(make, eager=True, **kw)
        replayed, counts_r, runner = _run_steps(make, **kw)
        if counts_r != counts_a:
            raise AssertionError(f"{what}: launches {counts_r} replayed, "
                                 f"{counts_a} eager")
        if not all(step.captured for step in runner.kinds.values()
                   if step.calls > step.warmup):
            raise AssertionError(f"{what}: a step was not captured")
        calls = {str(v): (s.calls, s.warmup) for v, s in runner.kinds.items()}
        if _bit_equal(eager_a, eager_b):
            if not _bit_equal(eager_a, replayed):
                raise AssertionError(f"{what}: replayed differs from eager "
                                     f"by {_worst(replayed, eager_a)} "
                                     f"(losses, tensors); two eager runs "
                                     f"are bit-equal")
            verdict = "bit-equal to eager"
        else:
            _nondeterministic_rule(what, make, kw, eager_a, eager_b,
                                   replayed)
            verdict = "within the fixed f32 tolerances"
        print(f"{what}: {GRAPH_STEPS} steps' losses and {len(replayed) - 1} "
              f"tensors {verdict}; launches {_nonzero(counts_r)}; (steps, "
              f"of which eager warm-up) by kind {calls}")
        runners[what] = runner
    return runners


def _sampler_models(seed: int = 41):
    """Random-weight denoisers at the samplers' widths: the text model at
    the headline shape, a self-conditioned one (its projection drawn, not
    zero) and the UNet."""
    import torch

    from tinydiffusionmodels_torch.models import (
        SimpleUNet,
        TinyTransformer,
        TransformerConfig,
    )

    g = torch.Generator().manual_seed(seed)
    text = TinyTransformer(TransformerConfig(dim=DIM, n_heads=HEADS,
                                             depth=DEPTH), generator=g)
    text_sc = TinyTransformer(TransformerConfig(dim=DIM, n_heads=HEADS,
                                                depth=DEPTH, self_cond=True),
                              generator=g)
    with torch.no_grad():
        text_sc.selfcond_proj.weight.normal_(0.0, 0.05, generator=g)
    unet = SimpleUNet(generator=g)
    return [m.cuda().eval() for m in (text, text_sc, unet)]


def _sampler_cases(models):
    """name: (denoise_fn, shape, method, steps, self_cond) of the samplers
    held against their eager loops."""
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.sample.text import make_denoiser

    text, text_sc, unet = models
    sched = make_schedule(device="cuda")
    return sched, {
        f"text ancestral n {N}": (make_denoiser(text, sched), (N, SEQ, DIM),
                                  "ancestral", None, False),
        f"text ddim {MNIST_DDIM_STEPS} self-cond n {N}": (
            make_denoiser(text_sc, sched), (N, SEQ, DIM), "ddim",
            MNIST_DDIM_STEPS, True),
        f"MNIST ancestral n {MNIST_N}": (unet, (MNIST_N, 28, 28, 1),
                                         "ancestral", None, False),
        f"MNIST ddim {MNIST_DDIM_STEPS} n {MNIST_N}": (
            unet, (MNIST_N, 28, 28, 1), "ddim", MNIST_DDIM_STEPS, False),
        f"MNIST dpm++ 20 n {MNIST_N}": (unet, (MNIST_N, 28, 28, 1), "dpm++",
                                        20, False),
    }


def _sample(case, sched, eager: bool, seed: int = 51) -> list:
    """Two calls of one ``Sampler`` (the second replays every step on the
    card, DPM-Solver++'s first-order step included): [(samples,
    launches)] of each."""
    import torch

    from tinydiffusionmodels_torch.sample.ancestral import Sampler

    denoise, shape, method, steps, self_cond = case
    sampler = Sampler(denoise, sched, shape, method=method, num_steps=steps,
                      self_cond=self_cond, eager=eager,
                      generator=torch.Generator(device="cuda")
                      .manual_seed(seed))
    calls = []
    for _ in range(2):
        torch.cuda.synchronize()
        _reset_counts()
        x = sampler()
        torch.cuda.synchronize()
        calls.append((x, _counts()))
    return calls


def replay_vs_eager_samplers(models) -> None:
    """Phase 24b: each captured sampler against its eager loop, from one
    seed, bit for bit (two eager loops are), with equal launch counts: the
    first call of a ``Sampler`` (each kind of step eager once, then
    captured) and its second (every step replayed)."""
    import torch

    phase("CUDA graphs: captured samplers against their eager loops, bit "
          "for bit")
    sched, cases = _sampler_cases(models)
    for what, case in cases.items():
        eager_a = _sample(case, sched, eager=True)
        eager_b = _sample(case, sched, eager=True)
        replayed = _sample(case, sched, eager=False)
        for call, ((a, counts_a), (b, _), (r, counts_r)) in enumerate(
                zip(eager_a, eager_b, replayed), 1):
            if counts_r != counts_a:
                raise AssertionError(f"{what}, call {call}: launches "
                                     f"{counts_r} replayed, {counts_a} eager")
            if not bool(torch.isfinite(r).all()):
                raise AssertionError(f"{what}: samples are not finite")
            if not torch.equal(a, b):
                raise AssertionError(f"{what}, call {call}: two eager loops "
                                     f"differ by {_diff(a, b)}")
            if not torch.equal(r, a):
                raise AssertionError(f"{what}, call {call}: the captured "
                                     f"loop differs from the eager one by "
                                     f"{_diff(r, a)}")
        print(f"{what}: {tuple(r.shape)} samples of two calls bit-equal to "
              f"the eager loop's; launches a call {_nonzero(counts_r)}")


def _kernel_counts(prof) -> dict:
    from torch.autograd import DeviceType

    counts = dict.fromkeys(GRAPH_KERNEL_NAMES, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for counter, name in GRAPH_KERNEL_NAMES.items():
            if name in e.key:
                counts[counter] += e.count
    return counts


def kernels_in_graphs(runners: dict, models) -> None:
    """Phase 25: torch.profiler over one replay of each training graph must
    list the flash forward, dq and dk/dv kernels (text) and the resblock
    kernel (MNIST) as many times as the capture counted them (one eager
    step's launches); over a captured 10-step sampler loop, 10 steps'
    worth. Where the profiler lists none from a replay, that is printed and
    the launch counters' deltas are what remains."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch import graphs
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.sample.ancestral import sample_loop

    phase("CUDA graphs: the kernels inside the replays (torch.profiler)")
    names = [f"{m.__name__.split('.')[-1]}.{a}" for m, a in graphs.COUNTERS]
    print(f"counters {names}")
    blind = []
    for what, runner in runners.items():
        for variant, step in runner.kinds.items():
            if not step.captured:
                continue
            # COUNTERS begins with the flash and resblock counters, in
            # GRAPH_KERNEL_NAMES' order.
            want = dict(zip(GRAPH_KERNEL_NAMES, step.delta))
            runner.cursor.zero_()   # the epoch's first step again
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step.graph.replay()
                torch.cuda.synchronize()
            seen = _kernel_counts(prof)
            if not any(seen.values()):
                blind.append(what)
            elif seen != want:
                raise AssertionError(f"{what} (step {variant}): the "
                                     f"profiler lists {seen} in one replay, "
                                     f"the capture counted {want}")
            print(f"{what} (step {variant}): one replay lists {seen}; the "
                  f"capture counted {step.delta}")
    sched = make_schedule(10, device="cuda")
    text, _, unet = models
    for what, model, shape, counter, per_step in (
            (f"text sampler n {N}", text, (N, SEQ, DIM),
             "flash_attention_fwd", DEPTH),
            (f"MNIST sampler n {MNIST_N}", unet, (MNIST_N, 28, 28, 1),
             "fused_resblock", 4)):
        gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                torch.inference_mode():
            sample_loop(model, sched, shape, generator=gen)
            torch.cuda.synchronize()
        seen = _kernel_counts(prof)[counter]
        print(f"{what}, a captured 10-step loop (1 eager step, 9 replays): "
              f"the profiler lists {seen} {GRAPH_KERNEL_NAMES[counter]}, "
              f"{10 * per_step} launched")
        if seen == per_step:
            blind.append(what)
        elif seen != 10 * per_step:
            raise AssertionError(f"{what}: {seen} kernels listed, "
                                 f"{10 * per_step} launched")
    if blind:
        print(f"torch.profiler lists no kernel of a replay for {blind}: "
              "the launch counters' deltas are the evidence there")


# --- data and sequence parallelism (phases 29-31) ---------------------------

# Ring attention on the card (phase 29): (B, H, L, Dh) of the headline
# training shape and of the kernel bench's long one; shards of the ring
# held in one process; (causal, bidirectional, dropout rate).
RING_SHAPES = ((BATCH, HEADS, SEQ, DIM // HEADS), (2, HEADS, 2048, DIM // HEADS))
RING_SHARDS = (2, 4)
RING_CONFIGS = ((False, False, 0.0), (True, False, DROPOUT),
                (False, True, DROPOUT), (True, True, 0.0))
# The CLIs under torchrun at world 1 (phase 30): characters of the corpus
# (about 63 text steps of 8) and MNIST images (64 steps of 128).
TORCHRUN_CHARS = 40_000
TORCHRUN_MNIST_IMAGES = 64 * MNIST_BATCH
TORCHRUN_TIMEOUT_S = 300
CLI_MARK = "CHIP_SMOKE_CLI "
# Replayed steps a mode, timed alternately (phase 31).
GROUP_WALL_STEPS = 200


def ring_on_card(card: str) -> dict:
    """Phase 29: ``parallel.ring_attention`` with n shards in one process
    (every block the flash forward at q_offset = r L / n and k_offset =
    src L / n, merged through its lse; the backward one dq and one dk/dv
    launch a block) against the kernels over the whole sequence, forward
    (out and lse) and backward (q, k, v gradients from an output and an
    lse cotangent), at PERF.md §2's limits. Launches asserted: n x n
    blocks (2 n x n bidirectional) of each kernel. Returns the largest
    f32 errors (out, dq, dk/dv)."""
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.parallel import ring_attention

    phase("ring attention on the card: n shards in one process against the "
          "flash kernels over the whole sequence")
    f32, bf16 = torch.float32, torch.bfloat16
    seed = _seed(1_357_913)
    worst = {"out": 0.0, "dq": 0.0, "dkv": 0.0}
    i = 0
    for b, h, length, d in RING_SHAPES:
        for dtype in (f32, bf16):
            for n in RING_SHARDS:
                for causal, bidir, rate in RING_CONFIGS:
                    i += 1
                    g = torch.Generator(device="cuda").manual_seed(700 + i)
                    q, k, v = (torch.randn(b, h, length, d, generator=g,
                                           device="cuda").to(dtype)
                               .requires_grad_() for _ in range(3))
                    g_out = torch.randn(b, h, length, d, generator=g,
                                        device="cuda").to(dtype)
                    g_lse = torch.randn(b, h, length, generator=g,
                                        device="cuda")
                    kw = dict(causal=causal, dropout_rate=rate,
                              dropout_seed=seed if rate else None)
                    torch.cuda.synchronize()
                    _reset_counts()
                    out, lse = ring_attention(q, k, v, seq=n,
                                              bidirectional=bidir,
                                              with_lse=True, **kw)
                    grads = torch.autograd.grad((out, lse), (q, k, v),
                                                (g_out, g_lse))
                    torch.cuda.synchronize()
                    counts = _counts()
                    blocks = n * n * (2 if bidir else 1)
                    expect = dict.fromkeys(counts, 0)
                    expect.update({"flash_attention_fwd": blocks,
                                   "flash_attention_bwd_dq": blocks,
                                   "flash_attention_bwd_dkv": blocks})
                    if counts != expect:
                        raise AssertionError(f"ring launches {counts}, "
                                             f"expected {expect}")
                    r_out, r_lse = fa.flash_attention_with_lse(q, k, v, **kw)
                    r_grads = torch.autograd.grad((r_out, r_lse), (q, k, v),
                                                  (g_out, g_lse))
                    torch.cuda.synchronize()
                    bf = dtype == bf16
                    tol_o, tol_l, tol_g = ((2e-2, 1e-2, 2e-2) if bf
                                           else (1e-4, 1e-4, 2e-4))
                    if bf and length > 64:
                        tol_g = BF16_LONG_GRAD_TOL
                    torch.testing.assert_close(out, r_out, atol=tol_o,
                                               rtol=tol_o)
                    torch.testing.assert_close(lse, r_lse, atol=tol_l,
                                               rtol=tol_l)
                    for x, r in zip(grads, r_grads):
                        torch.testing.assert_close(x, r, atol=tol_g,
                                                   rtol=tol_g)
                    errs = [_max_err(x, r) for x, r in zip(grads, r_grads)]
                    e_out = _max_err(out, r_out)
                    print(f"B {b} L {length} {str(dtype)[6:]:8s} n {n} "
                          f"{'causal' if causal else 'full  '} "
                          f"{'bidir' if bidir else 'uni  '} p {rate:g}: "
                          f"max|dO| {e_out:.3e} max|dlse| "
                          f"{_max_err(lse, r_lse):.3e} (tol {tol_o:g}/"
                          f"{tol_l:g}) max|ddq| {errs[0]:.3e} max|ddk| "
                          f"{errs[1]:.3e} max|ddv| {errs[2]:.3e} (tol "
                          f"{tol_g:g}); launches {blocks} of each kernel")
                    if not bf:
                        worst["out"] = max(worst["out"], e_out)
                        worst["dq"] = max(worst["dq"], errs[0])
                        worst["dkv"] = max(worst["dkv"], *errs[1:])
    print(f"ring attention: {i} cases within the limits on {card}; worst "
          f"f32 {worst}")
    return worst


def _cli_child(argv: list[str]) -> None:
    """``chip_smoke.py --cli shakespeare|mnist [--deterministic] ARGS``:
    one CLI run in this process (under torchrun, or not), TF32 off as in
    the main run; prints CLI_MARK and a JSON object: the launches, the
    training steps and their loop's seconds, the world size (0 without a
    process group)."""
    import torch
    import torch.distributed as dist

    cli, args = argv[0], argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args and args[0] == "--deterministic":
        args = args[1:]
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    # No network: load_mnist must not try a torchvision download.
    sys.modules["torchvision"] = None
    if cli == "shakespeare":
        from tinydiffusionmodels_torch import shakespeare as module
    else:
        from tinydiffusionmodels_torch import mnist as module
    _reset_counts()
    result = module.main(args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    world = dist.get_world_size() if dist.is_initialized() else 0
    print(CLI_MARK + json.dumps({"counts": _counts(), "steps": result.steps,
                                 "seconds": result.seconds, "world": world}),
          flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def _start_cli(cli: str, argv: list, *, torchrun: bool, workdir: Path,
               log: Path, deterministic: bool = False,
               env: dict | None = None):
    """Start one ``_cli_child`` run as a subprocess, under ``python -m
    torch.distributed.run --standalone --nproc_per_node 1`` or not, its
    output into ``log``; (process, command, log)."""
    cmd = [sys.executable]
    if torchrun:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1"]
    cmd += [str(REPO / "chip_smoke.py"), "--cli", cli]
    cmd += (["--deterministic"] if deterministic else []) + list(argv)
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                              "MASTER_ADDR", "MASTER_PORT")}
    child_env.update(env or {})
    child_env["PYTHONPATH"] = str(REPO)
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=workdir, env=child_env, stdout=out,
                                stderr=subprocess.STDOUT, text=True)
    return proc, cmd, log


def _finish_cli(run, deadline: float) -> dict:
    """Wait for a ``_start_cli`` run (killed past ``deadline``); its JSON
    record."""
    proc, cmd, log = run
    try:
        proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    text = log.read_text()
    lines = [ln for ln in text.splitlines() if ln.startswith(CLI_MARK)]
    if proc.returncode or not lines:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                             f"{text[-4000:]}")
    return json.loads(lines[-1][len(CLI_MARK):])


def _checkpoint_diff(a: Path, b: Path) -> list:
    """The entries of two checkpoints that are not bit-equal."""
    import numpy as np

    from tinydiffusionmodels_torch.io import load_checkpoint

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for key, value in tree.items():
                yield from leaves(value, f"{prefix}{key}/")
        else:
            yield prefix.rstrip("/"), tree

    x, y = dict(leaves(load_checkpoint(a))), dict(leaves(load_checkpoint(b)))
    if x.keys() != y.keys():
        return sorted(set(x) ^ set(y))
    diff = []
    for key, value in x.items():
        other = y[key]
        if hasattr(value, "shape") or hasattr(other, "shape"):
            u, w = np.asarray(value), np.asarray(other)
            if u.dtype != w.dtype or u.shape != w.shape or not np.array_equal(
                    u, w):
                diff.append(key)
        elif value != other:
            diff.append(key)
    return diff


def torchrun_paths(card: str) -> list:
    """Phase 30: the CLIs under ``python -m torch.distributed.run
    --nproc_per_node 1`` (a real NCCL group of one: the gradient all-reduce
    is captured in every replayed chunk) against the same commands without
    torchrun (no group, no collective): the text CLI at the headline width
    (dim 256, depth 3, seq 64, bs 8, dropout 0.1) plain and with
    ``--seq_parallel`` (a ring of one), and the MNIST CLI under
    ``cudnn.deterministic``. The six runs share the card at once (their
    step times are phase 31's to measure). The checkpoints must be
    bit-equal and the launches as counted. Returns the launches of the
    runs (main paths)."""
    from tinydiffusionmodels_torch.data import (
        CharTokenizer,
        load_text_corpus,
        num_batches,
        tokenize_corpus,
    )
    from tinydiffusionmodels_torch.data.mnist import load_mnist

    phase("the CLIs under torchrun at world 1 (a NCCL group of one) against "
          "the same commands without torchrun")
    t0 = time.perf_counter()
    _prepare_workdir(TORCHRUN_CHARS)
    work = WORK / "torchrun"
    work.mkdir(parents=True, exist_ok=True)
    corpus, _ = load_text_corpus(WORK / "data")
    corpus = corpus[:TORCHRUN_CHARS]
    train_chunks, val_chunks = tokenize_corpus(corpus, CharTokenizer(corpus),
                                               SEQ, 0.1)
    steps = num_batches(len(train_chunks), BATCH)
    val_batches = num_batches(len(val_chunks), BATCH)
    text_env = {"TDM_PLATFORM": "cuda", "TDM_DATA_LIMIT": str(TORCHRUN_CHARS)}
    text_argv = ["--train", "--epochs", "1", "--batch_size", str(BATCH),
                 "--seq_len", str(SEQ), "--embed_dim", str(DIM), "--depth",
                 str(DEPTH), "--dropout", str(DROPOUT), "--model_id", "char",
                 "--use_learned_embeddings", "--data_root",
                 str(WORK / "data")]
    # The synthetic digits are rendered once here, so that the runs read
    # the cache (no download: torchvision is blocked in this process).
    mnist_data = WORK / "mnist" / "data"
    sys.modules["torchvision"] = None
    load_mnist(mnist_data)
    mnist_env = {"TDM_PLATFORM": "cuda",
                 "TDM_DATA_LIMIT": str(TORCHRUN_MNIST_IMAGES)}
    mnist_argv = ["--train", "--epochs", "1", "--batch_size",
                  str(MNIST_BATCH), "--no_epoch_samples", "--data_root",
                  str(mnist_data)]
    text_launches = {"flash_attention_fwd": (steps + val_batches) * DEPTH,
                     "flash_attention_bwd_dq": steps * DEPTH,
                     "flash_attention_bwd_dkv": steps * DEPTH}
    cases = (("text", "shakespeare", text_argv, text_env, False,
              text_launches),
             ("text --seq_parallel", "shakespeare",
              [*text_argv, "--seq_parallel"], text_env, False,
              text_launches),
             ("MNIST (cudnn.deterministic)", "mnist", mnist_argv, mnist_env,
              True, {"fused_resblock":
                     (TORCHRUN_MNIST_IMAGES // MNIST_BATCH) * 4}))
    started = {}
    for i, (what, cli, argv, env, det, _) in enumerate(cases):
        for torchrun in (True, False):
            name = f"case{i}_{'torchrun' if torchrun else 'plain'}"
            ckpt = work / f"{name}.pth"
            for old in (ckpt, work / f"{name}_best.pth"):
                old.unlink(missing_ok=True)
            started[i, torchrun] = ckpt, _start_cli(
                cli, [*argv, "--ckpt", str(ckpt)], torchrun=torchrun,
                workdir=work, log=work / f"{name}.log", env=env,
                deterministic=det)
    deadline = time.monotonic() + TORCHRUN_TIMEOUT_S
    records = {key: _finish_cli(run, deadline)
               for key, (_, run) in started.items()}
    runs = []
    for i, (what, cli, _, _, _, expect) in enumerate(cases):
        for torchrun in (True, False):
            rec = records[i, torchrun]
            if rec["world"] != (1 if torchrun else 0):
                raise AssertionError(f"{what}: world {rec['world']} "
                                     f"({'with' if torchrun else 'without'} "
                                     "torchrun)")
            counts = {k: v for k, v in rec["counts"].items() if v}
            if counts != expect:
                raise AssertionError(f"{what}: launches {counts}, expected "
                                     f"{expect}")
            runs.append(rec["counts"])
        a, b = started[i, True][0], started[i, False][0]
        diff = _checkpoint_diff(a, b)
        if cli == "shakespeare":
            diff += [f"best: {k}" for k in _checkpoint_diff(
                *(Path(str(c).replace(".pth", "_best.pth")) for c in (a, b)))]
        if diff:
            raise AssertionError(f"{what}: the torchrun checkpoint differs "
                                 f"from the plain one in {diff[:8]}")
        print(f"{what}: checkpoints bit-equal with and without torchrun "
              f"(a NCCL group of one); launches {expect} each; "
              f"{records[i, True]['steps']} steps")
    print(f"phase: {time.perf_counter() - t0:.1f} s for the six runs, on "
          f"{card}")
    return runs


def replayed_step_with_group(card: str) -> dict:
    """Phase 31: the replayed text step at the headline shape with a world-1
    NCCL process group (its gradient and loss all-reduce captured in the
    chunk) and without one, from one seed: bit-equal losses and parameters,
    then the wall per replayed step over GROUP_WALL_STEPS steps, alternately
    (A B A B), and torch.profiler's device time of the NCCL kernel per
    step. The group is destroyed at the end."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch.parallel import make_mesh

    phase("the replayed text step with a world-1 NCCL group and without "
          "one")
    WORK.mkdir(parents=True, exist_ok=True)
    store = WORK / "nccl_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh()
        steps = 3 + 2 * GROUP_WALL_STEPS + PROFILE_TRAIN_STEPS
        modes = {"no group": _text_runner(steps=steps),
                 "NCCL group of 1": _text_runner(steps=steps, mesh=mesh)}
        first = {m: torch.as_tensor(r.run(3)) for m, (r, _) in modes.items()}
        torch.cuda.synchronize()
        (ra, ta), (rb, tb) = modes.values()
        same = torch.equal(*first.values()) and all(
            torch.equal(ta[k], tb[k]) for k in ta)
        if not same:
            raise AssertionError("the step with the group differs from the "
                                 "step without it")
        walls = {m: [] for m in modes}
        for _ in range(2):
            for m, (runner, _) in modes.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runner.run(GROUP_WALL_STEPS)
                torch.cuda.synchronize()
                walls[m].append(1e6 * (time.perf_counter() - t0)
                                / GROUP_WALL_STEPS)
        runner, _ = modes["NCCL group of 1"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runner.run(PROFILE_TRAIN_STEPS)
            torch.cuda.synchronize()
        nccl_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and "nccl" in e.key.lower()) / PROFILE_TRAIN_STEPS
        names = sorted({e.key for e in prof.key_averages()
                        if "nccl" in e.key.lower()})
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    best = {m: min(w) for m, w in walls.items()}
    ratio = best["NCCL group of 1"] / best["no group"]
    print(f"replayed text step (bs {BATCH}, dim {DIM}, depth {DEPTH}, f32): "
          f"3 steps bit-equal with and without the group; wall per step over "
          f"{GROUP_WALL_STEPS} steps, two rounds each: {walls} us; best "
          f"{best}, ratio {ratio:.4f}; NCCL kernels {names}: {nccl_us:.2f} "
          f"us of device time per step; on {card}")
    return {"wall_us": walls, "ratio": ratio, "nccl_us": nccl_us}


def main() -> None:
    import torch

    t_start = time.perf_counter()
    card = environment()
    build()
    fwd_errors = kernel_vs_plain()
    train_errors, mask_mismatches = training_kernels()
    resblock_error, resblock_bf16_error = resblock_kernel_vs_plain()
    single_block_errors = single_block_kernel_vs_plain()
    result, ckpt, train_counts, _ = main_path_train(card)
    model = result.joint["diffusion_model"].eval()
    sample_counts, _, z = main_path_sample(card, ckpt, model)
    _, narrow_ckpt, narrow_train_counts, _ = main_path_train(
        card, NARROW_DIM, NARROW_CHARS, NARROW_TRAIN_ARGS, "narrow_ckpt")
    narrow_sample_counts = main_path_sample_ddim(card, narrow_ckpt,
                                                 NARROW_DIM)
    _, wide_ckpt, wide_train_counts, _ = main_path_train(
        card, WIDE_DIM, NARROW_CHARS, WIDE_TRAIN_ARGS, "wide_ckpt",
        WIDE_DEPTH)
    wide_sample_counts = main_path_sample_ddim(card, wide_ckpt, WIDE_DIM,
                                               WIDE_DEPTH)
    _, gemma_ckpt, gemma_train_counts, _ = main_path_train(
        card, GEMMA_DIM, NARROW_CHARS, GEMMA_TRAIN_ARGS, "gemma_width_ckpt")
    gemma_sample_counts = main_path_sample_ddim(card, gemma_ckpt, GEMMA_DIM)
    decode_worst_gap, decode_stats = decode_kernel_vs_plain()
    guided_counts, lm_ckpt = main_path_guided(card, ckpt)
    exact_counts, rounds, agree, exact_gap, exact_stats = guided_exact(
        card, lm_ckpt, ckpt, z, result.joint["rounding_fn"].eval())
    jacobi = jacobi_rounds_on_card(card, lm_ckpt)
    _, mnist_ckpt, mnist_train_counts, _ = main_path_mnist_train(card)
    mnist_sample_counts, _, unet = main_path_mnist_sample(card, mnist_ckpt)
    bench_counts, _, bench_seconds = main_path_kernel_bench(card)
    bf16_text_counts, bf16_mnist_counts = main_path_bf16_train(card)
    bf16_step_vs_cpu(card)
    graph_runners = replay_vs_eager_training()
    sampler_models = _sampler_models()
    replay_vs_eager_samplers(sampler_models)
    kernels_in_graphs(graph_runners, sampler_models)
    del graph_runners
    decoder_rows, decoder_counts = guided_decoder_replay(card)
    ring_errors = ring_on_card(card)
    torchrun_counts = torchrun_paths(card)
    replayed_step_with_group(card)
    device_vs_cpu(model)
    timings = kernel_timing(card)
    decode_times = decode_timing(card)
    resblock_times = resblock_timing(card)
    timings.update(single_block_timing(card))
    bf16 = "bf16"
    rows = {f"text train bs {BATCH} f32": profile_training(card),
            f"text sampler n {N}": profile_sampler(model, card),
            f"MNIST sampler n {MNIST_N}": profile_mnist_sampler(unet, card),
            f"MNIST train bs {MNIST_BATCH} f32": profile_mnist_training(card),
            # The bench's bf16 training shapes (batch 512).
            f"text train bs {BF16_BATCH} bf16 (vocab {GRAPH_VOCAB})":
                profile_training(card, BF16_BATCH, bf16),
            f"MNIST train bs {BF16_BATCH} bf16":
                profile_mnist_training(card, BF16_BATCH, bf16)}
    print(f"\nsteps eager and replayed, on {card}:")
    print("step | mode | wall us | device us | busy | kernels")
    for what, modes in rows.items():
        for mode, r in modes.items():
            print(f"{what} | {mode} | {r['wall_us']:.1f} | "
                  f"{r['device_us']:.1f} | {r['busy']:.3f} | "
                  f"{r['kernels']:.1f}")
    suite_counts = main_path_bench(card)
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
              "fused_resblock": resblock_error,
              "attention_single_block_fwd": single_block_errors["fwd"],
              "attention_single_block_bwd": single_block_errors["bwd"]}
    bs8, bs256 = (decode_times[b] for b in DECODE_BATCHES)
    timings["guided_decode"] = {
        **{k: bs8[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "fp32_fma_roof_ms")},
        "at": "bs 8",
        "bs256": {k: v for k, v in bs256.items()
                  if k not in ("grid", "units", "barriers")},
        "barrier_share_bs8": bs8["barrier_share"],
        "bs8": {k: bs8[k] for k in ("barrier_ms", "phase_us")},
        # from decode_kernel.plan and barriers(), not measured
        **{f"{name}_plan": {k: t[k] for k in ("grid", "units", "barriers")}
           for name, t in (("bs8", bs8), ("bs256", bs256))},
        "jacobi_rounds_main_path": rounds, "agreement_with_plain": agree,
        "jacobi_rounds_tool": jacobi, "decoder": decoder_rows,
        "vs_plain": decode_stats, "vs_plain_main_path": exact_stats,
    }
    n25, n128 = (resblock_times[b] for b in (MNIST_N, MNIST_BATCH))
    sums = ("ms", "plain_ms", "bound_ms", "fp32_fma_roof_ms")
    timings["fused_resblock"] = {
        **{k: n25[k] for k in (*sums, "bound_by")}, "library_ms": None,
        "at": "sum of the four blocks of one UNet forward, n 25, f32",
        "cudnn_kernels_ms": n25["library_ms"],
        "n128": {k: n128[k] for k in (*sums, "bound_by", "library_ms")},
        "bf16_n25": n25["bf16"], "bf16_n128": n128["bf16"],
        "blocks_n25": n25["blocks"], "blocks_n128": n128["blocks"],
        "plain": "cuDNN convs, TF32 off; no single PyTorch call computes "
                 "the block, so library_ms is null and cudnn_kernels_ms "
                 "is the plain version's kernels' profiler time",
        "max_abs_err_bf16": resblock_bf16_error,
    }
    paths = (train_counts, sample_counts, narrow_train_counts,
             narrow_sample_counts, wide_train_counts, wide_sample_counts,
             gemma_train_counts, gemma_sample_counts, guided_counts,
             exact_counts, decoder_counts,
             mnist_train_counts, *mnist_sample_counts, bench_counts,
             bf16_text_counts, bf16_mnist_counts, suite_counts,
             *torchrun_counts)
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
            entry["ring_max_abs_err_f32"] = ring_errors[
                {"flash_attention_fwd": "out", "flash_attention_bwd_dq": "dq",
                 "flash_attention_bwd_dkv": "dkv"}[name]]
            entry["dropout_hash"] = {"source": DROPOUT_HASH[0],
                                     "replaces": DROPOUT_HASH[1],
                                     "mask_mismatches": mask_mismatches}
        record.append(entry)
    print(f"command time {time.perf_counter() - t_start:.1f} s, of which the "
          f"kernel bench {bench_seconds:.1f} s")
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli"]:
        _cli_child(sys.argv[2:])
    else:
        main()
