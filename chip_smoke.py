#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Runs from the root of a checkout, imports nothing of jax and nothing of the
JAX package (only ``tinydiffusionmodels_torch``), and fails (exit code != 0,
no result line) on any error; no phase catches its own failure.

1. Environment: the card's name and power limit (nvidia-smi), the torch,
   CUDA, nvcc and transformers versions. Fails when CUDA is not available.
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
   Dh 264 with Dv 320, causal, f32 and bf16. And the Gemma base LM's
   operands as ``models.gemma`` lays them out (phase 32), f32 and bf16: a
   decode position's folded MQA view (B 10, Gemma-2B's 8 query heads as
   the 8 rows of its one KV head, Dh 256) against cache prefixes of Lk 1,
   2, 17, 64 and 65, and the causal forward (B 2, L 64) with k and v
   expanded over the 8 heads at head stride 0.
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
   TRAIN_CHARS characters. Asserts forward launches = (training +
   validation batches + 1, the validation graph's prime) x depth, dq and
   dkv launches = training steps x depth, finite losses, a lower mean
   loss over the last 50 steps than over the first 50, and the
   checkpoints written. Prints training steps/s.
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
   (``scaled_dot_product_attention`` at dropout 0: the forward, and the
   backward for dq and dk/dv; CUDA events over replays of a graph of 20
   calls, as its eager calls can be host-bound), which must be no less
   than the bound (bytes
   over 3.35 TB/s or the products as 3xTF32, three TF32 products at 495
   TFLOP/s each, the larger), with the FP32-FMA roof (the FLOPs at 67
   TFLOP/s) printed beside it. Then the forward alone at the Gemma decode
   shape (B 10, 8 rows on 1 KV head, Lk 64, Dh 256, f32) beside its plain
   version, SDPA's time on the same views and the bound. At the training
   shape SDPA's forward and backward are also read by torch.profiler (the
   launches it recorded, and their time over the calls) and by eager CUDA
   events, printed beside the replayed graph's time, not asserted.
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
   off) and the bound (the products as 3xTF32 in f32 or at the bf16
   peak, against bytes at 3.35 TB/s; the FP32-FMA roof printed beside; no
   single PyTorch call computes the block), and their sums over a UNet forward; then
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
   backward; a replayed graph, as phase 11's) and the bound (bytes over 3.35 TB/s or the products as 3xTF32, the backward's
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
   training graph (the second of two) must list the flash
   forward, dq and dk/dv kernels, the resblock kernel and the draw kernel
   as many times as the capture counted; over a second call of a
   captured 10-step sampler loop (ten replays), ten steps' worth. Where
   the profiler lists no kernel of a replay, that is printed, and the
   counters' deltas are the evidence.
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
   15's, the draws as ``_text_train_draws`` counts them (MNIST: the init,
   then t and noise a step in one). The six runs share the card at once. Their launches
   count with the main paths'.
31. The replayed text step (headline shape, f32) with a world-1 NCCL group
   created in this process and without one, from one seed: bit-equal
   after 3 steps, then the wall per replayed step over GROUP_WALL_STEPS
   steps, two rounds each alternately, and torch.profiler's device time of
   the NCCL kernel per step, beside the card's name and power limit.

The Gemma base LM (after phase 27).

32. The guided decode with a Gemma-2B base LM: HF ``google/gemma-2b``'s
   published widths (vocab 256000, hidden 2048, 18 layers, 8 heads on 1
   KV head of 256, intermediate 16384, rope theta 10000, rms eps 1e-6),
   every weight N(0, 0.02) drawn on the card from a seed, f32 (10.0 GB;
   the real weights are not on the card machine), n 10 (the CLI's
   ``--n`` default), seq 64, alpha 0.3. A
   width-2048 denoiser samples the embeddings by DDIM 10 and a random
   rounding head over the 256 000 tokens gives the (10, 64, 256000)
   diffusion logits, all through the text CLI's own
   ``shakespeare.guided_decode``, whose ``GuidedDecoder`` replays the
   64-position scan as one CUDA graph. Asserts: flash-forward launches =
   18 x (64 + 1 prime) for the decode (30 for the sampler), no other
   kernel, 10 sample files, the tokens bit-equal to the eager
   ``guided_generate_scan`` on the same logits (a second decoder's replay
   too); then the module at depth 2 (the same widths) on the card against
   the CPU, one 16-token causal forward and 4 decode positions, logits
   within 1e-3 (TF32 off). Prints the replayed ms a decode and a position,
   tokens/s, the eager ms, the bound (the 10.02 GB of f32 weights read
   once a position at 3.35 TB/s: 2.99 ms, 191 ms a decode, 3.34k tokens/s
   at n 10), and the busy share and top kernels of one replay from
   torch.profiler. Its launches count with the main paths'.
33. The text CLI's Hugging Face route: ``shakespeare.main(["--train",
   "--guided_sample", "--base_lm", "hf", ...])`` with ``_load_hf`` stubbed
   to return a stand-in tokenizer over Gemma's 256 000 ids, the embedding
   matrix and a random HF ``GemmaForCausalLM`` (transformers' own module,
   Gemma-2B widths at depth 2, on the host as a checkpoint loads). The CLI
   trains a width-2048 denoiser of depth 1 for one epoch of 8000
   characters on the pretrained embeddings, samples by DDIM 10, converts
   the HF weights to the port's Gemma on the card and decodes n 10 at seq
   64. Asserts the launches, 10 sample files of the tokens' texts, the
   tokens bit-equal to the eager scan of the converted Gemma on the
   diffusion logits the CLI computed, and that Gemma against HF's module
   on the card (a 16-token causal forward, 4 decode positions) within
   1e-3 (TF32 off). Needs transformers. Its launches count with the main
   paths'.

Resume and the fidelity tools (after the bench, phase c).

34. ``--resume`` on the card, a ``SIGKILL`` drill of each CLI as a
   subprocess, the two drills side by side: (a) the uninterrupted run,
   (b) the same command killed as soon as its ``_state.pth`` lands
   (during epoch 2; the file must say epoch 1), (c) the command again,
   which must log ``[resume] restored epoch 1`` and finish. The text CLI
   at the headline width (bs 8, seq 64, dim 256, depth 3, dropout 0.1,
   f32, ``--ema_decay 0.999``) for two epochs of TRAIN_CHARS characters:
   (c)'s final and best checkpoints and last resume file bit-equal to
   (a)'s, and its epoch-2 record equal but for the rate, through the
   replayed graphs, the validation graph included (captured in (c) after
   the restore). The MNIST CLI (bs 128, two epochs of the 60 000 digits,
   ``--ema_decay 0.99``) likewise, under ``cudnn.deterministic``. Prints
   the restore time (reading the file and copying it into a trainer's
   tensors on the card, in this process) and the replayed epochs' it/s
   before and after the restart (each drill's with the other running
   beside it). (a)'s and (c)'s launches count with the main paths'.
35. The fidelity tools on the card: ``python -m tinydiffusionmodels_torch.
   fidelity`` (its ``main``) on phase 34's MNIST checkpoint, n 256, DDIM
   50, f32 and bf16 (200 resblock launches each), then bf16 again with
   the UNet's blocks through their plain version (the witness that tells
   the kernel's bf16 from bf16 rounding; no launch). Every run's samples
   must hold all ten classes, and the f32 run's FID must lie within
   FID_FLOOR_MULTIPLE (10) times the real digits' floor. Then ``python -m
   tinydiffusionmodels_torch.text_fidelity`` on phase 5's checkpoint and
   phase 8's TinyGPT, n 16, ``pure`` and ``guided`` (the 1000-step sampler
   and the TinyGPT judge on the flash forward). Asserts the JAX tools'
   JSON keys, finite values and the synthetic digits and built-in corpus,
   and prints the JSON lines. Their launches count with the main paths'.

The modules ported last (the validation graph, tensor parallelism, the
op table tool), in main()'s order among the phases above:

36. (after phase 4) The three flash kernels on a slice of a layer's heads,
   as a tensor-parallel rank runs them: heads 0-1 and 2-3 of 4 at the
   training shape (B 8, L 64, Dh 64, the rank's own fused QKV tensor),
   dropout 0.1, f32 and bf16, against the plain version of the whole
   layer sliced (O and lse at phase 3's limits, dq, dk, dv at phase 4's);
   the realised masks (v = I, dO = I) bit-equal to ``dropout_scale`` at
   the layer's heads b * 4 + h0 + h; offset 0 of the layer's 4 heads
   bit-equal to the call without an offset.
37. (after phase 6) The validation pass as one CUDA graph
   (``text_train.EvalPass``) at the headline width on phase 5's
   validation batches, for phase 5's weights and an EMA-like second set:
   replayed against eager against the plain loop (``eval_losses``), bit
   for bit, over VALIDATION_EPOCHS epochs, each its own validation key in
   one device buffer; the launches (depth a batch, the prime's depth
   once; one draw launch a batch); the wall time of a pass both ways. Its
   replays count with the main paths'.
38. (after phase 31) Tensor parallelism on the card: two processes
   (``chip_smoke.py --tp RANK STORE``) joined by gloo on the one H100
   (NCCL refuses two ranks on one card), a 'model' axis of 2, the
   headline text step (``dryrun.text_step``) against the same step in one
   process within 1e-5, each rank's flash launches on its head slice.
   Its launches count with the main paths'.
39. (after the bench, phase c) ``python -m tinydiffusionmodels_torch.
   xprof_ops`` in a fresh process: the per-op tables of the headline text
   step and of the bf16 MNIST step at bs 512 and 2048, and
   its coverage asserted: the kernels recorded a replay at least 0.99 of
   the replay's launches and no more than all of them (the graph's kernel
   nodes, and the two generator fills ``CUDAGraph.replay`` launches
   outside it for each registered generator), the profiled device time no
   more than 1.05 x the CUDA event time.

The key tree (``core/rng.py``) and its draw kernel (``csrc/rng.cu``):

40. (after phase 36) The three flash kernels on a data-parallel rank's
   rows: rows 0-3 and 4-7 of a batch of 8 at ``batch_offset`` 0 and 4
   (B 8, L 64, Dh 64), dropout 0.1, f32 and bf16, against the plain
   version of the whole batch sliced (phase 36's limits); offset 0
   bit-equal to the call without one; the realised masks at offsets 0
   and 6 bit-equal to ``dropout_scale`` at the global rows.
41. (after phase 40) The draw kernel against ``core/rng.py``'s plain
   versions run on the card, from a key path with a device counter (the
   train key, step 12345 on the device, the step's substreams): the text
   step's noise (8 x 64 x 256; whole, rows 4-7, positions 32-63) and the
   MNIST step's (128 x 28 x 28), stock and counter normals within
   RNG_ULPS float32 spacings; the timesteps (B 8 and 128), three layers'
   attention seeds and an initialiser's uniform (2048 x 2048) bit-equal;
   the bf16 bs-512 step's FFN dropout (512 x 64 x 2048, and columns
   1024-2047), stock and counter masks, f32 and bf16, forward and
   backward bit-equal; every kind on RNG_RAGGED's boxes (1001 elements,
   an odd unaligned innermost run, a 3-D box) and the masks on unaligned
   inputs; a text step's t, noise and seeds as one list launch; the
   card's init of the width-2048 text denoiser (with its embedding and
   rounding head) and of the UNet against the plain init on the card,
   one launch a model. Then CUDA-event times beside the earlier design's
   (PERF.md §6 row 8), the plain
   version, torch's own draw of the shape (another stream: not the same
   function, so ``library_ms`` is null) and the bound (bytes at 3.35
   TB/s, or a stock draw's threefry integer operations at the INT32
   pipes' rate, the larger). Every main path's draw launches are counted
   (``rng_draw``), and the text and MNIST training and sampling paths
   assert theirs: a CLI's initialisation one a model (text 3, MNIST 1;
   a text ``--sample`` draws the embedding table), a text step 1 + 2 (1
   + 3 depth), a validation batch 1, a sampler x_T 1 and an ancestral
   step 1, an MNIST step 1. Since the draws moved to the key tree no
   graph registers a generator, so phase 39 counts no fills.

The peaks, the bound and the timer are ``tinydiffusionmodels_torch.perf``'s.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``; before them, the command's time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.metadata
import json
import math
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

# The Gemma base LM (phase 32): HF google/gemma-2b's config.json, its
# published widths; the CLI's --n default; DDIM steps of the width-2048
# denoiser that samples the guided embeddings; timed replayed decodes a
# round. The module against the CPU: GEMMA_CPU_DEPTH layers at these widths,
# GEMMA_CPU_POSITIONS decode positions and a GEMMA_CPU_L-token causal
# forward, logits within GEMMA_CPU_TOL (TF32 off; sums in another order).
GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, num_layers=18,
                num_heads=8, num_kv_heads=1, head_dim=256,
                intermediate_size=16384, rope_theta=10000.0, rms_eps=1e-6)
GEMMA_N, GEMMA_DDIM_STEPS, GEMMA_RUNS = 10, 10, 5
GEMMA_CPU_DEPTH, GEMMA_CPU_POSITIONS, GEMMA_CPU_L = 2, 4, 16
GEMMA_CPU_TOL = 1e-3
# The CLI's HF route (phase 33): characters of its one training epoch.
HF_CLI_CHARS = 8000
# The flash forward at the Gemma shapes (phase 3): a decode position's
# folded MQA view against cache prefixes of these lengths.
GEMMA_DECODE_LK = (1, 2, 17, 64, 65)

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
# The draws have no Pallas kernel: the JAX package's are XLA code
# (core/rng.py's counter draws from :35 on, and jax.random).
KERNELS["rng_draw"] = (_CSRC + "rng.cu", "tinydiffusionmodels_tpu/core/rng.py:35")
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


_START = time.monotonic()


def phase(name: str) -> None:
    """A phase's header, with the seconds since the script started."""
    print(f"\n== {name} (at {time.monotonic() - _START:.1f} s)", flush=True)


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
    try:   # phase 33 imports it and fails without it
        hf = importlib.metadata.version("transformers")
    except importlib.metadata.PackageNotFoundError:
        hf = "not installed"
    print(f"transformers: {hf}")
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
        errors[name] = _forward_vs_plain(name, q, k, v, causal=causal,
                                         layout=layout, k_offset=k_off)
    # The Gemma base LM's operands as models/gemma.py lays them out.
    for dtype in (f32, bf16):
        for name, (q, k, v, causal) in _gemma_attention_cases(
                dtype, 97).items():
            name = f"{name}_{str(dtype)[6:]}"
            errors[name] = _forward_vs_plain(name, q, k, v, causal=causal,
                                             layout="blhd")
    return errors


def _forward_vs_plain(name: str, q, k, v, **kw) -> float:
    """The forward kernel against its plain version on (q, k, v) with
    ``attention``'s keyword arguments: O and lse within phase 3's limits
    (f32 1e-4; bf16 2e-2 on O, 1e-2 on lse). Returns max |dO|."""
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    ref_out, ref_lse = reference.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    bf16 = q.dtype == torch.bfloat16
    tol_o = 2e-2 if bf16 else 1e-4
    tol_l = 1e-2 if bf16 else 1e-4
    torch.testing.assert_close(out, ref_out, atol=tol_o, rtol=tol_o)
    torch.testing.assert_close(lse, ref_lse, atol=tol_l, rtol=tol_l)
    err = _max_err(out, ref_out)
    print(f"{name:20s} max|dO| {err:.3e} (tol {tol_o:g})  "
          f"max|dlse| {_max_err(lse, ref_lse):.3e} (tol {tol_l:g})")
    return err


def _gemma_attention_cases(dtype, seed: int) -> dict:
    """name: (q, k, v, causal) of the flash forward on the Gemma-2B head
    layout (8 query heads on 1 KV head, Dh 256), built as ``models.gemma``
    builds them: a decode position's folded view (B GEMMA_N; the 8 query
    heads as the 8 rows of the KV head, a transposed view of the q
    projection) against cache prefixes of GEMMA_DECODE_LK keys, strided
    slices of one (B, 65, 1, Dh) cache; and the causal forward (B 2, L 64)
    with k and v expanded over the 8 heads at head stride 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    h, kv, dh = (GEMMA_2B[k] for k in ("num_heads", "num_kv_heads",
                                        "head_dim"))

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cache_k, cache_v = (randn(GEMMA_N, max(GEMMA_DECODE_LK), kv, dh)
                        for _ in range(2))
    q = randn(GEMMA_N, 1, h * dh).reshape(GEMMA_N, kv, h // kv, dh)
    q = q.transpose(1, 2)
    cases = {f"gemma_decode_Lk{lk}": (q, cache_k[:, :lk], cache_v[:, :lk],
                                      False) for lk in GEMMA_DECODE_LK}
    b, l = 2, SEQ
    k, v = (randn(b, l, kv, dh)[:, :, :, None].expand(b, l, kv, h // kv, dh)
            .reshape(b, l, h, dh) for _ in range(2))
    if k.stride(2) != 0:
        raise AssertionError(f"expanded k has strides {k.stride()}")
    cases["gemma_causal_stride0"] = (randn(b, l, h, dh), k, v, True)
    return cases


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
    return TinyGPT(cfg, key=_init_key(seed), device="cuda").eval()


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
    from tinydiffusionmodels_torch.ops import rng
    from tinydiffusionmodels_torch.ops import single_block as sb

    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    dk.launches = rb.launches = sb.launches = sb.bwd_launches = 0
    rng.launches = 0


def _counts() -> dict:
    from tinydiffusionmodels_torch.ops import decode_kernel as dk
    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import resblock as rb
    from tinydiffusionmodels_torch.ops import rng
    from tinydiffusionmodels_torch.ops import single_block as sb

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "guided_decode": dk.launches,
            "fused_resblock": rb.launches,
            "attention_single_block_fwd": sb.launches,
            "attention_single_block_bwd": sb.bwd_launches,
            "rng_draw": rng.launches}


def _others(counts: dict) -> dict:
    """The launch counts without the random draws' (which the main paths'
    own checks count: ``_text_train_draws`` and the sampler's)."""
    return {k: v for k, v in counts.items() if k != "rng_draw"}


# Draw launches of a model's initialisation: one for all its weights.
# The text CLI draws the embedding table, the denoiser and the rounding
# head (the embedding also when it only samples, as the JAX CLI does);
# the MNIST CLI its UNet.
TEXT_INIT_DRAWS, MNIST_INIT_DRAWS = 3, 1


def _text_train_draws(steps: int, depth: int, val_batches: int) -> int:
    """Draw launches of a text CLI's training run of ``steps`` steps and a
    validation pass of ``val_batches``: the initialisation; each step's t,
    noise and the layers' attention seeds in one launch, the input mask
    and the three masks of each layer, and the backward's launch of every
    mask; each validation batch's t and noise in one."""
    return (TEXT_INIT_DRAWS + steps * (1 + 2 * (1 + 3 * depth))
            + val_batches)


def _check_draws(counts: dict, want: int, what: str) -> None:
    if counts["rng_draw"] != want:
        raise AssertionError(f"{counts['rng_draw']} draw launches on {what}, "
                             f"expected {want}")


def _key(seed: int):
    """``PRNGKey(seed)`` (the port's ``core.rng``) on the card."""
    from tinydiffusionmodels_torch.core import rng

    return rng.prng_key(seed).cuda()


def _init_key(seed: int, name: str | None = None):
    """A model's initialisation key on the host: ``PRNGKey(seed)``, or its
    substream ``name`` (the CLIs' "diffusion", "rounding", "embedding")."""
    from tinydiffusionmodels_torch.core import rng

    key = rng.prng_key(seed)
    return key if name is None else rng.substream(key, name)


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

    # + 1: the validation graph's prime, one batch's forward.
    expect = {"flash_attention_fwd": (steps + val_batches + 1) * depth,
              "flash_attention_bwd_dq": steps * depth,
              "flash_attention_bwd_dkv": steps * depth, "guided_decode": 0,
              "fused_resblock": 0, **_SINGLE_BLOCK_IDLE}
    if _others(counts) != expect:
        raise AssertionError(f"launches {counts} on the training path, "
                             f"expected {expect}")
    _check_draws(counts, _text_train_draws(steps, depth, val_batches),
                 "the training path")
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
    if _others(counts) != expect:
        raise AssertionError(f"launches {counts} on the sampling path, "
                             f"expected {expect}")
    # The embedding table, x_T, each step.
    _check_draws(counts, 1 + 1 + STEPS, "the sampling path")
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
    times = []
    for run in range(RATE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_diffusion_embeddings(model, sched, n=N, seq_len=SEQ,
                                    embed_dim=DIM, key=_key(1 + run))
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
    if _others(counts) != expect:
        raise AssertionError(f"launches {counts} on the dim-{dim} sampling "
                             f"path, expected {expect}")
    # The embedding table and x_T.
    _check_draws(counts, 1 + 1, f"the dim-{dim} DDIM path")
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
        if _others(counts) != expect:
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
    if _others(counts) != expect:
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


_LIBRARY_STREAM = []


def _library_stream():
    """The side stream that ``_graph_device_ms`` captures on (one per
    process). A library call's autograd graph is built on it, as a
    backward runs on its forward's stream."""
    import torch

    if not _LIBRARY_STREAM:
        _LIBRARY_STREAM.append(torch.cuda.Stream())
    return _LIBRARY_STREAM[0]


def _graph_device_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time in ms of one call of ``fn``: ``calls`` calls captured
    into one CUDA graph on ``_library_stream()`` (after 3 calls there to
    warm up), replayed ``reps`` times behind a sleep kernel between CUDA
    events. For a PyTorch call, whose burst of eager calls can be bound by
    the host (its autograd, its allocator) rather than by the device: a
    replay runs no host code and allocates nothing. torch.profiler is no
    timer here: on the card it records 16-18 of 20 calls' kernels."""
    import torch

    stream = _library_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps / calls


def _timer_cross_check(fn, what: str, card: str, calls: int = 20) -> None:
    """Prints what three timers make of ``fn``: torch.profiler over
    ``calls`` calls (the kernels it recorded, against ``calls``, and their
    device time over ``calls``), eager CUDA events (``perf.device_ms``) and
    a replayed graph (``_graph_device_ms``). Not asserted: it shows why a
    library call is timed by a replayed graph."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch import perf

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = _kernel_events(prof)
    counts = sorted({e.count for e in kernels})
    summed = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    print(f"timers on {what}: torch.profiler recorded {counts} launches of "
          f"each of its {len(kernels)} kernels in {calls} calls, {summed} ms "
          f"a call by its sum; eager CUDA events {perf.device_ms(fn)} ms; a "
          f"replayed graph {_graph_device_ms(fn)} ms; on {card}")


def kernel_timing(card: str) -> dict:
    """The three flash kernels at TIMING_SHAPES on the model's operands
    (strided views of one QKV projection, f32, dropout 0.1): CUDA-event
    device times in turns within this call (plain, kernel, kernel, plain),
    beside the device time of PyTorch's fused attention
    (``scaled_dot_product_attention`` at dropout 0: the forward for the
    forward kernel, the backward for dq and dk/dv, which together compute
    what that backward does; CUDA events over a replayed graph of its
    calls) and the bound (3xTF32 products, or bytes). Returns per kernel the
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
        _library_stream().wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(_library_stream()):
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
            runs, work, card, "dropout 0, a replayed graph", at=at,
            iters=iters)
        if (b, l, d) == TIMING_SHAPES[0]:
            _timer_cross_check(sdpa_fwd, "SDPA forward", card)
            _timer_cross_check(sdpa_bwd, "SDPA backward", card)
        del plain_out, sdpa_out
    timings = {name: dict(row, shapes={
        f"B{b} L{l} Dh{d}": out[(b, l, d)][name]
        for b, l, d in TIMING_SHAPES[1:]})
        for name, row in out[TIMING_SHAPES[0]].items()}
    timings["flash_attention_fwd"]["shapes"].update(_gemma_decode_timing(card))
    return timings


def _gemma_decode_timing(card: str) -> dict:
    """The forward kernel at the Gemma-2B decode shape (phase 32's every
    layer and position: B GEMMA_N, the 8 query heads folded into 8 rows of
    the one KV head, Lk 64, Dh 256, f32): CUDA-event times beside its plain
    version, ``scaled_dot_product_attention``'s (a replayed graph) on the
    same (bhld-strided) views, and the bound."""
    import torch
    import torch.nn.functional as F

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    q, k, v, _ = _gemma_attention_cases(torch.float32, 13)["gemma_decode_Lk64"]
    params = dict(causal=False, layout="blhd", q_offset=0, k_offset=0,
                  dropout_rate=0.0, dropout_seed=None)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def plain():
        with torch.no_grad():
            reference.attention(q, k, v, layout="blhd")

    def sdpa():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt)

    at = (f"Gemma decode: B {GEMMA_N}, {tuple(q.shape)[1]} rows on 1 KV "
          f"head, Lk {k.shape[1]}, Dh {q.shape[-1]}, f32")
    print(f"-- {at}")
    row = _time_against_plain(
        {"flash_attention_fwd": (lambda: fa.forward(q, k, v, **params),
                                 plain, sdpa, "SDPA forward")},
        {"flash_attention_fwd": fa.work("fwd", q, k, v, **params)}, card,
        "a replayed graph", at=at)["flash_attention_fwd"]
    return {f"Gemma decode B{GEMMA_N} rows8 Lk64 Dh256": row}


def _time_against_plain(runs: dict, work: dict, card: str, library_note: str,
                        iters: int = 200, **extra) -> dict:
    """For each name: (kernel, plain version, library yardstick, its label)
    of ``runs``, device times in turns within this call (plain, kernel,
    kernel, plain: CUDA events over ``iters`` calls), then the library's
    (``_graph_device_ms``; no less than the bound), and the bound of
    ``work[name]`` = (bytes read once and written once, f32 product FLOPs):
    the FLOPs as 3xTF32 on the tensor cores, the least time for an f32
    product on the card. Returns per name ms, plain_ms, library_ms, bound_ms,
    bound_by, fp32_fma_roof_ms (the FLOPs at the FP32-FMA rate) and
    ``extra``."""
    from tinydiffusionmodels_torch import perf

    timings = {}
    for name, (kernel, plain, library, lib_name) in runs.items():
        p_ms = [perf.device_ms(plain, iters)]
        k_ms = [perf.device_ms(kernel, iters), perf.device_ms(kernel, iters)]
        p_ms.append(perf.device_ms(plain, iters))
        nbytes, flops = work[name]
        bound_ms, bound_by = perf.bound_ms(nbytes,
                                           perf.f32_tensor_core_ops(flops))
        lib_ms = _graph_device_ms(library)
        if not lib_ms >= bound_ms:
            raise AssertionError(f"{lib_name}: {lib_ms} ms, under the bound "
                                 f"{bound_ms} ms")
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
    rows = {}
    for mode in ("eager", "replayed"):
        def loop(steps):
            with torch.inference_mode():
                sample_loop(model, make_schedule(steps, device="cuda"), shape,
                            key=_key(3), eager=mode == "eager")
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
    model = SimpleUNet(key=_init_key(4)).eval()
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
    if _others(counts) != expect:
        raise AssertionError(f"launches {counts} on the MNIST training path, "
                             f"expected {expect}")
    # The UNet; t and noise a step in one launch; the epoch's sample grid:
    # x_T and each step.
    _check_draws(counts, MNIST_INIT_DRAWS + steps + 1 + STEPS,
                 "the MNIST training path")
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
        if _others(counts) != expect:
            raise AssertionError(f"launches {counts} on the MNIST sampling "
                                 f"path {extra}, expected {expect}")
        _check_draws(counts, 1 + (0 if extra else STEPS),
                     f"the MNIST sampling path {extra}")
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
    times = []
    for run in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_images(model, sched, n_samples=MNIST_N, key=_key(1 + run))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = min(times)
    print(f"MNIST sampler: 1000-step loop {times} s, {MNIST_N / wall} "
          f"samples/s ({STEPS / wall} steps/s), n={MNIST_N}, on {card}")
    return runs, wall / STEPS, model


def resblock_timing(card: str) -> dict:
    """CUDA-event device times of each block at n 25 and 128 (plain,
    kernel, kernel, plain), f32 and bf16, at the wrapper's tile, and the
    bound (no single PyTorch call computes the block): bytes, or the products on the tensor cores (f32 as 3xTF32, bf16
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
                nbytes, flops = rb.work(*typed)
                f32 = dtype == torch.float32
                ops = (perf.f32_tensor_core_ops(flops) if f32
                       else [(flops, "bf16")])
                bound_ms, bound_by = perf.bound_ms(nbytes, ops)
                roof_ms = perf.bound_ms(0, [(flops, "f32")])[0]
                ms = sum(k_ms) / 2
                key = "f32" if f32 else "bf16"
                row[key] = dict(ms=ms, plain_ms=sum(p_ms) / 2,
                                bound_ms=bound_ms,
                                bound_by=bound_by, fp32_fma_roof_ms=roof_ms,
                                bytes=nbytes, flops=flops)
                x = typed[0]
                tile = rb.tile_for(*x.shape[:3])
                print(f"{name} {key} n {b} (tile {tile}): kernel {k_ms} ms, "
                      f"plain {p_ms} ms; bound {bound_ms} ms by {bound_by} "
                      f"({nbytes} B, {flops} FLOP as "
                      f"{'3xTF32' if f32 else 'bf16'}), "
                      f"{ms / bound_ms:.1f}x; FP32-FMA roof {roof_ms} ms; "
                      f"{flops / ms / 1e9:.2f} TFLOP/s; on {card}")
            blocks[name] = row
        sums = {}
        for key in ("f32", "bf16"):
            t = {k: sum(v[key][k] for v in blocks.values())
                 for k in ("ms", "plain_ms", "fp32_fma_roof_ms", "bytes",
                           "flops")}
            # The bound of the four blocks as one piece of work.
            t["bound_ms"], t["bound_by"] = perf.bound_ms(
                t["bytes"], perf.f32_tensor_core_ops(t["flops"])
                if key == "f32" else [(t["flops"], "bf16")])
            sums[key] = t
            print(f"UNet forward's four blocks at n {b}, {key}: kernel "
                  f"{t['ms']} ms, plain {t['plain_ms']} ms, bound "
                  f"{t['bound_ms']} ms by "
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
    if _others(counts) != expect:
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
    backward for the backward kernel; a replayed graph) and the bound."""
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
    # beside).
    return _time_against_plain(runs, work, card,
                               "distinct q, k, v, a replayed graph",
                               at="B 8, H 4, L 64, Dh 64, f32")


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
    # The UNet, then t and noise a step in one launch.
    expect["rng_draw"] = MNIST_INIT_DRAWS + MNIST_BF16_STEPS
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
        "diffusion_model": TinyTransformer(cfg, key=_init_key(21,
                                                              "diffusion")),
        "rounding_fn": LearnedRounding(DIM, vocab,
                                       key=_init_key(21, "rounding")),
        "embedding_fn": LearnedEmbedding(vocab, DIM,
                                         key=_init_key(21, "embedding"))})
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
    unet = SimpleUNet(key=_init_key(21, "init"))

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
    import gc
    import math

    import torch

    phase("main path: python -m tinydiffusionmodels_torch.bench --quick")
    # The bench is a process of its own: this one first hands back what its
    # caching allocator holds (the Gemma phases' freed models and graphs).
    gc.collect()
    torch.cuda.empty_cache()
    print(f"this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB of the card ({torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated) while the bench runs")
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
                 "guided_decode", "rng_draw"):
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
                      "fused_resblock": "fused_resblock_kernel",
                      "rng_draw": "draw_kernel"}
GRAPH_WALL_STEPS = 100  # steps a row's unprofiled wall time is taken over
REPLAY_GAP_S = 0.01     # the card idles between phase 25's two replays
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
    joint = nn.ModuleDict({
        "diffusion_model": TinyTransformer(
            cfg, key=_init_key(seed, "diffusion"), device="cuda"),
        "rounding_fn": LearnedRounding(
            DIM, GRAPH_VOCAB, key=_init_key(seed, "rounding"), device="cuda"),
        "embedding_fn": LearnedEmbedding(
            GRAPH_VOCAB, DIM, key=_init_key(seed, "embedding"),
            device="cuda"),
    })
    ema = copy.deepcopy(joint).requires_grad_(False) if ema_decay else None
    optimizer = adamw(joint.parameters(), GRAPH_LR, weight_decay=1e-4)
    lam = cosine_warmup_lambda(GRAPH_WARMUP, 4 * steps)
    tokens = torch.randint(0, GRAPH_VOCAB, (steps * batch, SEQ),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed + 1), device="cuda")
    runner = text_train.TextSteps(
        joint, optimizer, tokens, batch_size=batch, steps=steps,
        key=_key(seed + 2), ema=ema, ema_decay=ema_decay, lr_at=lambda s: GRAPH_LR * lam(s), eager=eager,
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
    model = SimpleUNet(sched.timesteps, key=_init_key(seed, "init"),
                       device="cuda")
    ema = copy.deepcopy(model).requires_grad_(False) if ema_decay else None
    optimizer = adamw(model.parameters(), 1e-3, weight_decay=0.01)
    images = torch.rand((steps * batch, 28, 28, 1),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(seed + 1), device="cuda") * 2 - 1
    runner = mnist_train.MnistSteps(
        model, optimizer, images, sched, batch_size=batch, steps=steps,
        key=_key(seed + 2), ema=ema, ema_decay=ema_decay,
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
                                             depth=DEPTH),
                           key=_init_key(seed, "diffusion"), device="cuda")
    text_sc = TinyTransformer(TransformerConfig(dim=DIM, n_heads=HEADS,
                                                depth=DEPTH, self_cond=True),
                              key=_init_key(seed + 1, "diffusion"),
                              device="cuda")
    with torch.no_grad():
        text_sc.selfcond_proj.weight.copy_(0.05 * torch.randn(
            DIM, DIM, generator=g))
    unet = SimpleUNet(key=_init_key(seed, "init"), device="cuda")
    return [m.eval() for m in (text, text_sc, unet)]


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
                      self_cond=self_cond, eager=eager)
    calls = []
    for call in range(2):
        torch.cuda.synchronize()
        _reset_counts()
        x = sampler(_key(seed + call))
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


def _last_replay_kernels(prof) -> list:
    """The names of the kernels of the last profiled replay: the device
    events after the widest gap between two of them, where the replays
    are REPLAY_GAP_S apart and a replay's kernels microseconds (all of
    them when no gap is that wide)."""
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    gaps = [b.time_range.start - a.time_range.end
            for a, b in zip(events, events[1:])]
    cut = 0
    if gaps and max(gaps) >= REPLAY_GAP_S * 1e6 / 2:
        cut = gaps.index(max(gaps)) + 1
    return [e.name for e in events[cut:]]


def _named_counts(names: list) -> dict:
    counts = dict.fromkeys(GRAPH_KERNEL_NAMES, 0)
    for name in names:
        for counter, kernel in GRAPH_KERNEL_NAMES.items():
            if kernel in name:
                counts[counter] += 1
    return counts


def _draw_kinds(names: list) -> dict:
    """Draw kernels among ``names``, by template instance."""
    kinds = {}
    for name in names:
        if "draw_kernel" in name:
            kind = name[name.find("draw_kernel"):].split("(")[0]
            kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def kernels_in_graphs(runners: dict, models) -> None:
    """Phase 25: torch.profiler over one replay of each training graph (the
    second of two, told apart by the idle gap between them) must list
    the flash forward, dq and dk/dv kernels (text), the resblock kernel
    (MNIST) and the draw kernel as many times as the capture counted them
    (one eager step's launches); over a second call of a captured 10-step
    sampler loop (ten replays), 10 steps' worth. Where the profiler lists none
    from a replay, that is printed and the launch counters' deltas are
    what remains."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch import graphs
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.sample.ancestral import Sampler

    phase("CUDA graphs: the kernels inside the replays (torch.profiler)")
    names = [f"{m.__name__.split('.')[-1]}.{a}" for m, a in graphs.COUNTERS]
    print(f"counters {names}")
    blind = []
    for what, runner in runners.items():
        for variant, step in runner.kinds.items():
            if not step.captured:
                continue
            # COUNTERS begins with the flash and resblock counters, in
            # GRAPH_KERNEL_NAMES' order, and ends with the draws'.
            want = dict(zip(list(GRAPH_KERNEL_NAMES)[:4], step.delta))
            want["rng_draw"] = step.delta[-1]
            # Two replays, REPLAY_GAP_S apart, and the second counted: a
            # profile has missed the first kernels it saw on the H100 (a
            # text step's first draw; the self-conditioning step's first
            # three flash forwards; an MNIST step's two draws), also
            # after a profiler warm-up step.
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(2):
                    if i:
                        time.sleep(REPLAY_GAP_S)
                    runner.cursor.zero_()   # the epoch's first step again
                    step.graph.replay()
                    torch.cuda.synchronize()
            names = _last_replay_kernels(prof)
            seen = _named_counts(names)
            if not any(seen.values()):
                blind.append(what)
            elif seen != want:
                raise AssertionError(f"{what} (step {variant}): the "
                                     f"profiler lists {seen} in one replay "
                                     f"(draws {_draw_kinds(names)}), the "
                                     f"capture counted {want}")
            print(f"{what} (step {variant}): one replay lists {seen}, the "
                  f"draws by instance {_draw_kinds(names)}; the capture "
                  f"counted {step.delta}")
    sched = make_schedule(10, device="cuda")
    text, _, unet = models
    for what, model, shape, counter, per_step in (
            (f"text sampler n {N}", text, (N, SEQ, DIM),
             "flash_attention_fwd", DEPTH),
            (f"MNIST sampler n {MNIST_N}", unet, (MNIST_N, 28, 28, 1),
             "fused_resblock", 4)):
        # The first call runs a step eagerly and captures; the profiled
        # second call is ten replays (the profiler misses eager launches
        # on the card: 38 of 40 listed once when the eager step was in).
        sampler = Sampler(model, sched, shape, key=_key(1))
        sampler()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                torch.inference_mode():
            sampler()
            torch.cuda.synchronize()
        seen = _kernel_counts(prof)[counter]
        print(f"{what}, a captured 10-step loop called again (10 replays): "
              f"the profiler lists {seen} {GRAPH_KERNEL_NAMES[counter]}, "
              f"{10 * per_step} launched")
        if seen == 0:
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
                                 "seconds": result.seconds, "world": world,
                                 "epochs": result.epochs}),
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
        elif isinstance(tree, (list, tuple)):
            for i, value in enumerate(tree):
                yield from leaves(value, f"{prefix}{i}/")
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
    bit-equal and the launches and draws as counted. Returns the launches
    of the runs (main paths)."""
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
    # + 1: the validation graph's prime, one batch's forward.
    text_launches = {"flash_attention_fwd": (steps + val_batches + 1) * DEPTH,
                     "flash_attention_bwd_dq": steps * DEPTH,
                     "flash_attention_bwd_dkv": steps * DEPTH}
    text_draws = _text_train_draws(steps, DEPTH, val_batches)
    mnist_steps = TORCHRUN_MNIST_IMAGES // MNIST_BATCH
    cases = (("text", "shakespeare", text_argv, text_env, False,
              text_launches, text_draws),
             ("text --seq_parallel", "shakespeare",
              [*text_argv, "--seq_parallel"], text_env, False,
              text_launches, text_draws),
             ("MNIST (cudnn.deterministic)", "mnist", mnist_argv, mnist_env,
              True, {"fused_resblock": mnist_steps * 4},
              MNIST_INIT_DRAWS + mnist_steps))
    started = {}
    for i, (what, cli, argv, env, det, _, _) in enumerate(cases):
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
    for i, (what, cli, _, _, _, expect, draws) in enumerate(cases):
        for torchrun in (True, False):
            rec = records[i, torchrun]
            if rec["world"] != (1 if torchrun else 0):
                raise AssertionError(f"{what}: world {rec['world']} "
                                     f"({'with' if torchrun else 'without'} "
                                     "torchrun)")
            counts = {k: v for k, v in rec["counts"].items() if v}
            if _others(counts) != expect:
                raise AssertionError(f"{what}: launches {counts}, expected "
                                     f"{expect}")
            _check_draws(rec["counts"], draws, f"{what} "
                         f"({'with' if torchrun else 'without'} torchrun)")
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
              f"(a NCCL group of one); launches {expect} and {draws} "
              f"draws each; {records[i, True]['steps']} steps")
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


# --- the Gemma base LM (phase 32) --------------------------------------------


# Phase 34: the drills' deadline, and the victim's poll for its file.
RESUME_TIMEOUT_S = 300
RESUME_POLL_S = 0.005
# The MNIST drill's EMA decay: its 936 steps bring an EMA at 0.99 to the
# trained weights (0.99^936 ~ 1e-4 of the initial ones are left; at 0.999,
# 0.39), so phase 35 measures a trained model's samples.
MNIST_RESUME_EMA = "0.99"


def _resume_drill(what: str, cli: str, argv: list, env: dict, work: Path,
                  deterministic: bool, best: bool) -> tuple[dict, dict]:
    """Phase 34's three runs of one CLI in ``work``: (a) uninterrupted,
    (b) killed by SIGKILL once its resume file exists, (c) resumed. Checks
    (b)'s file holds epoch 1, (c)'s restore line, and (c)'s checkpoints
    (final, best with ``best``, and the last resume file) bit-equal to
    (a)'s. Returns (a)'s and (c)'s records."""
    import signal

    from tinydiffusionmodels_torch.io import load_checkpoint

    deadline = time.monotonic() + RESUME_TIMEOUT_S
    files = {}
    for tag in ("whole", "cut"):
        ckpt = work / f"{tag}.pth"
        files[tag] = [ckpt, work / f"{tag}_state.pth"]
        if best:
            files[tag].append(work / f"{tag}_best.pth")
        for old in files[tag]:
            old.unlink(missing_ok=True)

    def start(tag, log):
        return _start_cli(cli, [*argv, "--ckpt", str(work / f"{tag}.pth")],
                          torchrun=False, workdir=work, log=work / log,
                          env=env, deterministic=deterministic)

    whole = _finish_cli(start("whole", "whole.log"), deadline)
    proc, _, victim_log = start("cut", "victim.log")
    state = files["cut"][1]
    while not state.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            raise AssertionError(f"{what}: the victim wrote no resume file "
                                 f"(exit {proc.returncode}):\n"
                                 f"{victim_log.read_text()[-4000:]}")
        time.sleep(RESUME_POLL_S)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"{what}: the victim exited {proc.returncode} "
                             "before the SIGKILL")
    if int(load_checkpoint(state)["epoch"]) != 1:
        raise AssertionError(f"{what}: killed after its epoch-2 resume file")
    resumed_run = start("cut", "resumed.log")
    resumed = _finish_cli(resumed_run, deadline)
    log = resumed_run[2].read_text()
    if "[resume] restored epoch 1" not in log:
        raise AssertionError(f"{what}: no restore line:\n{log[-4000:]}")
    diff = []
    for a, b in zip(files["whole"], files["cut"]):
        diff += [f"{b.name}: {k}" for k in _checkpoint_diff(a, b)]
    if diff:
        raise AssertionError(f"{what}: the resumed run differs from the "
                             f"uninterrupted one in {diff[:8]}")

    def timeless(r):
        return {k: v for k, v in r.items() if k != "it_per_s"}

    if [timeless(r) for r in resumed["epochs"]] != [
            timeless(r) for r in whole["epochs"][1:]]:
        raise AssertionError(f"{what}: epoch-2 records differ: "
                             f"{resumed['epochs']} vs {whole['epochs'][1:]}")
    print(f"{what}: killed during epoch 2, resumed from epoch 1; final"
          f"{', best' if best else ''} and resume checkpoints and the epoch-2 "
          f"record bit-equal to the uninterrupted run's; replayed it/s "
          f"uninterrupted epoch 1 {whole['epochs'][0]['it_per_s']}, epoch 2 "
          f"{whole['epochs'][1]['it_per_s']}; resumed epoch 2 "
          f"{resumed['epochs'][0]['it_per_s']} (each epoch's first steps "
          f"warm up and capture; the other CLI's drill runs beside it)",
          flush=True)
    return whole, resumed


def _restore_seconds(state: Path, kind: str) -> tuple[float, float]:
    """(seconds to read ``state``, seconds to restore it into a trainer's
    tensors on the card), as the trainers do at start."""
    import copy

    import numpy as np
    import torch

    from tinydiffusionmodels_torch.io import config_from_state_dict
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        SimpleUNet,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.train import state as train_state
    from tinydiffusionmodels_torch.train.optim import adamw

    t0 = time.perf_counter()
    saved = train_state.read(str(state))
    read_s = time.perf_counter() - t0
    if kind == "text":
        cfg = config_from_state_dict(saved["diffusion_model"],
                                     TransformerConfig(dim=DIM, n_heads=HEADS))
        vocab = np.shape(saved["rounding_fn"]["decoder.weight"])[0]
        model = torch.nn.ModuleDict({
            "diffusion_model": TinyTransformer(cfg),
            "rounding_fn": LearnedRounding(DIM, vocab),
            "embedding_fn": LearnedEmbedding(vocab, DIM)}).cuda()
    else:
        model = SimpleUNet().cuda()
    ema = copy.deepcopy(model).requires_grad_(False)
    optimizer = adamw(model.parameters(), 1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "text":
        train_state.restore_text(saved, model, optimizer, ema)
    else:
        train_state.restore_mnist(saved, model, optimizer, ema)
    torch.cuda.synchronize()
    return read_s, time.perf_counter() - t0


def resume_on_card(card: str) -> tuple[list, Path]:
    """Phase 34: the SIGKILL drills of both CLIs on the card, side by side
    (see the module docstring). Returns the launches of the uninterrupted
    and resumed runs (main paths) and the MNIST checkpoint."""
    from concurrent.futures import ThreadPoolExecutor

    from tinydiffusionmodels_torch.data import (
        CharTokenizer,
        load_text_corpus,
        num_batches,
        tokenize_corpus,
    )
    from tinydiffusionmodels_torch.data.mnist import load_mnist

    phase("--resume on the card: each CLI killed during epoch 2 and resumed "
          "against its uninterrupted run, the two drills side by side")
    t0 = time.perf_counter()
    _prepare_workdir(TRAIN_CHARS)
    work = WORK / "resume"
    work.mkdir(parents=True, exist_ok=True)
    corpus, _ = load_text_corpus(WORK / "data")
    corpus = corpus[:TRAIN_CHARS]
    train_chunks, val_chunks = tokenize_corpus(corpus, CharTokenizer(corpus),
                                               SEQ, 0.1)
    steps = num_batches(len(train_chunks), BATCH)
    val_batches = num_batches(len(val_chunks), BATCH)
    text_argv = ["--train", "--epochs", "2", "--batch_size", str(BATCH),
                 "--seq_len", str(SEQ), "--embed_dim", str(DIM), "--depth",
                 str(DEPTH), "--dropout", str(DROPOUT), "--model_id", "char",
                 "--use_learned_embeddings", "--data_root",
                 str(WORK / "data"), "--ema_decay", "0.999", "--resume",
                 "--resume_every", "1"]
    text_env = {"TDM_PLATFORM": "cuda", "TDM_DATA_LIMIT": str(TRAIN_CHARS)}
    (work / "text").mkdir(exist_ok=True)
    mnist_data = WORK / "mnist" / "data"
    sys.modules["torchvision"] = None
    load_mnist(mnist_data)
    mnist_argv = ["--train", "--epochs", "2", "--batch_size",
                  str(MNIST_BATCH), "--no_epoch_samples", "--data_root",
                  str(mnist_data), "--ema_decay", MNIST_RESUME_EMA, "--resume",
                  "--resume_every", "1"]
    (work / "mnist").mkdir(exist_ok=True)
    # The drills are subprocesses that share nothing: they run side by
    # side, so the phase takes about the longer drill's time.
    with ThreadPoolExecutor(2) as pool:
        text_drill = pool.submit(_resume_drill, "text", "shakespeare",
                                 text_argv, text_env, work / "text", False,
                                 True)
        mnist_drill = pool.submit(
            _resume_drill, "MNIST (cudnn.deterministic)", "mnist",
            mnist_argv, {"TDM_PLATFORM": "cuda"}, work / "mnist", True,
            False)
        drills = {"text": text_drill.result(), "mnist": mnist_drill.result()}
    # Each run validates every epoch, after the one prime of its
    # validation graph (a batch's forward at depth DEPTH).
    per_epoch = {"flash_attention_fwd": (steps + val_batches) * DEPTH,
                 "flash_attention_bwd_dq": steps * DEPTH,
                 "flash_attention_bwd_dkv": steps * DEPTH}
    mnist_steps = MNIST_IMAGES // MNIST_BATCH
    runs = []
    for kind, (whole, resumed) in drills.items():
        for rec, epochs in ((whole, 2), (resumed, 1)):
            counts = {k: v for k, v in _others(rec["counts"]).items() if v}
            if kind == "text":
                want = {k: v * epochs for k, v in per_epoch.items()}
                want["flash_attention_fwd"] += DEPTH
            else:
                want = {"fused_resblock": mnist_steps * 4 * epochs}
            if counts != want:
                raise AssertionError(f"{kind} resume: launches {counts} over "
                                     f"{epochs} epoch(s), expected {want}")
            runs.append(rec["counts"])
        state = work / kind / "cut_state.pth"
        read_s, restore_s = _restore_seconds(state, kind)
        print(f"{kind} restore: read {read_s:.4f} s "
              f"({state.stat().st_size} bytes) + restore {restore_s:.4f} s, "
              f"on {card}")
    print(f"phase: {time.perf_counter() - t0:.1f} s for the six runs, on "
          f"{card}")
    return runs, work / "mnist" / "whole.pth"


# Phase 35: the JAX tools' JSON keys (tools/fidelity.py, and
# tools/text_fidelity.py at --seeds 1, plus the port's data_source).
FIDELITY_KEYS = {
    "data_source", "classifier_accuracy_on_data", "n_samples",
    "mean_max_prob", "inception_score", "fid", "fid_real_floor",
    "nn_train_dist_mean", "nn_train_dist_p05", "nn_train_dist_real_mean",
    "nn_train_dist_real_p05", "class_histogram", "dtype"}
TEXT_FIDELITY_KEYS = {
    "mode", "guidance_norm", "n_samples", "n_seeds", "corpus_perplexity",
    "uniform_perplexity", "lm_perplexity", "distinct_1", "distinct_2",
    "dup_8gram_rate", "corpus_8gram_overlap", "corpus_distinct_1",
    "corpus_distinct_2", "corpus_dup_8gram_rate", "data_source"}
FIDELITY_N, TEXT_FIDELITY_N = 256, 16
# The f32 samples' floor: every class of digit among them, and an FID
# within this multiple of the real digits' own small-sample FID
# (fid_real_floor). A trained model's samples read about 6x; a sampler or
# resblock that has gone wrong (a model left near its random weights read
# 335x, with three classes empty) fails.
FID_FLOOR_MULTIPLE = 10.0


@contextlib.contextmanager
def _plain_resblocks():
    """The UNet's residual blocks through their plain PyTorch version
    (``reference.fused_resblock``: cuDNN convs and elementwise ops) inside,
    not the fused kernel."""
    from tinydiffusionmodels_torch import ops
    from tinydiffusionmodels_torch.ops import reference

    fused = ops.fused_resblock
    ops.fused_resblock = reference.fused_resblock
    try:
        yield
    finally:
        ops.fused_resblock = fused


def _finite_record(what: str, rec: dict, keys: set, source: str) -> None:
    import math

    if set(rec) != keys:
        raise AssertionError(f"{what}: keys {sorted(set(rec) ^ keys)} differ "
                             "from the JAX tool's")
    bad = [k for k, v in rec.items() if isinstance(v, (int, float))
           and not isinstance(v, bool) and not math.isfinite(v)]
    if bad or rec["data_source"] != source:
        raise AssertionError(f"{what}: not finite {bad}, data_source "
                             f"{rec['data_source']}")


def _mnist_fidelity(card: str, mnist_ckpt: Path) -> list:
    """Phase 35's MNIST part: ``fidelity.main`` on ``mnist_ckpt``, f32 and
    bf16 on the kernel, then the plain-resblock bf16 witness; the floors of
    the module docstring. Returns the kernel runs' launches."""
    import torch

    from tinydiffusionmodels_torch import fidelity

    runs, recs = [], {}
    work = _prepare_mnist_workdir()
    # The kernel's f32 and bf16 runs, then the witness: bf16 through the
    # plain resblock, same seed (outside the counted runs).
    for dtype, plain in (("f32", False), ("bf16", False), ("bf16", True)):
        what = f"fidelity {dtype}" + (" plain resblock" if plain else "")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with _plain_resblocks() if plain else contextlib.nullcontext():
            rec = fidelity.main([
                "--ckpt", str(mnist_ckpt), "--n", str(FIDELITY_N),
                "--sampler", "ddim", "--steps", str(MNIST_DDIM_STEPS),
                "--data_root", str(work / "data"), "--dtype", dtype])
        torch.cuda.synchronize()
        counts = _counts()
        _finite_record(what, rec, FIDELITY_KEYS, "synthetic")
        want = {} if plain else {"fused_resblock": MNIST_DDIM_STEPS * 4}
        if {k: v for k, v in _others(counts).items() if v} != want:
            raise AssertionError(f"{what}: launches {counts}")
        if not all(rec["class_histogram"]):
            raise AssertionError(f"{what}: a class of digit is missing from "
                                 f"the samples, {rec['class_histogram']}")
        if not plain:
            runs.append(counts)
        recs[what] = rec
        print(f"{what}: {time.perf_counter() - t0:.1f} s, launches "
              f"{_nonzero(counts)}, on {card}")
    f32 = recs["fidelity f32"]
    if not f32["fid"] <= FID_FLOOR_MULTIPLE * f32["fid_real_floor"]:
        raise AssertionError(
            f"fidelity f32: FID {f32['fid']} above {FID_FLOOR_MULTIPLE} x the "
            f"real digits' floor {f32['fid_real_floor']}")
    print(f"MNIST FID (n {FIDELITY_N}, DDIM {MNIST_DDIM_STEPS}): f32 kernel "
          f"{f32['fid']}, bf16 kernel {recs['fidelity bf16']['fid']}, bf16 "
          f"plain resblock {recs['fidelity bf16 plain resblock']['fid']}; "
          f"real floor {f32['fid_real_floor']} (f32 limit "
          f"{FID_FLOOR_MULTIPLE}x); on {card}")
    return runs


def fidelity_on_card(card: str, mnist_ckpt: Path, text_ckpt: Path,
                     lm_ckpt: Path) -> list:
    """Phase 35: both fidelity tools' ``main`` on the card (see the module
    docstring). Returns their launches (main paths)."""
    import torch

    from tinydiffusionmodels_torch import text_fidelity

    phase("the fidelity tools on the card: fidelity (MNIST, n 256, DDIM 50, "
          "f32 and bf16) and text_fidelity (n 16, pure and guided)")
    runs = _mnist_fidelity(card, mnist_ckpt)
    _prepare_workdir(TRAIN_CHARS)
    for mode in ("pure", "guided"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        rec = text_fidelity.main(["--ckpt", str(text_ckpt), "--lm_ckpt",
                                  str(lm_ckpt), "--n", str(TEXT_FIDELITY_N),
                                  "--seq_len", str(SEQ), "--mode", mode])
        torch.cuda.synchronize()
        counts = _counts()
        _finite_record(f"text_fidelity {mode}", rec, TEXT_FIDELITY_KEYS,
                       "builtin")
        if counts["flash_attention_fwd"] < STEPS * DEPTH or any(
                v for k, v in _others(counts).items()
                if k != "flash_attention_fwd"):
            raise AssertionError(f"text_fidelity {mode}: launches {counts}")
        runs.append(counts)
        print(f"text_fidelity {mode}: {time.perf_counter() - t0:.1f} s, "
              f"launches {_nonzero(counts)}, on {card}")
    return runs


def _random_gemma(depth: int, seed: int, device="cuda"):
    """A ``models.gemma.Gemma`` at Gemma-2B's published widths (GEMMA_2B)
    cut to ``depth`` layers, max_len 65, every weight N(0, 0.02) drawn on
    ``device`` from ``seed``, f32: the real gemma-2b-it weights are not on
    the card machine."""
    import torch

    from tinydiffusionmodels_torch.models.gemma import Gemma, GemmaConfig

    cfg = GemmaConfig(**dict(GEMMA_2B, num_layers=depth),
                      max_len=max(SEQ + 1, 64))
    model = Gemma(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    return model.eval()


class _StandInTokenizer:
    """``data.tokenizer.HFTokenizerAdapter``'s interface over Gemma's
    vocabulary: characters encode as ord mod vocab, ids decode as text of
    numbers (so texts are equal exactly when tokens are)."""

    bos_token_id, eos_token_id = 2, 1
    vocab_size = GEMMA_2B["vocab_size"]

    def encode(self, text: str):
        import numpy as np

        return np.asarray([ord(c) % self.vocab_size for c in text], np.int64)

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)

    def batch_decode(self, ids, skip_special_tokens=True):
        return [self.decode(row) for row in ids]


def gemma_guided_decode(card: str):
    """Phase 32: the guided decode with a Gemma-2B base LM at its published
    widths (GEMMA_2B, random weights, f32, about 10.0 GB), n GEMMA_N, seq
    SEQ, alpha ALPHA, through the text CLI's own ``shakespeare.
    guided_decode``: a width-2048 denoiser samples the embeddings by DDIM
    GEMMA_DDIM_STEPS, a random rounding head over the 256 000 tokens gives
    the (10, 64, 256000) diffusion logits, and the port's Gemma decodes
    them with a ``GuidedDecoder`` (its 64-position scan one CUDA graph).
    Asserts: flash-forward launches 18 x (64 + 1 prime) for the decode (and
    DDIM steps x 3 for the sampler), no other kernel, GEMMA_N sample files,
    the tokens bit-equal to the eager ``guided_generate_scan`` on the same
    logits, and the module at GEMMA_CPU_DEPTH layers against the CPU.
    Prints the replayed ms a decode and a position, tokens/s, the eager
    time, the bound (the f32 weights read once a position at 3.35 TB/s),
    and the busy share and top kernels of one replay (torch.profiler).
    Returns the launches and the measured row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tinydiffusionmodels_torch import perf, shakespeare
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.models import (
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.models.gemma import Gemma
    from tinydiffusionmodels_torch.sample.guided import (
        GuidedDecoder,
        guided_generate_scan,
    )
    from tinydiffusionmodels_torch.sample.text import (
        diffusion_position_logits,
        sample_diffusion_embeddings,
    )

    phase("the guided decode with a Gemma-2B base LM (published widths, "
          f"random weights, f32), n {GEMMA_N}, seq {SEQ}, through the "
          "CLI's guided_decode")
    work = WORK / "gemma"
    (work / "samples").mkdir(parents=True, exist_ok=True)
    os.chdir(work)
    for old in (work / "samples").glob("guided_sample_*.txt"):
        old.unlink()
    t0 = time.perf_counter()
    gemma = _random_gemma(GEMMA_2B["num_layers"], seed=7)
    layers, vocab = GEMMA_2B["num_layers"], GEMMA_2B["vocab_size"]
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in gemma.parameters())
    denoiser = TinyTransformer(TransformerConfig(
        dim=GEMMA_DIM, n_heads=HEADS, depth=DEPTH),
        key=_init_key(8, "diffusion"), device="cuda").eval()
    rounding = LearnedRounding(GEMMA_DIM, vocab, key=_init_key(8, "rounding"),
                               device="cuda").eval()
    sched = make_schedule(device="cuda")
    tok = _StandInTokenizer()
    torch.cuda.synchronize()
    print(f"Gemma-2B widths, {layers} layers: {weight_bytes / 1e9:.3f} GB "
          f"of f32 weights, drawn on the card with the denoiser and "
          f"rounding head in {time.perf_counter() - t0:.1f} s")

    idle = {k: 0 for k in _counts()}
    _reset_counts()
    z = sample_diffusion_embeddings(
        denoiser, sched, n=GEMMA_N, seq_len=SEQ, embed_dim=GEMMA_DIM,
        method="ddim", num_steps=GEMMA_DDIM_STEPS, key=_key(9))
    torch.cuda.synchronize()
    sampler = _counts()
    expect = dict(idle, flash_attention_fwd=GEMMA_DDIM_STEPS * DEPTH,
                  rng_draw=1)        # x_T
    if sampler != expect or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"the sampler launched {sampler}, expected "
                             f"{expect}; finite: {torch.isfinite(z).all()}")
    _reset_counts()
    t0 = time.perf_counter()
    tokens = shakespeare.guided_decode(gemma, tok, z, rounding=rounding,
                                       alpha=ALPHA)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    decode = _counts()
    expect = dict(idle, flash_attention_fwd=layers * (SEQ + 1))
    if decode != expect:
        raise AssertionError(f"the Gemma decode launched {decode}, expected "
                             f"{expect}")
    written = sorted((work / "samples").glob("guided_sample_*.txt"))
    if len(written) != GEMMA_N or tuple(tokens.shape) != (GEMMA_N, SEQ):
        raise AssertionError(f"{len(written)} samples, tokens "
                             f"{tuple(tokens.shape)}")

    diff = diffusion_position_logits(z, rounding=rounding, embed_matrix=None,
                                     use_learned_rounding=True)
    if tuple(diff.shape) != (GEMMA_N, SEQ, vocab):
        raise AssertionError(f"diffusion logits {tuple(diff.shape)}")
    bos = tok.bos_token_id

    def eager():
        return guided_generate_scan(gemma.decode_step,
                                    gemma.init_cache(GEMMA_N), diff, bos,
                                    alpha=ALPHA)

    want = eager()
    if not torch.equal(tokens, want):
        raise AssertionError(f"the replayed decode differs from the eager "
                             f"scan in {int((tokens != want).sum())} tokens")
    decoder = GuidedDecoder(gemma, GEMMA_N, SEQ, bos, alpha=ALPHA)
    if not torch.equal(decoder(diff), want):
        raise AssertionError("a second decoder's replay differs from the "
                             "eager scan")
    replay_ms = [_wall_ms(lambda: decoder(diff), GEMMA_RUNS)]
    eager_ms = _wall_ms(eager, 2)
    replay_ms.append(_wall_ms(lambda: decoder(diff), GEMMA_RUNS))
    ms = sum(replay_ms) / 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decoder(diff)
        torch.cuda.synchronize()
    prof_row = _profile_table(prof, 1, ms / 1e3, card,
                              "Gemma-2B guided decode, a replayed call")
    # The bound of a position: its f32 weights read once (the tied head's
    # 2.1 GB included); the products, 2 FLOPs a weight a row, at the FP32
    # FMA rate, are below it.
    bound_ms, bound_by = perf.bound_ms(
        weight_bytes, [(2 * GEMMA_N * weight_bytes / 4, "f32")])
    row = {"first_call_s": first_s, "replayed_ms": ms,
           "replayed_ms_runs": replay_ms, "eager_ms": eager_ms,
           "ms_per_position": ms / SEQ, "tokens_s": GEMMA_N * SEQ / ms * 1e3,
           "bound_ms_per_position": bound_ms, "bound_by": bound_by,
           "bound_ms_per_decode": bound_ms * SEQ,
           "bound_tokens_s": GEMMA_N / bound_ms * 1e3,
           "device_us": prof_row["device_us"], "busy": prof_row["busy"],
           "kernels": prof_row["kernels"], "weight_gb": weight_bytes / 1e9}
    print(f"Gemma-2B guided decode: replayed tokens equal the eager scan bit "
          f"for bit; launches {decode} (decode), {sampler} (DDIM "
          f"{GEMMA_DDIM_STEPS}); first call (prime, capture, replay) "
          f"{first_s:.3f} s; replayed {ms:.3f} ms a decode ({replay_ms}), "
          f"{ms / SEQ:.4f} ms a position, {row['tokens_s']:.1f} tokens/s; "
          f"eager {eager_ms:.3f} ms; bound {bound_ms:.4f} ms a position by "
          f"{bound_by} ({weight_bytes / 1e9:.3f} GB at 3.35 TB/s), "
          f"{bound_ms * SEQ:.2f} ms a decode, {row['bound_tokens_s']:.1f} "
          f"tokens/s; replayed at {bound_ms * SEQ / ms:.3f} of the bound; "
          f"busy {prof_row['busy']:.3f}; on {card}")
    del decoder, gemma, diff

    # The module at GEMMA_CPU_DEPTH layers, card against CPU, one weight set.
    small = _random_gemma(GEMMA_CPU_DEPTH, seed=11)
    cpu = Gemma(small.cfg, device="cpu")
    cpu.load_state_dict(small.state_dict())
    cpu.eval()
    ids = torch.randint(0, vocab, (2, GEMMA_CPU_L),
                        generator=torch.Generator().manual_seed(12))
    with torch.inference_mode():
        errs = [_max_err(small(ids.cuda()).cpu(), cpu(ids))]
        caches = [small.init_cache(2), cpu.init_cache(2)]
        for pos in range(GEMMA_CPU_POSITIONS):
            (a, caches[0]), (b, caches[1]) = (
                small.decode_step(caches[0], ids[:, pos].cuda()),
                cpu.decode_step(caches[1], ids[:, pos]))
            errs.append(_max_err(a.cpu(), b))
    print(f"Gemma-2B widths at depth {GEMMA_CPU_DEPTH}, card vs CPU (TF32 "
          f"off): {GEMMA_CPU_L}-token causal forward max |d logits| "
          f"{errs[0]:.3e}, {GEMMA_CPU_POSITIONS} decode positions "
          f"{max(errs[1:]):.3e} (tol {GEMMA_CPU_TOL:g})")
    if not max(errs) <= GEMMA_CPU_TOL:
        raise AssertionError(f"the Gemma on the card and on the CPU differ "
                             f"by {errs}")
    del small, cpu
    row["cpu_max_abs_err"] = max(errs)
    return {k: sampler[k] + decode[k] for k in sampler}, row


def _random_hf_gemma(depth: int, seed: int):
    """An HF ``transformers.GemmaForCausalLM`` at Gemma-2B's published
    widths (GEMMA_2B) cut to ``depth`` layers, f32 on the host, as the
    CLI's ``_load_hf`` returns a checkpoint: transformers' own init from
    ``seed`` (N(0, 0.02) embedding and projections), its zero norm weights
    drawn N(0, 0.1) so that they count."""
    import torch
    import transformers

    cfg = transformers.GemmaConfig(
        vocab_size=GEMMA_2B["vocab_size"],
        hidden_size=GEMMA_2B["hidden_size"],
        intermediate_size=GEMMA_2B["intermediate_size"],
        num_hidden_layers=depth,
        num_attention_heads=GEMMA_2B["num_heads"],
        num_key_value_heads=GEMMA_2B["num_kv_heads"],
        head_dim=GEMMA_2B["head_dim"], rms_norm_eps=GEMMA_2B["rms_eps"],
        rope_theta=GEMMA_2B["rope_theta"])
    torch.manual_seed(seed)
    hf = transformers.GemmaForCausalLM(cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.normal_(0.0, 0.1)
    return hf


def gemma_hf_cli(card: str) -> dict:
    """Phase 33: the text CLI's Hugging Face route on the card,
    ``shakespeare.main(["--train", "--guided_sample", "--base_lm", "hf",
    ...])``. ``shakespeare._load_hf`` is stubbed to return what it returns
    for a Gemma checkpoint: a stand-in tokenizer over Gemma's 256 000 ids,
    the embedding matrix, and a random HF ``GemmaForCausalLM`` at Gemma-2B's
    widths cut to GEMMA_CPU_DEPTH layers, on the host. The CLI trains a
    width-2048 denoiser of depth 1 on the pretrained embeddings for one
    epoch of HF_CLI_CHARS characters, samples by DDIM GEMMA_DDIM_STEPS,
    converts the HF weights to the port's Gemma on the card
    (``gemma_from_hf``) and decodes. Asserts: the launches, GEMMA_N sample
    files, the tokens bit-equal to the eager scan of a Gemma converted
    again on the card on the diffusion logits the CLI computed, and that
    Gemma's logits against HF's own on the card (one GEMMA_CPU_L-token
    causal forward, GEMMA_CPU_POSITIONS decode positions) within
    GEMMA_CPU_TOL. Returns the launches."""
    import importlib.metadata

    import torch

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.data import (
        load_text_corpus,
        num_batches,
        tokenize_corpus,
    )
    from tinydiffusionmodels_torch.models.gemma import gemma_from_hf
    from tinydiffusionmodels_torch.sample import text
    from tinydiffusionmodels_torch.sample.guided import guided_generate_scan

    phase("the CLI's --guided_sample --base_lm hf with an HF Gemma (Gemma-2B "
          f"widths, depth {GEMMA_CPU_DEPTH}, random) on transformers "
          f"{importlib.metadata.version('transformers')}")
    _prepare_workdir(HF_CLI_CHARS)
    work = WORK / "gemma_hf"
    (work / "samples").mkdir(parents=True, exist_ok=True)
    os.chdir(work)
    for old in (work / "samples").glob("guided_sample_*.txt"):
        old.unlink()
    t0 = time.perf_counter()
    hf = _random_hf_gemma(GEMMA_CPU_DEPTH, seed=13)
    matrix = hf.get_input_embeddings().weight.detach().cpu().numpy()
    tok = _StandInTokenizer()
    print(f"HF GemmaForCausalLM built on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    corpus, _ = load_text_corpus(WORK / "data")
    train_chunks, val_chunks = tokenize_corpus(corpus[:HF_CLI_CHARS], tok,
                                               SEQ, 0.1)
    steps = num_batches(len(train_chunks), BATCH)
    val_batches = num_batches(len(val_chunks), BATCH)
    argv = ["--train", "--guided_sample", "--base_lm", "hf", "--model_id",
            "google/gemma-2b-it", "--ckpt", str(work / "hf_ckpt.pth"),
            "--epochs", "1", "--batch_size", str(BATCH), "--seq_len",
            str(SEQ), "--depth", "1", "--n", str(GEMMA_N), "--alpha",
            str(ALPHA), "--sampler", "ddim", "--steps",
            str(GEMMA_DDIM_STEPS), "--data_root", str(WORK / "data")]
    seen = []
    plain_logits = text.diffusion_position_logits
    load_hf = shakespeare._load_hf

    def recording(*args, **kw):
        seen.append(plain_logits(*args, **kw))
        return seen[-1]

    text.diffusion_position_logits = recording
    shakespeare._load_hf = lambda model_id: (tok, matrix, hf)
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        tokens = shakespeare.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = _counts()
    finally:
        text.diffusion_position_logits = plain_logits
        shakespeare._load_hf = load_hf
    # steps + val_batches + 1: training, validation and its graph's prime
    # (depth 1).
    expect = {"flash_attention_fwd": steps + val_batches + 1
              + GEMMA_DDIM_STEPS + GEMMA_CPU_DEPTH * (SEQ + 1),
              "flash_attention_bwd_dq": steps,
              "flash_attention_bwd_dkv": steps, "guided_decode": 0,
              "fused_resblock": 0, **_SINGLE_BLOCK_IDLE}
    if _others(counts) != expect:
        raise AssertionError(f"launches {counts} on the HF route, expected "
                             f"{expect}")
    written = sorted((work / "samples").glob("guided_sample_*.txt"))
    if (len(written) != GEMMA_N or tuple(tokens.shape) != (GEMMA_N, SEQ)
            or tokens.device.type != "cuda" or len(seen) != 1):
        raise AssertionError(f"{len(written)} samples, tokens "
                             f"{tuple(tokens.shape)} on {tokens.device}, "
                             f"{len(seen)} diffusion logits")
    gemma = gemma_from_hf(hf, max_len=max(SEQ + 1, 64), device="cuda")
    want = guided_generate_scan(gemma.decode_step, gemma.init_cache(GEMMA_N),
                                seen[0], tok.bos_token_id, alpha=ALPHA)
    if not torch.equal(tokens, want):
        raise AssertionError(f"the CLI's tokens differ from the eager scan "
                             f"in {int((tokens != want).sum())}")
    for i, path in enumerate(written):
        if path.read_text() != tok.decode(tokens[i].tolist()):
            raise AssertionError(f"{path.name} is not the tokens' text")

    # The converted Gemma against HF's own model, both on the card.
    hf.to("cuda")
    ids = torch.randint(0, GEMMA_2B["vocab_size"], (2, GEMMA_CPU_L),
                        generator=torch.Generator().manual_seed(14)).cuda()
    with torch.inference_mode():
        ref = hf(ids, use_cache=False).logits
        errs = [_max_err(gemma(ids), ref)]
        cache = gemma.init_cache(2)
        for pos in range(GEMMA_CPU_POSITIONS):
            logits, cache = gemma.decode_step(cache, ids[:, pos])
            errs.append(_max_err(logits, ref[:, pos]))
    print(f"HF route: CLI call {cli_s:.1f} s ({steps} training steps, "
          f"{val_batches} validation batches, DDIM {GEMMA_DDIM_STEPS}, the "
          f"conversion and the decode); launches {counts}; {len(written)} "
          f"samples; tokens bit-equal to the eager scan; the converted "
          f"Gemma against HF on the card (TF32 off): {GEMMA_CPU_L}-token "
          f"forward max |d logits| {errs[0]:.3e}, {GEMMA_CPU_POSITIONS} "
          f"decode positions {max(errs[1:]):.3e} (tol {GEMMA_CPU_TOL:g}); "
          f"on {card}")
    if not max(errs) <= GEMMA_CPU_TOL:
        raise AssertionError(f"the port's Gemma and HF's differ by {errs}")
    del hf, gemma, seen
    return counts


# Phase 36: the flash kernels on a slice of a layer's heads, as a rank of
# a tensor-parallel 'model' axis of 2 runs them (heads h0, h0 + 1 of 4).
HEAD_OFFSETS = (0, 2)
TP_HEADS = 2


def flash_head_offsets() -> dict:
    """Phase 36: the forward with dropout and both backward kernels on
    heads h0..h0+1 of a layer of 4 (the rank's slice of the fused QKV
    projection, as ``parallel.tp`` lays it out), against the plain version
    of the whole layer, sliced: O and lse at phase 3's limits, dq, dk, dv
    at phase 4's; then the realised mask of the slice (v = I, dO = I)
    against ``dropout_scale`` at the layer's heads b * 4 + h0 + h, and
    offset 0 of 4 heads bit-equal to the call without an offset. Returns
    the largest f32 errors."""
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    phase(f"flash kernels at head offsets {HEAD_OFFSETS} ({TP_HEADS} of "
          f"{HEADS} heads), dropout {DROPOUT}, f32 and bf16 (TF32 off)")
    seed = _seed(-987_654_321)
    worst = {"out": 0.0, "dq": 0.0, "dkv": 0.0}
    dh = DIM // HEADS
    for dtype in (torch.float32, torch.bfloat16):
        for h0 in HEAD_OFFSETS:
            g = torch.Generator(device="cuda").manual_seed(300 + h0)
            qkv = torch.randn(BATCH, SEQ, 3, HEADS, dh, generator=g,
                              device="cuda").to(dtype)
            g_out = torch.randn(BATCH, SEQ, HEADS, dh, generator=g,
                                device="cuda").to(dtype)
            g_lse = torch.randn(BATCH, HEADS, SEQ, generator=g,
                                device="cuda")
            cut = slice(h0, h0 + TP_HEADS)
            kw = dict(layout="blhd", dropout_rate=DROPOUT, dropout_seed=seed)
            whole = qkv.clone().requires_grad_()
            r_out, r_lse = reference.attention(*whole.unbind(2), **kw)
            (r_grad,) = torch.autograd.grad((r_out, r_lse), whole,
                                            (g_out, g_lse))
            part = qkv[:, :, :, cut].contiguous().requires_grad_()
            out, lse = fa.flash_attention_with_lse(
                *part.unbind(2), head_offset=h0, total_heads=HEADS, **kw)
            (grad,) = torch.autograd.grad(
                (out, lse), part, (g_out[:, :, cut].contiguous(),
                                   g_lse[:, cut].contiguous()))
            torch.cuda.synchronize()
            bf = dtype == torch.bfloat16
            tol_o, tol_l, tol_g = ((2e-2, 1e-2, 2e-2) if bf
                                   else (1e-4, 1e-4, 2e-4))
            torch.testing.assert_close(out, r_out[:, :, cut], atol=tol_o,
                                       rtol=tol_o)
            torch.testing.assert_close(lse, r_lse[:, cut], atol=tol_l,
                                       rtol=tol_l)
            want = r_grad[:, :, :, cut]
            errs = []
            for i, name in enumerate(("dq", "dk", "dv")):
                torch.testing.assert_close(grad[:, :, i], want[:, :, i],
                                           atol=tol_g, rtol=tol_g)
                errs.append(_max_err(grad[:, :, i], want[:, :, i]))
            e_out = _max_err(out, r_out[:, :, cut])
            print(f"heads {h0}-{h0 + TP_HEADS - 1} of {HEADS} "
                  f"{str(dtype)[6:]:8s} max|dO| {e_out:.3e} max|dlse| "
                  f"{_max_err(lse, r_lse[:, cut]):.3e} (tol {tol_o:g}/"
                  f"{tol_l:g})  max|ddq| {errs[0]:.3e} max|ddk| "
                  f"{errs[1]:.3e} max|ddv| {errs[2]:.3e} (tol {tol_g:g})")
            if not bf:
                worst["out"] = max(worst["out"], e_out)
                worst["dq"] = max(worst["dq"], errs[0])
                worst["dkv"] = max(worst["dkv"], errs[1], errs[2])
            if h0 == 0:
                views = qkv.unbind(2)
                same = torch.equal(
                    fa.flash_attention(*views, head_offset=0,
                                       total_heads=HEADS, **kw),
                    fa.flash_attention(*views, **kw))
                if not same:
                    raise AssertionError("offset 0 of the layer's heads is "
                                         "not the call without an offset")
    _offset_mask_probes(seed)
    return worst


def _offset_mask_probes(seed) -> None:
    """The forward's and the dkv kernel's realised masks on heads h0..h0+1
    of 4 against ``dropout_scale`` at the layer's heads."""
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    b, l = 2, 64
    g = torch.Generator(device="cuda").manual_seed(8)
    q = 0.3 * torch.randn(b, TP_HEADS, l, 64, generator=g, device="cuda")
    k = 0.3 * torch.randn(b, TP_HEADS, l, 64, generator=g, device="cuda")
    eye = torch.eye(l, device="cuda").expand(b, TP_HEADS, l, l).contiguous()
    p = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1)
    keep_scale = 1.0 / (1.0 - DROPOUT)
    for h0 in HEAD_OFFSETS:
        bh = reference._hashed_heads(b, TP_HEADS, h0, HEADS, "cuda")
        want = reference.dropout_scale(
            seed, bh, torch.arange(l, device="cuda")[:, None],
            torch.arange(l, device="cuda")[None, :], DROPOUT) > 0
        kw = dict(dropout_rate=DROPOUT, dropout_seed=seed, head_offset=h0,
                  total_heads=HEADS)
        fwd = fa.flash_attention(q, k, eye, **kw) / p
        v = eye.clone().requires_grad_()
        (dv,) = torch.autograd.grad(fa.flash_attention(q, k, v, **kw), v,
                                    eye)
        for what, ratio in (("forward", fwd),
                            ("dkv", dv.transpose(-1, -2) / p)):
            got = ratio > keep_scale / 2
            torch.testing.assert_close(ratio, got * keep_scale, atol=1e-4,
                                       rtol=1e-4)
            bad = int((got != want).sum())
            print(f"mask probe at head offset {h0} ({what}): {bad} of "
                  f"{want.numel()} keep/drop decisions differ from "
                  f"dropout_scale at the layer's heads")
            if bad:
                raise AssertionError(f"{bad} dropout decisions differ at "
                                     f"head offset {h0}")


# Phase 40: the flash kernels on a data-parallel rank's rows: rows
# b0..b0 + BATCH_ROWS of a global batch of BATCH.
BATCH_OFFSETS = (0, 4)
BATCH_ROWS = 4


def flash_batch_offsets() -> dict:
    """Phase 40: the forward with dropout and both backward kernels on rows
    b0..b0+3 of a global batch of 8 (``batch_offset``: a data-parallel
    rank's rows, whose mask hashes their global index), against the plain
    version of the whole batch, sliced: O and lse at phase 3's limits, dq,
    dk, dv at phase 4's; offset 0 bit-equal to the call without one; then
    the realised mask (v = I, dO = I) at the offset against
    ``dropout_scale`` at the global rows. Returns the largest f32 errors."""
    import torch

    from tinydiffusionmodels_torch.ops import flash_attention as fa
    from tinydiffusionmodels_torch.ops import reference

    phase(f"flash kernels at batch offsets {BATCH_OFFSETS} ({BATCH_ROWS} of "
          f"{BATCH} rows), dropout {DROPOUT}, f32 and bf16 (TF32 off)")
    seed = _seed(135_792_468)
    worst = {"out": 0.0, "dq": 0.0, "dkv": 0.0}
    dh = DIM // HEADS
    for dtype in (torch.float32, torch.bfloat16):
        for b0 in BATCH_OFFSETS:
            g = torch.Generator(device="cuda").manual_seed(400 + b0)
            qkv = torch.randn(BATCH, SEQ, 3, HEADS, dh, generator=g,
                              device="cuda").to(dtype)
            g_out = torch.randn(BATCH, SEQ, HEADS, dh, generator=g,
                                device="cuda").to(dtype)
            g_lse = torch.randn(BATCH, HEADS, SEQ, generator=g,
                                device="cuda")
            rows = slice(b0, b0 + BATCH_ROWS)
            kw = dict(layout="blhd", dropout_rate=DROPOUT, dropout_seed=seed)
            whole = qkv.clone().requires_grad_()
            r_out, r_lse = reference.attention(*whole.unbind(2), **kw)
            (r_grad,) = torch.autograd.grad((r_out, r_lse), whole,
                                            (g_out, g_lse))
            part = qkv[rows].contiguous().requires_grad_()
            out, lse = fa.flash_attention_with_lse(
                *part.unbind(2), batch_offset=b0, **kw)
            (grad,) = torch.autograd.grad(
                (out, lse), part, (g_out[rows].contiguous(),
                                   g_lse[rows].contiguous()))
            torch.cuda.synchronize()
            bf = dtype == torch.bfloat16
            tol_o, tol_l, tol_g = ((2e-2, 1e-2, 2e-2) if bf
                                   else (1e-4, 1e-4, 2e-4))
            torch.testing.assert_close(out, r_out[rows], atol=tol_o,
                                       rtol=tol_o)
            torch.testing.assert_close(lse, r_lse[rows], atol=tol_l,
                                       rtol=tol_l)
            errs = []
            for i in range(3):
                torch.testing.assert_close(grad[:, :, i], r_grad[rows, :, i],
                                           atol=tol_g, rtol=tol_g)
                errs.append(_max_err(grad[:, :, i], r_grad[rows, :, i]))
            e_out = _max_err(out, r_out[rows])
            print(f"rows {b0}-{b0 + BATCH_ROWS - 1} of {BATCH} "
                  f"{str(dtype)[6:]:8s} max|dO| {e_out:.3e} max|dlse| "
                  f"{_max_err(lse, r_lse[rows]):.3e} (tol {tol_o:g}/"
                  f"{tol_l:g})  max|ddq| {errs[0]:.3e} max|ddk| "
                  f"{errs[1]:.3e} max|ddv| {errs[2]:.3e} (tol {tol_g:g})")
            if not bf:
                worst["out"] = max(worst["out"], e_out)
                worst["dq"] = max(worst["dq"], errs[0])
                worst["dkv"] = max(worst["dkv"], errs[1], errs[2])
            if b0 == 0:
                views = qkv.unbind(2)
                if not torch.equal(
                        fa.flash_attention(*views, batch_offset=0, **kw),
                        fa.flash_attention(*views, **kw)):
                    raise AssertionError("batch offset 0 is not the call "
                                         "without an offset")
    b, l = 2, 64
    g = torch.Generator(device="cuda").manual_seed(9)
    q = 0.3 * torch.randn(b, HEADS, l, 64, generator=g, device="cuda")
    k = 0.3 * torch.randn(b, HEADS, l, 64, generator=g, device="cuda")
    eye = torch.eye(l, device="cuda").expand(b, HEADS, l, l).contiguous()
    p = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1)
    keep_scale = 1.0 / (1.0 - DROPOUT)
    for b0 in (0, 6):
        bh = reference._hashed_heads(b, HEADS, 0, HEADS, "cuda", b0)
        want = reference.dropout_scale(
            seed, bh, torch.arange(l, device="cuda")[:, None],
            torch.arange(l, device="cuda")[None, :], DROPOUT) > 0
        kw = dict(dropout_rate=DROPOUT, dropout_seed=seed, batch_offset=b0)
        fwd = fa.flash_attention(q, k, eye, **kw) / p
        v = eye.clone().requires_grad_()
        (dv,) = torch.autograd.grad(fa.flash_attention(q, k, v, **kw), v,
                                    eye)
        for what, ratio in (("forward", fwd),
                            ("dkv", dv.transpose(-1, -2) / p)):
            got = ratio > keep_scale / 2
            torch.testing.assert_close(ratio, got * keep_scale, atol=1e-4,
                                       rtol=1e-4)
            bad = int((got != want).sum())
            print(f"mask probe at batch offset {b0} ({what}): {bad} of "
                  f"{want.numel()} keep/drop decisions differ from "
                  f"dropout_scale at the global rows")
            if bad:
                raise AssertionError(f"{bad} dropout decisions differ at "
                                     f"batch offset {b0}")
    return worst


# Phase 41: the draw kernel at the training steps' full sizes. Each case:
# (what, global shape, window or None). The text step's noise (and a
# data-parallel rank's rows and a sequence shard's positions of it), the
# MNIST step's noise, and the bf16 bs-512 text step's FFN feature mask
# (and a tensor-parallel rank's columns of it).
RNG_NOISE = (("text noise", (BATCH, SEQ, DIM), None),
             ("text noise, rows 4-7", (BATCH, SEQ, DIM),
              ((4, 4), (0, SEQ), (0, DIM))),
             ("text noise, positions 32-63", (BATCH, SEQ, DIM),
              ((0, BATCH), (32, 32), (0, DIM))),
             ("MNIST noise", (MNIST_BATCH, 28, 28, 1), None))
RNG_MASKS = (("bf16 text step FFN mask", (512, SEQ, FFN), None),
             ("its columns 1024-2047", (512, SEQ, FFN),
              ((0, 512), (0, SEQ), (1024, 1024))))
# Boxes the vector path does not cover whole: a size that is no multiple
# of any vector width, an innermost run of 13 starting at element 5 (odd
# and not 16-byte aligned in the global shape), a 3-D box of a 3-D shape.
# Each mask case also runs on an input that starts 4 bytes (f32) or 2
# bytes (bf16) past a 16-byte boundary.
RNG_RAGGED = (("1001 elements", (1001,), None),
              ("an odd innermost run", (BATCH, SEQ, DIM),
               ((1, 5), (3, 7), (5, 13))),
              ("a 3-D box", (7, 9, 13), ((1, 3), (2, 5), (3, 7))))
# Mask inputs outside the range where the kernel divides by a reciprocal:
# zeros, subnormals, extremes, infinities.
RNG_SPECIAL = (0.0, -0.0, 1e-40, -3e-39, 1e-30, 2.0**-100, 2.0**100, 3e38,
               -3e38, float("inf"), -float("inf"))
RNG_ULPS = 2.0
# The uniform kind at an initialiser's bound: linear1 of a width-2048
# denoiser, U(+-1/sqrt(2048)).
RNG_UNIFORM = (GEMMA_DIM, FFN)
# Integer operations of one threefry-2x32 (20 rounds of an add, a rotate
# and an xor, 5 key injections of two adds, the input adds, the output
# xor): the stock draws' cost an element, two for randint.
THREEFRY_OPS = 73


def _ulps(a, b) -> float:
    """Largest |a - b| in float32 spacings at the larger magnitude."""
    import torch

    a, b = a.double(), b.double()
    mag = torch.maximum(a.abs(), b.abs()).float()
    spacing = (torch.nextafter(mag, torch.full_like(mag, float("inf")))
               - mag).double()
    return float(((a - b).abs() / spacing).max()) if a.numel() else 0.0


@contextlib.contextmanager
def _plain_draws():
    """``ops.rng.draw_many`` as ``core/rng.py``'s plain versions on the
    card (the initialisers' plain init), inside the block."""
    import torch

    from tinydiffusionmodels_torch.ops import rng as ops_rng

    kernel = ops_rng.draw_many

    def plain(draws, device=None):
        device = torch.device("cuda" if device is None else device)
        return [ops_rng._plain(d, device) for d in draws]

    ops_rng.draw_many = plain
    try:
        yield
    finally:
        ops_rng.draw_many = kernel


def _check_masks(key, hkey, shape, window, what, *, offset=False) -> int:
    """The stock and counter dropout of ``window`` of ``shape``, f32 and
    bf16, forward and backward, against the plain mask; the elements that
    differ. ``offset``: the input starts one element past an aligned
    address."""
    import torch

    from tinydiffusionmodels_torch.core import rng
    from tinydiffusionmodels_torch.ops import rng as ops_rng

    size = tuple(n for _, n in rng.window_of(shape, window))
    bad = 0
    for mode in ("0", "1"):
        os.environ["TDM_FAST_NOISE"] = mode
        for dtype in (torch.float32, torch.bfloat16):
            n = math.prod(size)
            buf = torch.randn(n + 1, device="cuda")
            # Values the kernel's division takes the IEEE path for.
            buf[1:len(RNG_SPECIAL) + 1] = torch.tensor(
                RNG_SPECIAL, device="cuda")[:n]
            buf = buf.to(dtype)
            x = (buf[1:] if offset else buf[:n]).view(size)
            x.requires_grad_()
            got = ops_rng.dropout(x, key, DROPOUT, shape=shape,
                                  window=window)
            (grad,) = torch.autograd.grad(got, x, x.detach())
            keep = rng.draw_keep(hkey, 1.0 - DROPOUT, shape, window,
                                 device="cuda")
            div = torch.tensor(1.0 - DROPOUT, dtype=dtype, device="cuda")
            want = torch.where(keep, x.detach() / div,
                               torch.zeros((), dtype=dtype, device="cuda"))
            differ = int((got != want).sum()) + int((grad != want).sum())
            bad += differ
            print(f"{what} ({'counter' if mode == '1' else 'stock'}, "
                  f"{str(dtype)[6:]}{', unaligned' if offset else ''}): "
                  f"kept {float(keep.float().mean()):.4f}, {differ} "
                  f"elements differ (forward and backward)")
    return bad


def _check_kinds(key, hkey, shape, window, what) -> tuple[float, int]:
    """Normal, counter normal, uniform and randint of ``window`` of
    ``shape`` against the plain versions: (worst ulp, integers and
    uniforms that differ)."""
    from tinydiffusionmodels_torch.core import rng
    from tinydiffusionmodels_torch.ops import rng as ops_rng

    bound = 1.0 / math.sqrt(GEMMA_DIM)
    worst = 0.0
    for kind, kernel, plain in (
            ("normal", ops_rng.normal, rng.normal),
            ("counter", ops_rng.counter_normal, rng.counter_normal)):
        got = kernel(key, shape, window=window)
        u = _ulps(got, plain(hkey, shape, window=window, device="cuda"))
        worst = max(worst, u)
        print(f"{what} {kind}: {tuple(got.shape)}, max {u:.1f} ulp")
    got = ops_rng.uniform(key, shape, -bound, bound, window=window)
    want = rng.uniform(hkey, shape, minval=-bound, maxval=bound,
                       window=window, device="cuda")
    differ = int((got != want).sum())
    got = ops_rng.randint(key, shape, 0, STEPS, window=window)
    want = rng.randint(hkey, shape, 0, STEPS, window=window,
                       device="cuda").long()
    differ += int((got != want).sum())
    print(f"{what} uniform and randint: {differ} elements differ")
    return worst, differ


def _check_step_list(step, host) -> int:
    """A text step's t, noise and three attention seeds as one
    ``draw_many`` launch (``text_train.step_draws``' list) against the
    plain draws; the elements that differ."""
    import torch

    from tinydiffusionmodels_torch.core import rng
    from tinydiffusionmodels_torch.ops import rng as ops_rng

    def draws(k):
        seeds = [ops_rng.attention_seed_draw(rng.substream(rng.fold_in(
            rng.substream(k, "dropout"), i), "attn_weights"))
            for i in range(DEPTH)]
        return [ops_rng.Draw("randint", rng.substream(k, "timesteps"),
                             (BATCH,), None, 0, STEPS, dtype=torch.int64),
                ops_rng.Draw("noise", rng.substream(k, "noise"),
                             (BATCH, SEQ, DIM)), *seeds]

    before = ops_rng.launches
    got = ops_rng.draw_many(draws(step))
    launched = ops_rng.launches - before
    want = [ops_rng._plain(d, torch.device("cuda")) for d in draws(host)]
    bad = sum(int((a != b).sum()) for a, b in zip(got, want))
    print(f"the text step's {len(got)} draws in {launched} launch: {bad} "
          f"elements differ")
    if launched != 1:
        raise AssertionError(f"the step's draws took {launched} launches")
    return bad


def _check_init_on_card() -> tuple[float, int]:
    """The card's initialisation (one draw launch a model) against the
    plain init on the card: the text denoiser at --embed_dim 2048 (depth
    3, abs positions, self-conditioning), its embedding table and
    rounding head (vocab 4096), and the UNet. Uniform-drawn weights and
    zeros and ones bit-equal, the normal tables within RNG_ULPS. Returns
    (worst ulp, elements that differ)."""
    from tinydiffusionmodels_torch.core import rng
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        SimpleUNet,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.ops import rng as ops_rng

    root = rng.prng_key(2026)
    cfg = TransformerConfig(dim=GEMMA_DIM, n_heads=HEADS, depth=DEPTH,
                            pos_emb="abs", self_cond=True, max_len=512)
    builds = (
        (f"text denoiser, dim {GEMMA_DIM}", lambda: TinyTransformer(
            cfg, key=rng.substream(root, "diffusion"), device="cuda")),
        (f"embedding table {GRAPH_VOCAB} x {GEMMA_DIM}",
         lambda: LearnedEmbedding(GRAPH_VOCAB, GEMMA_DIM, key=rng.substream(
             root, "embedding"), device="cuda")),
        (f"rounding head {GEMMA_DIM} -> {GRAPH_VOCAB}",
         lambda: LearnedRounding(GEMMA_DIM, GRAPH_VOCAB, key=rng.substream(
             root, "rounding"), device="cuda")),
        ("UNet", lambda: SimpleUNet(key=rng.substream(root, "init"),
                                    device="cuda")))
    worst, bad = 0.0, 0
    for what, build in builds:
        before = ops_rng.launches
        card = build().state_dict()
        launched = ops_rng.launches - before
        with _plain_draws():
            plain = build().state_dict()
        differ, ulps = 0, 0.0
        for name, got in card.items():
            if name in ("pos_emb.weight", "embeddings.weight"):
                ulps = max(ulps, _ulps(got, plain[name]))
            else:
                differ += int((got != plain[name]).sum())
        n = sum(t.numel() for t in card.values())
        print(f"init of the {what}: {n} parameters in {launched} launch, "
              f"{differ} uniform-drawn or constant elements differ, normals "
              f"max {ulps:.1f} ulp")
        if launched != 1:
            raise AssertionError(f"the {what}'s init took {launched} "
                                 "launches")
        worst, bad = max(worst, ulps), bad + differ
    return worst, bad


def rng_kernel_vs_plain(card: str) -> tuple[float, dict]:
    """Phase 41: ``csrc/rng.cu`` (``ops.rng``) against ``core/rng.py``'s
    plain versions run on the card, from a key path with a device counter
    (the train key, step 12345 read from the device, then the step's
    substreams, as a replayed step derives them): normals (stock and
    counter) within RNG_ULPS float32 spacings, integers (the timesteps at
    B 8 and 128, the flash kernels' int32 seed), uniforms and the dropout
    outputs (stock and counter masks, f32 and bf16, and their backward)
    bit-equal; every kind again on the ragged boxes of RNG_RAGGED and on
    unaligned mask inputs; a text step's draws as one list launch; the
    card's initialisation of the width-2048 text model and of the UNet
    against the plain init. Then CUDA-event times at the text step's
    noise, FFN mask and list, the bf16 step's feature mask and an
    initialiser's uniform, beside the earlier design's (PERF.md §6 row
    8), the plain version, torch's own
    draw of the shape (another stream, so not the same function:
    ``library_ms`` is null) and the bound (the bytes written, and read
    for a mask, at the HBM rate, or for a stock draw its threefry's
    integer operations at the INT32 rate, the larger). Returns (largest
    error, timing row)."""
    import torch

    from tinydiffusionmodels_torch import perf
    from tinydiffusionmodels_torch.core import rng
    from tinydiffusionmodels_torch.ops import rng as ops_rng

    phase("random draws kernel vs plain (csrc/rng.cu against core/rng.py "
          "on the card, full sizes, ragged boxes, lists, initialisation)")
    root = rng.substream(rng.prng_key(2026), "train")
    counter = torch.tensor([12345], device="cuda")
    step = rng.KeyPath(root.cuda(), counter)
    host = rng.fold_in(root, 12345)
    env = os.environ.get("TDM_FAST_NOISE")
    worst_ulps, bad = 0.0, 0
    try:
        for what, shape, window in RNG_NOISE:
            key, hkey = (rng.substream(k, "noise") for k in (step, host))
            for kind, kernel, plain in (
                    ("normal", ops_rng.normal, rng.normal),
                    ("counter", ops_rng.counter_normal, rng.counter_normal)):
                got = kernel(key, shape, window=window)
                want = plain(hkey, shape, window=window, device="cuda")
                u = _ulps(got, want)
                worst_ulps = max(worst_ulps, u)
                print(f"{what} {kind}: {tuple(got.shape)}, "
                      f"{int((got != want).sum())} elements differ, max "
                      f"{u:.1f} ulp (tol {RNG_ULPS:g})")
        for b in (BATCH, MNIST_BATCH):
            key, hkey = (rng.substream(k, "timesteps") for k in (step, host))
            got = ops_rng.randint(key, (b,), 0, STEPS)
            want = rng.randint(hkey, (b,), 0, STEPS, device="cuda").long()
            bad += int((got != want).sum())
        for layer in range(3):
            key, hkey = (rng.substream(rng.fold_in(rng.substream(
                k, "dropout"), layer), "attn_weights") for k in (step, host))
            got = ops_rng.attention_seed(key)
            want = rng.randint(hkey, (1,), -2**31, 2**31 - 1, device="cuda")
            bad += int((got != want).sum())
        print(f"timesteps (B {BATCH}, {MNIST_BATCH}) and 3 attention seeds: "
              f"{bad} integers differ")
        key, hkey = (rng.substream(k, "init") for k in (step, host))
        bound = 1.0 / math.sqrt(GEMMA_DIM)
        got = ops_rng.uniform(key, RNG_UNIFORM, -bound, bound)
        want = rng.uniform(hkey, RNG_UNIFORM, minval=-bound, maxval=bound,
                           device="cuda")
        differ = int((got != want).sum())
        print(f"uniform {RNG_UNIFORM} on +-1/sqrt({GEMMA_DIM}): {differ} "
              f"elements differ")
        bad += differ
        for what, shape, window in RNG_MASKS:
            key, hkey = (rng.substream(k, "dropout_ffn") for k in
                         (step, host))
            bad += _check_masks(key, hkey, shape, window, what)
        for what, shape, window in RNG_RAGGED:
            key, hkey = (rng.substream(k, "ragged") for k in (step, host))
            u, n = _check_kinds(key, hkey, shape, window, what)
            worst_ulps, bad = max(worst_ulps, u), bad + n
            for offset in (False, True):
                bad += _check_masks(key, hkey, shape, window, what,
                                    offset=offset)
        bad += _check_step_list(step, host)
        u, n = _check_init_on_card()
        worst_ulps, bad = max(worst_ulps, u), bad + n
    finally:
        if env is None:
            os.environ.pop("TDM_FAST_NOISE", None)
        else:
            os.environ["TDM_FAST_NOISE"] = env
    if worst_ulps > RNG_ULPS or bad:
        raise AssertionError(f"draws: {worst_ulps} ulp (tol {RNG_ULPS}), "
                             f"{bad} integers, uniforms or mask elements "
                             "differ")

    # Timing: each row under the draws it names (TDM_FAST_NOISE), the
    # card's default being the counter draws.
    key = rng.substream(step, "noise")
    hkey = rng.substream(host, "noise")
    text = (BATCH, SEQ, DIM)
    ffn = (BATCH, SEQ, FFN)
    mask_shape = RNG_MASKS[0][1]
    x16 = torch.randn(mask_shape, device="cuda").bfloat16()
    x32 = torch.randn(ffn, device="cuda")
    bound = 1.0 / math.sqrt(GEMMA_DIM)
    n_uniform = math.prod(RNG_UNIFORM)
    list_draws = [ops_rng.Draw("randint", rng.substream(step, "timesteps"),
                               (BATCH,), None, 0, STEPS, dtype=torch.int64),
                  ops_rng.Draw("noise", key, text)] + [
        ops_rng.attention_seed_draw(rng.substream(step, f"seed{i}"))
        for i in range(DEPTH)]
    plain_list = [dataclasses.replace(d, key=rng.resolve(d.key))
                  for d in list_draws]
    text_bytes = 4 * math.prod(text)
    rows = {}
    # Each row: what, the kernel, the plain version, torch's own draw, the
    # bytes, the stock draws' integer operations, and the kernel's time
    # before its redesign (PERF.md §6 row 8; None: not timed then).
    for what, kernel, plain, torch_draw, nbytes, ops, earlier in (
            (f"counter noise {text}",
             lambda: ops_rng.counter_normal(key, text),
             lambda: rng.counter_normal(hkey, text, device="cuda"),
             lambda: torch.randn(text, device="cuda"), text_bytes, 0,
             0.00461),
            (f"stock noise {text}",
             lambda: ops_rng.normal(key, text),
             lambda: rng.normal(hkey, text, device="cuda"),
             lambda: torch.randn(text, device="cuda"), text_bytes,
             THREEFRY_OPS * math.prod(text), 0.00486),
            (f"counter mask {ffn} f32 (the text f32 step's FFN mask)",
             lambda: ops_rng.dropout(x32, key, DROPOUT),
             lambda: torch.where(rng.counter_bernoulli(
                 hkey, 1.0 - DROPOUT, ffn, device="cuda"), x32 / 0.9, 0.0),
             lambda: torch.empty_like(x32).bernoulli_(0.9).mul_(x32),
             2 * 4 * x32.numel(), 0, None),
            (f"counter mask {mask_shape} bf16",
             lambda: ops_rng.dropout(x16, key, DROPOUT),
             lambda: torch.where(rng.counter_bernoulli(
                 hkey, 1.0 - DROPOUT, mask_shape, device="cuda"),
                 x16 / 0.8984375, 0.0),
             lambda: torch.empty_like(x16).bernoulli_(0.9).mul_(x16),
             2 * 2 * x16.numel(), 0, 0.2499),
            (f"stock mask {mask_shape} bf16",
             lambda: ops_rng.dropout(x16, key, DROPOUT),
             lambda: torch.where(rng.bernoulli(
                 hkey, 1.0 - DROPOUT, mask_shape, device="cuda"),
                 x16 / 0.8984375, 0.0),
             lambda: torch.empty_like(x16).bernoulli_(0.9).mul_(x16),
             2 * 2 * x16.numel(), THREEFRY_OPS * x16.numel(), 0.3973),
            (f"text step list: t, noise {text}, {DEPTH} seeds, one launch",
             lambda: ops_rng.draw_many(list_draws),
             lambda: [ops_rng._plain(d, torch.device("cuda"))
                      for d in plain_list],
             lambda: (torch.randint(0, STEPS, (BATCH,), device="cuda"),
                      torch.randn(text, device="cuda"),
                      torch.randint(-2**31, 2**31 - 1, (DEPTH,),
                                    device="cuda")),
             text_bytes + 8 * BATCH + 4 * DEPTH, 0, None),
            (f"uniform {RNG_UNIFORM} (an initialiser's)",
             lambda: ops_rng.uniform(key, RNG_UNIFORM, -bound, bound),
             lambda: rng.uniform(hkey, RNG_UNIFORM, minval=-bound,
                                 maxval=bound, device="cuda"),
             lambda: torch.empty(RNG_UNIFORM, device="cuda").uniform_(
                 -bound, bound), 4 * n_uniform,
             THREEFRY_OPS * n_uniform, None)):
        stock = what.startswith("stock")
        os.environ["TDM_FAST_NOISE"] = "0" if stock else "1"
        try:
            iters = 50 if ("mask" in what or "uniform" in what) else 200
            # The plain stock mask takes 77 ms a call: a short burst.
            p_iters = 2 if "stock mask" in what else max(5, iters // 10)
            p_ms = [perf.device_ms(plain, p_iters, warmup=1)]
            k_ms = [perf.device_ms(kernel, iters),
                    perf.device_ms(kernel, iters)]
            p_ms.append(perf.device_ms(plain, p_iters, warmup=1))
            t_ms = perf.device_ms(torch_draw, iters)
        finally:
            if env is None:
                os.environ.pop("TDM_FAST_NOISE", None)
            else:
                os.environ["TDM_FAST_NOISE"] = env
        bound_ms, bound_by = perf.bound_ms(
            nbytes, [(ops, "int32")] if ops else [])
        rows[what] = dict(ms=sum(k_ms) / 2, plain_ms=sum(p_ms) / 2,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None, torch_draw_ms=t_ms,
                          earlier_ms=earlier, bytes=nbytes, int_ops=ops)
        print(f"{what}: kernel {k_ms} ms (before the redesign: {earlier}), "
              f"plain {p_ms} "
              f"ms, torch's own draw (another stream) {t_ms} ms; bound "
              f"{bound_ms} ms by {bound_by} ({nbytes} B, {ops} integer "
              f"operations), {sum(k_ms) / 2 / bound_ms:.2f}x; on {card}")
    head = rows[f"counter noise {text}"]
    timing = {**head, "at": f"counter noise {text} f32 (the text step's, "
                            f"TDM_FAST_NOISE auto on the card)",
              "library": "none: torch draws another stream; torch_draw_ms "
                         "is torch.randn, randint, uniform_ or bernoulli_ + "
                         "mul_ of the shape",
              "shapes": {k: v for k, v in rows.items()
                         if k != f"counter noise {text}"},
              "max_ulp_normals": worst_ulps}
    return worst_ulps, timing


VALIDATION_EPOCHS = 3


def validation_replay(card: str, joint) -> dict:
    """Phase 37: the validation pass as one CUDA graph
    (``text_train.EvalPass``) at the headline width, on phase 5's corpus
    split (its validation batches), for the trained weights (live) and an
    EMA-like second set (the live weights halfway to a fresh init, not
    trainable): the replayed pass against the eager one and against the
    plain loop (``eval_losses`` with the epoch's fresh generator), bit for
    bit, over VALIDATION_EPOCHS epochs (the generator re-seeded before each
    replay), and its launches (depth per batch, replayed; the prime's
    depth). Prints the wall time of a pass each way. Returns the
    launches."""
    import copy

    import numpy as np
    import torch

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.data import (
        CharTokenizer,
        batch_iterator,
        load_text_corpus,
        tokenize_corpus,
    )
    from tinydiffusionmodels_torch.train import text_train

    phase("validation as one CUDA graph (EvalPass) against the eager pass "
          "and the plain loop, live and EMA weights")
    start = time.perf_counter()
    corpus, _ = load_text_corpus(WORK / "data")
    corpus = corpus[:TRAIN_CHARS]
    _, val_chunks = tokenize_corpus(corpus, CharTokenizer(corpus), SEQ, 0.1)
    val_dev = torch.as_tensor(np.stack(list(batch_iterator(
        val_chunks, BATCH, shuffle=False))), dtype=torch.long, device="cuda")
    k = val_dev.shape[0]
    sched = make_schedule(device="cuda")
    kw = dict(sched=sched, use_learned_embeddings=True,
              pretrained_matrix=None)
    ema = copy.deepcopy(joint).requires_grad_(False)
    fresh = copy.deepcopy(joint)
    fresh["diffusion_model"].reset_parameters(_init_key(61))
    with torch.no_grad():
        for p, f in zip(ema.parameters(), fresh.parameters()):
            p.lerp_(f, 0.5)
    del fresh
    launches = {}
    for what, weights in (("live", joint), ("EMA", ema)):
        depth = weights["diffusion_model"].cfg.depth
        eager = text_train.EvalPass(weights, val_dev, seed=0, eager=True,
                                    **kw)
        replayed = text_train.EvalPass(weights, val_dev, seed=0, **kw)
        walls = {"eager": [], "replayed": []}
        for epoch in range(VALIDATION_EPOCHS):
            w = 1.0 - 0.1 * epoch
            plain = text_train.eval_losses(
                weights, val_dev, w, text_train.val_key(0, epoch), **kw)
            got = {}
            for mode, fn in (("eager", eager), ("replayed", replayed)):
                torch.cuda.synchronize()
                _reset_counts()
                t0 = time.perf_counter()
                got[mode] = fn(epoch, w)
                walls[mode].append(time.perf_counter() - t0)
                counts = _counts()
                # The first replayed call primes its graph: one batch.
                batches = k + (1 if mode == "replayed" and epoch == 0
                               else 0)
                want = {n: 0 for n in counts}
                want["flash_attention_fwd"] = batches * depth
                want["rng_draw"] = k     # each batch's t and noise
                if counts != want:
                    raise AssertionError(f"{what} {mode} validation, epoch "
                                         f"{epoch}: launches {counts}, "
                                         f"expected {want}")
                if mode == "replayed" and epoch > 0:
                    launches = {n: launches.get(n, 0) + c
                                for n, c in counts.items()}
            if not (np.array_equal(got["eager"], got["replayed"])
                    and np.array_equal(got["eager"], plain)):
                raise AssertionError(
                    f"{what} validation, epoch {epoch}: replayed "
                    f"{got['replayed']}, eager {got['eager']}, plain loop "
                    f"{plain}: not bit-equal")
            print(f"{what} epoch {epoch}: (diff, round, total) "
                  f"{got['replayed'].tolist()} bit-equal replayed, eager "
                  f"and plain")
        if np.array_equal(replayed(0, 1.0), replayed(1, 1.0)):
            raise AssertionError("the replay after a re-seed drew the "
                                 "previous epoch's stream")
        print(f"{what} validation ({k} batches of {BATCH} x {SEQ}, depth "
              f"{depth}): wall ms a pass, eager "
              f"{[round(1e3 * s, 3) for s in walls['eager']]}, replayed "
              f"{[round(1e3 * s, 3) for s in walls['replayed']]} (the "
              f"first replayed pass primes and captures), on {card}")
    print(f"phase: {time.perf_counter() - start:.1f} s")
    return launches


TP_TIMEOUT_S = 300
TP_MARK = "CHIP_SMOKE_TP "


def _tp_child(rank: int, store: str) -> None:
    """``chip_smoke.py --tp RANK STORE``: one rank of a gloo group of two
    on the one card, both on cuda:0 (gloo moves CUDA tensors through the
    host). Runs the text step of the dry run at the headline width
    (``dryrun.text_step``: one SGD step at learning rate 1) over a 'model'
    axis of 2 and in one process, and prints TP_MARK and a JSON object:
    the largest difference, the TP step's launches and its wall time."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tinydiffusionmodels_torch import dryrun
    from tinydiffusionmodels_torch.models import TransformerConfig
    from tinydiffusionmodels_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        cfg = TransformerConfig(dim=DIM, n_heads=HEADS, depth=DEPTH,
                                dropout=DROPOUT, timesteps=1000)
        tokens = torch.as_tensor(np.random.default_rng(6).integers(
            0, dryrun.VOCAB, (BATCH, SEQ)), device=dev)
        mesh = make_mesh({"data": 1, "model": 2})
        dryrun.text_step(cfg, tokens, mesh, dev)   # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        got = dryrun.text_step(cfg, tokens, mesh, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        want = dryrun.text_step(cfg, tokens, None, dev)
        err = dryrun._worst("TP step on the card", got, want)
        print(TP_MARK + json.dumps({"rank": rank, "max_abs_err": err,
                                    "counts": counts, "wall_s": wall}),
              flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def tp_on_card(card: str) -> dict:
    """Phase 38: tensor parallelism on the card. NCCL refuses two ranks on
    one GPU, so the two ranks of a 'model' axis of 2 are two processes
    joined by gloo on the one H100 (gloo stages the CUDA all-reduces
    through the host): the headline text step (dim 256, 4 heads, depth 3,
    FFN 2048, dropout 0.1, bs 8, seq 64) with each rank's 2 heads on the
    flash kernels at head offsets 0 and 2, held within 1e-5 (losses, and
    every parameter after one SGD step at learning rate 1, gathered whole)
    of the same step in one process; eager (gloo does not capture).
    Returns the TP steps' launches (both ranks)."""
    phase("tensor parallelism on the card: 2 ranks (gloo) on one H100 "
          "against the one-process step")
    t0 = time.perf_counter()
    work = WORK / "tp"
    work.mkdir(parents=True, exist_ok=True)
    store = work / "store"
    store.unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO)
    procs = []
    for rank in range(2):
        log = work / f"rank{rank}.log"
        with open(log, "w") as out:
            procs.append((subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--tp",
                 str(rank), str(store)], cwd=work, env=env, stdout=out,
                stderr=subprocess.STDOUT, text=True), log))
    deadline = time.monotonic() + TP_TIMEOUT_S
    records = []
    for proc, log in procs:
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
                p.wait()
            raise AssertionError(f"the TP ranks did not finish in "
                                 f"{TP_TIMEOUT_S} s") from None
        text = log.read_text()
        lines = [ln for ln in text.splitlines() if ln.startswith(TP_MARK)]
        if proc.returncode or not lines:
            raise AssertionError(f"TP rank exited {proc.returncode}:\n"
                                 f"{text[-4000:]}")
        records.append(json.loads(lines[-1][len(TP_MARK):]))
    counts = {}
    for rec in records:
        expect = {n: 0 for n in _others(rec["counts"])}
        expect.update({"flash_attention_fwd": DEPTH,
                       "flash_attention_bwd_dq": DEPTH,
                       "flash_attention_bwd_dkv": DEPTH})
        if _others(rec["counts"]) != expect:
            raise AssertionError(f"TP rank {rec['rank']}: launches "
                                 f"{rec['counts']}, expected {expect}")
        counts = {n: counts.get(n, 0) + c for n, c in rec["counts"].items()}
        print(f"TP rank {rec['rank']} (heads {TP_HEADS * rec['rank']}-"
              f"{TP_HEADS * rec['rank'] + TP_HEADS - 1}): max |diff| from "
              f"the one-process step {rec['max_abs_err']:.3e} (tol 1e-5); "
              f"launches {_nonzero(rec['counts'])}; eager TP step "
              f"{rec['wall_s'] * 1e3:.1f} ms wall")
    print(f"tensor parallelism ran 2 ranks (gloo, one card) on {card}; "
          f"NCCL at world > 1 is not verified (one card); phase "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


XPROF_TIMEOUT_S = 400
# The headline text step and the JAX tool's own question, bf16 MNIST at
# bs 2048 against 512 (every step: ``python -m
# tinydiffusionmodels_torch.xprof_ops`` alone).
XPROF_STEPS = "text_f32,mnist_bf16"
# The share of a replay's launches the profiler must record: a table that
# missed kernels (as the profiler once missed 12 of 20 eager SDPA
# launches) would read low.
XPROF_MIN_COVERAGE = 0.99


def xprof_on_card(card: str) -> list:
    """Phase 39: ``python -m tinydiffusionmodels_torch.xprof_ops`` in a
    fresh process (XPROF_STEPS: text f32 at bs 8, MNIST bf16 at 512 and
    2048):
    its tables printed here, and each step's coverage asserted: the
    kernels the profiler recorded a replay between XPROF_MIN_COVERAGE of
    the replay's launches and all of them (the graph's kernel nodes, and
    two fills of each registered generator that ``CUDAGraph.replay``
    launches outside the graph), and the profiled device time no more
    than 1.05 x the CUDA-event time.
    Returns the records."""
    import torch

    phase("the per-op device table tool (xprof_ops) in a fresh process")
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(REPO), TDM_PLATFORM="cuda")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tinydiffusionmodels_torch.xprof_ops",
         "--steps", XPROF_STEPS, "--batches", "512,2048"],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=XPROF_TIMEOUT_S)
    print(out.stdout)
    if out.returncode:
        raise AssertionError(f"xprof_ops exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    records = [json.loads(ln[len("XPROF "):]) for ln in
               out.stdout.splitlines() if ln.startswith("XPROF ")]
    names = [r["step"] for r in records]
    for want in ("text_f32_bs8", "mnist_bf16_bs512", "mnist_bf16_bs2048"):
        if want not in names:
            raise AssertionError(f"xprof_ops printed no {want}: {names}")
    for r in records:
        if r["platform"] != "cuda" or r["timer"] != "cuda events":
            raise AssertionError(f"{r['step']}: not a card reading: {r}")
        launched = r["replay_launches"]
        if not XPROF_MIN_COVERAGE * launched <= r["recorded_kernels"] <= (
                launched):
            raise AssertionError(
                f"{r['step']}: {r['recorded_kernels']} kernels recorded, "
                f"{launched} launched a replay (at least "
                f"{XPROF_MIN_COVERAGE} of them must be recorded)")
        if not 0 < r["profiled_us"] <= 1.05 * r["timer_us"]:
            raise AssertionError(
                f"{r['step']}: profiled {r['profiled_us']} us against "
                f"{r['timer_us']} us by CUDA events")
        print(f"xprof coverage {r['step']}: {r['recorded_kernels']:.2f} of "
              f"{r['replay_launches']:.2f} kernels, "
              f"{r['profiled_us']:.2f} of {r['timer_us']:.2f} us per "
              f"{r['unit']}")
    print(f"xprof_ops: {time.perf_counter() - t0:.1f} s, on {card}")
    return records


# PERF.md §5's replayed steps before the draws moved to the key tree
# (xprof_ops on the bench's steps): profiled device us and kernels a step,
# printed beside phase 13's rows.
PERF5_STEPS = {
    f"text train bs {BATCH} f32": (1372.8, 244),
    f"MNIST train bs {MNIST_BATCH} f32": (4426.5, 268),
    f"text train bs {BF16_BATCH} bf16 (vocab {GRAPH_VOCAB})": (10823.6, 326),
    f"MNIST train bs {BF16_BATCH} bf16": (4682.3, 258),
    f"text sampler n {N}": (364.4, 60),
}


def main() -> None:
    import torch

    t_start = time.perf_counter()
    card = environment()
    build()
    fwd_errors = kernel_vs_plain()
    train_errors, mask_mismatches = training_kernels()
    offset_errors = flash_head_offsets()
    batch_offset_errors = flash_batch_offsets()
    rng_error, rng_timing = rng_kernel_vs_plain(card)
    resblock_error, resblock_bf16_error = resblock_kernel_vs_plain()
    single_block_errors = single_block_kernel_vs_plain()
    result, ckpt, train_counts, _ = main_path_train(card)
    model = result.joint["diffusion_model"].eval()
    sample_counts, _, z = main_path_sample(card, ckpt, model)
    validation_counts = validation_replay(card, result.joint)
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
    gemma_counts, gemma_row = gemma_guided_decode(card)
    gemma_hf_counts = gemma_hf_cli(card)
    ring_errors = ring_on_card(card)
    torchrun_counts = torchrun_paths(card)
    replayed_step_with_group(card)
    tp_counts = tp_on_card(card)
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
    print(f"\nsteps eager and replayed, on {card}; the last column is "
          f"PERF.md §5's replayed row before the draws moved to the key "
          f"tree (xprof_ops: profiled device us / kernels; the bench's "
          f"steps, which phase 39 prints again):")
    print("step | mode | wall us | device us | busy | kernels | PERF.md §5")
    for what, modes in rows.items():
        for mode, r in modes.items():
            before = PERF5_STEPS.get(what) if mode == "replayed" else None
            print(f"{what} | {mode} | {r['wall_us']:.1f} | "
                  f"{r['device_us']:.1f} | {r['busy']:.3f} | "
                  f"{r['kernels']:.1f} | "
                  f"{'-' if before is None else '%.1f / %d' % before}")
    suite_counts = main_path_bench(card)
    xprof_on_card(card)
    # After every in-process profile: once phase 34's CLI runs had run
    # before them, torch.profiler here recorded no device time.
    resume_counts, resume_mnist_ckpt = resume_on_card(card)
    fidelity_counts = fidelity_on_card(card, resume_mnist_ckpt, ckpt, lm_ckpt)
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
              "attention_single_block_bwd": single_block_errors["bwd"],
              "rng_draw": rng_error}
    timings["rng_draw"] = rng_timing
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
        "n128": {k: n128[k] for k in (*sums, "bound_by")},
        "bf16_n25": n25["bf16"], "bf16_n128": n128["bf16"],
        "blocks_n25": n25["blocks"], "blocks_n128": n128["blocks"],
        "plain": "cuDNN convs, TF32 off; no single PyTorch call computes "
                 "the block, so library_ms is null",
        "max_abs_err_bf16": resblock_bf16_error,
    }
    paths = (train_counts, sample_counts, narrow_train_counts,
             narrow_sample_counts, wide_train_counts, wide_sample_counts,
             gemma_train_counts, gemma_sample_counts, guided_counts,
             exact_counts, decoder_counts, gemma_counts, gemma_hf_counts,
             mnist_train_counts, *mnist_sample_counts, bench_counts,
             bf16_text_counts, bf16_mnist_counts, suite_counts,
             *torchrun_counts, *resume_counts, *fidelity_counts,
             validation_counts, tp_counts)
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
        if name == "flash_attention_fwd":
            entry["gemma_2b_guided_decode"] = gemma_row
        if name.startswith("flash"):
            entry["ring_max_abs_err_f32"] = ring_errors[
                {"flash_attention_fwd": "out", "flash_attention_bwd_dq": "dq",
                 "flash_attention_bwd_dkv": "dkv"}[name]]
            part = {"flash_attention_fwd": "out",
                    "flash_attention_bwd_dq": "dq",
                    "flash_attention_bwd_dkv": "dkv"}[name]
            entry["head_offset_max_abs_err_f32"] = offset_errors[part]
            entry["batch_offset_max_abs_err_f32"] = batch_offset_errors[part]
            entry["dropout_hash"] = {"source": DROPOUT_HASH[0],
                                     "replaces": DROPOUT_HASH[1],
                                     "mask_mismatches": mask_mismatches}
        if name == "rng_draw":
            entry["max_abs_err_unit"] = ("float32 spacings of the normals; "
                                         "integers and masks bit-equal")
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
    elif sys.argv[1:2] == ["--tp"]:
        _tp_child(int(sys.argv[2]), sys.argv[3])
    else:
        main()
