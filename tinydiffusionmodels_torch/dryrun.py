"""Multi-process dry run of every parallel path (port of
``__graft_entry__.dryrun_multichip``).

    python -m tinydiffusionmodels_torch.dryrun N [--timeout SECONDS]

Starts N processes on the CPU (``TDM_PLATFORM=cpu``, one thread each),
joined in one gloo group through a file store in a temporary directory,
and runs the JAX dry run's five sections at its shapes, one training step
(or one call) each:

1. MNIST UNet, data-parallel over ('data',) N. The port has one form of
   the data-parallel step, the explicit all-reduce
   (``parallel/data_parallel.py``), so this section stands for both of the
   JAX package's (GSPMD and ``shard_map_step``'s psum).
2. The text transformer over data N/2 x model 2 (N even): dim 64, 4
   heads, depth 2, FFN 128, dropout 0.1, vocabulary 97, the denoiser
   split by ``parallel.tp``.
3. Ring attention over ('seq',) N.
4. Sequence-parallel text training over ('seq',) N: dim 32, depth 1,
   FFN 64, dropout 0.1.
5. Data N/2 x seq 2 text training (N >= 4, even).

Every rank also runs the section's step in one process, on the same
inputs and weights, and the section fails unless every output (losses and
every parameter after the step, or the attention output) is within 1e-5
of it. The one-process text step draws each data shard's dropout from
that shard's generator, as the trainer's shards do (``train/
text_train.py``: a generator of its own for each data shard), and
averages the shards' gradients. Every step is SGD at learning rate 1, so
the parameters after it differ from their start by the gradient itself:
AdamW's first step turns a gradient that is zero up to rounding (the key
bias's; at 8 ranks some of the UNet's) into +-lr whichever way the
rounding goes, and the ranks' reductions round otherwise than one
process's sums. Rank 0 prints
one line a section, and the run ends with ``[dryrun] OK on N devices``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SEED = 0
TOL = 1e-5
VOCAB = 97
_REPO = Path(__file__).resolve().parents[1]


def _params(module) -> dict:
    return {n: p.detach() for n, p in module.named_parameters()}


def _worst(what: str, got: dict, want: dict) -> float:
    """The largest |got - want|; raises unless every pair is within TOL
    (relative and absolute)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=TOL, atol=TOL):
            raise AssertionError(
                f"{what}: {name} differs from the one-process step by "
                f"{float((g - w).abs().max()):.3e} (tolerance {TOL})")
    return worst


def mnist_dp(world: int, device) -> str:
    """Section 1: one step of the MNIST UNet over ('data',) world."""
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.models import SimpleUNet
    from tinydiffusionmodels_torch.parallel import make_mesh
    from tinydiffusionmodels_torch.train import mnist_train

    sched = make_schedule(10, device=device)
    mesh = make_mesh({"data": world})
    batch = torch.as_tensor(np.random.default_rng(1).uniform(
        -1, 1, (2 * world, 28, 28, 1)).astype(np.float32), device=device)

    def step(m) -> dict:
        model = SimpleUNet(sched.timesteps, generator=torch.Generator(
        ).manual_seed(SEED)).to(device)
        optimizer = torch.optim.SGD(model.parameters(), lr=1.0)
        loss = mnist_train.train_step(
            model, optimizer, batch, sched,
            torch.Generator(device=device).manual_seed(1), mesh=m)
        return {"loss": loss.reshape(1).detach(), **_params(model)}

    got = step(mesh)
    err = _worst("mnist dp", got, step(None))
    return (f"[dryrun] mnist dp({world}): loss={float(got['loss']):.4f}, "
            f"max |diff| from one process {err:.2e} (the explicit "
            f"all-reduce step: the JAX package's GSPMD and shard_map "
            f"variants in one)")


def _joint(cfg, device):
    from torch import nn

    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
    )

    g = torch.Generator().manual_seed(SEED)
    return nn.ModuleDict({
        "diffusion_model": TinyTransformer(cfg, generator=g),
        "rounding_fn": LearnedRounding(cfg.dim, VOCAB, generator=g),
        "embedding_fn": LearnedEmbedding(VOCAB, cfg.dim, generator=g),
    }).to(device)


def _one_process_step(joint, optimizer, tokens, gen, drop_gens, *, sched,
                      **kw) -> torch.Tensor:
    """The global text step in one process: the timesteps and noise of the
    whole batch from ``gen``, then each data shard's rows with its own
    dropout generator, the shards' losses and gradients averaged."""
    from tinydiffusionmodels_torch.train import text_train

    t, noise = text_train._draw_t_noise(joint, tokens, sched.timesteps, gen)
    dp = len(drop_gens)
    rows = tokens.shape[0] // dp
    optimizer.zero_grad(set_to_none=True)
    sums = torch.zeros(3, device=tokens.device)
    for d, drop_gen in enumerate(drop_gens):
        cut = slice(d * rows, (d + 1) * rows)
        total, (diff, round_) = text_train._losses(
            joint, tokens[cut], t[cut], noise[cut], 1.0, sched=sched,
            deterministic=False, generator=drop_gen, **kw)
        (total / dp).backward()
        sums += torch.stack([diff, round_, total]).detach()
    optimizer.step()
    return sums / dp


def text_step(cfg, tokens, mesh, device, seq_cfg=None,
              shards: int = 1) -> dict:
    """One SGD step (learning rate 1) of the text trainer's step on
    ``tokens``: over ``mesh`` (the denoiser split on its 'model' axis, the
    sequence on its 'seq' axis with ``seq_cfg``, the model configured for
    it), or with ``mesh`` None in one process, as ``shards`` data shards
    (``cfg``'s model). Returns the losses and every parameter after the
    step, whole."""
    from tinydiffusionmodels_torch import ops
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.parallel import (
        gather_transformer,
        shard_transformer,
    )
    from tinydiffusionmodels_torch.train import text_train

    sched = make_schedule(cfg.timesteps, device=device)
    kw = dict(sched=sched, use_learned_embeddings=True,
              pretrained_matrix=None)
    gen = text_train._generator(device, SEED, 0)
    if mesh is not None:
        joint = _joint(seq_cfg or cfg, device)
        shard_transformer(joint["diffusion_model"], mesh)
        if "seq" in mesh.shape:
            ops.register_sequence_mesh(mesh, "seq")
        dp = mesh.axis_size("data")
        drop_gen = (text_train._generator(device, SEED, 0,
                                          1 + mesh.index("data"))
                    if dp > 1 else None)
        optimizer = torch.optim.SGD(joint.parameters(), lr=1.0)
        losses = text_train.train_step(
            joint, optimizer, tokens, 1.0, gen, mesh=mesh,
            dropout_generator=drop_gen, **kw)
        gather_transformer(joint["diffusion_model"], mesh)
    else:
        joint = _joint(cfg, device)
        optimizer = torch.optim.SGD(joint.parameters(), lr=1.0)
        drop_gens = ([text_train._generator(device, SEED, 0, 1 + d)
                      for d in range(shards)] if shards > 1 else [gen])
        losses = _one_process_step(joint, optimizer, tokens, gen, drop_gens,
                                   **kw)
    return {"losses": losses.detach(), **_params(joint)}


def _text_section(what: str, cfg, tokens, axes: dict, device,
                  seq: bool = False) -> tuple[dict, float]:
    import dataclasses

    from tinydiffusionmodels_torch.parallel import make_mesh

    mesh = make_mesh(axes)
    seq_cfg = dataclasses.replace(cfg, seq_axis="seq") if seq else None
    got = text_step(cfg, tokens, mesh, device, seq_cfg)
    want = text_step(cfg, tokens, None, device,
                     shards=mesh.axis_size("data"))
    return got, _worst(what, got, want)


def text_dp_tp(world: int, device) -> str:
    """Section 2: the text step over data world/2 x model 2."""
    from tinydiffusionmodels_torch.models import TransformerConfig

    tp, dp = 2, world // 2
    cfg = TransformerConfig(dim=64, n_heads=4, depth=2, dropout=0.1,
                            ffn_dim=128, timesteps=10)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, VOCAB, (2 * dp, 16)), device=device)
    got, err = _text_section("text dp x tp", cfg, tokens,
                             {"data": dp, "model": tp}, device)
    return (f"[dryrun] text dp({dp})xtp({tp}): "
            f"total={float(got['losses'][2]):.4f}, max |diff| from one "
            f"process {err:.2e}")


def ring(world: int, device) -> str:
    """Section 3: ring attention over ('seq',) world against attention
    over the whole sequence."""
    from tinydiffusionmodels_torch.ops import flash_attention
    from tinydiffusionmodels_torch.parallel import (
        gather_positions,
        make_mesh,
        ring_attention_shard,
    )

    mesh = make_mesh({"seq": world})
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal(
        (1, 2, 16 * world, 16)).astype(np.float32), device=device)
        for _ in range(3))
    i = mesh.index("seq")
    local = [x.narrow(2, 16 * i, 16) for x in (q, k, v)]
    out = gather_positions(mesh, ring_attention_shard(
        *local, mesh=mesh, axis="seq"), "seq", dim=2)
    err = _worst("ring attention", {"out": out},
                 {"out": flash_attention.flash_attention(q, k, v)})
    return (f"[dryrun] ring attention sp({world}): out={tuple(out.shape)}, "
            f"max |diff| from one process {err:.2e}")


def text_sp(world: int, device) -> str:
    """Section 4: sequence-parallel text training over ('seq',) world."""
    from tinydiffusionmodels_torch.models import TransformerConfig

    cfg = TransformerConfig(dim=32, n_heads=4, depth=1, dropout=0.1,
                            ffn_dim=64, timesteps=10)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, VOCAB, (2, 16 * world)), device=device)
    got, err = _text_section("text sp", cfg, tokens, {"seq": world}, device,
                             seq=True)
    return (f"[dryrun] text sp({world}) ring-attention train step: "
            f"total={float(got['losses'][2]):.4f}, max |diff| from one "
            f"process {err:.2e}")


def text_dp_sp(world: int, device) -> str:
    """Section 5: text training over data world/2 x seq 2."""
    from tinydiffusionmodels_torch.models import TransformerConfig

    sp, dp = 2, world // 2
    cfg = TransformerConfig(dim=32, n_heads=4, depth=1, dropout=0.1,
                            ffn_dim=64, timesteps=10)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, VOCAB, (2 * dp, 16 * sp)), device=device)
    got, err = _text_section("text dp x sp", cfg, tokens,
                             {"data": dp, "seq": sp}, device, seq=True)
    return (f"[dryrun] text dp({dp})xsp({sp}) ring-attention train step: "
            f"total={float(got['losses'][2]):.4f}, max |diff| from one "
            f"process {err:.2e}")


def sections(world: int):
    """The sections that run at this world size, in order."""
    out = [mnist_dp]
    if world % 2 == 0:
        out.append(text_dp_tp)
    out += [ring, text_sp]
    if world >= 4 and world % 2 == 0:
        out.append(text_dp_sp)
    return out


def _rank_main(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    # oneDNN picks its CPU convolution algorithm by batch size: the UNet's
    # gradient at 2 rows a rank differs from one process's at 16 by up to
    # 4e-5 with it, 4.5e-7 without (the ranks' sums alone).
    torch.backends.mkldnn.enabled = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        device = torch.device("cpu")
        for section in sections(world):
            line = section(world, device)
            if rank == 0:
                print(line, flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(world: int, timeout: float = 900.0) -> None:
    """Start ``world`` ranks, wait for them, print rank 0's lines; raises
    (killing every rank) on a failure or past ``timeout`` seconds."""
    if world < 1:
        raise ValueError(f"the dry run needs 1 or more processes, not {world}")
    with tempfile.TemporaryDirectory(prefix="tdm-dryrun-") as tmp:
        env = dict(os.environ, TDM_PLATFORM="cpu", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(_REPO), os.environ.get("PYTHONPATH", "")]))
        procs, logs = [], []
        for rank in range(world):
            log = open(Path(tmp) / f"rank{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tinydiffusionmodels_torch.dryrun",
                 "--rank", str(rank), str(world), str(Path(tmp) / "store")],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the dry run on {world} processes did not "
                               f"finish in {timeout:.0f} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for log in logs:
                log.seek(0)
                texts.append(log.read())
                log.close()
        for rank, p in enumerate(procs):
            if p.returncode:
                raise RuntimeError(f"rank {rank} of {world} exited "
                                   f"{p.returncode}:\n{texts[rank][-4000:]}")
        print(texts[0], end="", flush=True)
    print(f"[dryrun] OK on {world} devices", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="every parallel path over N gloo processes on the CPU")
    parser.add_argument("n", type=int, help="processes (devices)")
    parser.add_argument("--timeout", type=float, default=900.0)
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("store", nargs="?", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.n, args.store)
    else:
        run(args.n, args.timeout)


if __name__ == "__main__":
    main()
