"""Data- and sequence-parallel training of the torch package on the CPU.

Real process groups: ``spawn`` starts one Python process per rank with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and
``TDM_PLATFORM=cpu``; each joins a gloo group through
``parallel.multihost.initialize`` with a ``FileStore`` under the test's
temporary directory (no TCP port, so parallel test workers cannot
collide), runs one task of this file and hands numpy arrays back. One spawn
per world size runs every check of that size; its result is shared by the
test workers of a session, and every spawn has its own timeout.

The checks: the mesh rules of the JAX package's ``tests/test_parallel.py``;
a world-2 data-parallel MNIST step and text step equal to the world-1 step
on the same global batch (losses and parameters after one AdamW step,
within 1e-5, as ``tests/test_parallel.py`` holds the JAX package's data
parallelism); sequence-parallel text steps (a ring of 2, and data 2 x ring
2 on 4 ranks) with absolute and rotary positions equal to world 1 after
one SGD step, the counterparts of ``tests/test_seq_parallel.py``'s
training equivalences (which use SGD too; ``text_step`` says why); the
ring of 2 at dropout 0.1 too, since the ring draws each mask for the whole
sequence; the routing of ``ops.attention``; and the text CLI with
``--seq_parallel`` under a process group (a ring of 2 writes the
checkpoint one process writes).
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120.0
TOL = dict(rtol=1e-5, atol=1e-5)
# Samples: the sampling limit of the port's CPU tests (PERF.md §2), since
# the ring samples with weights that its training left within TOL of one
# process's, and 5 DDIM steps amplify that.
SAMPLE_TOL = dict(rtol=1e-3, atol=1e-3)

VOCAB, DIM, B, L = 29, 32, 4, 16


# --- process groups ---------------------------------------------------------

def spawn(world: int, module: str, task: str, workdir: Path,
          timeout: float = SPAWN_TIMEOUT) -> list[dict]:
    """Run ``task`` of test module ``module`` in ``world`` processes of one
    gloo group; the arrays each rank returned, by rank. Fails (and kills
    every rank) past ``timeout`` seconds."""
    workdir.mkdir(parents=True, exist_ok=True)
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), TDM_PLATFORM="cpu",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / f"{module}.py"), task,
             str(workdir)], env=env, cwd=str(workdir),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{task} at world {world} did not finish in "
                    f"{timeout:.0f} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            pytest.fail(f"{task}, rank {rank} of {world} exited "
                        f"{p.returncode}:\n{log[-4000:]}")
    out = []
    for rank in range(world):
        with np.load(workdir / f"rank{rank}.npz") as f:
            out.append(dict(f))
    return out


def shared_spawn(tmp_path_factory, world: int, module: str,
                 task: str) -> list[dict]:
    """``spawn`` once per test session: the test workers of one session
    share the first one's result through a lock in their common
    temporary directory."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent / f"spawn-{run}" if run
            else tmp_path_factory.getbasetemp() / "spawn")
    root.mkdir(parents=True, exist_ok=True)
    workdir = root / f"{module}-{task}-{world}"
    with open(root / f"{module}-{task}-{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = workdir / "done"
        if done.exists():
            out = []
            for rank in range(world):
                with np.load(workdir / f"rank{rank}.npz") as f:
                    out.append(dict(f))
            return out
        out = spawn(world, module, task, workdir)
        done.write_text("ok")
        return out


def worker_main(tasks: dict) -> None:
    """A rank's process: join the group, run the task named in argv, save
    its arrays as ``rank{RANK}.npz``."""
    import torch

    from tinydiffusionmodels_torch.parallel import multihost

    torch.set_num_threads(1)
    task, workdir = sys.argv[1], Path(sys.argv[2])
    assert multihost.initialize(init_method=f"file://{workdir / 'store'}")
    import torch.distributed as dist

    try:
        arrays = tasks[task]()
        np.savez(workdir / f"rank{dist.get_rank()}.npz", **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# --- the tasks (run by every rank, and at world 1 in the test process) -------

def _text_joint(pos_emb: str, dropout: float, seq_axis):
    import torch
    from torch import nn

    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )

    cfg = TransformerConfig(dim=DIM, n_heads=4, depth=2, dropout=dropout,
                            ffn_dim=64, timesteps=100, pos_emb=pos_emb,
                            max_len=64, seq_axis=seq_axis)
    g = torch.Generator().manual_seed(0)
    return nn.ModuleDict({
        "diffusion_model": TinyTransformer(cfg, generator=g),
        "rounding_fn": LearnedRounding(DIM, VOCAB, generator=g),
        "embedding_fn": LearnedEmbedding(VOCAB, DIM, generator=g),
    })


def text_step(axes=None, pos_emb="none", dropout=0.0, parallel=True,
              sgd=False):
    """One AdamW step of ``text_train.train_step`` on a global batch of B
    rows of L tokens: the losses and every parameter after it. ``axes``
    (a mesh) with a 'seq' axis runs the model on its ring;
    ``parallel=False`` is the single-device step.

    ``sgd``: a step of SGD at learning rate 1 instead, so the parameters
    after it differ from those before by the averaged gradient itself. The
    ring steps use it, as the JAX package's sequence-parallel tests use
    SGD: the gradient of the key bias is zero up to rounding (a constant
    added to every key of a row moves no softmax), and AdamW's first step
    turns that rounding into +-lr whatever its size, so the ring's other
    summation order would show as differences of lr there."""
    import torch

    from tinydiffusionmodels_torch import ops
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.parallel import make_mesh
    from tinydiffusionmodels_torch.train import text_train
    from tinydiffusionmodels_torch.train.optim import adamw

    mesh = make_mesh(axes) if parallel else None
    seq_axis = "seq" if mesh is not None and "seq" in mesh.shape else None
    if seq_axis:
        ops.register_sequence_mesh(mesh, seq_axis)
    joint = _text_joint(pos_emb, dropout, seq_axis)
    optimizer = (torch.optim.SGD(joint.parameters(), lr=1.0) if sgd
                 else adamw(joint.parameters(), 1e-3))
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, VOCAB, (B, L)))
    losses = text_train.train_step(
        joint, optimizer, tokens, 0.5, torch.Generator().manual_seed(7),
        sched=make_schedule(100), mesh=mesh,
        use_learned_embeddings=True, pretrained_matrix=None)
    return {"losses": losses.numpy(),
            **{n: p.detach().numpy() for n, p in joint.named_parameters()}}


def mnist_step(parallel=True):
    """One AdamW step of ``mnist_train.train_step`` on a global batch of 8
    images: the loss and every parameter after it."""
    import torch

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.models import SimpleUNet
    from tinydiffusionmodels_torch.parallel import make_mesh
    from tinydiffusionmodels_torch.train import mnist_train
    from tinydiffusionmodels_torch.train.optim import adamw

    mesh = make_mesh() if parallel else None
    sched = make_schedule(100)
    model = SimpleUNet(sched.timesteps,
                       generator=torch.Generator().manual_seed(0))
    optimizer = adamw(model.parameters(), 1e-3, weight_decay=0.01)
    batch = torch.as_tensor(np.random.default_rng(2).uniform(
        -1, 1, (8, 28, 28, 1)).astype(np.float32))
    loss = mnist_train.train_step(model, optimizer, batch, sched,
                                  torch.Generator().manual_seed(3),
                                  mesh=mesh)
    return {"losses": loss.reshape(1).numpy(),
            **{n: p.detach().numpy() for n, p in model.named_parameters()}}


def _mesh_facts() -> dict:
    """The mesh rules under the group: shapes, coordinates, ring peers,
    the batch helpers, ``process_batch_slice`` and ``replicate_tree``."""
    import torch
    import torch.distributed as dist

    from tinydiffusionmodels_torch.parallel import (
        make_mesh,
        multihost,
        replicate_tree,
        shard_batch,
        shard_stacked_batch,
    )

    world, rank = dist.get_world_size(), dist.get_rank()
    facts = {}
    mesh = make_mesh()
    facts["default"] = np.array([mesh.shape["data"], mesh.index("data")])
    mesh = make_mesh({"data": -1, "seq": 2})
    facts["dp_sp"] = np.array([mesh.shape["data"], mesh.shape["seq"],
                               mesh.index("data"), mesh.index("seq"),
                               mesh.peer("seq", 1), mesh.peer("seq", -1)])
    x = torch.arange(world * 2 * 4).reshape(world * 2, 4)
    facts["rows_positions"] = shard_batch(mesh, x, seq_axis="seq").numpy()
    stack = torch.arange(3 * world * 4).reshape(3, world, 4)
    facts["stacked"] = shard_stacked_batch(mesh, stack, seq_axis="seq").numpy()
    s = multihost.process_batch_slice(8 * world)
    facts["slice"] = np.array([s.start, s.stop])
    raised = []
    for bad in ({"data": 3}, {"data": -1, "seq": -1}):
        try:
            make_mesh(bad)
        except ValueError:
            raised.append(1)
    try:
        multihost.process_batch_slice(world + 1)
    except ValueError:
        raised.append(1)
    same = torch.nn.Linear(3, 3)
    with torch.no_grad():
        same.weight.fill_(1.0)
        same.bias.fill_(2.0)
    replicate_tree(mesh, same)
    differ = torch.nn.Linear(3, 3)
    with torch.no_grad():
        differ.weight.fill_(float(rank))
    try:
        replicate_tree(mesh, differ)
    except ValueError:
        raised.append(1)
    facts["raised"] = np.array(raised)
    return facts


def _prefixed(prefix: str, arrays: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in arrays.items()}


def _cli_seq_parallel(argv: list[str], name: str) -> dict:
    """The text CLI with ``--seq_parallel`` under the group (rank 0 writes
    the checkpoint): its final parameters from rank 0's file, and the
    embeddings its ``--sample`` drew through the ring."""
    import torch.distributed as dist

    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.io import load_checkpoint

    ckpt = f"{name}.pth"
    z = shakespeare.main([*CLI_ARGS, *argv, "--ckpt", ckpt])
    dist.barrier()
    state = load_checkpoint(ckpt)["diffusion_model"]
    return {"z": z.numpy(), **{k: np.asarray(v) for k, v in state.items()}}


CLI_ARGS = ["--train", "--epochs", "1", "--batch_size", "4", "--seq_len",
            "16", "--embed_dim", "32", "--depth", "1", "--model_id", "char",
            "--warmup_steps", "2", "--pos_emb", "rope", "--sample",
            "--sampler", "ddim", "--steps", "5", "--n", "2"]
CLI_CHARS = "2000"


def task_world2() -> dict:
    out = _prefixed("mesh", _mesh_facts())
    out.update(_prefixed("mnist", mnist_step()))
    out.update(_prefixed("dp", text_step()))
    for pos in ("abs", "rope"):
        out.update(_prefixed(f"sp_{pos}", text_step({"seq": -1}, pos,
                                                    sgd=True)))
    out.update(_prefixed("sp_dropout", text_step({"seq": -1}, "rope", 0.1,
                                                 sgd=True)))
    out.update(_prefixed("cli", _cli_seq_parallel(["--seq_parallel"],
                                                  "ring2")))
    return out


def task_world4() -> dict:
    out = _prefixed("mesh", _mesh_facts())
    for pos in ("abs", "rope"):
        out.update(_prefixed(f"dpsp_{pos}",
                             text_step({"data": -1, "seq": 2}, pos,
                                       sgd=True)))
    out.update(_prefixed("cli", _cli_seq_parallel(["--seq_parallel", "2"],
                                                  "dp2_ring2")))
    return out


TASKS = {"world2": task_world2, "world4": task_world4}


# --- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return shared_spawn(tmp_path_factory, 2, "test_torch_parallel", "world2")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return shared_spawn(tmp_path_factory, 4, "test_torch_parallel", "world4")


@pytest.fixture(scope="module")
def torch_cpu():
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    return torch


def _part(result: dict, prefix: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in result.items()
            if k.startswith(prefix + "/")}


def _assert_same_step(ranks: list[dict], prefix: str, want: dict) -> None:
    """Every rank ends the step with the world-1 losses and parameters."""
    for rank, result in enumerate(ranks):
        got = _part(result, prefix)
        assert sorted(got) == sorted(want), (rank, prefix)
        for name, value in want.items():
            np.testing.assert_allclose(
                got[name], value, **(SAMPLE_TOL if name == "z" else TOL),
                err_msg=f"rank {rank}: {name}")


def test_mesh_rules_without_a_group(torch_cpu):
    """``make_mesh``'s axis rules, as the JAX package's (-1 fills, a shape
    that does not divide the world raises), laid out for 8 ranks."""
    from tinydiffusionmodels_torch.parallel import make_mesh, shard_batch

    assert make_mesh(world=8).shape == {"data": 8}
    assert make_mesh({"data": 4, "model": 2}, world=8).shape == {
        "data": 4, "model": 2}
    assert make_mesh({"data": -1, "model": 2}, world=8).shape["data"] == 4
    for bad in ({"data": 3}, {"data": -1, "seq": -1}, {"data": -1, "seq": 3}):
        with pytest.raises(ValueError):
            make_mesh(bad, world=8)
    one = make_mesh()
    assert one.shape == {"data": 1} and not one.distributed
    x = torch_cpu.arange(12).reshape(4, 3)
    assert shard_batch(one, x, seq_axis="seq") is x


def test_multihost_without_torchrun_is_a_no_op(torch_cpu, monkeypatch):
    from tinydiffusionmodels_torch.parallel import multihost

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize() is False
    assert multihost.process_batch_slice(64) == slice(0, 64)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_rules_under_a_group(world, world2, world4):
    ranks = {2: world2, 4: world4}[world]
    for rank, result in enumerate(ranks):
        f = _part(result, "mesh")
        np.testing.assert_array_equal(f["default"], [world, rank])
        dp, sp = world // 2, 2
        d, s = divmod(rank, sp)
        np.testing.assert_array_equal(
            f["dp_sp"], [dp, sp, d, s, d * sp + (s + 1) % sp,
                         d * sp + (s - 1) % sp])
        x = np.arange(world * 2 * 4).reshape(world * 2, 4)
        rows = world * 2 // dp
        np.testing.assert_array_equal(
            f["rows_positions"], x[rows * d:rows * (d + 1), 2 * s:2 * s + 2])
        stack = np.arange(3 * world * 4).reshape(3, world, 4)
        np.testing.assert_array_equal(
            f["stacked"], stack[:, 2 * d:2 * d + 2, 2 * s:2 * s + 2])
        np.testing.assert_array_equal(f["slice"], [8 * rank, 8 * rank + 8])
        # Two bad shapes, an indivisible batch, ranks with other weights.
        assert f["raised"].tolist() == [1, 1, 1, 1]


def test_data_parallel_mnist_step_equals_world1(world2, torch_cpu):
    _assert_same_step(world2, "mnist", mnist_step(parallel=False))


def test_data_parallel_text_step_equals_world1(world2, torch_cpu):
    _assert_same_step(world2, "dp", text_step(parallel=False))


@pytest.mark.parametrize("pos_emb", ["abs", "rope"])
def test_sequence_parallel_text_step_equals_world1(pos_emb, world2,
                                                   torch_cpu):
    """A ring of 2 (``tests/test_seq_parallel.py``'s
    ``test_train_loss_equivalence``)."""
    _assert_same_step(world2, f"sp_{pos_emb}",
                      text_step(pos_emb=pos_emb, parallel=False, sgd=True))


def test_sequence_parallel_dropout_step_equals_world1(world2, torch_cpu):
    """At dropout 0.1 a ring of 2 drops what one device drops: the
    attention mask hashes global positions and the other masks are drawn
    for the whole sequence."""
    _assert_same_step(world2, "sp_dropout",
                      text_step(pos_emb="rope", dropout=0.1,
                                parallel=False, sgd=True))


@pytest.mark.parametrize("pos_emb", ["abs", "rope"])
def test_data_and_sequence_parallel_text_step_equals_world1(pos_emb, world4,
                                                            torch_cpu):
    """Data 2 x ring 2 on 4 ranks (``tests/test_seq_parallel.py``'s
    ``test_train_loss_equivalence_dp4_sp2``)."""
    _assert_same_step(world4, f"dpsp_{pos_emb}",
                      text_step(pos_emb=pos_emb, parallel=False, sgd=True))


@pytest.fixture(scope="module")
def cli_world1(tmp_path_factory, torch_cpu):
    """The text CLI's final denoiser parameters and sampled embeddings at
    world 1 (no group)."""
    from tinydiffusionmodels_torch import shakespeare
    from tinydiffusionmodels_torch.io import load_checkpoint

    workdir = tmp_path_factory.mktemp("cli_world1")
    cwd = os.getcwd()
    env = {"TDM_PLATFORM": "cpu", "TDM_DATA_LIMIT": CLI_CHARS}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    os.chdir(workdir)
    try:
        z = shakespeare.main([*CLI_ARGS, "--ckpt", "one.pth"])
        state = load_checkpoint("one.pth")["diffusion_model"]
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"z": z.numpy(), **{k: np.asarray(v) for k, v in state.items()}}


def test_cli_seq_parallel_ring_equals_world1(world2, cli_world1):
    """``--train --sample --seq_parallel`` under a group of 2 (a ring of 2,
    dropout 0.1) writes the checkpoint one process writes, and samples
    through the ring what one process samples."""
    _assert_same_step(world2[:1], "cli", cli_world1)


def test_cli_seq_parallel_dp_ring_trains(world4, cli_world1):
    """``--train --sample --seq_parallel 2`` on 4 ranks (data 2 x ring 2):
    every denoiser parameter of rank 0's checkpoint and every sampled
    embedding is finite and has the world-1 shape (the data shards draw
    their own dropout masks, so the values differ)."""
    got = _part(world4[0], "cli")
    assert sorted(got) == sorted(cli_world1)
    for name, value in cli_world1.items():
        assert got[name].shape == value.shape
        assert np.isfinite(got[name]).all(), name


def test_ops_attention_routes_to_the_ring(torch_cpu):
    """``tests/test_seq_parallel.py``'s routing cases: a registered axis
    routes to the ring (one rank, no group: full attention), an
    unregistered axis raises ValueError, a mask NotImplementedError."""
    from tinydiffusionmodels_torch import ops
    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_torch.parallel import make_mesh

    ops.register_sequence_mesh(make_mesh({"seq": -1}), "seq-test")
    rng = np.random.default_rng(3)
    q, k, v = (torch_cpu.as_tensor(rng.standard_normal(
        (2, 4, 64, 16), dtype=np.float32)) for _ in range(3))
    out = ops.attention(q, k, v, seq_axis="seq-test")
    np.testing.assert_allclose(out.numpy(),
                               reference.attention(q, k, v)[0].numpy(),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="no mesh"):
        ops.attention(q, q, q, seq_axis="nonexistent-axis")
    with pytest.raises(NotImplementedError):
        ops.attention(q, q, q, mask=torch_cpu.ones(64, 64, dtype=bool),
                      seq_axis="seq-test")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("TDM_DATA_LIMIT", CLI_CHARS)
    worker_main(TASKS)
