"""Tensor parallelism of the torch package on the CPU (``parallel/tp.py``).

Real gloo groups, through ``test_torch_parallel``'s ``shared_spawn``: one
spawn of 2 ranks (a 'model' axis of 2, and a 'data' axis of 2 for the
comparison below) and one of 4 (data 2 x model 2), each with its own
timeout, their results shared by the test workers of a session.

The checks:
- a TP step at dropout 0.1 equals the world-1 step within 1e-5 (losses,
  and every parameter after one SGD step at learning rate 1, gathered
  whole, so the parameters differ from their start by the gradient
  itself; SGD for the reason ``test_torch_parallel.text_step`` gives for
  the ring: the key bias's gradient is zero up to rounding, the row-
  parallel sums round otherwise than one process's products, and
  AdamW's first step would turn that rounding into +-lr): tp 2 against one
  process; data 2 x tp 2 against data 2 alone (the data shards draw their
  own dropout streams, by design, so no single process draws them), and
  at dropout 0 against one process;
- the TP forward equals the JAX package's ``tiny_transformer_apply`` with
  ``apply_rules(..., transformer_tp_rules("model"))`` on the 8-device CPU
  mesh (data 4 x model 2), within ``tests/test_parallel.py``'s rtol 2e-4,
  atol 2e-5;
- ``gather_transformer(shard_transformer(m))`` equals ``m`` exactly;
- the plain ``dropout_scale`` at a head offset equals JAX's
  ``_dropout_scale`` at the layer's head ``b H + h0 + h``, and the plain
  attention on a slice of the heads equals the whole layer's, sliced.

JAX is imported inside the tests that compare with it: the ranks import
this module as their main program and never import JAX.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import REPO, TOL, shared_spawn, worker_main  # noqa: E402,I001

VOCAB, DIM, HEADS, B, L = 29, 32, 4, 4, 16
# The JAX package's TP test (tests/test_parallel.py:102-124).
JAX_DIM, JAX_FFN, JAX_B, JAX_L = 64, 128, 8, 16
JAX_TOL = dict(rtol=2e-4, atol=2e-5)


def _joint(dropout: float):
    import torch
    from torch import nn

    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )

    cfg = TransformerConfig(dim=DIM, n_heads=HEADS, depth=2, dropout=dropout,
                            ffn_dim=64, timesteps=100)
    g = torch.Generator().manual_seed(0)
    return nn.ModuleDict({
        "diffusion_model": TinyTransformer(cfg, generator=g),
        "rounding_fn": LearnedRounding(DIM, VOCAB, generator=g),
        "embedding_fn": LearnedEmbedding(VOCAB, DIM, generator=g),
    })


def tp_text_step(axes=None, dropout: float = 0.0) -> dict:
    """One SGD step (learning rate 1) of ``text_train.train_step`` on a
    global batch of B
    rows of L tokens over the mesh ``axes`` (None: one process, no mesh),
    the denoiser split over its 'model' axis: the losses and every
    parameter after the step, gathered whole. As in the trainer, the
    timesteps and noise come from one generator and, with more than one
    data shard, each shard draws its dropout from a generator keyed on its
    'data' index, shared by the ranks of its 'model' axis."""
    import torch

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.parallel import (
        gather_transformer,
        make_mesh,
        shard_transformer,
    )
    from tinydiffusionmodels_torch.train import text_train

    mesh = make_mesh(axes) if axes is not None else None
    joint = _joint(dropout)
    drop_gen = None
    if mesh is not None:
        shard_transformer(joint["diffusion_model"], mesh)
        if mesh.axis_size("data") > 1:
            drop_gen = text_train._generator("cpu", 7, 0,
                                             1 + mesh.index("data"))
    optimizer = torch.optim.SGD(joint.parameters(), lr=1.0)
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, VOCAB, (B, L)))
    losses = text_train.train_step(
        joint, optimizer, tokens, 0.5, torch.Generator().manual_seed(7),
        sched=make_schedule(100), mesh=mesh, dropout_generator=drop_gen,
        use_learned_embeddings=True, pretrained_matrix=None)
    if mesh is not None:
        gather_transformer(joint["diffusion_model"], mesh)
    return {"losses": losses.numpy(),
            **{n: p.detach().numpy() for n, p in joint.named_parameters()}}


def _jax_test_model():
    """The JAX TP test's denoiser (dim 64, 4 heads, depth 2, FFN 128), its
    weights from seed 0, and its inputs: x (8, 16, 64) and t = 0..7."""
    import torch

    from tinydiffusionmodels_torch.models import (
        TinyTransformer,
        TransformerConfig,
    )

    cfg = TransformerConfig(dim=JAX_DIM, n_heads=HEADS, depth=2, dropout=0.0,
                            ffn_dim=JAX_FFN)
    model = TinyTransformer(cfg, generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(5).standard_normal(
        (JAX_B, JAX_L, JAX_DIM)).astype(np.float32)
    return model, x, np.arange(JAX_B)


def tp_forward(axes) -> dict:
    """The TP forward of ``_jax_test_model`` on this rank's rows, and the
    round trip of its weights through shard and gather."""
    import torch

    from tinydiffusionmodels_torch.parallel import (
        gather_transformer,
        make_mesh,
        shard_batch,
        shard_transformer,
    )

    mesh = make_mesh(axes)
    model, x, t = _jax_test_model()
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    shard_transformer(model, mesh)
    xs, ts = shard_batch(mesh, (torch.as_tensor(x), torch.as_tensor(t)))
    with torch.no_grad():
        out = model(xs, ts)
    gather_transformer(model, mesh)
    same = [torch.equal(p, whole[n]) for n, p in model.named_parameters()]
    return {"out": out.numpy(), "round_trip": np.array(same),
            "names": np.array(sorted(whole) == sorted(
                n for n, _ in model.named_parameters()))}


def _prefixed(prefix: str, arrays: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in arrays.items()}


def task_tp2() -> dict:
    tp = {"data": 1, "model": 2}
    return {**_prefixed("tp_drop", tp_text_step(tp, 0.1)),
            **_prefixed("dp_drop", tp_text_step({"data": 2}, 0.1)),
            **_prefixed("fwd", tp_forward(tp))}


def task_tp4() -> dict:
    axes = {"data": 2, "model": 2}
    return {**_prefixed("tp_drop", tp_text_step(axes, 0.1)),
            **_prefixed("tp0", tp_text_step(axes, 0.0)),
            **_prefixed("fwd", tp_forward(axes))}


TASKS = {"tp2": task_tp2, "tp4": task_tp4}


# --- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    return shared_spawn(tmp_path_factory, 2, "test_torch_tp", "tp2")


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return shared_spawn(tmp_path_factory, 4, "test_torch_tp", "tp4")


@pytest.fixture(scope="module")
def torch_cpu():
    torch = pytest.importorskip("torch")
    torch.set_num_threads(1)
    return torch


def _part(result: dict, prefix: str) -> dict:
    return {k.split("/", 1)[1]: v for k, v in result.items()
            if k.startswith(prefix + "/")}


def _assert_same(ranks: list[dict], prefix: str, want: dict) -> None:
    for rank, result in enumerate(ranks):
        got = _part(result, prefix)
        assert sorted(got) == sorted(want), (rank, prefix)
        for name, value in want.items():
            np.testing.assert_allclose(got[name], value, **TOL,
                                       err_msg=f"rank {rank}: {name}")


def test_tp2_dropout_step_equals_world1(tp2, torch_cpu):
    """tp 2 at dropout 0.1: the ranks draw the whole layer's masks from
    the same generator and hash the layer's heads, so the step is one
    process's."""
    _assert_same(tp2, "tp_drop", tp_text_step(None, 0.1))


def test_dp2_tp2_dropout_step_equals_dp2(tp2, tp4, torch_cpu):
    """Data 2 x tp 2 at dropout 0.1 equals data 2 alone: the 'model' axis
    changes nothing a data shard computes."""
    _assert_same(tp4, "tp_drop", _part(tp2[0], "dp_drop"))


def test_dp2_tp2_step_equals_world1(tp4, torch_cpu):
    _assert_same(tp4, "tp0", tp_text_step(None, 0.0))


def test_shard_then_gather_is_exact(tp2, tp4):
    for result in (*tp2, *tp4):
        f = _part(result, "fwd")
        assert f["names"].all() and f["round_trip"].all()


@pytest.mark.parametrize("world", [2, 4])
def test_tp_forward_matches_jax_apply_rules(world, tp2, tp4, torch_cpu,
                                            eight_devices):
    """The port's TP forward against the JAX package's GSPMD forward with
    Megatron rules on the 8-device mesh (data 4 x model 2)."""
    import jax
    import jax.numpy as jnp

    from tinydiffusionmodels_torch.io import convert
    from tinydiffusionmodels_tpu.models import tiny_transformer_apply
    from tinydiffusionmodels_tpu.models.transformer import TransformerConfig
    from tinydiffusionmodels_tpu.parallel import (
        apply_rules,
        make_mesh,
        shard_batch,
        transformer_tp_rules,
    )

    model, x, t = _jax_test_model()
    cfg = TransformerConfig(dim=JAX_DIM, n_heads=HEADS, depth=2, dropout=0.0,
                            ffn_dim=JAX_FFN)
    params = jax.tree_util.tree_map(jnp.asarray, convert.params_tree(
        torch_cpu.nn.ModuleDict({"diffusion_model": model}))["diffusion_model"])
    mesh = make_mesh({"data": 4, "model": 2})
    tp_params = apply_rules(mesh, params, transformer_tp_rules("model"))
    want = np.asarray(jax.jit(
        lambda p, xx, tt: tiny_transformer_apply(p, xx, tt, cfg))(
            tp_params, shard_batch(mesh, jnp.asarray(x)),
            shard_batch(mesh, jnp.asarray(t))))
    ranks = {2: tp2, 4: tp4}[world]
    dp = world // 2
    for rank, result in enumerate(ranks):
        rows = JAX_B // dp
        d = rank // 2
        np.testing.assert_allclose(
            _part(result, "fwd")["out"], want[d * rows:(d + 1) * rows],
            **JAX_TOL, err_msg=f"rank {rank} of {world}")


@pytest.mark.parametrize("h0", [0, 2])
def test_dropout_scale_at_a_head_offset_matches_jax(h0, torch_cpu):
    """The plain mask of heads h0, h0 + 1 of 4 hashes the layer's head,
    ``b * 4 + h0 + h``, as JAX's ``_dropout_scale`` at that index."""
    import jax.numpy as jnp

    from tinydiffusionmodels_torch.ops import reference
    from tinydiffusionmodels_tpu.ops import pallas_kernels

    b, h, total, lq, lk, rate, seed = 3, 2, 4, 8, 16, 0.1, -12345
    bh = reference._hashed_heads(b, h, h0, total, torch_cpu.device("cpu"))
    q_pos = np.arange(lq)[:, None]
    k_pos = np.arange(lk)[None, :]
    got = reference.dropout_scale(seed, bh, torch_cpu.as_tensor(q_pos),
                                  torch_cpu.as_tensor(k_pos), rate).numpy()
    for bi in range(b):
        for hi in range(h):
            want = pallas_kernels._dropout_scale(
                jnp.int32(seed), bi * total + h0 + hi,
                jnp.asarray(q_pos + 0 * k_pos, jnp.int32),
                jnp.asarray(k_pos + 0 * q_pos, jnp.int32), rate)
            np.testing.assert_array_equal(got[bi, hi], np.asarray(want))


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_attention_on_a_slice_of_heads_is_the_layers_slice(layout,
                                                           torch_cpu):
    """Output, lse and the three gradients of heads 2-3 of 4 at dropout
    0.2, bit for bit those of the whole layer, sliced; offset 0 with the
    layer's own count is the call without an offset."""
    from tinydiffusionmodels_torch.ops import flash_attention as fa

    torch = torch_cpu
    rng = np.random.default_rng(4)
    hd = 1 if layout == "bhld" else 2
    shape = (2, 4, 16, 8) if layout == "bhld" else (2, 16, 4, 8)
    q, k, v = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    kw = dict(layout=layout, dropout_rate=0.2, dropout_seed=99)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    g = torch.as_tensor(rng.standard_normal(out.shape), dtype=torch.float32)
    grads = torch.autograd.grad((out * g).sum() + lse.sum(), (q, k, v))
    cut = [slice(None)] * 4
    cut[hd] = slice(2, 4)
    cut = tuple(cut)
    part = [x.detach()[cut].clone().requires_grad_() for x in (q, k, v)]
    o2, lse2 = fa.flash_attention_with_lse(*part, head_offset=2,
                                           total_heads=4, **kw)
    g2 = torch.autograd.grad((o2 * g[cut]).sum() + lse2.sum(), part)
    assert torch.equal(o2, out[cut]) and torch.equal(lse2, lse[:, 2:4])
    for a, b in zip(g2, grads):
        assert torch.equal(a, b[cut])
    o0 = fa.flash_attention(q, k, v, head_offset=0, total_heads=4, **kw)
    assert torch.equal(o0, fa.flash_attention(q, k, v, **kw))
    with pytest.raises(ValueError, match="not among"):
        fa.flash_attention(*part, head_offset=3, total_heads=4, **kw)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("TDM_DATA_LIMIT", "2000")
    worker_main(TASKS)
