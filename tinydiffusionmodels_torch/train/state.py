"""Resumable train state: the counterpart of ``train/state.py``'s
``TrainState`` (params, opt_state, step) and of the resume files the JAX
trainers write and read (``train/text_train.py:615-678, :804-824``,
``train/mnist_train.py:286-328, :430-442``).

A resume file holds the JAX package's resume dict, so each package resumes
a run the other wrote:

- text: the trainer's checkpoint dict of the live weights
  (``diffusion_model``, ``rounding_fn``[, ``embedding_fn``], ``epoch``[,
  ``tokenizer``]), ``opt_state_leaves`` (optax ``adamw``'s state leaves,
  ``io.convert.adamw_state_to_jax``), ``step``, ``best_val_loss``,
  ``patience_counter`` and, with an EMA, ``ema`` (the checkpoint dict of
  the EMA weights);
- MNIST: ``model`` (the UNet's state dict), ``opt_state_leaves``,
  ``step``, ``epoch`` and, with an EMA, ``ema`` (its state dict).

One key is the port's own, ``GENERATORS``: the states of the
``torch.Generator``s a step draws from (``gen``; ``drop_gen`` of every data
shard, gathered to rank 0) and of the host's self-conditioning coin
(``coin_rng``). The JAX package keys each step's randomness on the step
number and needs none; the port's generators carry state, and only with
these does a resumed run draw what the uninterrupted run draws. A file
without the key (one the JAX package wrote) restores the weights and AdamW
exactly, and the generators start again from the seed.

Restoring copies every value into the tensors the trainer already holds
(parameters, EMA, AdamW's state, generators) before the first step of the
run is warmed up or captured (``graphs.Step``), so the captured addresses
are the restored tensors and a replay draws on from the restored offsets.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tinydiffusionmodels_torch.io import (
    adamw_state_from_jax,
    adamw_state_to_jax,
    load_checkpoint,
    state_from_checkpoint,
    text_checkpoint_dict,
    unet_checkpoint_dict,
)
from tinydiffusionmodels_torch.train.optim import load_adamw_state

GENERATORS = "torch_generators"


def read(path: str, log_fn=print) -> dict | None:
    """The resume dict at ``path``; None, to start fresh, when there is no
    file or it cannot be read (the JAX trainers' one soft path: a
    truncated file must not kill the job)."""
    if not os.path.exists(path):
        return None
    try:
        return load_checkpoint(path)
    except Exception as e:
        log_fn(f"[resume] could not read {path} ({e}); starting fresh")
        return None


def _data_shard_states(mesh, gen: torch.Generator) -> list[np.ndarray]:
    """``gen``'s state on every data shard of ``mesh``, by data index: one
    all-gather over the process group, which every rank must join."""
    local = gen.get_state()
    if not mesh.distributed:
        return [local.numpy()]
    local = local.to(gen.device)    # what the backend moves (NCCL: the card)
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local)
    names, sizes = list(mesh.shape), list(mesh.shape.values())
    states = [None] * mesh.axis_size("data")
    for rank, part in enumerate(parts):
        states[int(np.unravel_index(rank, sizes)[names.index("data")])] = \
            part.cpu().numpy()
    return states


def generator_states(mesh, gen: torch.Generator,
                     drop_gen: torch.Generator | None = None,
                     coin_rng: np.random.Generator | None = None) -> dict:
    """The ``GENERATORS`` entry: every rank calls this (``drop_gen``'s
    states are gathered); rank 0 writes it."""
    states: dict = {"gen": gen.get_state().numpy()}
    if drop_gen is not None:
        states["drop_gen"] = _data_shard_states(mesh, drop_gen)
    if coin_rng is not None:
        states["coin_rng"] = coin_rng.bit_generator.state
    return states


def _set(gen: torch.Generator, state) -> None:
    gen.set_state(torch.from_numpy(np.array(state, dtype=np.uint8)))


def restore_generators(saved: dict, mesh, gen: torch.Generator,
                       drop_gen: torch.Generator | None = None,
                       coin_rng: np.random.Generator | None = None,
                       log_fn=print) -> None:
    """Set the generators to the states ``saved`` holds (this rank's data
    shard's dropout stream). A port-written file must come from a run of
    as many data shards as this one: each shard's dropout stream is its
    own, so another count has no stream to carry on, and this raises."""
    states = saved.get(GENERATORS)
    if states is None:
        log_fn("[resume] the file holds no generator states (the JAX "
               "package's): t, noise and dropout are drawn afresh from "
               "the seed")
        return
    if drop_gen is not None:
        shards = states.get("drop_gen") or []
        if len(shards) != mesh.axis_size("data"):
            raise ValueError(
                f"the resume file holds the dropout streams of {len(shards)} "
                f"data shards and this run has {mesh.axis_size('data')}: "
                "resume on the data-parallel width that wrote it")
        _set(drop_gen, shards[mesh.index("data")])
    _set(gen, states["gen"])
    if coin_rng is not None:
        coin_rng.bit_generator.state = states["coin_rng"]


def _load(module: nn.Module, sd: dict) -> None:
    """Copy a checkpoint's weights into ``module``'s tensors in place: a
    joint ``ModuleDict`` key by key, else the module whole."""
    if isinstance(module, nn.ModuleDict):
        for key in module:
            module[key].load_state_dict(state_from_checkpoint(sd[key]),
                                        strict=True)
    else:
        module.load_state_dict(state_from_checkpoint(sd), strict=True)


def _restore_adamw(saved: dict, optimizer, params: nn.Module) -> None:
    step, mu, nu = adamw_state_from_jax(saved["opt_state_leaves"], params)
    load_adamw_state(optimizer, params, step, mu, nu)


def _text_ckpt(joint: nn.ModuleDict, **kw) -> dict:
    return text_checkpoint_dict(
        joint["diffusion_model"], joint["rounding_fn"],
        joint["embedding_fn"] if "embedding_fn" in joint else None, **kw)


def text_state(joint: nn.ModuleDict, optimizer, ema, *, epoch: int,
               step: int, best_val_loss: float, patience_counter: int,
               schedule: bool, generators: dict,
               tokenizer_state: dict | None = None) -> dict:
    """The text trainer's resume dict after ``epoch`` epochs and ``step``
    optimizer steps (``train/text_train.py:804-824``)."""
    state = _text_ckpt(joint, epoch=epoch, tokenizer_state=tokenizer_state,
                       extra={
                           "opt_state_leaves": adamw_state_to_jax(
                               optimizer, joint, schedule=schedule),
                           "step": step,
                           "best_val_loss": best_val_loss,
                           "patience_counter": patience_counter,
                           GENERATORS: generators,
                       })
    if ema is not None:
        state["ema"] = _text_ckpt(ema, epoch=epoch)
    return state


def restore_text(saved: dict, joint: nn.ModuleDict, optimizer, ema, *,
                 mesh, gen, drop_gen=None, coin_rng=None, log_fn=print):
    """Restore the text trainer from its resume dict
    (``train/text_train.py:615-678``); returns (epochs done, steps done,
    best_val_loss, patience_counter). The EMA is the file's when it has
    one, else the restored weights."""
    _load(joint, saved)
    _restore_adamw(saved, optimizer, joint)
    if ema is not None:
        if "ema" in saved:
            _load(ema, saved["ema"])
        else:
            ema.load_state_dict(joint.state_dict())
    restore_generators(saved, mesh, gen, drop_gen, coin_rng, log_fn)
    return (int(saved["epoch"]), int(saved["step"]),
            float(saved.get("best_val_loss", float("inf"))),
            int(saved.get("patience_counter", 0)))


def mnist_state(model: nn.Module, optimizer, ema, *, epoch: int, step: int,
                generators: dict) -> dict:
    """The MNIST trainer's resume dict (``train/mnist_train.py:430-442``)."""
    state = {
        "model": unet_checkpoint_dict(model),
        "opt_state_leaves": adamw_state_to_jax(optimizer, model,
                                               schedule=False),
        "step": step,
        "epoch": epoch,
        GENERATORS: generators,
    }
    if ema is not None:
        state["ema"] = unet_checkpoint_dict(ema)
    return state


def restore_mnist(saved: dict, model: nn.Module, optimizer, ema, *, mesh,
                  gen, log_fn=print) -> tuple[int, int]:
    """Restore the MNIST trainer from its resume dict
    (``train/mnist_train.py:286-328``); returns (epochs done, steps
    done)."""
    _load(model, saved["model"])
    _restore_adamw(saved, optimizer, model)
    if ema is not None:
        _load(ema, saved["ema"] if saved.get("ema") is not None
              else saved["model"])
    restore_generators(saved, mesh, gen, log_fn=log_fn)
    return int(saved["epoch"]), int(saved["step"])
