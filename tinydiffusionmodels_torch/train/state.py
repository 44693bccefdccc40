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

Both packages key each step's randomness on (seed, step) (``core/rng.py``),
so the step number is all a resumed run needs to draw what the
uninterrupted run draws, at any data-parallel width, and a file the JAX
package wrote carries its run's draws on. Files of an earlier port also
hold ``GENERATORS`` (torch generator states): they load, and that key is
ignored with one log line.

Restoring copies every value into the tensors the trainer already holds
(parameters, EMA, AdamW's state) before the first step of the run is
warmed up or captured (``graphs.Step``), so the captured addresses are the
restored tensors.
"""

from __future__ import annotations

import os

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


def _drop_generator_states(saved: dict, log_fn) -> None:
    """A file that an earlier port wrote holds generator states: the draws
    are keyed on the step now, so they are ignored, with one log line."""
    if GENERATORS in saved:
        log_fn(f"[resume] ignoring the file's {GENERATORS!r}: the draws "
               "are keyed on (seed, step) and need no state")


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
               schedule: bool, tokenizer_state: dict | None = None) -> dict:
    """The text trainer's resume dict after ``epoch`` epochs and ``step``
    optimizer steps (``train/text_train.py:804-824``)."""
    state = _text_ckpt(joint, epoch=epoch, tokenizer_state=tokenizer_state,
                       extra={
                           "opt_state_leaves": adamw_state_to_jax(
                               optimizer, joint, schedule=schedule),
                           "step": step,
                           "best_val_loss": best_val_loss,
                           "patience_counter": patience_counter,
                       })
    if ema is not None:
        state["ema"] = _text_ckpt(ema, epoch=epoch)
    return state


def restore_text(saved: dict, joint: nn.ModuleDict, optimizer, ema, *,
                 log_fn=print):
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
    _drop_generator_states(saved, log_fn)
    return (int(saved["epoch"]), int(saved["step"]),
            float(saved.get("best_val_loss", float("inf"))),
            int(saved.get("patience_counter", 0)))


def mnist_state(model: nn.Module, optimizer, ema, *, epoch: int,
                step: int) -> dict:
    """The MNIST trainer's resume dict (``train/mnist_train.py:430-442``)."""
    state = {
        "model": unet_checkpoint_dict(model),
        "opt_state_leaves": adamw_state_to_jax(optimizer, model,
                                               schedule=False),
        "step": step,
        "epoch": epoch,
    }
    if ema is not None:
        state["ema"] = unet_checkpoint_dict(ema)
    return state


def restore_mnist(saved: dict, model: nn.Module, optimizer, ema, *,
                  log_fn=print) -> tuple[int, int]:
    """Restore the MNIST trainer from its resume dict
    (``train/mnist_train.py:286-328``); returns (epochs done, steps
    done)."""
    _load(model, saved["model"])
    _restore_adamw(saved, optimizer, model)
    if ema is not None:
        _load(ema, saved["ema"] if saved.get("ema") is not None
              else saved["model"])
    _drop_generator_states(saved, log_fn)
    return int(saved["epoch"]), int(saved["step"])
