"""Shakespeare embedding-space diffusion training (port of
``train/text_train.py``).

Rebuild of reference src/shakespeare.py:174-341: joint AdamW over the
transformer denoiser + learned rounding head (+ learned embeddings), loss =
eps-MSE + weight(epoch) * rounding-CE, cosine-warmup LR schedule, per-epoch
validation, early stopping on val total loss, best + final checkpoints in
the reference's dict format (the JAX CLI reads them).

The joint model is an ``nn.ModuleDict`` with the JAX package's keys:
'diffusion_model' (TinyTransformer), 'rounding_fn' (LearnedRounding) and,
with learned embeddings, 'embedding_fn' (LearnedEmbedding).

One optimizer step per Python iteration, with no host sync inside it: the
batch is gathered on the device from the corpus held there, timesteps,
noise, dropout masks and attention-dropout seeds are drawn on the device
from one ``torch.Generator``, and each step's losses stay on the device
until the progress interval (``TDM_PROGRESS_EVERY`` steps) or the end of
the epoch. The JAX package's K-step scans (``TDM_SCAN_CHUNK``) are a
dispatch device of XLA and have no counterpart here; a CUDA graph over the
step is later work.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinydiffusionmodels_torch.core.diffusion import _bcast, q_sample
from tinydiffusionmodels_torch.core.schedule import DiffusionSchedule
from tinydiffusionmodels_torch.data.loader import batch_iterator, num_batches
from tinydiffusionmodels_torch.io import (
    get_vertex_checkpoint_path,
    save_checkpoint,
    text_checkpoint_dict,
)
from tinydiffusionmodels_torch.models.embedding import _apply_norm
from tinydiffusionmodels_torch.train.metrics import MetricsLogger
from tinydiffusionmodels_torch.train.optim import (
    adamw,
    cosine_warmup_lambda,
    dynamic_rounding_weight_schedule,
    freeze_subtree,
)
from tinydiffusionmodels_torch.train.precision import in_dtype


def _clamp_to_embedding(x0_hat, rounding, emb_table):
    """Snap an x0 estimate to its nearest embedding via the rounding head
    (the same clamp the sampler applies, sample/text.make_clamped_denoiser)."""
    return emb_table[torch.argmax(rounding(x0_hat), dim=-1)]


def _token_ce(rounding, x, token_ids) -> torch.Tensor:
    """Mean cross-entropy of the rounding head's logits on ``x``, reduced
    in f32."""
    logp = F.log_softmax(rounding(x).float(), dim=-1)
    return -torch.gather(logp, -1, token_ids[..., None]).mean()


def _losses(
    joint: nn.ModuleDict,
    token_ids: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    rounding_weight: float,
    *,
    sched: DiffusionSchedule,
    use_learned_embeddings: bool,
    pretrained_matrix: torch.Tensor | None,
    deterministic: bool,
    generator: torch.Generator | None = None,
    self_cond_coin: bool = False,
    parameterization: str = "eps",
    clamp_train: bool = False,
    embed_norm: str = "none",
    freeze_embeddings: bool = False,
    anchor_ce: float = 0.0,
    compute_dtype=None,
):
    """Joint diffusion + rounding loss (reference src/shakespeare.py:224-243);
    returns (total, (diffusion_loss, rounding_loss)).

    ``compute_dtype=torch.bfloat16`` runs the denoiser and the rounding head
    in bf16, as the JAX package does: their parameters, ``x_noisy`` and
    ``x0`` are cast before them, the predicted x0 before the anchor CE. The
    embedding table, its normalisation and the lookup, the clamp and every
    loss stay f32, and the gradients reach the f32 parameters.

    ``t`` (B,) and ``noise`` (B, L, dim) are arguments, as in the JAX
    package, so a test can feed both packages the same values.
    ``deterministic=False`` (training) needs ``generator`` for the dropout
    masks and seeds.

    ``parameterization``: "eps" (reference, predict the noise) or "x0"
    (Diffusion-LM: predict the clean embeddings).

    Self-conditioning (the model's ``cfg.self_cond``): in training,
    ``self_cond_coin`` (a fair coin the caller draws on the host, the JAX
    package's ``jax.random.bernoulli`` under ``lax.cond``) chooses between a
    gradient-free estimate pass fed back through the self-conditioning
    channel and the zeros channel; validation always feeds the estimate.

    ``clamp_train`` (x0 only): add a loss term against the clamped
    prediction the sampler uses, a straight-through estimator through the
    nearest-embedding snap; snap and target carry no gradient.

    ``anchor_ce``: weight of Diffusion-LM's anchor term, the rounding head's
    CE on the predicted x0 with gradient into the denoiser.

    ``freeze_embeddings``: no gradient reaches the embedding table.
    """
    model = joint["diffusion_model"]
    rounding = joint["rounding_fn"]
    if use_learned_embeddings:
        emb_w = joint["embedding_fn"].embeddings.weight
    else:
        emb_w = pretrained_matrix
    if freeze_embeddings:
        emb_w = emb_w.detach()
    # Normalize the TABLE, then look up (zscore needs vocab-axis stats).
    norm_table = _apply_norm(emb_w, embed_norm)
    x0 = norm_table[token_ids]
    x_noisy = q_sample(sched, x0, t, noise)
    denoise = in_dtype(model, compute_dtype)
    rounding_c = in_dtype(rounding, compute_dtype)
    x0_c = x0
    if compute_dtype is not None:
        x_noisy = x_noisy.to(compute_dtype)
        x0_c = x0.to(compute_dtype)

    def to_x0(x, pred):
        if parameterization == "x0":
            return pred
        sqrt_acp = _bcast(sched.sqrt_alphas_cumprod, t, pred.ndim)
        sqrt_om = _bcast(sched.sqrt_one_minus_alphas_cumprod, t, pred.ndim)
        return (x - sqrt_om * pred) / sqrt_acp

    x0_prev = None
    if model.cfg.self_cond:
        if deterministic or self_cond_coin:
            # Gradient-free estimate pass with the zeros channel (eval-mode
            # dropout: how the sampler produces the estimate).
            with torch.no_grad():
                pred1 = denoise(x_noisy, t, deterministic=True,
                                x0_prev=torch.zeros_like(x_noisy)).float()
                x0_prev = to_x0(x_noisy.float(), pred1)
                if clamp_train:
                    x0_prev = _clamp_to_embedding(x0_prev, rounding,
                                                  norm_table)
        else:
            x0_prev = torch.zeros(x_noisy.shape, device=x_noisy.device)

    pred = denoise(x_noisy, t, deterministic=deterministic,
                   generator=generator, x0_prev=x0_prev)
    target = x0 if parameterization == "x0" else noise
    pred_f32 = pred.float()
    if clamp_train:
        with torch.no_grad():
            x0_snap = _clamp_to_embedding(pred_f32, rounding, norm_table)
        pred_ste = pred_f32 + (x0_snap - pred_f32.detach())
        diffusion_loss = 0.5 * (
            torch.mean(torch.square(pred_f32 - target))
            + torch.mean(torch.square(pred_ste - target.detach()))
        )
    else:
        diffusion_loss = torch.mean(torch.square(pred_f32 - target))

    rounding_loss = _token_ce(rounding_c, x0_c, token_ids)
    total = diffusion_loss + rounding_weight * rounding_loss
    if anchor_ce:
        x0_pred = to_x0(x_noisy.float(), pred_f32)
        if compute_dtype is not None:
            x0_pred = x0_pred.to(compute_dtype)
        total = total + anchor_ce * _token_ce(rounding_c, x0_pred, token_ids)
    return total, (diffusion_loss, rounding_loss)


def _draw_t_noise(joint, token_ids, timesteps, generator):
    """Timesteps (B,) and noise (B, L, dim) on the device of the tokens."""
    b, length = token_ids.shape
    dim = joint["diffusion_model"].cfg.dim
    dev = token_ids.device
    t = torch.randint(0, timesteps, (b,), generator=generator, device=dev)
    noise = torch.randn((b, length, dim), generator=generator, device=dev)
    return t, noise


def train_step(joint, optimizer, token_ids, rounding_weight, generator, *,
               sched, self_cond_coin=False, **loss_kwargs):
    """One optimizer step: forward with dropout, backward, AdamW. Returns
    the (diff, round, total) losses as a (3,) tensor on the device."""
    t, noise = _draw_t_noise(joint, token_ids, sched.timesteps, generator)
    total, (diff, round_) = _losses(
        joint, token_ids, t, noise, rounding_weight, sched=sched,
        deterministic=False, generator=generator,
        self_cond_coin=self_cond_coin, **loss_kwargs,
    )
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    return torch.stack([diff, round_, total]).detach()


@torch.no_grad()
def eval_losses(joint, batches, rounding_weight, generator, *, sched,
                **loss_kwargs):
    """Mean (diff, round, total) over ``batches`` (K, B, L) on the device,
    without dropout; one host read at the end."""
    sums = torch.zeros(3, device=batches.device)
    for token_ids in batches:
        t, noise = _draw_t_noise(joint, token_ids, sched.timesteps, generator)
        total, (diff, round_) = _losses(
            joint, token_ids, t, noise, rounding_weight, sched=sched,
            deterministic=True, **loss_kwargs,
        )
        sums += torch.stack([diff, round_, total])
    return (sums / max(len(batches), 1)).cpu().numpy()


def _generator(device, seed: int, *words: int) -> torch.Generator:
    """A generator on ``device`` for the stream named by ``words``."""
    state = np.random.SeedSequence([seed, *words]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _checkpoint_dict(joint, **kw) -> dict:
    return text_checkpoint_dict(
        joint["diffusion_model"], joint["rounding_fn"],
        joint["embedding_fn"] if "embedding_fn" in joint else None, **kw,
    )


@dataclasses.dataclass
class TrainResult:
    """What ``train`` returns: the final joint model (the EMA one with
    ``ema_decay``), every step's (diff, round, total) training losses,
    the per-epoch records of the metrics JSONL, and the training steps and
    the seconds their loops took (validation and checkpoints excluded)."""

    joint: nn.ModuleDict
    step_losses: np.ndarray
    epochs: list[dict]
    steps: int
    seconds: float


def train(
    joint: nn.ModuleDict,
    train_chunks: np.ndarray,
    val_chunks: np.ndarray,
    *,
    sched: DiffusionSchedule,
    ckpt_path: str = "text_ckpt.pth",
    epochs: int = 1,
    batch_size: int = 32,
    lr: float = 1e-4,
    weight_decay: float = 1e-4,
    rounding_weight: float = 1.0,
    use_learned_embeddings: bool = True,
    pretrained_matrix: torch.Tensor | None = None,
    patience: int = 5,
    use_lr_scheduling: bool = True,
    warmup_steps: int = 100,
    seed: int = 0,
    tokenizer_state: dict | None = None,
    metrics_path: str | None = None,
    ema_decay: float | None = None,
    parameterization: str = "eps",
    clamp_train: bool = False,
    noise_schedule: str = "linear",
    embed_norm: str = "none",
    freeze_embeddings: bool = False,
    anchor_ce: float = 0.0,
    compute_dtype=None,
    log_fn=print,
) -> TrainResult:
    """Epoch loop with validation + early stopping
    (reference src/shakespeare.py:174-341), on the device of ``joint``'s
    parameters.

    ``ema_decay`` keeps an EMA of the joint parameters, updated after every
    step; validation, best-checkpoint selection and the final checkpoint
    then use the EMA weights.

    ``compute_dtype=torch.bfloat16`` trains and validates in bf16
    (``_losses``); the parameters, AdamW's state, the EMA and the
    checkpoints stay f32."""
    if clamp_train and parameterization != "x0":
        raise ValueError(
            "clamp_train requires --parameterization x0 (the clamp operates "
            "on the predicted clean embeddings)"
        )
    dev = next(joint.parameters()).device
    model = joint["diffusion_model"]
    steps_per_epoch = num_batches(train_chunks.shape[0], batch_size)
    total_steps = steps_per_epoch * epochs
    if freeze_embeddings and use_learned_embeddings:
        params = freeze_subtree(joint, "embedding_fn")
    else:
        params = list(joint.parameters())
    optimizer = adamw(params, lr, weight_decay=weight_decay)
    scheduler = (
        torch.optim.lr_scheduler.LambdaLR(
            optimizer, cosine_warmup_lambda(warmup_steps, total_steps))
        if use_lr_scheduling else None
    )
    if pretrained_matrix is not None:
        pretrained_matrix = torch.as_tensor(
            pretrained_matrix, dtype=torch.float32, device=dev)
    loss_kwargs = dict(
        sched=sched, use_learned_embeddings=use_learned_embeddings,
        pretrained_matrix=pretrained_matrix, parameterization=parameterization,
        clamp_train=clamp_train, embed_norm=embed_norm,
        freeze_embeddings=freeze_embeddings, anchor_ce=anchor_ce,
        compute_dtype=compute_dtype,
    )
    ema = None
    if ema_decay is not None:
        ema = copy.deepcopy(joint).requires_grad_(False)
        ema_params, live_params = list(ema.parameters()), list(joint.parameters())

    # The corpus lives on the device; each step gathers its batch there.
    train_dev = torch.as_tensor(train_chunks, dtype=torch.long, device=dev)
    val_batches = list(batch_iterator(val_chunks, batch_size, shuffle=False))
    val_dev = (torch.as_tensor(np.stack(val_batches), dtype=torch.long,
                               device=dev) if val_batches else None)
    gen = _generator(dev, seed, 0)            # t, noise and dropout
    coin_rng = np.random.default_rng([seed, 2])  # self-conditioning coin
    progress_every = int(os.environ.get("TDM_PROGRESS_EVERY", "250"))

    ckpt_meta = dict(
        tokenizer_state=tokenizer_state, parameterization=parameterization,
        noise_schedule=noise_schedule, embed_norm=embed_norm,
        anchor_ce=anchor_ce,
    )
    metrics = MetricsLogger(metrics_path)
    best_val_loss = float("inf")
    patience_counter = 0
    history, records = [], []
    steps_done, loop_seconds = 0, 0.0
    for epoch in range(epochs):
        w = dynamic_rounding_weight_schedule(epoch, epochs, rounding_weight)
        # The batch order of data.loader.batch_iterator, as index rows.
        order = list(batch_iterator(np.arange(train_chunks.shape[0]),
                                    batch_size, seed=seed, epoch=epoch))
        t0 = time.perf_counter()
        losses = []
        if order:
            order_dev = torch.as_tensor(np.stack(order), device=dev)
        for i in range(len(order)):
            coin = bool(model.cfg.self_cond and coin_rng.random() < 0.5)
            losses.append(train_step(
                joint, optimizer, train_dev[order_dev[i]], w, gen,
                self_cond_coin=coin, **loss_kwargs,
            ))
            if scheduler is not None:
                scheduler.step()
            if ema is not None:
                with torch.no_grad():  # no autograd record across steps
                    torch._foreach_mul_(ema_params, ema_decay)
                    torch._foreach_add_(ema_params, live_params,
                                        alpha=1.0 - ema_decay)
            if progress_every and (i + 1) % progress_every == 0:
                dt = time.perf_counter() - t0
                recent = float(torch.stack(losses).sum(0)[2]) / (i + 1)
                log_fn(f"[epoch {epoch + 1}] step {i + 1}/{steps_per_epoch} "
                       f"({(i + 1) / dt:.1f} it/s), loss~{recent:.4f}")
        n = len(losses)
        epoch_losses = (torch.stack(losses).cpu().numpy() if n
                        else np.zeros((0, 3), np.float32))
        dt = time.perf_counter() - t0
        steps_done += n
        loop_seconds += dt
        history.append(epoch_losses)
        train_losses = epoch_losses.mean(0) if n else np.zeros(3)

        eval_joint = ema if ema is not None else joint
        vn = len(val_batches)
        val_losses = (
            eval_losses(eval_joint, val_dev, w, _generator(dev, seed, 1, epoch),
                        **loss_kwargs)
            if vn else np.zeros(3)
        )
        record = {
            "workload": "shakespeare",
            "epoch": epoch + 1,
            "steps": n,
            "it_per_s": round(n / dt, 2),
            "train_diff": float(train_losses[0]),
            "train_round": float(train_losses[1]),
            "train_total": float(train_losses[2]),
            "val_diff": float(val_losses[0]),
            "val_round": float(val_losses[1]),
            "val_total": float(val_losses[2]),
            "rounding_weight": w,
        }
        metrics.log(record)
        records.append(record)
        log_fn(f"Epoch {epoch + 1}/{epochs} ({n} steps, {n / dt:.1f} it/s):")
        log_fn(f"  Train: diff={train_losses[0]:.4f}, "
               f"round={train_losses[1]:.4f}, total={train_losses[2]:.4f}")
        log_fn(f"  Val:   diff={val_losses[0]:.4f}, round={val_losses[1]:.4f}, "
               f"total={val_losses[2]:.4f}")
        log_fn(f"  Rounding weight: {w:.3f}")

        if vn and val_losses[2] < best_val_loss:
            best_val_loss = float(val_losses[2])
            patience_counter = 0
            best_ckpt_path = str(ckpt_path).replace(".pth", "_best.pth")
            save_checkpoint(
                _checkpoint_dict(eval_joint, epoch=epoch,
                                 extra={"val_loss": best_val_loss},
                                 **ckpt_meta),
                best_ckpt_path,
            )
            log_fn(f"  New best validation loss! Saved to {best_ckpt_path}")
        elif vn:
            # Patience counts only when a val measurement exists (with
            # --val_split 0 early stopping never fires).
            patience_counter += 1
            if patience_counter >= patience:
                log_fn(f"  Early stopping triggered after {patience} epochs "
                       "without improvement")
                break

    final = ema if ema is not None else joint
    final_ckpt_path = (
        get_vertex_checkpoint_path("text-model.pth")
        if "AIP_MODEL_DIR" in os.environ
        else ckpt_path
    )
    log_fn(f"✔ Saving final checkpoint to {final_ckpt_path}...")
    save_checkpoint(
        _checkpoint_dict(final, epoch=epochs, extra={"final_training": True},
                         **ckpt_meta),
        final_ckpt_path,
    )
    metrics.close()
    return TrainResult(
        joint=final,
        step_losses=np.concatenate(history) if history else np.zeros((0, 3)),
        epochs=records,
        steps=steps_done,
        seconds=loop_seconds,
    )
