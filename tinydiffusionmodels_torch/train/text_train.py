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

The epoch runs in chunks of ``TDM_SCAN_CHUNK`` steps with one host read a
chunk (``train/chunks.py``), the counterpart of the JAX package's
``make_text_train_step_multi[_ema]``: ``TextSteps`` is its step on device
state. The batch is gathered on the device from the corpus held there by
a device step cursor, the learning rate comes from a device table of the
schedule, timesteps, noise, dropout masks and attention-dropout seeds are
drawn on the device from one ``torch.Generator``, and the EMA update runs
in the same step. On the card each kind of step (one per value of the
self-conditioning coin, which the host draws) is captured once as a CUDA
graph and replayed (``graphs.py``); on the CPU it runs eagerly.

Data and sequence parallelism (``mesh``, the JAX trainer's): every rank
gathers the same global batch and draws its timesteps and noise from the
same generator, keeps its rows (the 'data' axis) and, with
``cfg.seq_axis``, its token positions, and after the backward one
all-reduce averages the gradients and losses over the ranks
(``parallel/data_parallel.py``), inside the captured step. ``batch_size``
stays the global batch. Dropout draws from a generator of its own for
each data shard, shared by the ranks of a sequence ring; validation
losses are the global mean, so every rank stops early alike; only rank 0
writes checkpoints and metrics.

``resume`` (``train/state.py``) writes the whole train state every
``resume_every`` epochs and restores it at the start: weights, AdamW, EMA,
the early-stopping counters and the generators' states, so that a resumed
run is the uninterrupted one, bit for bit.
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

from tinydiffusionmodels_torch import graphs, ops
from tinydiffusionmodels_torch.core.diffusion import _bcast, q_sample
from tinydiffusionmodels_torch.core.schedule import DiffusionSchedule
from tinydiffusionmodels_torch.data.loader import batch_iterator, num_batches
from tinydiffusionmodels_torch.io import (
    get_vertex_checkpoint_path,
    save_checkpoint,
    text_checkpoint_dict,
)
from tinydiffusionmodels_torch.models.embedding import _apply_norm
from tinydiffusionmodels_torch.parallel import (
    all_reduce_mean,
    average_gradients,
    make_mesh,
    replicate_tree,
    shard_batch,
)
from tinydiffusionmodels_torch.train import chunks
from tinydiffusionmodels_torch.train import state as train_state
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


def _local(joint, mesh, token_ids, t, noise):
    """This rank's rows (and positions) of a global batch's tokens,
    timesteps and noise."""
    if mesh is None:
        return token_ids, t, noise
    return shard_batch(mesh, (token_ids, t, noise),
                       seq_axis=joint["diffusion_model"].cfg.seq_axis)


def train_step(joint, optimizer, token_ids, rounding_weight, generator, *,
               sched, self_cond_coin=False, mesh=None,
               dropout_generator=None, **loss_kwargs):
    """One optimizer step: forward with dropout, backward, AdamW. Returns
    the (diff, round, total) losses as a (3,) tensor on the device.

    ``token_ids`` is the global batch; with ``mesh`` the step trains on
    this rank's share of it, the timesteps and noise drawn for the whole
    batch from ``generator``, the dropout masks from ``dropout_generator``
    (default ``generator``), and ``parallel.average_gradients`` averages
    the gradients and losses over the ranks before AdamW."""
    t, noise = _draw_t_noise(joint, token_ids, sched.timesteps, generator)
    token_ids, t, noise = _local(joint, mesh, token_ids, t, noise)
    total, (diff, round_) = _losses(
        joint, token_ids, t, noise, rounding_weight, sched=sched,
        deterministic=False, generator=dropout_generator or generator,
        self_cond_coin=self_cond_coin, **loss_kwargs,
    )
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    losses = torch.stack([diff, round_, total]).detach()
    average_gradients(optimizer, losses, mesh)
    optimizer.step()
    return losses


@torch.no_grad()
def eval_losses(joint, batches, rounding_weight, generator, *, sched,
                mesh=None, **loss_kwargs):
    """Mean (diff, round, total) over ``batches`` (K, B, L) on the device,
    without dropout; one host read at the end. With ``mesh`` each rank
    evaluates its share of every batch and the means are averaged over
    the ranks (the global mean, the same on every rank). The plain eager
    loop that ``EvalPass`` replays as one CUDA graph."""
    sums = torch.zeros(3, device=batches.device)
    for token_ids in batches:
        t, noise = _draw_t_noise(joint, token_ids, sched.timesteps, generator)
        token_ids, t, noise = _local(joint, mesh, token_ids, t, noise)
        total, (diff, round_) = _losses(
            joint, token_ids, t, noise, rounding_weight, sched=sched,
            deterministic=True, **loss_kwargs,
        )
        sums += torch.stack([diff, round_, total])
    means = sums / max(len(batches), 1)
    if mesh is not None and mesh.distributed:
        means = all_reduce_mean([means], mesh.size)[0]
    return means.cpu().numpy()


def _seed_of(seed: int, *words: int) -> int:
    """The 32-bit seed of the stream named by ``words``."""
    return int(np.random.SeedSequence([seed, *words]).generate_state(1)[0])


def _generator(device, seed: int, *words: int) -> torch.Generator:
    """A generator on ``device`` for the stream named by ``words``."""
    return torch.Generator(device=device).manual_seed(_seed_of(seed, *words))


class EvalPass:
    """A run's validation pass as one ``graphs.Step``: the counterpart of
    ``make_text_eval_multi``, the JAX package's K validation batches in one
    dispatch.

    One pass draws every batch's timesteps and noise from one generator,
    re-seeded each epoch to the stream ``_generator(dev, seed, 1, epoch)``
    starts (so the numbers are ``eval_losses``'s with that generator), and
    walks the (K, B, L) ``val_dev`` batches with a device cursor, adding
    each batch's (diff, round, total) into a device buffer; the rounding
    weight is a device scalar. The weights are those of ``joint`` (the EMA
    or the live model), fixed for the run, so one graph serves every
    epoch. On the card the step is primed with one batch's forward at
    t = 0 and zero noise (no draw from the generator), captured at the
    first call and replayed, one host read an epoch; with a process group
    the means are all-reduced after the replay. On the CPU, or with
    ``eager``, every call runs the loop eagerly."""

    def __init__(self, joint, val_dev, *, seed: int, sched, mesh=None,
                 eager: bool = False, **loss_kwargs):
        dev = val_dev.device
        self.seed = seed
        self.mesh = mesh
        self.batches = val_dev.shape[0]
        self.generator = torch.Generator(device=dev)
        self.rounding_weight = torch.zeros((), device=dev)
        self.cursor = torch.zeros((1,), dtype=torch.long, device=dev)
        self.sums = torch.zeros(3, device=dev)
        kw = dict(sched=sched, deterministic=True, **loss_kwargs)

        @torch.no_grad()
        def run():
            self.cursor.zero_()
            self.sums.zero_()
            for _ in range(self.batches):
                token_ids = val_dev.index_select(0, self.cursor).squeeze(0)
                t, noise = _draw_t_noise(joint, token_ids, sched.timesteps,
                                         self.generator)
                token_ids, t, noise = _local(joint, mesh, token_ids, t, noise)
                total, (diff, round_) = _losses(
                    joint, token_ids, t, noise, self.rounding_weight, **kw)
                self.sums += torch.stack([diff, round_, total])
                self.cursor.add_(1)

        @torch.no_grad()
        def prime():
            token_ids = val_dev[0]
            b, length = token_ids.shape
            t = torch.zeros((b,), dtype=torch.long, device=dev)
            noise = torch.zeros((b, length, joint["diffusion_model"].cfg.dim),
                                device=dev)
            token_ids, t, noise = _local(joint, mesh, token_ids, t, noise)
            _losses(joint, token_ids, t, noise, self.rounding_weight, **kw)

        self.step = graphs.Step(run, dev, generators=(self.generator,),
                                warmup=0, eager=eager, prime=prime)

    def __call__(self, epoch: int, rounding_weight: float) -> np.ndarray:
        """Epoch ``epoch``'s mean (diff, round, total), as numpy."""
        self.generator.manual_seed(_seed_of(self.seed, 1, epoch))
        self.rounding_weight.fill_(rounding_weight)
        self.step()
        means = self.sums / max(self.batches, 1)
        if self.mesh is not None and self.mesh.distributed:
            means = all_reduce_mean([means], self.mesh.size)[0]
        return means.cpu().numpy()


class TextSteps(chunks.EpochSteps):
    """Optimizer steps of ``train_step`` on device state, in chunks: the
    counterpart of ``make_text_train_step_multi`` (and, with ``ema``, of
    ``make_text_train_step_multi_ema``).

    A step gathers its batch from ``train_dev`` (N, L) by the epoch's order
    at the device cursor, takes its learning rate from the epoch's table
    (``lr_at``: global step -> lr) and the rounding weight from a device
    scalar, steps AdamW, updates ``ema`` (ema <- d * ema + (1 - d) * live)
    and writes its (diff, round, total) losses. With ``cfg.self_cond``,
    ``run`` draws each step's coin from ``coin_rng`` on the host, in the
    order the eager loop draws it, and runs that coin's step (a graph
    each on the card). ``eager`` runs every step eagerly on the card too
    (the plain version a replay is held against)."""

    def __init__(self, joint, optimizer, train_dev, *, batch_size: int,
                 steps: int, generator, coin_rng=None, ema=None,
                 ema_decay: float | None = None, lr_at=None,
                 eager: bool = False, mesh=None, dropout_generator=None,
                 **loss_kwargs):
        dev = train_dev.device
        self.self_cond = joint["diffusion_model"].cfg.self_cond
        self.coin_rng = coin_rng
        self.rounding_weight = torch.zeros((), device=dev)
        live = list(joint.parameters())
        shadow = list(ema.parameters()) if ema is not None else None

        def step(coin):
            self.set_lr()
            losses = train_step(
                joint, optimizer, train_dev.index_select(0, self.rows()),
                self.rounding_weight, generator, self_cond_coin=coin,
                mesh=mesh, dropout_generator=dropout_generator,
                **loss_kwargs)
            if shadow is not None:
                with torch.no_grad():
                    torch._foreach_mul_(shadow, ema_decay)
                    torch._foreach_add_(shadow, live, alpha=1.0 - ema_decay)
            optimizer.zero_grad(set_to_none=True)
            self.finish(losses)

        super().__init__(step, optimizer=optimizer, steps=steps,
                         batch_size=batch_size, loss_width=3, device=dev,
                         generators=(generator, dropout_generator),
                         variants=(False, True) if self.self_cond else (False,),
                         lr_at=lr_at, eager=eager)

    def start(self, order: np.ndarray, rounding_weight: float = 1.0,
              first_step: int = 0) -> None:
        """A new epoch: its batch order, rounding weight and first global
        step."""
        super().start(order, first_step)
        self.rounding_weight.fill_(rounding_weight)

    def run(self, n: int) -> np.ndarray:
        """The next ``n`` steps; their (n, 3) losses, one host read."""
        coins = [bool(self.self_cond and self.coin_rng.random() < 0.5)
                 for _ in range(n)]
        return self.run_variants(coins)


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
    mesh=None,
    resume: bool = False,
    resume_path: str | None = None,
    resume_every: int = 1,
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
    checkpoints stay f32.

    ``mesh`` (``parallel.make_mesh``; default: every rank of the process
    group on 'data', or one rank without one) makes the run data-parallel
    over its 'data' axis and, with ``cfg.seq_axis``, sequence-parallel over
    that axis (registered here for ``ops.attention``); ``batch_size`` is
    the global batch.

    ``resume=True`` adds the JAX trainer's mid-training resume: the train
    state goes to ``resume_path`` (default ``ckpt_path`` with ``.pth`` ->
    ``_state.pth``) every ``resume_every`` epochs, after the best-checkpoint
    and early-stopping checks, and a run that finds the file starts from
    it (``train/state.py``; a file that cannot be read starts fresh)."""
    if clamp_train and parameterization != "x0":
        raise ValueError(
            "clamp_train requires --parameterization x0 (the clamp operates "
            "on the predicted clean embeddings)"
        )
    dev = next(joint.parameters()).device
    if mesh is None:
        mesh = make_mesh()
    seq_axis = joint["diffusion_model"].cfg.seq_axis
    if seq_axis is not None:
        if seq_axis not in mesh.shape:
            raise ValueError(
                f"cfg.seq_axis={seq_axis!r} is not an axis of the "
                f"training mesh {dict(mesh.shape)}; build the mesh with "
                f"that axis (e.g. make_mesh({{{seq_axis!r}: -1}}))"
            )
        ops.register_sequence_mesh(mesh, seq_axis)
    dp = mesh.axis_size("data")
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} not divisible by 'data' axis "
                         f"size {dp}")
    replicate_tree(mesh, joint)
    main = mesh.rank == 0
    if not main:
        def log_fn(*_):
            pass
    steps_per_epoch = num_batches(train_chunks.shape[0], batch_size)
    total_steps = steps_per_epoch * epochs
    if freeze_embeddings and use_learned_embeddings:
        params = freeze_subtree(joint, "embedding_fn")
    else:
        params = list(joint.parameters())
    optimizer = adamw(params, lr, weight_decay=weight_decay)
    lr_at = None
    if use_lr_scheduling:
        lam = cosine_warmup_lambda(warmup_steps, total_steps)

        def lr_at(step):
            return lr * lam(step)   # LambdaLR's base_lr * lambda(step)
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

    # The corpus lives on the device; each step gathers its batch there.
    train_dev = torch.as_tensor(train_chunks, dtype=torch.long, device=dev)
    val_batches = list(batch_iterator(val_chunks, batch_size, shuffle=False))
    val_dev = (torch.as_tensor(np.stack(val_batches), dtype=torch.long,
                               device=dev) if val_batches else None)
    eval_joint = ema if ema is not None else joint
    val_pass = (EvalPass(eval_joint, val_dev, seed=seed, mesh=mesh,
                         **loss_kwargs) if val_batches else None)
    gen = _generator(dev, seed, 0)            # t, noise and dropout
    # With several data shards each draws its own dropout masks.
    drop_gen = (None if dp == 1
                else _generator(dev, seed, 0, 1 + mesh.index("data")))
    coin_rng = np.random.default_rng([seed, 2])  # self-conditioning coin
    steps = TextSteps(joint, optimizer, train_dev, batch_size=batch_size,
                      steps=steps_per_epoch, generator=gen, coin_rng=coin_rng,
                      ema=ema, ema_decay=ema_decay, lr_at=lr_at,
                      mesh=mesh, dropout_generator=drop_gen, **loss_kwargs)
    chunk, progress_every = chunks.scan_chunk(), chunks.progress_every()

    ckpt_meta = dict(
        tokenizer_state=tokenizer_state, parameterization=parameterization,
        noise_schedule=noise_schedule, embed_norm=embed_norm,
        anchor_ce=anchor_ce,
    )
    metrics = MetricsLogger(metrics_path)
    if not main:
        metrics.path = None
    best_val_loss = float("inf")
    patience_counter = 0
    start_epoch, global_step = 0, 0
    resume_path = resume_path or str(ckpt_path).replace(".pth", "_state.pth")
    saved = train_state.read(resume_path, log_fn) if resume else None
    if saved is not None:
        start_epoch, global_step, best_val_loss, patience_counter = \
            train_state.restore_text(saved, joint, optimizer, ema, mesh=mesh,
                                     gen=gen, drop_gen=drop_gen,
                                     coin_rng=coin_rng, log_fn=log_fn)
        log_fn(f"[resume] restored epoch {start_epoch} from {resume_path}")
    history, records = [], []
    steps_done, loop_seconds = 0, 0.0
    for epoch in range(start_epoch, epochs):
        w = dynamic_rounding_weight_schedule(epoch, epochs, rounding_weight)
        # The batch order of data.loader.batch_iterator, as index rows.
        order = list(batch_iterator(np.arange(train_chunks.shape[0]),
                                    batch_size, seed=seed, epoch=epoch))
        if order:
            steps.start(np.stack(order), w, global_step)
        t0 = time.perf_counter()
        losses, n = [], 0
        for c, k in enumerate(chunks.chunk_lengths(len(order), chunk)):
            losses.append(steps.run(k))
            n += k
            if progress_every and (c + 1) % progress_every == 0:
                dt = time.perf_counter() - t0
                recent = float(np.concatenate(losses)[:, 2].sum()) / n
                log_fn(f"[epoch {epoch + 1}] step {n}/{steps_per_epoch} "
                       f"({n / dt:.1f} it/s), loss~{recent:.4f}")
        epoch_losses = (np.concatenate(losses) if n
                        else np.zeros((0, 3), np.float32))
        dt = time.perf_counter() - t0
        steps_done += n
        global_step += n
        loop_seconds += dt
        history.append(epoch_losses)
        train_losses = epoch_losses.mean(0) if n else np.zeros(3)

        vn = len(val_batches)
        val_losses = val_pass(epoch, w) if vn else np.zeros(3)
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
            if main:
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

        if resume and (epoch + 1) % max(1, resume_every) == 0:
            generators = train_state.generator_states(mesh, gen, drop_gen,
                                                      coin_rng)
            if main:
                save_checkpoint(
                    train_state.text_state(
                        joint, optimizer, ema, epoch=epoch + 1,
                        step=global_step, best_val_loss=best_val_loss,
                        patience_counter=patience_counter,
                        schedule=use_lr_scheduling, generators=generators,
                        tokenizer_state=tokenizer_state),
                    resume_path)

    final = ema if ema is not None else joint
    final_ckpt_path = (
        get_vertex_checkpoint_path("text-model.pth")
        if "AIP_MODEL_DIR" in os.environ
        else ckpt_path
    )
    log_fn(f"✔ Saving final checkpoint to {final_ckpt_path}...")
    if main:
        save_checkpoint(
            _checkpoint_dict(final, epoch=epochs,
                             extra={"final_training": True}, **ckpt_meta),
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
