"""MNIST DDPM training and sampling (port of ``train/mnist_train.py``).

Rebuild of reference src/mnist.py:128-212: AdamW (lr 1e-3, weight decay
0.01) on the eps-prediction MSE of a SimpleUNet, a 25-digit sample grid
after every epoch, the final weights saved as the reference's bare state
dict (the JAX CLI reads it), and standalone sampling from a checkpoint.

The epoch runs in chunks of ``TDM_SCAN_CHUNK`` steps with one host read a
chunk (``train/chunks.py``), the counterpart of the JAX package's
``make_train_step_multi[_ema]``: ``MnistSteps`` is its step on device
state. The dataset (60 000 images, 188 MB in float32) is put on the device
once and each step gathers its batch there by a device step cursor, in
``batch_iterator``'s order (the JAX package's device-resident data path,
without its knob); timesteps and noise are drawn on the device from one
``torch.Generator``; the EMA update runs in the same step. On the card the
step is captured once as a CUDA graph and replayed (``graphs.py``); on the
CPU it runs eagerly. The metrics record's ``loss`` is the last chunk's
mean step loss, as the JAX trainer logs it.

Data parallelism (``mesh``, the JAX trainer's): every rank gathers the
same global batch and draws its timesteps and noise from the same
generator, trains on its rows, and one all-reduce inside the captured step
averages the gradients and the loss over the ranks
(``parallel/data_parallel.py``); ``batch_size`` stays the global batch,
and only rank 0 samples the epoch grids and writes the checkpoint and
metrics.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time

import numpy as np
import torch
from torch import nn

from tinydiffusionmodels_torch.core import ddpm_loss, make_schedule
from tinydiffusionmodels_torch.core.schedule import DiffusionSchedule
from tinydiffusionmodels_torch.data import (
    batch_iterator,
    load_mnist,
    normalize_mnist,
)
from tinydiffusionmodels_torch.io import (
    get_samples_dir,
    get_vertex_checkpoint_path,
    grid_png,
    load_checkpoint,
    save_checkpoint,
    save_samples,
    state_from_checkpoint,
    unet_checkpoint_dict,
)
from tinydiffusionmodels_torch.models import SimpleUNet
from tinydiffusionmodels_torch.parallel import (
    average_gradients,
    make_mesh,
    replicate_tree,
    shard_batch,
)
from tinydiffusionmodels_torch.runtime import device as runtime_device
from tinydiffusionmodels_torch.sample.ancestral import sample_loop
from tinydiffusionmodels_torch.train import chunks
from tinydiffusionmodels_torch.train.metrics import MetricsLogger
from tinydiffusionmodels_torch.train.optim import adamw
from tinydiffusionmodels_torch.train.precision import in_dtype
from tinydiffusionmodels_torch.train.text_train import _generator

IMAGE_SHAPE = (28, 28, 1)


def optimizer_step(model: nn.Module, optimizer, batch: torch.Tensor,
                   t: torch.Tensor, noise: torch.Tensor,
                   sched: DiffusionSchedule, *,
                   compute_dtype=None, mesh=None) -> torch.Tensor:
    """One AdamW step on ``ddpm_loss`` at the given timesteps and noise;
    returns the loss, still on the device. ``compute_dtype`` (bf16) runs the
    UNet forward and backward in bf16 on parameters cast inside the loss;
    the parameters and AdamW's state stay f32. With ``mesh``
    (``parallel.average_gradients``) the gradients and the loss are
    averaged over the ranks before AdamW."""
    loss = ddpm_loss(sched, in_dtype(model, compute_dtype), batch, t, noise,
                     compute_dtype=compute_dtype)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    average_gradients(optimizer, loss, mesh)
    optimizer.step()
    return loss


def train_step(model, optimizer, batch, sched, generator, *,
               compute_dtype=None, mesh=None) -> torch.Tensor:
    """``optimizer_step`` with timesteps and noise drawn on the batch's
    device from ``generator``. ``batch`` is the global batch; with
    ``mesh`` the step trains on this rank's rows of it and of the
    timesteps and noise drawn for all of it."""
    t = torch.randint(0, sched.timesteps, (batch.shape[0],),
                      generator=generator, device=batch.device)
    noise = torch.randn(batch.shape, generator=generator, device=batch.device)
    if mesh is not None:
        batch, t, noise = shard_batch(mesh, (batch, t, noise))
    return optimizer_step(model, optimizer, batch, t, noise, sched,
                          compute_dtype=compute_dtype, mesh=mesh)


def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """One EMA step in place: ema <- decay * ema + (1 - decay) * params,
    outside autograd."""
    with torch.no_grad():
        ema_params = list(ema.parameters())
        torch._foreach_mul_(ema_params, decay)
        torch._foreach_add_(ema_params, list(model.parameters()),
                            alpha=1.0 - decay)


def epoch_order(n: int, batch_size: int, *, seed: int, epoch: int,
                device) -> torch.Tensor:
    """(steps, batch_size) indices of one epoch's batches on ``device``:
    ``batch_iterator``'s order over ``arange(n)``, so gathering them from the
    dataset gives the JAX package's batches."""
    order = list(batch_iterator(np.arange(n), batch_size, seed=seed,
                                epoch=epoch))
    if not order:
        return torch.zeros((0, batch_size), dtype=torch.long, device=device)
    return torch.as_tensor(np.stack(order), device=device)


class MnistSteps(chunks.EpochSteps):
    """Optimizer steps of ``train_step`` on device state, in chunks: the
    counterpart of ``make_train_step_multi`` (and, with ``ema``, of
    ``make_train_step_multi_ema``). A step gathers its batch from ``data``
    (N, 28, 28, 1) by the epoch's order at the device cursor, steps AdamW,
    updates ``ema`` and writes its loss. ``eager`` runs every step eagerly
    on the card too (the plain version a replay is held against)."""

    def __init__(self, model, optimizer, data, sched, *, batch_size: int,
                 steps: int, generator, ema=None,
                 ema_decay: float | None = None, compute_dtype=None,
                 eager: bool = False, mesh=None):

        def step(_):
            loss = train_step(model, optimizer,
                              data.index_select(0, self.rows()), sched,
                              generator, compute_dtype=compute_dtype,
                              mesh=mesh)
            if ema is not None:
                ema_update(ema, model, ema_decay)
            optimizer.zero_grad(set_to_none=True)
            self.finish(loss)

        super().__init__(step, optimizer=optimizer, steps=steps,
                         batch_size=batch_size, loss_width=1,
                         device=data.device, generators=(generator,),
                         eager=eager)

    def run(self, n: int) -> np.ndarray:
        """The next ``n`` steps; their (n,) losses, one host read."""
        return self.run_variants([None] * n)[:, 0]


def sample_images(model: nn.Module, sched: DiffusionSchedule, *,
                  n_samples: int = 25, method: str = "ancestral",
                  num_steps: int | None = None, **randomness) -> torch.Tensor:
    """(n_samples, 28, 28, 1) digits in about [-1, 1] from the reverse
    process on ``sched``'s device. ``randomness`` is ``sample_loop``'s:
    ``generator``, or ``x_T`` (and ``noise_fn``)."""
    with torch.inference_mode():
        return sample_loop(model.eval(), sched, (n_samples, *IMAGE_SHAPE),
                           method=method, num_steps=num_steps, **randomness)


def _grid(x: torch.Tensor, n_samples: int) -> bytes:
    imgs = (x[..., 0].clamp(-1, 1).cpu().numpy() + 1) / 2  # [-1,1] -> [0,1]
    return grid_png(imgs, nrow=int(math.sqrt(n_samples)))


def sample_grid_png(model, sched, *, n_samples: int = 25,
                    method: str = "ancestral", num_steps: int | None = None,
                    **randomness) -> bytes:
    """Draw ``n_samples`` digits and encode the PNG grid (reference
    src/mnist.py:99-126 without the torchvision/tempfile detour)."""
    return _grid(sample_images(model, sched, n_samples=n_samples,
                               method=method, num_steps=num_steps,
                               **randomness), n_samples)


def _sample_path(outdir: str, name: str):
    samples_dir = get_samples_dir(outdir)
    if isinstance(samples_dir, str):
        return f"{samples_dir}/{name}"
    return samples_dir / name


@dataclasses.dataclass
class TrainResult:
    """What ``train`` returns: the final model (the EMA one with
    ``ema_decay``), every step's loss, the per-epoch metrics records, and the
    steps and the seconds their loops took (sample grids and checkpoints
    excluded)."""

    model: SimpleUNet
    step_losses: np.ndarray
    epochs: list[dict]
    steps: int
    seconds: float


def train(
    *,
    epochs: int = 5,
    batch_size: int = 128,
    lr: float = 1e-3,
    ckpt_path: str = "ckpt.pth",
    sample_every_epoch: bool = True,
    samples_per_epoch: int = 25,
    seed: int = 0,
    data_root: str = "./data",
    metrics_path: str | None = None,
    ema_decay: float | None = None,
    compute_dtype=None,
    device=None,
    mesh=None,
    log_fn=print,
) -> TrainResult:
    """Full training run (reference src/mnist.py:128-165 surface) on
    ``device`` (default ``runtime.device()``: the card unless
    ``TDM_PLATFORM=cpu``). ``TDM_DATA_LIMIT`` cuts the dataset.

    ``ema_decay`` (e.g. 0.999) keeps an exponential moving average of the
    weights, updated after every step; the per-epoch grids and the final
    checkpoint then use it. The metrics record's ``loss`` is the mean step
    loss of the epoch's last chunk (the JAX trainer's).
    ``compute_dtype=torch.bfloat16`` trains in bf16 (``optimizer_step``);
    the weights, AdamW's state, the EMA, the sample grids and the
    checkpoint stay f32. ``mesh`` (default: every rank of the process
    group on 'data', or one rank without one) makes the run data-parallel
    over its 'data' axis; ``batch_size`` is the global batch."""
    dev = runtime_device() if device is None else torch.device(device)
    if mesh is None:
        mesh = make_mesh()
    dp = mesh.axis_size("data")
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} not divisible by 'data' axis "
                         f"size {dp}")
    main = mesh.rank == 0
    if not main:
        def log_fn(*_):
            pass
    ckpt_path = (get_vertex_checkpoint_path("image-model.pth")
                 if "AIP_MODEL_DIR" in os.environ else ckpt_path)
    metrics = MetricsLogger(metrics_path)
    if not main:
        metrics.path = None
    images, _, source = load_mnist(data_root, train=True)
    if source == "synthetic":
        log_fn("[data] MNIST unavailable -> deterministic synthetic digits")
    limit = int(os.environ.get("TDM_DATA_LIMIT", "0"))
    if limit:
        images = images[:limit]
    data = torch.as_tensor(normalize_mnist(images), device=dev)

    sched = make_schedule(device=dev)
    # Parameters are drawn on the CPU, so a seed gives the same weights on
    # every device; t and noise are drawn on the device.
    model = SimpleUNet(sched.timesteps,
                       generator=torch.Generator().manual_seed(seed)).to(dev)
    replicate_tree(mesh, model)
    # torch AdamW default weight decay, reference src/mnist.py:148.
    optimizer = adamw(model.parameters(), lr, weight_decay=0.01)
    ema = None
    if ema_decay is not None:
        ema = copy.deepcopy(model).requires_grad_(False)
    gen = _generator(dev, seed, 0)
    epoch_steps = data.shape[0] // batch_size
    steps = MnistSteps(model, optimizer, data, sched, batch_size=batch_size,
                       steps=epoch_steps, generator=gen, ema=ema,
                       ema_decay=ema_decay, compute_dtype=compute_dtype,
                       mesh=mesh)
    chunk, progress_every = chunks.scan_chunk(), chunks.progress_every()

    history, records = [], []
    steps_done, loop_seconds = 0, 0.0
    for epoch in range(epochs):
        order = epoch_order(data.shape[0], batch_size, seed=seed,
                            epoch=epoch, device="cpu")
        if epoch_steps:
            steps.start(order.numpy())
        model.train()
        t0 = time.perf_counter()
        losses = []
        for c, k in enumerate(chunks.chunk_lengths(epoch_steps, chunk)):
            losses.append(steps.run(k))
            if progress_every and (c + 1) % progress_every == 0:
                dt = time.perf_counter() - t0
                n = sum(len(x) for x in losses)
                log_fn(f"[epoch {epoch + 1}] step {n}/{epoch_steps} "
                       f"({n / dt:.1f} it/s), "
                       f"loss~{float(losses[-1].mean()):.4f}")
        epoch_losses = (np.concatenate(losses) if losses
                        else np.zeros(0, np.float32))
        n = len(epoch_losses)
        dt = time.perf_counter() - t0
        steps_done += n
        loop_seconds += dt
        history.append(epoch_losses)
        # The JAX trainer's ``float(loss)``: the last chunk's mean (0 when
        # the epoch has no step).
        last_chunk = float(losses[-1].mean()) if losses else 0.0
        log_fn(f"Epoch {epoch + 1}/{epochs}: {n} steps in {dt:.1f}s "
               f"({n / dt:.1f} it/s), loss~{last_chunk:.4f}")
        record = {"workload": "mnist", "epoch": epoch + 1, "steps": n,
                  "it_per_s": round(n / dt, 2), "loss": last_chunk}
        metrics.log(record)
        records.append(record)
        if sample_every_epoch and main:
            png = sample_grid_png(
                ema if ema is not None else model, sched,
                n_samples=samples_per_epoch,
                generator=_generator(dev, seed, 3, epoch))
            sample_path = _sample_path("samples", f"epoch_{epoch + 1:03d}.png")
            save_samples(png, sample_path, mode="wb")
            log_fn(f"[epoch {epoch + 1}] saved samples to {sample_path}")

    final = ema if ema is not None else model
    if main:
        save_checkpoint(unet_checkpoint_dict(final), ckpt_path)
    metrics.close()
    return TrainResult(
        model=final.eval(),
        step_losses=(np.concatenate(history) if history
                     else np.zeros(0, np.float32)),
        epochs=records, steps=steps_done, seconds=loop_seconds,
    )


def load_unet(ckpt_path: str, device=None) -> SimpleUNet:
    """A SimpleUNet from a checkpoint either package wrote, on ``device``."""
    model = SimpleUNet()
    model.load_state_dict(state_from_checkpoint(load_checkpoint(ckpt_path)),
                          strict=True)
    return model.to(runtime_device() if device is None else device).eval()


def sample(
    *,
    n_samples: int = 25,
    ckpt_path: str = "ckpt.pth",
    outdir: str = "samples",
    seed: int = 0,
    method: str = "ancestral",
    num_steps: int | None = None,
    device=None,
    log_fn=print,
) -> torch.Tensor:
    """Standalone sampling from a checkpoint (reference src/mnist.py:183-212):
    writes ``<outdir>/samples.png`` and returns the (n, 28, 28, 1) samples."""
    model = load_unet(ckpt_path, device)
    dev = next(model.parameters()).device
    x = sample_images(model, make_schedule(device=dev), n_samples=n_samples,
                      method=method, num_steps=num_steps,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    sample_path = _sample_path(outdir, "samples.png")
    save_samples(_grid(x, n_samples), sample_path, mode="wb")
    log_fn(f"Saved samples to {sample_path}")
    return x
