"""MNIST diffusion CLI on PyTorch (port of ``tinydiffusionmodels_tpu.mnist``).

    python -m tinydiffusionmodels_torch.mnist --train --epochs 3 --batch_size 128
    python -m tinydiffusionmodels_torch.mnist --sample --ckpt ckpt.pth

The parser is the port's own copy of the JAX CLI's (``build_parser``), so
every flag keeps its name, default and meaning. ``--train`` trains a
SimpleUNet initialized from ``--seed`` (``train/mnist_train.py``), with a
sample grid per epoch unless ``--no_epoch_samples``, and saves the
reference's bare state dict, which the JAX CLI reads; ``--sample`` reads a
checkpoint either CLI wrote and writes ``samples/samples.png``, with
``--sampler ancestral|ddim|dpm++`` and ``--steps``. It runs on the GPU
unless ``TDM_PLATFORM=cpu``; every residual block is one launch of the CUDA
kernel there. ``--train --dtype bf16`` trains in bf16
(``train/precision.py``: the parameters are cast inside the loss, the
weights, AdamW's state and the checkpoint stay f32). ``--profile_dir
DIR`` profiles the run with ``torch.profiler`` (``runtime.profile_trace``:
``DIR/trace.json`` and the per-op table ``DIR/ops.txt``). ``--train
--resume`` writes the whole train state to ``<ckpt>_state.pth`` every
``--resume_every`` epochs and resumes from it when it is there
(``train/state.py``): the JAX CLI's file, so either CLI resumes a run the
other wrote. Under ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N -m tinydiffusionmodels_torch.mnist
--train``) each process takes one GPU and ``--train`` is data-parallel over
all of them, ``--batch_size`` the global batch; rank 0 writes the
checkpoint and the sample grids.
"""

from __future__ import annotations

import argparse
import os

def build_parser() -> argparse.ArgumentParser:
    from tinydiffusionmodels_torch.io import get_vertex_checkpoint_path

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--train", action="store_true", help="Train the model")
    parser.add_argument("--sample", action="store_true", help="Generate samples")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument(
        "--ckpt",
        type=str,
        default=get_vertex_checkpoint_path("image-model.pth")
        if "AIP_MODEL_DIR" in os.environ
        else "ckpt.pth",
    )
    # Framework extensions (not in the reference surface):
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument(
        "--sampler", type=str, default="ancestral", choices=["ancestral", "ddim", "dpm++"]
    )
    parser.add_argument(
        "--steps", type=int, default=None,
        help="sampler steps (ddim); ancestral always runs the full schedule",
    )
    parser.add_argument(
        "--no_epoch_samples", action="store_true",
        help="skip the per-epoch sample grid during training",
    )
    parser.add_argument(
        "--ema_decay", type=float, default=None,
        help="maintain an EMA of the weights (e.g. 0.999) and sample/"
             "checkpoint from it (framework extension; DDPM standard)",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="checkpoint full train state each epoch and resume if present",
    )
    parser.add_argument(
        "--resume_every", type=int, default=1,
        help="epochs between resume-state checkpoints",
    )
    parser.add_argument(
        "--profile_dir", type=str, default=None,
        help="capture a torch.profiler trace of the run to this directory",
    )
    parser.add_argument(
        "--metrics_path", type=str, default=None,
        help="write per-epoch JSONL metrics here (or set TDM_METRICS_PATH)",
    )
    parser.add_argument(
        "--dtype", type=str, default=os.environ.get("TDM_DTYPE", "f32"),
        choices=["f32", "bf16"],
        help="compute dtype for the train step (master params stay f32)",
    )
    return parser


def main(argv=None):
    """Run the CLI. Returns the ``mnist_train.TrainResult`` of ``--train``,
    the (25, 28, 28, 1) samples of ``--sample``, or both as a pair."""
    args = build_parser().parse_args(argv)
    if not args.train and not args.sample:
        print("Nothing to do. Pass --train or --sample.")
        return None
    from tinydiffusionmodels_torch.runtime import profile_trace

    with profile_trace(args.profile_dir):
        return _run(args)


def _run(args):
    """``main`` past its argument checks."""
    from tinydiffusionmodels_torch.parallel import make_mesh, multihost
    from tinydiffusionmodels_torch.runtime import device
    from tinydiffusionmodels_torch.train import mnist_train
    from tinydiffusionmodels_torch.train.precision import resolve_compute_dtype

    dev = device()
    mesh = make_mesh() if multihost.initialize() else None
    result = samples = None
    if args.train:
        result = mnist_train.train(
            epochs=args.epochs,
            batch_size=args.batch_size,
            ckpt_path=args.ckpt,
            seed=args.seed,
            data_root=args.data_root,
            sample_every_epoch=not args.no_epoch_samples,
            metrics_path=args.metrics_path,
            ema_decay=args.ema_decay,
            compute_dtype=resolve_compute_dtype(args.dtype),
            device=dev,
            mesh=mesh,
            resume=args.resume,
            resume_every=args.resume_every,
        )
    if args.sample and (mesh is None or mesh.rank == 0):
        samples = mnist_train.sample(
            ckpt_path=args.ckpt,
            seed=args.seed,
            method=args.sampler,
            num_steps=args.steps,
            device=dev,
        )
    if result is not None and samples is not None:
        return result, samples
    return samples if result is None else result


if __name__ == "__main__":
    main()
