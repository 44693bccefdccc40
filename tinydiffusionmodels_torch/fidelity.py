"""Sample fidelity of an MNIST diffusion checkpoint (port of
``tools/fidelity.py``), on the card unless ``TDM_PLATFORM=cpu``.

    python -m tinydiffusionmodels_torch.fidelity --ckpt ckpt.pth [--n 256] \
        [--sampler ancestral|ddim|dpm++] [--steps 50] [--dtype f32|bf16]

It trains the small CNN classifier (``models/classifier.py``) on the
training digits, draws ``--n`` samples from the checkpoint through the
port's ``Sampler`` (every residual block one launch of the fused resblock
kernel on the card; ``--dtype bf16`` runs the UNet in bf16, the sampler's
update in f32) and prints one JSON line with the JAX tool's keys:

- ``data_source``: the digits read (``idx`` or ``synthetic``);
- ``classifier_accuracy_on_data``: the classifier on held-out digits;
- ``mean_max_prob``, ``inception_score`` and ``class_histogram`` of the
  samples under the classifier;
- ``fid`` against the training digits in the classifier's 128-d feature
  space, beside ``fid_real_floor`` (two disjoint sets of ``n`` real
  digits);
- ``nn_train_dist_*``: pixel-L2 distance to the nearest training digit,
  of the samples and of ``n`` held-out real digits;
- ``dtype``.

``inception_score``, ``fid`` and ``nn_train_distance`` are the port's own
copies of the root tool's numpy functions.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch
import torch.nn.functional as F

from tinydiffusionmodels_torch.core import make_schedule, rng
from tinydiffusionmodels_torch.core.rng import prng_key
from tinydiffusionmodels_torch.data import load_mnist, normalize_mnist
from tinydiffusionmodels_torch.models.classifier import (
    DigitClassifier,
    classifier_apply,
    classifier_features,
)
from tinydiffusionmodels_torch.runtime import device as runtime_device
from tinydiffusionmodels_torch.sample.ancestral import sample_loop
from tinydiffusionmodels_torch.train.mnist_train import IMAGE_SHAPE, load_unet


def _split(x: np.ndarray):
    """The root tool's split: the last max(256, N / 10) rows held out."""
    n_val = max(256, len(x) // 10)
    return x[:-n_val], x[-n_val:]


@torch.inference_mode()
def _batched(fn, x: np.ndarray | torch.Tensor, device, batch: int = 1024):
    """``fn`` over ``x`` in batches on ``device``; numpy out."""
    x = torch.as_tensor(x, device=device)
    return torch.cat([fn(x[s:s + batch]) for s in range(0, len(x), batch)]
                     ).float().cpu().numpy()


def predict(model: DigitClassifier, x, device) -> np.ndarray:
    """Class probabilities (N, 10) of digits (N, 28, 28, 1) in [-1, 1]."""
    return _batched(lambda b: torch.softmax(classifier_apply(model, b), dim=-1),
                    x, device)


def features(model: DigitClassifier, x, device, cap: int = 8192) -> np.ndarray:
    """The first ``cap`` digits' 128-d classifier features."""
    return _batched(lambda b: classifier_features(model, b), x[:cap], device)


def train_classifier(images: np.ndarray, labels: np.ndarray, *,
                     epochs: int = 2, batch_size: int = 256, seed: int = 0,
                     device=None) -> tuple[DigitClassifier, float]:
    """The classifier trained as the root tool trains it: AdamW at 1e-3
    (optax ``adamw``'s defaults: betas (0.9, 0.999), eps 1e-8, weight decay
    1e-4), ``epochs`` passes of full batches in a permutation drawn from
    ``seed``. The data sits on ``device`` and no step reads a value back.
    Returns (the model, its accuracy on the held-out digits)."""
    dev = runtime_device() if device is None else torch.device(device)
    x = normalize_mnist(images)
    y = labels.astype(np.int64)
    x_train, x_val = _split(x)
    y_train, y_val = _split(y)
    # init_classifier(PRNGKey(seed)), as tools/fidelity.py draws it.
    model = DigitClassifier(key=prng_key(seed), device=dev)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    xt = torch.as_tensor(x_train, device=dev)
    yt = torch.as_tensor(y_train, device=dev)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        idx = torch.as_tensor(rng.permutation(len(x_train)), device=dev)
        for s in range(0, len(x_train) - batch_size + 1, batch_size):
            b = idx[s:s + batch_size]
            loss = F.cross_entropy(classifier_apply(model, xt[b]), yt[b])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
    model.eval()
    acc = float((predict(model, x_val, dev).argmax(-1) == y_val).mean())
    return model, acc


def inception_score(probs: np.ndarray) -> float:
    """exp(E_x[KL(p(y|x) || p(y))]), the standard IS formula."""
    p_y = probs.mean(axis=0, keepdims=True)
    kl = (probs * (np.log(probs + 1e-12) - np.log(p_y + 1e-12))).sum(axis=1)
    return float(np.exp(kl.mean()))


def fid(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Frechet distance between Gaussian fits of two feature sets
    (Heusel et al. 2017): |mu_a - mu_b|^2 + Tr(Ca + Cb - 2 (Ca Cb)^1/2),
    the matrix root by the symmetric eigh form (Tr((Ca Cb)^1/2) =
    Tr((A Cb A)^1/2) with A = Ca^1/2), no scipy."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    ca = np.cov(feats_a, rowvar=False)
    cb = np.cov(feats_b, rowvar=False)
    wa, va = np.linalg.eigh(ca)
    a_half = (va * np.sqrt(np.clip(wa, 0, None))) @ va.T
    m = a_half @ cb @ a_half
    wm = np.linalg.eigvalsh(m)
    tr_sqrt = np.sqrt(np.clip(wm, 0, None)).sum()
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2.0 * tr_sqrt)


def nn_train_distance(gen: np.ndarray, train: np.ndarray,
                      block: int = 4096) -> np.ndarray:
    """Per-sample pixel-L2 distance to the nearest training image, in
    blocks of ``block`` training images (|a-b|^2 = |a|^2 + |b|^2 - 2ab)."""
    g = gen.reshape(len(gen), -1).astype(np.float32)
    t = train.reshape(len(train), -1).astype(np.float32)
    g2 = (g * g).sum(1)[:, None]
    best = np.full((len(g),), np.inf, dtype=np.float32)
    for s in range(0, len(t), block):
        tb = t[s:s + block]
        d2 = g2 + (tb * tb).sum(1)[None, :] - 2.0 * (g @ tb.T)
        best = np.minimum(best, d2.min(axis=1))
    return np.sqrt(np.clip(best, 0, None))


def sample_digits(model, *, n: int, method: str = "ancestral",
                  num_steps: int | None = None, seed: int = 0,
                  compute_dtype=None) -> torch.Tensor:
    """(n, 28, 28, 1) samples in [-1, 1] from ``model`` on its device.
    ``compute_dtype=torch.bfloat16``: a bf16 copy of the UNet denoises
    bf16 inputs and its output returns to f32 for the update, as the
    root tool's bf16 path does."""
    dev = next(model.parameters()).device
    denoise = model
    if compute_dtype is not None:
        low = copy.deepcopy(model).to(compute_dtype)

        def denoise(x, t):
            return low(x.to(compute_dtype), t).float()
    with torch.inference_mode():
        x = sample_loop(denoise, make_schedule(device=dev), (n, *IMAGE_SHAPE),
                        method=method, num_steps=num_steps,
                        key=rng.prng_key(seed))
    return x.clamp(-1.0, 1.0)


def evaluate_checkpoint(ckpt_path: str, *, n: int = 256,
                        method: str = "ancestral",
                        num_steps: int | None = None, seed: int = 0,
                        data_root: str = "./data", compute_dtype=None,
                        device=None) -> dict:
    """The root tool's ``evaluate_checkpoint``: its metrics of ``n`` samples
    of the checkpoint at ``ckpt_path`` (either package's MNIST ``.pth``).
    ``TDM_DATA_LIMIT`` cuts the digits."""
    dev = runtime_device() if device is None else torch.device(device)
    images, labels, source = load_mnist(data_root)
    limit = int(os.environ.get("TDM_DATA_LIMIT", "0"))
    if limit:
        images, labels = images[:limit], labels[:limit]
    clf, acc = train_classifier(images, labels, device=dev)
    # The classifier's split: the held-out tail calibrates FID's
    # small-sample floor and the nearest-neighbour distance.
    x_train, x_heldout = _split(np.asarray(normalize_mnist(images),
                                           dtype=np.float32))

    samples = sample_digits(load_unet(ckpt_path, dev), n=n, method=method,
                            num_steps=num_steps, seed=seed,
                            compute_dtype=compute_dtype)
    probs = predict(clf, samples, dev)
    samples_np = samples.float().cpu().numpy()

    feats_real = features(clf, x_train, dev)
    feats_gen = features(clf, samples_np, dev)
    half = np.random.default_rng(seed).permutation(len(x_train))
    floor_a = features(clf, x_train[half[:n]], dev, cap=n)
    floor_b = features(clf, x_train[half[n:2 * n]], dev, cap=n)
    nn_gen = nn_train_distance(samples_np, x_train)
    nn_real = nn_train_distance(x_heldout[:n], x_train)
    return {
        "data_source": source,
        "classifier_accuracy_on_data": round(acc, 4),
        "n_samples": n,
        "mean_max_prob": round(float(probs.max(axis=1).mean()), 4),
        "inception_score": round(inception_score(probs), 4),
        "fid": round(fid(feats_gen, feats_real), 4),
        "fid_real_floor": round(fid(floor_a, floor_b), 4),
        "nn_train_dist_mean": round(float(nn_gen.mean()), 4),
        "nn_train_dist_p05": round(float(np.percentile(nn_gen, 5)), 4),
        "nn_train_dist_real_mean": round(float(nn_real.mean()), 4),
        "nn_train_dist_real_p05": round(float(np.percentile(nn_real, 5)), 4),
        "class_histogram": np.bincount(probs.argmax(axis=1),
                                       minlength=10).tolist(),
    }


def main(argv=None) -> dict:
    """Print (and return) the JSON record of the root tool's CLI."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", type=str, default="ckpt.pth")
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--sampler", type=str, default="ancestral",
                        choices=["ancestral", "ddim", "dpm++"])
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    args = parser.parse_args(argv)
    result = evaluate_checkpoint(
        args.ckpt, n=args.n, method=args.sampler, num_steps=args.steps,
        seed=args.seed, data_root=args.data_root,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None)
    result["dtype"] = args.dtype
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
