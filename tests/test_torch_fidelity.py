"""The torch package's sample-fidelity tools on the CPU, against the JAX
package's classifier and the root ``tools/`` functions.

- ``models/classifier.py`` on weights converted from JAX's
  ``init_classifier`` (``io.convert.classifier_state_from_jax``, which
  permutes ``fc1``'s rows from JAX's HWC flatten to the port's CHW) equals
  JAX's ``classifier_apply`` and ``classifier_features`` within 1e-5.
- ``fidelity.inception_score``, ``fid`` and ``nn_train_distance`` and
  ``text_fidelity.ngram_stats`` equal the root tools' functions on the same
  numpy inputs within 1e-6; ``text_fidelity.lm_perplexity`` equals
  ``tools/text_fidelity.lm_perplexity`` on the same TinyGPT weights within
  1e-5 (relative).
- Each tool end to end at a tiny size (``TDM_PLATFORM=cpu``): its JSON
  line carries the JAX tool's keys, finite numbers and the data source.
"""

from __future__ import annotations

import json
import math
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tools import fidelity as jax_fidelity  # noqa: E402
from tools import text_fidelity as jax_text_fidelity  # noqa: E402

from tinydiffusionmodels_torch import fidelity, text_fidelity  # noqa: E402
from tinydiffusionmodels_torch.core.rng import prng_key, substream  # noqa: E402

# The JAX tools' JSON keys (tools/fidelity.py main, tools/text_fidelity.py
# main at --seeds 1).
MNIST_KEYS = {
    "data_source", "classifier_accuracy_on_data", "n_samples",
    "mean_max_prob", "inception_score", "fid", "fid_real_floor",
    "nn_train_dist_mean", "nn_train_dist_p05", "nn_train_dist_real_mean",
    "nn_train_dist_real_p05", "class_histogram", "dtype",
}
TEXT_KEYS = {
    "mode", "guidance_norm", "n_samples", "n_seeds", "corpus_perplexity",
    "uniform_perplexity", "lm_perplexity", "distinct_1", "distinct_2",
    "dup_8gram_rate", "corpus_8gram_overlap", "corpus_distinct_1",
    "corpus_distinct_2", "corpus_dup_8gram_rate",
}
NUMPY_TOL = dict(rtol=1e-6, atol=1e-6)


def test_classifier_matches_jax():
    """Logits and 128-d features of converted weights, within 1e-5."""
    import jax

    from tinydiffusionmodels_tpu.models.classifier import (
        classifier_apply,
        classifier_features,
        init_classifier,
    )
    from tinydiffusionmodels_torch.io import classifier_state_from_jax
    from tinydiffusionmodels_torch.models.classifier import DigitClassifier
    from tinydiffusionmodels_torch.models.classifier import (
        classifier_apply as port_apply,
    )
    from tinydiffusionmodels_torch.models.classifier import (
        classifier_features as port_features,
    )

    params = jax.tree_util.tree_map(
        np.asarray, init_classifier(jax.random.PRNGKey(3)))
    model = DigitClassifier()
    model.load_state_dict(classifier_state_from_jax(params), strict=True)
    x = np.random.default_rng(0).uniform(-1, 1, (5, 28, 28, 1)).astype(
        np.float32)
    with torch.no_grad():
        feats = port_features(model, torch.from_numpy(x)).numpy()
        logits = port_apply(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(feats, np.asarray(classifier_features(params, x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits, np.asarray(classifier_apply(params, x)),
                               rtol=1e-5, atol=1e-5)


def test_mnist_metrics_match_the_root_tool():
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(10) * 0.3, size=64)
    assert math.isclose(fidelity.inception_score(probs),
                        jax_fidelity.inception_score(probs),
                        rel_tol=1e-6, abs_tol=1e-6)
    a = rng.normal(size=(80, 12))
    b = rng.normal(0.3, 1.2, size=(70, 12))
    assert math.isclose(fidelity.fid(a, b), jax_fidelity.fid(a, b),
                        rel_tol=1e-6, abs_tol=1e-6)
    gen = rng.uniform(-1, 1, (9, 28, 28, 1)).astype(np.float32)
    train = rng.uniform(-1, 1, (50, 28, 28, 1)).astype(np.float32)
    np.testing.assert_allclose(
        fidelity.nn_train_distance(gen, train, block=16),
        jax_fidelity.nn_train_distance(gen, train, block=16), **NUMPY_TOL)


def test_text_metrics_match_the_root_tool():
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, 5, size=n) for n in (1, 8, 9, 20, 20)]
    seqs.append(seqs[3].copy())
    assert text_fidelity.ngram_stats(seqs) == jax_text_fidelity.ngram_stats(
        seqs)


def test_lm_perplexity_matches_the_root_tool():
    """The same TinyGPT weights, sequences shorter than 2, in between and
    longer than the position table: within 1e-5 (relative)."""
    import jax

    from tinydiffusionmodels_tpu.models.ar_lm import (
        TinyGPTConfig as JaxConfig,
    )
    from tinydiffusionmodels_tpu.models.ar_lm import init_tiny_gpt
    from tinydiffusionmodels_torch.io import tiny_gpt_state_from_jax
    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig

    shape = dict(vocab_size=23, dim=32, n_heads=2, depth=2, max_len=16)
    params = jax.tree_util.tree_map(
        np.asarray, init_tiny_gpt(jax.random.PRNGKey(0), JaxConfig(**shape)))
    lm = TinyGPT(TinyGPTConfig(**shape))
    lm.load_state_dict(tiny_gpt_state_from_jax(params), strict=True)
    lm.eval()
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 23, size=n) for n in (1, 2, 7, 16, 30)]
    want = jax_text_fidelity.lm_perplexity(params, JaxConfig(**shape), seqs)
    got = text_fidelity.lm_perplexity(lm, seqs)
    assert math.isclose(got, want, rel_tol=1e-5), (got, want)
    assert math.isnan(text_fidelity.lm_perplexity(lm, [seqs[0]]))


def _write_mnist_idx(root: Path, n: int) -> None:
    from tinydiffusionmodels_torch.data.mnist import _synthetic_mnist

    images, labels = _synthetic_mnist(n, seed=0)
    root.mkdir(parents=True, exist_ok=True)
    for name, array in (("train-images-idx3-ubyte", images),
                        ("train-labels-idx1-ubyte", labels)):
        (root / name).write_bytes(
            struct.pack(">I", 0x0800 | array.ndim)
            + struct.pack(f">{array.ndim}I", *array.shape)
            + array.astype(np.uint8).tobytes())


def _finite(record: dict) -> None:
    for k, v in record.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert math.isfinite(v), (k, v)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fidelity_tool_end_to_end(dtype, tmp_path, monkeypatch, capsys):
    """600 digits (one classifier step an epoch), 8 DDIM-3 samples of a
    random UNet: the JSON line has the JAX tool's keys, finite values."""
    from tinydiffusionmodels_torch.io import save_checkpoint, unet_checkpoint_dict
    from tinydiffusionmodels_torch.models import SimpleUNet

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    monkeypatch.delenv("TDM_DATA_LIMIT", raising=False)
    _write_mnist_idx(tmp_path / "digits", 600)
    save_checkpoint(unet_checkpoint_dict(SimpleUNet()), "m.pth")
    result = fidelity.main(["--ckpt", "m.pth", "--n", "8", "--sampler", "ddim",
                            "--steps", "3", "--data_root", "digits",
                            "--dtype", dtype])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert set(result) == MNIST_KEYS
    assert result["data_source"] == "idx" and result["dtype"] == dtype
    assert result["n_samples"] == 8 and sum(result["class_histogram"]) == 8
    _finite(result)


@pytest.mark.parametrize("mode", ["pure", "guided"])
def test_text_fidelity_tool_end_to_end(mode, tmp_path, monkeypatch, capsys):
    """A random narrow denoiser on 3000 characters of the built-in corpus,
    a judge TinyGPT trained one step and saved, then reused: the JSON line
    has the JAX tool's keys (and the corpus source), finite values."""
    from tinydiffusionmodels_torch.data import CharTokenizer, load_text_corpus
    from tinydiffusionmodels_torch.io import save_checkpoint, text_checkpoint_dict
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    monkeypatch.setenv("TDM_DATA_LIMIT", "3000")
    corpus, _ = load_text_corpus()
    tok = CharTokenizer(corpus[:3000])
    cfg = TransformerConfig(dim=16, n_heads=2, depth=1, ffn_dim=32,
                            self_cond=True)
    save_checkpoint(text_checkpoint_dict(
        TinyTransformer(cfg, key=substream(prng_key(0), "diffusion")),
        LearnedRounding(
            16, tok.vocab_size, key=substream(prng_key(0), "rounding")),
        LearnedEmbedding(
            tok.vocab_size, 16, key=substream(prng_key(0), "embedding")),
        tokenizer_state=tok.state()), "t.pth")
    argv = ["--ckpt", "t.pth", "--lm_ckpt", "lm.pth", "--n", "4",
            "--seq_len", "16", "--sampler", "ddim", "--steps", "3",
            "--lm_epochs", "1", "--mode", mode]
    for _ in range(2):
        result = text_fidelity.main(argv)
    out = capsys.readouterr()
    assert "[lm] loaded TinyGPT from lm.pth" in out.err
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line == result
    assert set(result) == TEXT_KEYS | {"data_source"}
    assert result["mode"] == mode and result["data_source"] == "builtin"
    assert result["uniform_perplexity"] == tok.vocab_size
    _finite(result)
