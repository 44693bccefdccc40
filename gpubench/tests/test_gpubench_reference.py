"""The plain reference against the program's CPU path at a tiny size, and
the rule on modules: nothing a run or the reference loads is JAX or the
JAX package, and the reference loads nothing of the program."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from gpubench import weights
from gpubench.reference import keytree
from gpubench.reference import text as ref_text
from gpubench.reference import unet as ref_unet
from gpubench.reference.adamw import AdamW
from gpubench.tests import tiny

KEY = (0x12345678, 0x9ABCDEF0)


def _program_key():
    return torch.tensor(KEY, dtype=torch.int64)


def test_keys_are_the_programs():
    from tinydiffusionmodels_torch.core import rng

    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        assert keytree.prng_key(seed) == rng.key_words(rng.prng_key(seed))
    k = _program_key()
    assert keytree.fold_in(KEY, 99) == rng.key_words(rng.fold_in(k, 99))
    assert keytree.substream(KEY, "noise") == rng.key_words(
        rng.substream(k, "noise"))
    assert [keytree.split(KEY)[i] for i in range(2)] == [
        rng.key_words(x) for x in rng.split(k)]


def test_draws_are_the_programs():
    from tinydiffusionmodels_torch.core import rng

    k, shape = _program_key(), (3, 5, 7)
    idx = keytree.full_index(shape, "cpu")
    n = math.prod(shape)
    assert torch.equal(keytree.normal(KEY, idx), rng.normal(k, shape))
    assert torch.equal(keytree.counter_normal(KEY, idx, n),
                       rng.counter_normal(k, shape))
    assert torch.equal(keytree.counter_keep(KEY, idx, 0.9),
                       rng.counter_bernoulli(k, 0.9, shape))
    for lo, hi in ((0, 1000), (-2**31, 2**31 - 1)):
        got = keytree.randint32(KEY, torch.arange(11), lo, hi)
        assert torch.equal(got, rng.randint(k, (11,), lo, hi).long())
    rows = [0, 2]
    assert torch.equal(keytree.normal(KEY, keytree.rows_index(shape, rows,
                                                              "cpu")),
                       rng.normal(k, shape)[rows])


def test_attention_hash_is_the_kernels():
    from tinydiffusionmodels_torch.ops import reference

    bh = torch.arange(6)[:, None, None]
    q = torch.arange(9)[:, None]
    kp = torch.arange(9)[None, :]
    for seed in (5, -123456789):
        assert torch.equal(keytree.attention_keep_scale(seed, bh, q, kp, 0.1),
                           reference.dropout_scale(seed, bh, q, kp, 0.1))


@pytest.fixture
def fast_noise(monkeypatch):
    monkeypatch.setenv("TDM_FAST_NOISE", "1")


def test_text_training_losses_are_the_programs(fast_noise):
    from torch import nn

    from tinydiffusionmodels_torch.core import make_schedule, rng
    from tinydiffusionmodels_torch.models import (
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
    )
    from tinydiffusionmodels_torch.train import text_train

    d, heads, depth, ffn, vocab = 32, 4, 2, 48, 64
    params = weights.draw(
        weights.transformer(d, depth, ffn, "diffusion_model.")
        + weights.rounding(d, vocab, "rounding_fn.")
        + [("table", (vocab, d), ("normal", 1.0))],
        torch.Generator().manual_seed(4), "cpu")
    cfg = TransformerConfig(dim=d, n_heads=heads, depth=depth, dropout=0.1,
                            ffn_dim=ffn, timesteps=20)
    joint = nn.ModuleDict({"diffusion_model": TinyTransformer(cfg),
                           "rounding_fn": LearnedRounding(d, vocab)})
    joint.load_state_dict({k: v for k, v in params.items() if k != "table"})
    tokens = torch.randint(vocab, (3, 8), generator=torch.Generator()
                           .manual_seed(5))
    step_key = rng.fold_in(_program_key(), 4)
    t, noise, seeds, dkey = text_train.step_draws(joint, tokens, 20,
                                                  step_key)
    got = text_train._losses(
        joint, tokens, t, noise, 1.0, sched=make_schedule(20),
        use_learned_embeddings=False, pretrained_matrix=params["table"],
        deterministic=False, key=dkey, attn_seeds=seeds)
    den = {k[len("diffusion_model."):]: v for k, v in params.items()
           if k.startswith("diffusion_model.")}
    rnd = {k[len("rounding_fn."):]: v for k, v in params.items()
           if k.startswith("rounding_fn.")}
    from gpubench.reference.diffusion import Schedule

    want = ref_text.train_losses(
        den, rnd, params["table"], tokens, keytree.fold_in(KEY, 4),
        sched=Schedule(20, "cpu"), heads=heads, depth=depth, rate=0.1,
        rounding_weight=1.0)
    total, (diff, round_) = got
    for a, b in zip((diff, round_, total), want):
        assert float(a.detach()) == pytest.approx(float(b.detach()), rel=1e-6)


def test_text_denoiser_and_unet_are_the_programs():
    from tinydiffusionmodels_torch.models import (
        SimpleUNet,
        TinyTransformer,
        TransformerConfig,
    )

    d, heads, depth, ffn = 32, 4, 2, 48
    p = weights.draw(weights.transformer(d, depth, ffn),
                     torch.Generator().manual_seed(6), "cpu")
    model = TinyTransformer(TransformerConfig(dim=d, n_heads=heads,
                                              depth=depth, ffn_dim=ffn,
                                              timesteps=50))
    model.load_state_dict(p)
    x, t = torch.randn(3, 8, d), torch.tensor([0, 17, 49])
    with torch.no_grad():
        torch.testing.assert_close(
            ref_text.denoise(p, x, t, heads=heads, depth=depth,
                             timesteps=50),
            model(x, t), rtol=1e-5, atol=1e-5)
    u = weights.draw(weights.unet(ref_unet.BLOCKS),
                     torch.Generator().manual_seed(7), "cpu")
    unet = SimpleUNet(50)
    unet.load_state_dict(u)
    img = torch.randn(2, 28, 28, 1)
    with torch.no_grad():
        torch.testing.assert_close(
            ref_unet.denoise(u, img, t[:2], timesteps=50), unet(img, t[:2]),
            rtol=1e-5, atol=1e-5)


def test_adamw_is_torchs():
    g = torch.Generator().manual_seed(8)
    p = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
    mine = {k: v.clone() for k, v in p.items()}
    theirs = [v.clone().requires_grad_() for v in p.values()]
    ours = AdamW(mine, 1e-2, 0.01)
    opt = torch.optim.AdamW(theirs, lr=1e-2, weight_decay=0.01)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        ours.step(grads)
        for t, gr in zip(theirs, grads.values()):
            t.grad = gr.clone()
        opt.step()
    for a, b in zip(mine.values(), theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)


_LOADED = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", _LOADED.format(repo=str(tiny.REPO), body=body)],
        capture_output=True, text=True, check=True, timeout=600,
        env={**os.environ, "TDM_FAST_NOISE": "1"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


BANNED = {"jax", "jaxlib", "flax", "tinydiffusionmodels_tpu"}


def test_the_reference_loads_no_program_and_no_jax():
    loaded = _modules("import gpubench.reference.text, "
                      "gpubench.reference.unet, gpubench.reference.adamw, "
                      "gpubench.reference.diffusion")
    assert not loaded & (BANNED | {"tinydiffusionmodels_torch"})


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make_root(tmp_path)
    body = f"""
import time, torch
from gpubench import harness
for cell in ("textdiff_d2048.train_bs32", "textdiff_d2048.sample_n10",
             "mnist_unet.train_bs128", "mnist_unet.sample_n256"):
    harness.run_cell({str(root)!r}, cell, seed=3, seconds=0.1, trace=True,
                     device=torch.device("cpu"), start=time.perf_counter())
"""
    loaded = _modules(body)
    assert "tinydiffusionmodels_torch" in loaded
    assert not loaded & BANNED
