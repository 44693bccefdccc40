"""Text models of the torch package against the JAX package.

Same weights (the JAX package's init, carried over by ``io.convert``) and the
same numpy inputs go through both packages on the CPU. The port's attention
runs its plain PyTorch version here. Tolerances: state dicts exact; model
outputs f32 ``atol = 1e-5`` (different matmul summation orders).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.io import checkpoint as jax_ckpt  # noqa: E402
from tinydiffusionmodels_tpu.models import (  # noqa: E402
    embedding as jax_emb,
    init_learned_embedding,
    init_learned_rounding,
    init_tiny_transformer,
    tiny_transformer_apply,
)
from tinydiffusionmodels_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JaxConfig,
)
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import (  # noqa: E402
    LearnedEmbedding,
    LearnedRounding,
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.models import embedding as port_emb  # noqa: E402
from tinydiffusionmodels_torch.core.rng import prng_key  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
DIM, DEPTH, FFN, VOCAB = 32, 2, 64, 19


def _configs(pos_emb="none", self_cond=False):
    kw = dict(dim=DIM, n_heads=4, depth=DEPTH, ffn_dim=FFN,
              pos_emb=pos_emb, self_cond=self_cond, max_len=64)
    return JaxConfig(**kw), TransformerConfig(**kw)


def _jax_params(jcfg, seed=0):
    p = init_tiny_transformer(jax.random.PRNGKey(seed), jcfg)
    if jcfg.self_cond:
        # The init is zero (a no-op); give the channel real weights.
        p["selfcond_proj"]["w"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 1), (DIM, DIM)
        )
        p["selfcond_proj"]["b"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(seed + 2), (DIM,)
        )
    return p


def _port_model(tcfg, params):
    model = TinyTransformer(tcfg)
    model.load_state_dict(convert.transformer_state_from_jax(params),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("pos_emb, self_cond", [
    ("none", False), ("abs", False), ("rope", False), ("none", True),
])
def test_state_from_jax_equals_checkpoint_map(pos_emb, self_cond):
    jcfg, tcfg = _configs(pos_emb, self_cond)
    params = _jax_params(jcfg)
    ref = jax_ckpt.transformer_to_state_dict(params)
    port = convert.transformer_state_from_jax(params)
    assert list(port) == list(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(port[key].numpy(), val, err_msg=key)
    model = TinyTransformer(tcfg)
    model.load_state_dict(port, strict=True)
    assert set(model.state_dict()) == set(ref)


@pytest.mark.parametrize("pos_emb, self_cond", [
    ("none", False), ("abs", False), ("rope", False), ("none", True),
    ("rope", True),
])
def test_transformer_matches_jax(pos_emb, self_cond):
    jcfg, tcfg = _configs(pos_emb, self_cond)
    params = _jax_params(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 12, DIM), dtype=np.float32)
    t = np.array([0, 417, 999], dtype=np.int32)
    x0 = rng.standard_normal((3, 12, DIM), dtype=np.float32)
    x0_prev = x0 if self_cond else None
    ref = tiny_transformer_apply(
        params, jnp.asarray(x), jnp.asarray(t), jcfg,
        x0_prev=None if x0_prev is None else jnp.asarray(x0_prev),
    )
    with torch.no_grad():
        out = _port_model(tcfg, params)(
            torch.from_numpy(x), torch.from_numpy(t).long(),
            x0_prev=None if x0_prev is None else torch.from_numpy(x0_prev),
        )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_self_cond_without_estimate_matches_jax():
    jcfg, tcfg = _configs("none", True)
    params = _jax_params(jcfg)
    x = np.random.default_rng(2).standard_normal((2, 8, DIM), dtype=np.float32)
    t = np.array([3, 900], dtype=np.int32)
    ref = tiny_transformer_apply(params, jnp.asarray(x), jnp.asarray(t), jcfg)
    with torch.no_grad():
        out = _port_model(tcfg, params)(
            torch.from_numpy(x), torch.from_numpy(t).long()
        )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_transformer_rejects_training_dropout():
    """Training mode draws every dropout mask from an explicit key, so it
    is refused without one."""
    _, tcfg = _configs()
    model = TinyTransformer(tcfg)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        model(torch.zeros(1, 4, DIM), torch.zeros(1, dtype=torch.long),
              deterministic=False)


def test_seeded_init_is_reproducible():
    _, tcfg = _configs("abs", True)
    a = TinyTransformer(tcfg, key=prng_key(3))
    b = TinyTransformer(tcfg, key=prng_key(3))
    c = TinyTransformer(tcfg, key=prng_key(4))
    for key, val in a.state_dict().items():
        torch.testing.assert_close(val, b.state_dict()[key], rtol=0, atol=0)
    w = "encoder.layers.0.linear1.weight"
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    bound = 1.0 / np.sqrt(DIM)
    assert float(a.state_dict()[w].abs().max()) <= bound


def test_rounding_matches_jax():
    params = init_learned_rounding(jax.random.PRNGKey(3), DIM, VOCAB)
    sd = convert.rounding_state_from_jax(params)
    ref_sd = jax_ckpt.rounding_to_state_dict(params)
    for key, val in ref_sd.items():
        np.testing.assert_array_equal(sd[key].numpy(), val)
    rounding = LearnedRounding(DIM, VOCAB)
    rounding.load_state_dict(sd, strict=True)
    x = np.random.default_rng(4).standard_normal((2, 6, DIM), dtype=np.float32)
    ref = jax_emb.rounding_apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = port_emb.rounding_apply(rounding, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("norm", ["none", "rms", "zscore"])
def test_embedding_norms_match_jax(norm):
    params = init_learned_embedding(jax.random.PRNGKey(5), VOCAB, DIM)
    sd = convert.embedding_state_from_jax(params)
    np.testing.assert_array_equal(
        sd["embeddings.weight"].numpy(),
        jax_ckpt.embedding_to_state_dict(params)["embeddings.weight"],
    )
    emb = LearnedEmbedding(VOCAB, DIM)
    emb.load_state_dict(sd, strict=True)
    with torch.no_grad():
        table = port_emb.embedding_matrix(emb.embeddings.weight,
                                          norm=norm).detach()
    np.testing.assert_allclose(
        table.numpy(),
        np.asarray(jax_emb.embedding_matrix(params, norm=norm)),
        rtol=0, atol=ATOL,
    )


def test_pretrained_projection_quirk_shapes():
    pre = np.random.default_rng(6).standard_normal((VOCAB, 48)).astype(np.float32)
    same = LearnedEmbedding(VOCAB, 48, pretrained=pre)
    np.testing.assert_array_equal(same.embeddings.weight.detach().numpy(), pre)
    projected = LearnedEmbedding(VOCAB, DIM, pretrained=pre)
    assert projected.embeddings.weight.shape == (VOCAB, DIM)


def test_cosine_logits_match_jax():
    rng = np.random.default_rng(7)
    table = rng.standard_normal((VOCAB, DIM), dtype=np.float32)
    x = rng.standard_normal((2, 5, DIM), dtype=np.float32)
    ref = jax_emb.cosine_logits(jnp.asarray(table), jnp.asarray(x))
    out = port_emb.cosine_logits(torch.from_numpy(table), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("pos_emb, self_cond", [
    ("none", False), ("abs", True), ("rope", False),
])
def test_config_from_state_dict(pos_emb, self_cond):
    jcfg, _ = _configs(pos_emb, self_cond)
    sd = jax_ckpt.transformer_to_state_dict(_jax_params(jcfg))
    base = TransformerConfig(dim=256, depth=3, pos_emb=pos_emb)
    cfg = convert.config_from_state_dict(sd, base)
    assert (cfg.dim, cfg.depth, cfg.ffn_dim) == (DIM, DEPTH, FFN)
    assert cfg.self_cond is self_cond
    assert cfg.pos_kind == pos_emb
    assert cfg.max_len == (64 if pos_emb == "abs" else base.max_len)


def test_text_checkpoint_dict_matches_jax_layout():
    from tinydiffusionmodels_tpu.data.tokenizer import CharTokenizer
    from tinydiffusionmodels_tpu.train import text_train

    jcfg, tcfg = _configs("abs", True)
    joint = {
        "diffusion_model": _jax_params(jcfg),
        "rounding_fn": init_learned_rounding(jax.random.PRNGKey(8), DIM, VOCAB),
        "embedding_fn": init_learned_embedding(
            jax.random.PRNGKey(9), VOCAB, DIM
        ),
    }
    tok = CharTokenizer("to be or not")
    meta = dict(parameterization="x0", noise_schedule="sqrt",
                embed_norm="zscore")
    # The port reads self_cond and pos_emb off the model's config.
    ref = text_train._checkpoint_dict(
        joint, epoch=4, use_learned_embeddings=True,
        tokenizer_state=tok.state(), self_cond=True, pos_emb="abs", **meta,
    )
    rounding = LearnedRounding(DIM, VOCAB)
    rounding.load_state_dict(
        convert.rounding_state_from_jax(joint["rounding_fn"]))
    emb = LearnedEmbedding(VOCAB, DIM)
    emb.load_state_dict(convert.embedding_state_from_jax(joint["embedding_fn"]))
    port = convert.text_checkpoint_dict(
        _port_model(tcfg, joint["diffusion_model"]), rounding, emb,
        epoch=4, tokenizer_state=tok.state(), **meta,
    )
    assert set(port) == set(ref)
    for key, val in ref.items():
        if isinstance(val, dict):
            assert list(port[key]) == list(val), key
            for name, arr in val.items():
                np.testing.assert_array_equal(port[key][name], arr)
        else:
            assert port[key] == val, key
