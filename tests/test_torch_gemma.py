"""The port's Gemma base LM (``tinydiffusionmodels_torch.models.gemma``)
against the JAX package's ``models/gemma.py`` and HF's
``GemmaForCausalLM``, on the CPU.

A tiny Gemma (vocab 97, hidden 64, 2 layers, 4 heads of 16) with 2 KV heads
(GQA) and 1 (MQA) is a seeded random HF ``GemmaForCausalLM`` built from a
config in code; its norm weights are drawn too, so the ``(1 + w)`` scale is
exercised. The same numpy weights go into all three.

- forward and the stepped ``decode_step`` against JAX ``gemma_apply`` and
  ``gemma_decode_step``: logits atol = rtol = 1e-4;
- forward against HF's logits: 2e-4 (the JAX test's limit);
- the cached decode against the full forward: 5e-4;
- ``io.convert.gemma_state_from_jax`` and the HF state dict build
  bit-equal modules;
- ``GuidedDecoder(gemma, draft="plain")`` (CPU eager) gives the tokens of
  JAX ``guided_generate_scan(gemma_decode_step)`` on the same N(0, 1)
  logits, raw and normalised mixing; the port's ``_guided_with_torch_lm``
  gives the JAX one's texts; the bf16 and fused drafts refuse a Gemma.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
jnp = jax.numpy

from tinydiffusionmodels_tpu.models import gemma as jax_gemma  # noqa: E402
from tinydiffusionmodels_tpu.sample import guided as jax_guided  # noqa: E402
from tinydiffusionmodels_torch.io import gemma_state_from_jax  # noqa: E402
from tinydiffusionmodels_torch.models.gemma import (  # noqa: E402
    Gemma,
    GemmaConfig,
    gemma_from_hf,
    load_gemma_from_hf,
)
from tinydiffusionmodels_torch.sample import guided  # noqa: E402

torch.set_num_threads(1)

VOCAB, B, L, BOS, ALPHA = 97, 2, 10, 2, 0.3
MAX_LEN = 32


class Tok:
    """The tokenizer interface the guided loops read."""

    bos_token_id = BOS
    eos_token_id = 1

    def batch_decode(self, ids, skip_special_tokens=True):
        return [" ".join(map(str, row)) for row in np.asarray(ids)]


@pytest.fixture(scope="module", params=[2, 1], ids=["gqa", "mqa"])
def tiny(request):
    """(HF model, JAX params, JAX config, port Gemma) of one KV-head
    count."""
    from transformers import GemmaConfig as HFGemmaConfig
    from transformers import GemmaForCausalLM

    hf_cfg = HFGemmaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=request.param, head_dim=16,
        max_position_embeddings=64,
    )
    torch.manual_seed(0)
    hf = GemmaForCausalLM(hf_cfg).eval()
    with torch.no_grad():   # HF starts its norms at 0; draw them
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.normal_(0.0, 0.1)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    cfg = jax_gemma.GemmaConfig.from_hf(hf_cfg, max_len=MAX_LEN)
    params = jax_gemma.gemma_from_hf_state_dict(sd, cfg)
    return hf, params, cfg, gemma_from_hf(hf, max_len=MAX_LEN)


def _ids(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, VOCAB, (B, L))


def _port_decode(model, ids: np.ndarray) -> np.ndarray:
    cache = model.init_cache(ids.shape[0])
    out = []
    with torch.no_grad():
        for pos in range(ids.shape[1]):
            logits, cache = model.decode_step(cache,
                                              torch.from_numpy(ids[:, pos]))
            out.append(logits.numpy())
    assert cache["pos"] == ids.shape[1]
    return np.stack(out, axis=1)


def test_forward_matches_jax(tiny):
    _, params, cfg, model = tiny
    ids = _ids()
    want = jax_gemma.gemma_apply(params, jnp.asarray(ids), cfg)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_decode_step_matches_jax(tiny):
    _, params, cfg, model = tiny
    ids = _ids(1)
    cache = jax_gemma.gemma_init_cache(cfg, B)
    want = []
    for pos in range(L):
        logits, cache = jax_gemma.gemma_decode_step(
            params, cache, jnp.asarray(ids[:, pos]), cfg)
        want.append(np.asarray(logits))
    np.testing.assert_allclose(_port_decode(model, ids), np.stack(want, 1),
                               rtol=1e-4, atol=1e-4)


def test_forward_matches_hf(tiny):
    hf, _, _, model = tiny
    ids = torch.from_numpy(_ids(2))
    with torch.no_grad():
        want = hf(ids).logits
        got = model(ids)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_cached_decode_matches_forward(tiny):
    _, _, _, model = tiny
    ids = _ids(3)
    with torch.no_grad():
        full = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(_port_decode(model, ids), full, rtol=5e-4,
                               atol=5e-4)


def test_state_from_jax_builds_the_hf_module(tiny):
    """``gemma_state_from_jax`` of the JAX tree and the HF state dict give
    bit-equal modules (no ``lm_head.weight``: the head is tied)."""
    _, params, cfg, model = tiny
    from_jax = Gemma(GemmaConfig.from_hf(
        transformers.GemmaConfig(**_hf_kwargs(cfg)), max_len=MAX_LEN))
    from_jax.load_state_dict(gemma_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    want, got = model.state_dict(), from_jax.state_dict()
    assert list(got) == list(want) and "lm_head.weight" not in got
    for name in want:
        assert torch.equal(got[name], want[name]), name


def _hf_kwargs(cfg) -> dict:
    return dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                intermediate_size=cfg.intermediate_size,
                num_hidden_layers=cfg.num_layers,
                num_attention_heads=cfg.num_heads,
                num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)


def test_causal_forward_ignores_later_tokens(tiny):
    _, _, _, model = tiny
    ids = torch.from_numpy(_ids(4))
    later = ids.clone()
    later[:, -1] = (later[:, -1] + 1) % VOCAB
    with torch.no_grad():
        a, b = model(ids), model(later)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=0)


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "norm"])
def test_guided_decoder_matches_jax_scan(tiny, normalize):
    """``GuidedDecoder(gemma, draft="plain")`` on the CPU against JAX
    ``guided_generate_scan`` of ``gemma_decode_step``: equal tokens, on
    two calls of one decoder."""
    _, params, cfg, model = tiny
    decoder = guided.GuidedDecoder(model, B, L, BOS, alpha=ALPHA,
                                   normalize=normalize)
    for seed in (3, 4):
        diff = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                          (B, L, VOCAB)))
        want = jax_guided.guided_generate_scan(
            lambda cache, tok: jax_gemma.gemma_decode_step(params, cache,
                                                           tok, cfg),
            jax_gemma.gemma_init_cache(cfg, B), jnp.asarray(diff), BOS,
            alpha=ALPHA, normalize=normalize)
        got = decoder(torch.from_numpy(diff))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        eager = guided.guided_generate_scan(
            model.decode_step, model.init_cache(B), torch.from_numpy(diff),
            BOS, alpha=ALPHA, normalize=normalize)
        torch.testing.assert_close(eager, got, rtol=0, atol=0)


def test_torch_loop_matches_jax_cli(tiny):
    """The port's ``_guided_with_torch_lm`` (the CLI's loop for an HF LM
    that is not a Gemma) gives the JAX CLI's texts on the same HF model
    and logits, and its tokens are the Gemma decode's."""
    from tinydiffusionmodels_tpu.shakespeare import (
        _guided_with_torch_lm as jax_loop,
    )
    from tinydiffusionmodels_torch.shakespeare import _guided_with_torch_lm

    hf, _, _, model = tiny
    diff = np.array(jax.random.normal(jax.random.PRNGKey(5), (B, 6, VOCAB)))
    texts = _guided_with_torch_lm(hf, Tok(), diff, alpha=ALPHA,
                                  temperature=0.7)
    assert texts == jax_loop(hf, Tok(), diff, alpha=ALPHA, temperature=0.7)
    texts, tokens = _guided_with_torch_lm(
        hf, Tok(), torch.from_numpy(diff), alpha=ALPHA, return_tokens=True)
    assert texts == Tok().batch_decode(tokens.numpy())
    decoded = guided.GuidedDecoder(model, B, 6, BOS, alpha=ALPHA)(
        torch.from_numpy(diff))
    torch.testing.assert_close(decoded.long(), tokens, rtol=0, atol=0)


@pytest.mark.parametrize("draft", ["scan_bf16", "fused"])
def test_bf16_and_fused_drafts_refuse_gemma(tiny, draft):
    _, _, _, model = tiny
    with pytest.raises(ValueError, match="Gemma"):
        guided.GuidedDecoder(model, B, L, BOS, draft=draft)
    with pytest.raises(ValueError, match="Gemma"):
        guided.guided_generate_verified(model, torch.zeros(B, L, VOCAB), BOS,
                                        draft=draft)


def test_gemma_from_hf_refuses_other_models():
    from transformers import LlamaConfig, LlamaForCausalLM

    llama = LlamaForCausalLM(LlamaConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2))
    with pytest.raises(ValueError, match="not a Gemma-v1 checkpoint: llama"):
        gemma_from_hf(llama)


def test_untied_head_refused(tiny):
    hf, _, cfg, _ = tiny
    sd = dict(hf.state_dict())
    sd["lm_head.weight"] = sd["lm_head.weight"] + 1.0
    model = Gemma(GemmaConfig.from_hf(hf.config, max_len=MAX_LEN))
    with pytest.raises(ValueError, match="ties its head"):
        model.load_hf_state_dict(sd)


def test_decode_past_max_len_refused(tiny):
    _, _, _, model = tiny
    cache = dict(model.init_cache(1), pos=MAX_LEN)
    with pytest.raises(ValueError, match="past the attention window"):
        model.decode_step(cache, torch.zeros(1, dtype=torch.long))


def test_load_gemma_from_hf(tiny, monkeypatch):
    """``load_gemma_from_hf`` reads the config, then the checkpoint, both
    with ``local_files_only``, into the module ``gemma_from_hf`` builds."""
    hf, _, _, model = tiny
    calls = []

    def loader(what):
        def from_pretrained(model_id, **kw):
            calls.append((what, model_id, kw))
            return hf.config if what == "config" else hf
        return from_pretrained

    monkeypatch.setattr(transformers.AutoConfig, "from_pretrained",
                        loader("config"))
    monkeypatch.setattr(transformers.AutoModelForCausalLM, "from_pretrained",
                        loader("model"))
    loaded = load_gemma_from_hf("tiny-gemma", max_len=MAX_LEN,
                                local_files_only=False)
    assert calls == [("config", "tiny-gemma", {"local_files_only": False}),
                     ("model", "tiny-gemma", {"local_files_only": False})]
    assert loaded.cfg == model.cfg
    ids = torch.from_numpy(_ids())
    with torch.no_grad():
        torch.testing.assert_close(loaded(ids), model(ids), rtol=0, atol=0)


def test_load_gemma_from_hf_refuses_other_models(monkeypatch):
    """A checkpoint that is not a Gemma is refused from its config, before
    its weights load."""
    from transformers import LlamaConfig

    monkeypatch.setattr(transformers.AutoConfig, "from_pretrained",
                        lambda model_id, **kw: LlamaConfig())

    def no_weights(*args, **kw):
        raise AssertionError("weights loaded")

    monkeypatch.setattr(transformers.AutoModelForCausalLM, "from_pretrained",
                        no_weights)
    with pytest.raises(ValueError, match="not a Gemma-v1 checkpoint: llama"):
        load_gemma_from_hf("tiny-llama")


@pytest.mark.parametrize("fields, theta", [
    ({"rope_theta": 500000.0}, 500000.0),
    ({"rope_parameters": {"rope_type": "default", "rope_theta": 250000.0}},
     250000.0),
    ({}, 10000.0),
], ids=["rope_theta", "rope_parameters", "default"])
def test_config_reads_rope_theta(fields, theta):
    """``GemmaConfig.from_hf`` takes theta from ``rope_parameters`` (how
    transformers 5 keeps it) or ``rope_theta`` (4.x), else Gemma's 10000."""
    from types import SimpleNamespace

    hf_cfg = SimpleNamespace(
        vocab_size=VOCAB, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=16,
        intermediate_size=128, rms_norm_eps=1e-6, **fields)
    assert GemmaConfig.from_hf(hf_cfg).rope_theta == theta
