"""Guided AR + diffusion decoding of the torch package against the JAX
package, on the CPU.

Same TinyGPT weights (the JAX init, carried over by ``io.convert``) and the
same numpy diffusion logits go through both packages.

- ``mix_logits``: 1e-6 (absolute and relative), both modes.
- ``guided_generate_scan`` (the f32 KV-cached decode): tokens equal JAX's
  exactly.
- The guided-decode kernel's plain version (``ops.decode_kernel`` on CPU
  tensors) against JAX's ``fused_guided_decode`` run as the JAX tests run it
  on the CPU (Pallas interpret mode): both are bf16 drafts, so they are
  held to ``tests/test_fused_decode.py``'s rule (rows agree until a first
  divergence, mean first divergence past L/2), and any first divergence
  must be a near-tie of the port's scores (``TIE_RTOL`` of the best score).
- ``guided_generate_verified`` with every draft: tokens equal JAX's
  verified output exactly, and the output is the greedy fixpoint of the f32
  full-context forward.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.models import (  # noqa: E402
    init_tiny_gpt,
    tiny_gpt_decode_step,
    tiny_gpt_init_cache,
)
from tinydiffusionmodels_tpu.models.ar_lm import (  # noqa: E402
    TinyGPTConfig as JaxGPTConfig,
)
from tinydiffusionmodels_tpu.ops import decode_kernel as jax_dk  # noqa: E402
from tinydiffusionmodels_tpu.sample import guided as jax_guided  # noqa: E402
from tinydiffusionmodels_torch.data import CharTokenizer  # noqa: E402
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import (  # noqa: E402
    LearnedRounding,
    TinyGPT,
    TinyGPTConfig,
)
from tinydiffusionmodels_torch.ops import _build  # noqa: E402
from tinydiffusionmodels_torch.ops import decode_kernel as dk  # noqa: E402
from tinydiffusionmodels_torch.ops import reference  # noqa: E402
from tinydiffusionmodels_torch.sample import guided  # noqa: E402
from tinydiffusionmodels_torch.sample.text import guided_sample_text  # noqa: E402
from tinydiffusionmodels_torch.core.rng import prng_key, substream  # noqa: E402

torch.set_num_threads(1)

CFG_KW = dict(vocab_size=97, dim=64, n_heads=4, depth=2, max_len=24)
JCFG = JaxGPTConfig(**CFG_KW)
B, L, BOS, ALPHA = 4, 16, 1, 0.3
TIE_RTOL = 1e-2


@pytest.fixture(scope="module")
def params():
    return init_tiny_gpt(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(params):
    m = TinyGPT(TinyGPTConfig(**CFG_KW))
    m.load_state_dict(convert.tiny_gpt_state_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return m.eval()


def _diff(seed, b=B):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, L, CFG_KW["vocab_size"])).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
def test_mix_logits_matches_jax(normalize):
    rng = np.random.default_rng(0)
    a, d = (3 * rng.standard_normal((B, 97)).astype(np.float32)
            for _ in range(2))
    want = jax_guided.mix_logits(jnp.asarray(a), jnp.asarray(d), 0.3, 0.7,
                                 normalize=normalize)
    got = guided.mix_logits(torch.from_numpy(a), torch.from_numpy(d), 0.3,
                            0.7, normalize=normalize)
    # 1e-6, relative as well: the normalized mix is a log-probability of
    # size ~10, where one float32 step is ~1e-6.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seg", [1, 5])
def test_scan_segments_change_no_result(model, seg):
    """The port's decode step attends to the filled prefix whatever
    ``attn_len`` says, so segmenting the scan leaves the tokens as they
    are."""
    diff = torch.from_numpy(_diff(4))
    want = guided.guided_generate_scan(model.decode_step, model.init_cache(B),
                                       diff, BOS, alpha=ALPHA)
    got = guided.guided_generate_scan(model.decode_step, model.init_cache(B),
                                      diff, BOS, alpha=ALPHA, seg=seg)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("seg", [None, 8])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scan_matches_jax(params, model, seed, seg):
    diff = _diff(seed)
    want = jax_guided.guided_generate_scan(
        lambda c, t, a=None: tiny_gpt_decode_step(params, c, t, JCFG, a),
        tiny_gpt_init_cache(JCFG, B), jnp.asarray(diff), BOS, alpha=ALPHA,
        seg=seg)
    got = guided.guided_generate_scan(
        model.decode_step, model.init_cache(B), torch.from_numpy(diff), BOS,
        alpha=ALPHA, seg=seg)
    assert got.dtype == torch.int32 and got.shape == (B, L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("normalize, temperature", [(False, 1.0),
                                                    (True, 1.0),
                                                    (False, 0.7)])
def test_plain_decode_matches_jax_kernel(params, model, normalize,
                                         temperature):
    """The kernel's plain version against the Pallas kernel (interpret mode
    on the CPU): both bf16 drafts of the same decode."""
    diff = _diff(5)
    kw = dict(alpha=ALPHA, temperature=temperature, normalize=normalize)
    want = np.asarray(jax_dk.fused_guided_decode(params, JCFG,
                                                 jnp.asarray(diff), BOS, **kw))
    before = dk.launches
    got = dk.fused_guided_decode(model, torch.from_numpy(diff), BOS, **kw)
    assert dk.launches == before and _build._lib is None
    assert got.dtype == torch.int32 and got.shape == (B, L)
    _, scores = reference.fused_guided_decode(
        dk.pack_weights(model), torch.from_numpy(diff), BOS,
        return_scores=True, forced_tokens=torch.from_numpy(want.copy()), **kw)
    firsts = []
    for row in range(B):
        differ = np.flatnonzero(got.numpy()[row] != want[row])
        firsts.append(differ[0] if differ.size else L)
        if differ.size:
            s = scores[row, differ[0]]
            gap = float(s.max() - s[int(want[row, differ[0]])])
            assert gap <= TIE_RTOL * float(s.max().abs()), (row, gap)
    assert np.mean(firsts) > L // 2


def test_plain_decode_packs_bf16_weights(model):
    w = dk.pack_weights(model)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for t in w.tensors())
    d, v = CFG_KW["dim"], CFG_KW["vocab_size"]
    assert w.qkv_w.shape == (2, d, 3 * d) and w.head.shape == (d, v)
    torch.testing.assert_close(
        w.qkv_w[1].float(),
        model.blocks[1].attn["qkv"].weight.T.bfloat16().float())


def test_forced_tokens_reproduce_own_decode(model):
    """Teacher-forcing the plain version on its own tokens gives back the
    same tokens and scores."""
    w = dk.pack_weights(model)
    diff = torch.from_numpy(_diff(6))
    toks, scores = reference.fused_guided_decode(w, diff, BOS,
                                                 return_scores=True)
    again, forced = reference.fused_guided_decode(
        w, diff, BOS, return_scores=True, forced_tokens=toks)
    torch.testing.assert_close(again, toks, rtol=0, atol=0)
    torch.testing.assert_close(forced, scores, rtol=0, atol=0)
    assert torch.equal(scores.argmax(-1).int(), toks)


def _fixpoint(model, tokens, diff, **kw):
    ids = torch.cat([torch.full((tokens.shape[0], 1), BOS),
                     tokens[:, :-1].long()], dim=1)
    with torch.no_grad():
        mixed = guided.mix_logits(model(ids), diff, ALPHA, **kw)
    return torch.argmax(mixed, -1).to(torch.int32)


@pytest.mark.parametrize("draft", ["auto", "fused", "scan_bf16", "plain"])
@pytest.mark.parametrize("normalize", [False, True])
def test_verified_matches_jax(params, model, draft, normalize):
    diff = _diff(7)
    # The port's auto is the plain scan at every batch (AUTO_DRAFT).
    jax_draft = "plain" if draft == "auto" else draft
    want = np.asarray(jax_guided.guided_generate_verified(
        params, JCFG, jnp.asarray(diff), BOS, alpha=ALPHA,
        normalize=normalize, draft=jax_draft))
    got, rounds = guided.guided_generate_verified(
        model, torch.from_numpy(diff), BOS, alpha=ALPHA, normalize=normalize,
        draft=draft, return_rounds=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _fixpoint(model, got, torch.from_numpy(diff),
                  normalize=normalize).numpy(), got.numpy())
    assert (rounds == 0) if jax_draft == "plain" else (1 <= rounds <= L + 1)


def test_packed_weights_decode_as_the_model(model):
    """``DecodeWeights`` packed once give the tokens the model gives, in the
    decode and in the verified decode's fused draft."""
    w = dk.pack_weights(model)
    diff = torch.from_numpy(_diff(9))
    torch.testing.assert_close(
        dk.fused_guided_decode(w, diff, BOS, alpha=ALPHA),
        dk.fused_guided_decode(model, diff, BOS, alpha=ALPHA), rtol=0, atol=0)
    got = guided.guided_generate_verified(model, diff, BOS, alpha=ALPHA,
                                          draft="fused", weights=w,
                                          return_rounds=True)
    want = guided.guided_generate_verified(model, diff, BOS, alpha=ALPHA,
                                           draft="fused", return_rounds=True)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert got[1] == want[1]


def test_auto_draft_is_the_kernel(model, monkeypatch):
    """No batch rule: ``auto`` is the plain f32 scan at any batch, the
    bench's 8 and 256 among them (replayed on the card, the scan was ahead
    of the guided-decode kernel's draft with its Jacobi rounds at both),
    in the eager function and in ``GuidedDecoder``; the kernel is not
    called."""
    calls = []
    real = guided.guided_generate_scan

    def spy(*a, **k):
        calls.append(a[2].shape[0])
        return real(*a, **k)

    def kernel(*a, **k):
        raise AssertionError("auto called the decode kernel")

    monkeypatch.setattr(guided, "guided_generate_scan", spy)
    monkeypatch.setattr(guided, "fused_guided_decode", kernel)
    for b in (2, 8, 70, 256):
        diff = torch.from_numpy(_diff(8, b))
        got = guided.guided_generate_verified(model, diff, BOS, alpha=ALPHA)
        decoder = guided.GuidedDecoder(model, b, L, BOS, alpha=ALPHA,
                                       draft="auto")
        assert decoder.draft == guided.AUTO_DRAFT == "plain"
        torch.testing.assert_close(decoder(diff), got, rtol=0, atol=0)
    assert calls == [2, 8, 70, 256]
    with pytest.raises(ValueError, match="unknown draft"):
        guided.guided_generate_verified(model, torch.from_numpy(_diff(8)),
                                        BOS, draft="spec")


def test_decode_checks_shapes_and_devices(model):
    w = dk.pack_weights(model)
    with pytest.raises(NotImplementedError, match="no path for meta"):
        dk.fused_guided_decode(w, torch.empty(1, 4, 97, device="meta"), BOS)
    # The card-side checks run before any build or launch.
    with pytest.raises(ValueError, match="vocab 50"):
        dk._check(w, torch.zeros(1, 4, 50), BOS)
    with pytest.raises(ValueError, match="outside 1..max_len=24"):
        dk._check(w, torch.zeros(1, 25, 97), BOS)
    assert _build._lib is None


def test_guided_sample_text_writes_samples(tmp_path, monkeypatch, model):
    monkeypatch.chdir(tmp_path)
    tok = CharTokenizer("abcdefghij klmnopqrstuvwxyz.,;:!?'\n" * 2)
    gen = torch.Generator().manual_seed(0)
    lm = TinyGPT(TinyGPTConfig(vocab_size=tok.vocab_size, dim=32, n_heads=2,
                               depth=1, max_len=12),
                 key=substream(prng_key(0), "lm_init")).eval()
    rounding = LearnedRounding(
        16, tok.vocab_size, key=substream(prng_key(0), "rounding"))
    z = torch.randn(3, 10, 16, generator=gen)
    texts, tokens = guided_sample_text(
        lm.decode_step, lm.init_cache(3), z, tok, rounding=rounding,
        alpha=0.5, return_tokens=True, log_fn=lambda s: None)
    assert len(texts) == 3 and tokens.shape == (3, 10)
    with torch.no_grad():
        diff = rounding(z)
    want = guided.guided_generate_scan(lm.decode_step, lm.init_cache(3), diff,
                                       tok.bos_token_id or tok.eos_token_id
                                       or 0, alpha=0.5)
    torch.testing.assert_close(tokens, want, rtol=0, atol=0)
    for i in range(3):
        assert (tmp_path / "samples" / f"guided_sample_{i}.txt").read_text() \
            == texts[i]
