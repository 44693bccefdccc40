"""``sample.guided.GuidedDecoder`` on the CPU: the guided decode of one
configuration, whose scans, fused draft and Jacobi rounds are CUDA graphs on
the card.

- On the CPU the decoder runs eagerly. Its tokens equal the eager loops'
  (``guided_generate_scan``, ``guided_generate_verified``) bit for bit, and
  its rounds equal ``return_rounds``, for each draft (``fused`` through the
  decode kernel's plain version) with ``normalize`` on and off.
- Its tokens equal the JAX package's ``guided_generate_scan`` /
  ``guided_generate_verified`` on the same weights exactly, the rule of
  ``tests/test_torch_guided.py``.
- One decoder called on new logits gives each its own result (no stale
  static buffer).
- A stand-in for torch's CUDA graph API (a capture runs the step's Python
  on snapshotted buffers and restores them, so it leaves nothing behind,
  as a capture launches nothing; a replay runs the step) drives the
  decoder's capture-and-replay path: each step primed once outside the
  capture, captured once, and replayed from the first call on.
- ``max_rounds``: "converged at round r" apart from "not converged".
"""

import contextlib
import types

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
from tinydiffusionmodels_tpu.sample import guided as jax_guided  # noqa: E402
from tinydiffusionmodels_torch import graphs  # noqa: E402
from tinydiffusionmodels_torch.data import CharTokenizer  # noqa: E402
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import (  # noqa: E402
    LearnedRounding,
    TinyGPT,
    TinyGPTConfig,
)
from tinydiffusionmodels_torch.sample import guided  # noqa: E402
from tinydiffusionmodels_torch.sample.text import guided_sample_text  # noqa: E402
from tinydiffusionmodels_torch.core.rng import prng_key, substream  # noqa: E402

torch.set_num_threads(1)

CFG_KW = dict(vocab_size=97, dim=32, n_heads=4, depth=2, max_len=18)
JCFG = JaxGPTConfig(**CFG_KW)
B, L, BOS, ALPHA = 3, 16, 1, 0.3
DRAFTS = ("plain", "scan_bf16", "fused")


@pytest.fixture(scope="module")
def params():
    return init_tiny_gpt(jax.random.PRNGKey(3), JCFG)


@pytest.fixture(scope="module")
def model(params):
    m = TinyGPT(TinyGPTConfig(**CFG_KW))
    m.load_state_dict(convert.tiny_gpt_state_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return m.eval()


def _diff(seed, b=B, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(
        (b, L, CFG_KW["vocab_size"]))).astype(np.float32)


def _eager(model, diff, draft, **kw):
    return guided.guided_generate_verified(
        model, torch.from_numpy(diff), BOS, alpha=ALPHA, draft=draft,
        return_rounds=True, **kw)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("draft", DRAFTS)
def test_decoder_equals_the_eager_loops(model, draft, normalize):
    decoder = guided.GuidedDecoder(model, B, L, BOS, alpha=ALPHA,
                                   normalize=normalize, draft=draft)
    diff = _diff(11)
    tokens, rounds = decoder(torch.from_numpy(diff), return_rounds=True)
    assert not decoder.draft_step.captured
    want, want_rounds = _eager(model, diff, draft, normalize=normalize)
    assert tokens.dtype == torch.int32 and tokens.shape == (B, L)
    torch.testing.assert_close(tokens, want, rtol=0, atol=0)
    assert rounds == want_rounds and decoder.converged
    assert (rounds == 0) if draft == "plain" else (rounds >= 1)
    if draft == "plain":
        scan = guided.guided_generate_scan(
            model.decode_step, model.init_cache(B), torch.from_numpy(diff),
            BOS, alpha=ALPHA, normalize=normalize)
        torch.testing.assert_close(tokens, scan, rtol=0, atol=0)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("draft", DRAFTS)
def test_decoder_matches_jax(params, model, draft, temperature):
    """The decoder's tokens equal the JAX package's scan (``plain``) and
    verified decode (the drafts) exactly."""
    diff = _diff(12)
    decoder = guided.GuidedDecoder(model, B, L, BOS, alpha=ALPHA,
                                   temperature=temperature, draft=draft)
    got = decoder(torch.from_numpy(diff)).numpy()
    if draft == "plain":
        want = jax_guided.guided_generate_scan(
            lambda c, t, a=None: tiny_gpt_decode_step(params, c, t, JCFG, a),
            tiny_gpt_init_cache(JCFG, B), jnp.asarray(diff), BOS,
            alpha=ALPHA, temperature=temperature)
    else:
        want = jax_guided.guided_generate_verified(
            params, JCFG, jnp.asarray(diff), BOS, alpha=ALPHA,
            temperature=temperature, draft=draft)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("draft", DRAFTS)
def test_repeated_calls_each_decode_their_own_logits(model, draft):
    """One decoder, three calls on two sets of logits: each call's result
    is that of a fresh eager decode of its own logits."""
    decoder = guided.GuidedDecoder(model, B, L, BOS, alpha=ALPHA,
                                   draft=draft)
    diffs = [_diff(20), _diff(21, scale=3.0), _diff(20)]
    results = [decoder(torch.from_numpy(d), return_rounds=True)
               for d in diffs]
    for (tokens, rounds), d in zip(results, diffs):
        want, want_rounds = _eager(model, d, draft)
        torch.testing.assert_close(tokens, want, rtol=0, atol=0)
        assert rounds == want_rounds
    assert not torch.equal(results[0][0], results[1][0])


class _ReplayingCuda:
    """Stand-ins for torch.cuda's graph API. A capture runs the step's
    Python on the CPU, then puts back the buffers in ``state`` as they were,
    so it leaves nothing behind (a capture launches nothing); a replay runs
    the captured step."""

    def __init__(self):
        self.capturing = False
        self.graphs = []
        self.state = []
        cuda = self

        class Graph:
            def __init__(self):
                self.replays, self.fn = 0, None
                cuda.graphs.append(self)

            def register_generator_state(self, gen):
                raise AssertionError("the decoder draws no random numbers")

            def capture_begin(self):
                cuda.capturing = True
                self.saved = [t.clone() for t in cuda.state]

            def capture_end(self):
                cuda.capturing = False
                for t, saved in zip(cuda.state, self.saved):
                    t.copy_(saved)

            def replay(self):
                self.replays += 1
                self.fn()

        def stream_(device=None):
            return types.SimpleNamespace(wait_stream=lambda other: None)

        self.CUDAGraph = Graph
        self.Stream = self.current_stream = stream_
        self.stream = lambda s: contextlib.nullcontext()


@pytest.fixture()
def replaying_cuda(monkeypatch):
    fake = _ReplayingCuda()
    for name in ("CUDAGraph", "Stream", "current_stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    capture = graphs.Step._capture

    def capture_and_keep_fn(self):
        capture(self)
        self.graph.fn = self.fn

    monkeypatch.setattr(graphs.Step, "_capture", capture_and_keep_fn)
    return fake


@pytest.mark.parametrize("draft", DRAFTS)
def test_decoder_captures_once_and_replays(model, replaying_cuda, draft):
    """The capture-and-replay path on the CPU: each step is primed once,
    outside the capture, then captured once; every call from the first
    replays the draft once and the round once a Jacobi round, and the
    results equal the eager decode's."""
    fake = replaying_cuda
    decoder = guided.GuidedDecoder(model, B, L, BOS, alpha=ALPHA,
                                   draft=draft)
    steps = (decoder.draft_step, decoder.round_step)
    primed = []
    for step in steps:
        step.eager = False      # as on the card
        prime = step.prime
        step.prime = lambda prime=prime: (
            primed.append(fake.capturing), prime())
    cache = getattr(decoder, "cache", None)
    fake.state = [decoder.diff, decoder.tokens, decoder.rounds,
                  decoder.changed] + ([cache["k"], cache["v"]] if cache
                                      else [])
    diffs = [_diff(30), _diff(31, scale=3.0), _diff(30)]
    total_rounds = 0
    for d in diffs:
        tokens, rounds = decoder(torch.from_numpy(d), return_rounds=True)
        want, want_rounds = _eager(model, d, draft)
        torch.testing.assert_close(tokens, want, rtol=0, atol=0)
        assert rounds == want_rounds
        total_rounds += rounds
    assert all(step.captured for step in steps[:1 + (draft != "plain")])
    assert primed == [False] * (1 + (draft != "plain"))
    replays = [g.replays for g in fake.graphs]
    assert replays == [3] + ([total_rounds] if draft != "plain" else [])


@pytest.mark.parametrize("draft", ["scan_bf16", "fused"])
def test_max_rounds_tells_converged_from_not(model, draft):
    """Stopped after ``max_rounds``: converged when the last round run
    changed nothing (the eager fixpoint, also when that is the last round
    allowed), not converged when it still changed tokens."""
    diff = _diff(44)        # four rounds with either draft
    want, rounds = _eager(model, diff, draft)
    assert rounds == 4
    decoder = guided.GuidedDecoder(model, B, L, BOS, alpha=ALPHA,
                                   draft=draft)
    for limit in (rounds, rounds + 3):
        tokens, ran = decoder(torch.from_numpy(diff), return_rounds=True,
                              max_rounds=limit)
        assert decoder.converged and ran == rounds
        torch.testing.assert_close(tokens, want, rtol=0, atol=0)
    tokens, ran = decoder(torch.from_numpy(diff), return_rounds=True,
                          max_rounds=rounds - 1)
    assert not decoder.converged and ran == rounds - 1


def test_decoder_checks_its_configuration(model):
    with pytest.raises(ValueError, match="unknown draft"):
        guided.GuidedDecoder(model, B, L, BOS, draft="spec")
    with pytest.raises(ValueError, match="1..18 positions"):
        guided.GuidedDecoder(model, B, 19, BOS)
    with pytest.raises(ValueError, match="outside the vocab"):
        guided.GuidedDecoder(model, B, L, 97)
    decoder = guided.GuidedDecoder(model, B, L, BOS)
    with pytest.raises(ValueError, match="serves"):
        decoder(torch.zeros(B + 1, L, 97))


def test_guided_sample_text_through_a_decoder(tmp_path, monkeypatch, model):
    """``guided_sample_text`` given a decoder decodes as with the decode
    step, and refuses a decoder built for another mix."""
    monkeypatch.chdir(tmp_path)
    tok = CharTokenizer("abcdefghij klmnopqrstuvwxyz.,;:!?'\n" * 2)
    gen = torch.Generator().manual_seed(0)
    lm = TinyGPT(TinyGPTConfig(vocab_size=tok.vocab_size, dim=32, n_heads=2,
                               depth=1, max_len=12),
                 key=substream(prng_key(0), "lm_init")).eval()
    rounding = LearnedRounding(
        16, tok.vocab_size, key=substream(prng_key(0), "rounding"))
    z = torch.randn(3, 10, 16, generator=gen)
    bos = tok.bos_token_id or tok.eos_token_id or 0
    kw = dict(rounding=rounding, alpha=0.5, return_tokens=True,
              log_fn=lambda s: None)
    texts, tokens = guided_sample_text(
        guided.GuidedDecoder(lm, 3, 10, bos, alpha=0.5), None, z, tok, **kw)
    want_texts, want = guided_sample_text(lm.decode_step, lm.init_cache(3),
                                          z, tok, save=False, **kw)
    torch.testing.assert_close(tokens, want, rtol=0, atol=0)
    assert texts == want_texts
    with pytest.raises(ValueError, match="the decoder serves"):
        guided_sample_text(guided.GuidedDecoder(lm, 3, 10, bos, alpha=0.4),
                           None, z, tok, **kw)


def test_step_prime_runs_once_before_the_capture(replaying_cuda):
    """``graphs.Step(prime=..., warmup=0)``: the first call primes (outside
    the capture), captures and replays; later calls replay."""
    fake = replaying_cuda
    ran, primed = [], []
    step = graphs.Step(lambda: ran.append(fake.capturing), "cuda", warmup=0,
                       prime=lambda: primed.append(fake.capturing))
    for _ in range(3):
        step()
    assert primed == [False] and ran == [True, False, False, False]
    (graph,) = fake.graphs
    assert graph.replays == 3


# --- python -m tinydiffusionmodels_torch.jacobi_rounds ----------------------

TOOL = ["--seq_len", "8", "--heads", "2", "--batches", "2", "3"]


def test_jacobi_rounds_tool_trains_and_counts(tmp_path, monkeypatch, capsys):
    """At a tiny size on the CPU: TinyGPT trained on the built-in corpus,
    every (weights, batch, draft) case converges within L + 1 rounds."""
    from tinydiffusionmodels_torch import jacobi_rounds

    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    records = jacobi_rounds.main([
        *TOOL, "--data_root", str(tmp_path), "--chars", "3000", "--epochs",
        "1", "--dim", "16", "--depth", "1"])
    out = capsys.readouterr().out
    assert [(r["params"], r["batch"], r["draft"]) for r in records] == [
        (p, b, d) for p in ("random", "trained") for b in (2, 3)
        for d in ("fused", "scan_bf16")]
    assert all(r["converged"] and 1 <= r["rounds"] <= 9 for r in records)
    assert out.count("converged at round") == 8


def test_jacobi_rounds_tool_tells_unconverged_apart(tmp_path, monkeypatch,
                                                    capsys):
    """On an ``--lm_ckpt``: the rounds equal ``guided_generate_verified``'s
    on the same logits; with ``--max_rounds`` too small the cases that need
    more say "not converged within", and one that needs exactly that many
    says "converged at round"."""
    from tinydiffusionmodels_torch import jacobi_rounds
    from tinydiffusionmodels_torch.io import (
        save_checkpoint,
        tiny_gpt_params_dict,
    )

    monkeypatch.setenv("TDM_PLATFORM", "cpu")
    lm = TinyGPT(TinyGPTConfig(**CFG_KW),
                 key=prng_key(5)).eval()
    with torch.no_grad():   # a sharper LM, whose drafts need more rounds
        lm.lm_head.weight.mul_(30.0)
    save_checkpoint({"params": tiny_gpt_params_dict(lm)},
                    str(tmp_path / "lm.pth"))
    argv = [*TOOL, "--heads", "4", "--lm_ckpt", str(tmp_path / "lm.pth")]
    full = jacobi_rounds.main(argv)
    for r in full:
        if r["params"] != "trained":
            continue
        diff = torch.randn((r["batch"], 8, 97),
                           generator=torch.Generator().manual_seed(7))
        _, want = guided.guided_generate_verified(
            lm, diff, jacobi_rounds.BOS, alpha=jacobi_rounds.ALPHA,
            draft=r["draft"], return_rounds=True)
        assert r["converged"] and r["rounds"] == want
    capsys.readouterr()
    # The fewest rounds that another case needs more than: one case
    # converges at that limit and another does not.
    rounds = {r["rounds"] for r in full}
    limit = min(n for n in rounds if n < max(rounds))
    cut = jacobi_rounds.main([*argv, "--max_rounds", str(limit)])
    out = capsys.readouterr().out
    for r, c in zip(full, cut):
        assert c["rounds"] == min(r["rounds"], limit)
        assert c["converged"] == (r["rounds"] <= limit)
    assert f"converged at round {limit}" in out
    assert f"not converged within {limit} rounds" in out
