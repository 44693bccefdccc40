"""Diffusion math and text sampling of the torch package against the JAX
package, on the CPU.

jax.random draws cannot be reproduced in torch, so the JAX draws are
replayed into the port: the sampler's x_T from the first half of the split
key and, per step, ``jax.random.normal(fold_in(loop_key, t))``, exactly as
``sample/ancestral.py`` draws them. Tolerances: schedule tables bit for bit;
single steps f32 ``atol = 1e-6``; whole sampling runs ``atol = 1e-3`` on the
final embeddings (1000 ancestral steps amplify each step's last-ulp matmul
differences; the measured maxima are recorded in PERF.md), and token ids
equal wherever the top two rounding logits differ by more than 1e-3.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
jnp = jax.numpy

from tinydiffusionmodels_tpu.core import diffusion as jax_diff  # noqa: E402
from tinydiffusionmodels_tpu.core.schedule import (  # noqa: E402
    make_schedule as jax_make_schedule,
)
from tinydiffusionmodels_tpu.data.tokenizer import CharTokenizer  # noqa: E402
from tinydiffusionmodels_tpu.models import (  # noqa: E402
    init_learned_rounding,
    init_tiny_transformer,
    rounding_apply,
)
from tinydiffusionmodels_tpu.models.transformer import (  # noqa: E402
    TransformerConfig as JaxConfig,
)
from tinydiffusionmodels_tpu.sample import text as jax_text  # noqa: E402
from tinydiffusionmodels_torch.core import diffusion as port_diff  # noqa: E402
from tinydiffusionmodels_torch.core import rng  # noqa: E402
from tinydiffusionmodels_torch.core.schedule import make_schedule  # noqa: E402
from tinydiffusionmodels_torch.io import convert  # noqa: E402
from tinydiffusionmodels_torch.models import (  # noqa: E402
    LearnedRounding,
    TinyTransformer,
    TransformerConfig,
)
from tinydiffusionmodels_torch.sample import text as port_text  # noqa: E402

torch.set_num_threads(1)

SCHEDULES = ["linear", "cosine", "sqrt"]
FIELDS = ["betas", "alphas", "alphas_cumprod", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas", "sqrt_betas"]


@pytest.mark.parametrize("kind", SCHEDULES)
def test_schedule_tables_bit_identical(kind):
    ref = jax_make_schedule(kind=kind)
    port = make_schedule(kind=kind)
    assert port.timesteps == ref.timesteps
    for field in FIELDS:
        np.testing.assert_array_equal(
            getattr(port, field).numpy(), np.asarray(getattr(ref, field)),
            err_msg=field,
        )


def _step_inputs(seed=0, shape=(4, 6, 8)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    eps = rng.standard_normal(shape, dtype=np.float32)
    noise = rng.standard_normal(shape, dtype=np.float32)
    t = np.array([0, 1, 500, 999], dtype=np.int32)
    return x, eps, noise, t


@pytest.mark.parametrize("kind", SCHEDULES)
def test_single_steps_match(kind):
    js, ps = jax_make_schedule(kind=kind), make_schedule(kind=kind)
    x, eps, noise, t = _step_inputs()
    jx, je, jt = jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t)
    tx, te, tt = (torch.from_numpy(x), torch.from_numpy(eps),
                  torch.from_numpy(t).long())
    tn = torch.from_numpy(noise)

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)

    close(port_diff.q_sample(ps, tx, tt, tn),
          jax_diff.q_sample(js, jx, jt, jnp.asarray(noise)))
    close(port_diff.eps_from_x0(ps, tx, tt, te),
          jax_diff.eps_from_x0(js, jx, jt, je))
    close(port_diff.p_sample_mean(ps, tx, tt, te),
          jax_diff.p_sample_mean(js, jx, jt, je))
    key = jax.random.PRNGKey(3)
    replay = torch.from_numpy(np.array(
        jax.random.normal(key, x.shape, dtype=jnp.float32)))
    close(port_diff.p_sample(ps, tx, tt, te, replay, noise_scale=0.7),
          jax_diff.p_sample(js, jx, jt, je, key, noise_scale=0.7))
    t_prev = np.array([-1, 0, 450, 980], dtype=np.int32)
    for eta in (0.0, 0.5):
        close(
            port_diff.ddim_step(ps, tx, tt, torch.from_numpy(t_prev).long(),
                                te, eta=eta,
                                noise=replay if eta > 0 else None),
            jax_diff.ddim_step(js, jx, jt, jnp.asarray(t_prev), je, eta=eta,
                               key=key if eta > 0 else None),
        )


DIM, DEPTH, FFN, N, SEQ = 32, 2, 64, 2, 8


@pytest.fixture(scope="module")
def slice_weights():
    jcfg = JaxConfig(dim=DIM, n_heads=4, depth=DEPTH, ffn_dim=FFN)
    tok = CharTokenizer("abcdefghijklmnop qrstuvwxyz,.")
    diff = init_tiny_transformer(jax.random.PRNGKey(0), jcfg)
    # Halve the residual branches' output projections. An untrained
    # denoiser drives the 1000-step trajectory to |z| ~ 150, and at the full
    # init its attention and ReLU kinks amplify last-ulp differences between
    # XLA and torch matmuls to 8.2e-4 for one of 8 keys, too close to the
    # tolerance; at half scale the maximum over 10 keys is 2.8e-4. Both
    # packages get the same weights.
    diff["layers"] = tuple(
        {**layer,
         "linear2": {k: 0.5 * v for k, v in layer["linear2"].items()},
         "self_attn": {**layer["self_attn"], "out_proj": {
             k: 0.5 * v for k, v in layer["self_attn"]["out_proj"].items()}}}
        for layer in diff["layers"]
    )
    rounding = init_learned_rounding(jax.random.PRNGKey(1), DIM,
                                     tok.vocab_size)
    model = TinyTransformer(TransformerConfig(dim=DIM, n_heads=4,
                                              depth=DEPTH, ffn_dim=FFN))
    model.load_state_dict(convert.transformer_state_from_jax(diff),
                          strict=True)
    port_rounding = LearnedRounding(DIM, tok.vocab_size)
    port_rounding.load_state_dict(convert.rounding_state_from_jax(rounding))
    return jcfg, tok, diff, rounding, model.eval(), port_rounding.eval()


def _replayed_noise(key, shape, method, ts):
    """x_T and the per-step noise function the JAX sampler draws."""
    init_key, loop_key = jax.random.split(key)
    x_T = torch.from_numpy(np.array(jax.random.normal(init_key, shape)))
    if method != "ancestral":
        return x_T, None
    draws = np.array(jax.vmap(
        lambda t: jax.random.normal(jax.random.fold_in(loop_key, t), shape)
    )(jnp.asarray(ts)))
    index = {int(t): i for i, t in enumerate(ts)}
    return x_T, lambda t: torch.from_numpy(draws[index[t]])


@pytest.mark.parametrize("method, steps", [
    ("ancestral", None), ("ddim", 20), ("dpm++", 10),
])
def test_sample_text_matches_jax(slice_weights, method, steps, tmp_path,
                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("AIP_MODEL_DIR", raising=False)
    jcfg, tok, diff, rounding, model, port_rounding = slice_weights
    jsched, psched = jax_make_schedule(), make_schedule()
    key = jax.random.PRNGKey(11)
    shape = (N, SEQ, DIM)
    common = dict(n_samples=N, seq_len=SEQ, embed_dim=DIM, method=method,
                  num_steps=steps, log_fn=lambda *a: None)

    jax_texts = jax_text.sample_text(
        diff, jcfg, jsched, tok, key, rounding_params=rounding, save=False,
        **common,
    )
    z_jax = np.asarray(jax_text.sample_diffusion_embeddings(
        diff, jcfg, jsched, key, n=N, seq_len=SEQ, embed_dim=DIM,
        method=method, num_steps=steps,
    ))

    x_T, noise_fn = _replayed_noise(
        key, shape, method, np.arange(jsched.timesteps - 1, -1, -1)
    )
    texts, z = port_text.sample_text(
        model, psched, tok, rounding=port_rounding, save=True,
        x_T=x_T, noise_fn=noise_fn, return_embeddings=True, **common,
    )
    err = float(np.abs(z.numpy() - z_jax).max())
    assert np.isfinite(z.numpy()).all()
    assert err <= 1e-3, f"{method}: max |z_port - z_jax| = {err:.3g}"

    logits = np.asarray(rounding_apply(rounding, jnp.asarray(z_jax)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 1e-3
    tokens_jax = logits.argmax(-1)
    tokens = port_text.decode_embeddings(
        z, rounding=port_rounding, embed_matrix=None,
        use_learned_rounding=True,
    ).numpy()
    np.testing.assert_array_equal(tokens[decided], tokens_jax[decided])
    assert texts == tok.batch_decode(tokens)
    assert jax_texts == tok.batch_decode(tokens_jax)
    for i in range(N):
        if decided[i].all():
            assert texts[i] == jax_texts[i]
        assert (tmp_path / "samples" / f"sample_{i}.txt").read_text() == texts[i]


@pytest.mark.parametrize("method, eta, self_cond, param", [
    ("ddim", 0.5, False, "eps"),     # stochastic DDIM: replayed eta noise
    ("dpm++", 0.0, True, "x0"),      # self-conditioning carry, x0 output
])
def test_sample_loop_variants_match_jax(method, eta, self_cond, param):
    from tinydiffusionmodels_tpu.sample.ancestral import (
        sample_loop as jax_sample_loop,
    )
    from tinydiffusionmodels_torch.sample.ancestral import sample_loop

    kw = dict(dim=DIM, n_heads=4, depth=DEPTH, ffn_dim=FFN,
              self_cond=self_cond)
    jcfg = JaxConfig(**kw)
    diff = init_tiny_transformer(jax.random.PRNGKey(4), jcfg)
    if self_cond:
        diff["selfcond_proj"]["w"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(5), (DIM, DIM))
    model = TinyTransformer(TransformerConfig(**kw))
    model.load_state_dict(convert.transformer_state_from_jax(diff))
    jsched, psched = jax_make_schedule(), make_schedule()
    key, shape, steps = jax.random.PRNGKey(13), (N, SEQ, DIM), 6
    ref = np.asarray(jax.jit(lambda k: jax_sample_loop(
        jax_text.make_denoiser(diff, jcfg, jsched, parameterization=param),
        jsched, shape, k, method=method, num_steps=steps, eta=eta,
        self_cond=self_cond,
    ))(key))

    ts = np.linspace(0, jsched.timesteps - 1, steps).round().astype(int)
    x_T, noise_fn = _replayed_noise(key, shape, "ancestral", ts)
    with torch.inference_mode():
        out = sample_loop(
            port_text.make_denoiser(model.eval(), psched,
                                    parameterization=param),
            psched, shape, method=method, num_steps=steps, eta=eta,
            self_cond=self_cond, x_T=x_T, noise_fn=noise_fn,
        )
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)


def test_clamped_sampling_matches_jax(slice_weights):
    """The Diffusion-LM clamping trick (ddim, 6 steps) on the same table."""
    jcfg, tok, diff, rounding, model, port_rounding = slice_weights
    table = np.random.default_rng(5).standard_normal(
        (tok.vocab_size, DIM)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jax_texts = jax_text.sample_text(
        diff, jcfg, jax_make_schedule(), tok, key, rounding_params=rounding,
        embed_matrix=jnp.asarray(table), n_samples=N, seq_len=SEQ,
        embed_dim=DIM, method="ddim", num_steps=6, clamp=True, save=False,
        log_fn=lambda *a: None,
    )
    x_T, _ = _replayed_noise(key, (N, SEQ, DIM), "ddim", None)
    texts = port_text.sample_text(
        model, make_schedule(), tok, rounding=port_rounding,
        embed_matrix=torch.from_numpy(table), n_samples=N, seq_len=SEQ,
        embed_dim=DIM, method="ddim", num_steps=6, clamp=True, save=False,
        x_T=x_T,
    )
    assert texts == jax_texts


def test_temperature_rejected_with_deterministic_solvers(slice_weights):
    _, _, _, _, model, _ = slice_weights
    for method in ("dpm++", "ddim"):
        with pytest.raises(ValueError, match="no effect"):
            port_text.sample_diffusion_embeddings(
                model, make_schedule(), n=1, seq_len=4, embed_dim=DIM,
                method=method, num_steps=4, temperature=1.1,
                key=rng.prng_key(0),
            )


def test_sampler_needs_explicit_randomness(slice_weights):
    _, _, _, _, model, _ = slice_weights
    with pytest.raises(ValueError, match="pass a key"):
        port_text.sample_diffusion_embeddings(
            model, make_schedule(), n=1, seq_len=4, embed_dim=DIM,
            method="ddim", num_steps=2,
        )


def test_generator_sampling_is_reproducible(slice_weights):
    """Sampling from a key is reproducible and differs between keys."""
    _, _, _, _, model, _ = slice_weights

    def draw(seed):
        return port_text.sample_diffusion_embeddings(
            model, make_schedule(), n=1, seq_len=4, embed_dim=DIM,
            method="ddim", num_steps=3, key=rng.prng_key(seed),
        )

    torch.testing.assert_close(draw(1), draw(1), rtol=0, atol=0)
    assert not torch.equal(draw(1), draw(2))
