"""Text sampling: diffusion sampling plus decoding, and guided generation
(port of ``sample/text.py``).

The reverse loop is ``sample.ancestral.sample_loop``; decoding is the learned
rounding head's argmax or the cosine fallback; guided generation mixes a base
LM's greedy decode with the per-position diffusion logits
(``sample.guided``). Everything runs on the device of the model's parameters
under ``torch.inference_mode``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from tinydiffusionmodels_torch.core.diffusion import _bcast, eps_from_x0
from tinydiffusionmodels_torch.core.schedule import DiffusionSchedule
from tinydiffusionmodels_torch.io import get_samples_dir, save_samples
from tinydiffusionmodels_torch.models.embedding import (
    LearnedRounding,
    cosine_logits,
    rounding_apply,
)
from tinydiffusionmodels_torch.models.transformer import TinyTransformer
from tinydiffusionmodels_torch.sample.ancestral import NoiseFn, sample_loop
from tinydiffusionmodels_torch.sample.guided import (
    GuidedDecoder,
    guided_generate_scan,
)
from tinydiffusionmodels_torch.runtime import span


def make_denoiser(
    model: TinyTransformer,
    sched: DiffusionSchedule,
    *,
    parameterization: str = "eps",
):
    """(x, t) -> eps whatever the model's output parameterization ('eps',
    the reference's, or 'x0', Diffusion-LM's). With ``cfg.self_cond`` the
    function is (x, t, x0_prev) -> (eps, x0_est)."""

    def denoise(x, t, x0_prev=None):
        pred = model(x, t, x0_prev=x0_prev)
        if parameterization == "x0":
            eps = eps_from_x0(sched, x, t, pred)
            x0_est = pred
        else:
            eps = pred
            sqrt_acp = _bcast(sched.sqrt_alphas_cumprod, t, x.ndim)
            sqrt_om = _bcast(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim)
            x0_est = (x - sqrt_om * pred) / sqrt_acp
        if model.cfg.self_cond:
            return eps, x0_est
        return eps

    return denoise


def make_clamped_denoiser(
    model: TinyTransformer,
    sched: DiffusionSchedule,
    *,
    rounding: LearnedRounding | None,
    embedding_table: torch.Tensor,
    use_learned_rounding: bool = True,
    parameterization: str = "eps",
):
    """Diffusion-LM's clamping trick (Li et al. 2022, section 4): at every
    reverse step snap the implied x0 to its nearest embedding and re-derive
    eps from it. With ``cfg.self_cond`` it returns (eps, x0_clamped)."""

    def denoise(x, t, x0_prev=None):
        pred = model(x, t, x0_prev=x0_prev)
        sqrt_acp = _bcast(sched.sqrt_alphas_cumprod, t, x.ndim)
        sqrt_om = _bcast(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim)
        if parameterization == "x0":
            x0 = pred
        else:
            x0 = (x - sqrt_om * pred) / sqrt_acp
        if use_learned_rounding:
            logits = rounding_apply(rounding, x0)
        else:
            logits = cosine_logits(embedding_table, x0)
        x0_clamped = embedding_table[torch.argmax(logits, dim=-1)]
        eps = (x - sqrt_acp * x0_clamped) / sqrt_om
        if model.cfg.self_cond:
            return eps, x0_clamped
        return eps

    return denoise


def _sample(model, sched, denoise, shape, *, method, num_steps, temperature,
            key, x_T, noise_fn) -> torch.Tensor:
    with torch.inference_mode():
        return sample_loop(
            denoise, sched, shape, method=method, num_steps=num_steps,
            self_cond=model.cfg.self_cond, temperature=temperature,
            key=key, x_T=x_T, noise_fn=noise_fn,
        )


def sample_diffusion_embeddings(
    model: TinyTransformer,
    sched: DiffusionSchedule,
    *,
    n: int,
    seq_len: int,
    embed_dim: int,
    method: str = "ancestral",
    num_steps: int | None = None,
    parameterization: str = "eps",
    temperature: float = 1.0,
    key=None,
    x_T: torch.Tensor | None = None,
    noise_fn: NoiseFn | None = None,
) -> torch.Tensor:
    """Reverse-diffuse (n, seq_len, embed_dim) embeddings from pure noise."""
    denoise = make_denoiser(model, sched, parameterization=parameterization)
    return _sample(
        model, sched, denoise, (n, seq_len, embed_dim), method=method,
        num_steps=num_steps, temperature=temperature, key=key,
        x_T=x_T, noise_fn=noise_fn,
    )


def decode_embeddings(
    x: torch.Tensor,
    *,
    rounding: LearnedRounding | None,
    embed_matrix: torch.Tensor | None,
    use_learned_rounding: bool,
) -> torch.Tensor:
    """Embeddings -> token ids by learned rounding or cosine similarity."""
    with span("tdm.sample.decode"):
        return torch.argmax(
            diffusion_position_logits(
                x, rounding=rounding, embed_matrix=embed_matrix,
                use_learned_rounding=use_learned_rounding,
            ),
            dim=-1,
        )


def diffusion_position_logits(
    z: torch.Tensor,
    *,
    rounding: LearnedRounding | None,
    embed_matrix: torch.Tensor | None,
    use_learned_rounding: bool,
) -> torch.Tensor:
    """(B, L, dim) z -> (B, L, V) per-position logits."""
    with torch.inference_mode():
        if use_learned_rounding:
            return rounding_apply(rounding, z)
        return cosine_logits(embed_matrix, z)


def sample_text(
    model: TinyTransformer,
    sched: DiffusionSchedule,
    tokenizer,
    *,
    rounding: LearnedRounding | None = None,
    embed_matrix: torch.Tensor | None = None,
    n_samples: int = 4,
    seq_len: int = 128,
    embed_dim: int,
    use_learned_rounding: bool = True,
    outdir: str = "samples",
    save: bool = True,
    method: str = "ancestral",
    num_steps: int | None = None,
    clamp: bool = False,
    parameterization: str = "eps",
    temperature: float = 1.0,
    log_fn=print,
    key=None,
    x_T: torch.Tensor | None = None,
    noise_fn: NoiseFn | None = None,
    return_embeddings: bool = False,
):
    """Pure diffusion text sampling; writes ``sample_{i}.txt`` when ``save``.

    ``clamp=True`` enables the clamping trick and needs an embedding table.
    Returns the texts, or (texts, final embeddings) with
    ``return_embeddings``."""
    shape = (n_samples, seq_len, embed_dim)
    if clamp:
        if embed_matrix is None:
            raise ValueError("clamp=True requires an embedding table")
        denoise = make_clamped_denoiser(
            model, sched, rounding=rounding, embedding_table=embed_matrix,
            use_learned_rounding=use_learned_rounding,
            parameterization=parameterization,
        )
        x = _sample(
            model, sched, denoise, shape, method=method, num_steps=num_steps,
            temperature=temperature, key=key, x_T=x_T,
            noise_fn=noise_fn,
        )
    else:
        x = sample_diffusion_embeddings(
            model, sched, n=n_samples, seq_len=seq_len, embed_dim=embed_dim,
            method=method, num_steps=num_steps,
            parameterization=parameterization, temperature=temperature,
            key=key, x_T=x_T, noise_fn=noise_fn,
        )
    tokens = decode_embeddings(
        x, rounding=rounding, embed_matrix=embed_matrix,
        use_learned_rounding=use_learned_rounding,
    )
    texts = tokenizer.batch_decode(tokens.cpu().numpy(), skip_special_tokens=True)

    if save:
        samples_dir = get_samples_dir(outdir)
        for i, text in enumerate(texts):
            log_fn(text)
            if isinstance(samples_dir, str) and samples_dir.startswith("gs://"):
                sample_path = f"{samples_dir}/sample_{i}.txt"
            else:
                sample_path = Path(samples_dir) / f"sample_{i}.txt"
            save_samples(text, sample_path)
            log_fn(f"✔ Wrote {sample_path}")
    return (texts, x) if return_embeddings else texts


def guided_sample_text(
    decode_step,
    init_cache: dict | None,
    z: torch.Tensor,
    tokenizer,
    *,
    rounding: LearnedRounding | None = None,
    embed_matrix: torch.Tensor | None = None,
    use_learned_rounding: bool = True,
    alpha: float = 0.3,
    temperature: float = 1.0,
    normalize: bool = False,
    outdir: str = "samples",
    save: bool = True,
    log_fn=print,
    return_tokens: bool = False,
):
    """Guided generation end to end (reference src/shakespeare.py:429-470,
    590-603): diffusion logits from z, the KV-cached greedy decode, decode,
    and ``guided_sample_{i}.txt`` when ``save``. ``normalize=True`` mixes
    probabilities instead of logits (``sample.guided.mix_logits``).

    ``decode_step`` is a ``sample.guided.GuidedDecoder`` built for z's
    batch and length, the tokenizer's BOS and this mix (``init_cache``
    None): its graphs replayed on the card. Or it is a cached decode step
    with its ``init_cache``, run eagerly by ``sample.guided.
    guided_generate_scan``. Returns the texts, or (texts, (B, L) int32
    tokens) with ``return_tokens``."""
    diff_logits = diffusion_position_logits(
        z, rounding=rounding, embed_matrix=embed_matrix,
        use_learned_rounding=use_learned_rounding,
    )
    bos = tokenizer.bos_token_id or tokenizer.eos_token_id or 0
    mix = dict(alpha=float(alpha), temperature=float(temperature),
               normalize=bool(normalize))
    if isinstance(decode_step, GuidedDecoder):
        if init_cache is not None or decode_step.mix != mix or \
                decode_step.bos_token != bos:
            raise ValueError(
                f"the decoder serves BOS {decode_step.bos_token} and "
                f"{decode_step.mix} with no init_cache; asked for BOS {bos} "
                f"and {mix}")
        tokens = decode_step(diff_logits)
    else:
        tokens = guided_generate_scan(decode_step, init_cache, diff_logits,
                                      bos, **mix)
    texts = tokenizer.batch_decode(tokens.cpu().numpy(),
                                   skip_special_tokens=True)
    if save:
        write_guided_samples(texts, outdir, log_fn)
    return (texts, tokens) if return_tokens else texts


def write_guided_samples(texts, outdir: str = "samples",
                         log_fn=print) -> None:
    """``guided_sample_{i}.txt`` of each text under the samples directory
    (local or ``gs://``)."""
    samples_dir = get_samples_dir(outdir)
    for i, text in enumerate(texts):
        if isinstance(samples_dir, str) and samples_dir.startswith("gs://"):
            sample_path = f"{samples_dir}/guided_sample_{i}.txt"
        else:
            sample_path = Path(samples_dir) / f"guided_sample_{i}.txt"
        save_samples(text, sample_path)
        log_fn(f"✔ Wrote {sample_path}")
