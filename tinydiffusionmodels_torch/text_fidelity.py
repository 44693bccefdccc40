"""Text-sampling fidelity of a Shakespeare diffusion checkpoint (port of
``tools/text_fidelity.py``), on the card unless ``TDM_PLATFORM=cpu``.

    python -m tinydiffusionmodels_torch.text_fidelity --ckpt text_ckpt.pth \
        [--lm_ckpt lm_ckpt.pth] [--n 16] [--seeds 3] [--seq_len 64] \
        [--mode pure|guided] [--alpha 0.3] [--clamp] [--sampler ancestral]

It samples ``--n`` texts from the checkpoint (either package's dict
format) through the port's samplers, ``pure`` (``sample/text.py``) or
``guided`` (a ``GuidedDecoder`` of the judge TinyGPT, its scan replayed as
one CUDA graph on the card), and prints one JSON line with the JAX tool's
keys:

- ``lm_perplexity``: token perplexity of the samples under a TinyGPT
  (dim 256, depth 4) trained on the corpus, beside ``corpus_perplexity``
  (held-out corpus text) and ``uniform_perplexity`` (the vocabulary);
- ``distinct_1``, ``distinct_2``, ``dup_8gram_rate`` (``ngram_stats``) and
  ``corpus_8gram_overlap``, beside the same statistics of ``n`` corpus
  windows (``corpus_*``);
- with ``--seeds K`` > 1, every metric's mean with ``_stderr`` and
  ``_per_seed``; and ``data_source``, the corpus read.

The judge is ``--lm_ckpt`` when it holds a TinyGPT of this vocabulary with
a long enough position table (either package's ``{"params": ...}``), else
one trained for ``--lm_epochs`` by ``train/lm_train.py`` and saved there.
Replicate ``r`` draws from ``substream(PRNGKey(--seed + 1000 r),
"sample")``, the JAX tool's key.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch
from torch.nn.utils import skip_init

from tinydiffusionmodels_torch.core.rng import prng_key, substream
from tinydiffusionmodels_torch.runtime import device as runtime_device


def ngram_stats(token_seqs: list[np.ndarray]) -> dict:
    """Distinct-1/2 over all samples and the share of 8-grams found in more
    than one sample."""
    def distinct(n: int) -> float:
        grams = [
            tuple(seq[i:i + n])
            for seq in token_seqs for i in range(len(seq) - n + 1)
        ]
        return len(set(grams)) / max(1, len(grams))

    per_sample_8grams = [
        {tuple(seq[i:i + 8]) for i in range(len(seq) - 7)}
        for seq in token_seqs
    ]
    counts: dict = {}
    for grams in per_sample_8grams:
        for g in grams:
            counts[g] = counts.get(g, 0) + 1
    dup = sum(1 for c in counts.values() if c > 1) / max(1, len(counts))
    return {
        "distinct_1": round(distinct(1), 4),
        "distinct_2": round(distinct(2), 4),
        "dup_8gram_rate": round(dup, 4),
    }


@torch.inference_mode()
def lm_perplexity(lm, token_seqs: list[np.ndarray],
                  max_len: int | None = None) -> float:
    """Mean token perplexity of sequences under the TinyGPT ``lm``: each
    cut to ``max_len`` (default the model's) and padded to it, one batched
    causal forward, the mean next-token NLL of each over its real
    positions, then exp of their mean (sequences under 2 tokens skipped)."""
    max_len = max_len or lm.cfg.max_len
    seqs = [np.asarray(s[:max_len], dtype=np.int64) for s in token_seqs]
    seqs = [s for s in seqs if len(s) >= 2]
    if not seqs:
        return float("nan")
    dev = next(lm.parameters()).device
    ids = np.zeros((len(seqs), max_len), np.int64)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
    ids = torch.as_tensor(ids, device=dev)
    logp = torch.log_softmax(lm(ids[:, :-1]).float(), dim=-1)
    tok_nll = -torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
    n_real = torch.as_tensor([len(s) for s in seqs], device=dev)
    valid = torch.arange(max_len - 1, device=dev)[None, :] < (n_real - 1)[:, None]
    nll = (torch.where(valid, tok_nll, 0.0).sum(1)
           / valid.sum(1).clamp(min=1))
    return float(np.exp(np.mean(nll.cpu().numpy().astype(np.float64))))


def load_or_train_lm(lm_ckpt: str, corpus: str, tokenizer, lm_cfg, *,
                     epochs: int, seed: int, device):
    """The judge TinyGPT: ``lm_ckpt`` when it fits ``lm_cfg`` (vocabulary,
    position table at least ``lm_cfg.max_len``), else trained on the
    corpus in windows of ``lm_cfg.max_len`` and saved to ``lm_ckpt``."""
    from tinydiffusionmodels_torch.data import tokenize_corpus
    from tinydiffusionmodels_torch.io import (
        load_checkpoint,
        save_checkpoint,
        tiny_gpt_params_dict,
        tiny_gpt_state_from_jax,
    )
    from tinydiffusionmodels_torch.models import TinyGPT
    from tinydiffusionmodels_torch.train.lm_train import train_lm

    def log(msg):
        print(msg, file=sys.stderr)

    if os.path.exists(lm_ckpt):
        try:
            params = load_checkpoint(lm_ckpt)["params"]
            vocab = int(np.shape(params["tok_emb"])[0])
            length = int(np.shape(params["pos_emb"])[0])
            if vocab != lm_cfg.vocab_size:
                raise ValueError(f"cached judge vocab {vocab} != tokenizer "
                                 f"vocab {lm_cfg.vocab_size}")
            if length < lm_cfg.max_len:
                raise ValueError(f"cached judge max_len {length} < "
                                 f"required {lm_cfg.max_len}")
            lm = skip_init(TinyGPT, dataclasses.replace(lm_cfg,
                                                        max_len=length))
            lm.load_state_dict(tiny_gpt_state_from_jax(params), strict=True)
            log(f"[lm] loaded TinyGPT from {lm_ckpt}")
            return lm.to(device).eval()
        except Exception as e:  # another vocabulary or shape: retrain
            log(f"[lm] could not load {lm_ckpt}: {e}")
    chunks, _ = tokenize_corpus(corpus, tokenizer, lm_cfg.max_len, 0.0)
    lm = train_lm(chunks, lm_cfg, epochs=epochs, seed=seed, device=device,
                  log_fn=log)
    save_checkpoint({"params": tiny_gpt_params_dict(lm)}, lm_ckpt)
    return lm


def _load_denoiser(ckpt: dict, corpus: str, device):
    """The checkpoint's denoiser, rounding head, embedding table, schedule,
    tokenizer and parameterization, as the JAX tool reads them."""
    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.data import CharTokenizer, tokenizer_from_state
    from tinydiffusionmodels_torch.io import (
        config_from_state_dict,
        state_from_checkpoint,
    )
    from tinydiffusionmodels_torch.models import (
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
        embedding_matrix,
    )

    tokenizer = (tokenizer_from_state(ckpt["tokenizer"]) if "tokenizer" in ckpt
                 else CharTokenizer(corpus))
    vocab, embed_dim = np.shape(ckpt["rounding_fn"]["decoder.weight"])
    self_cond = bool(ckpt.get("self_cond")) or (
        "selfcond_proj.weight" in ckpt["diffusion_model"])
    sched = make_schedule(kind=ckpt.get("noise_schedule", "linear"),
                          device=device)
    cfg = config_from_state_dict(ckpt["diffusion_model"], TransformerConfig(
        dim=int(embed_dim), timesteps=sched.timesteps, self_cond=self_cond,
        pos_emb=ckpt.get("pos_emb", "none")))
    model = skip_init(TinyTransformer, cfg)
    model.load_state_dict(state_from_checkpoint(ckpt["diffusion_model"]),
                          strict=True)
    rounding = skip_init(LearnedRounding, int(embed_dim), int(vocab))
    rounding.load_state_dict(state_from_checkpoint(ckpt["rounding_fn"]))
    embed_matrix = None
    if "embedding_fn" in ckpt:
        embed_matrix = embedding_matrix(
            torch.as_tensor(np.asarray(
                ckpt["embedding_fn"]["embeddings.weight"], np.float32),
                device=device),
            norm=ckpt.get("embed_norm", "none"))
    return (model.to(device).eval(), rounding.to(device).eval(), embed_matrix,
            sched, tokenizer, ckpt.get("parameterization", "eps"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", type=str, default="text_ckpt.pth")
    ap.add_argument("--lm_ckpt", type=str, default="lm_ckpt.pth")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--seq_len", type=int, default=64)
    ap.add_argument("--mode", choices=["pure", "guided"], default="pure")
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--guidance_norm", action="store_true",
                    help="log-prob mixing (sample.guided.mix_logits)")
    ap.add_argument("--clamp", action="store_true")
    ap.add_argument("--sampler", type=str, default="ancestral")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="ancestral sampling noise scale (pure mode); "
                         "errors with deterministic solvers (ddim/dpm++), "
                         "where it would silently no-op")
    ap.add_argument("--lm_epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="replicate generate+score over this many seeds; "
                         "metrics become means with _stderr and _per_seed")
    return ap


def main(argv=None) -> dict:
    """Print (and return) the JSON record of the root tool's CLI."""
    from tinydiffusionmodels_torch.data import load_text_corpus, tokenize_corpus
    from tinydiffusionmodels_torch.io import load_checkpoint
    from tinydiffusionmodels_torch.models import TinyGPTConfig
    from tinydiffusionmodels_torch.sample.guided import GuidedDecoder
    from tinydiffusionmodels_torch.sample.text import (
        guided_sample_text,
        sample_diffusion_embeddings,
        sample_text,
    )

    args = build_parser().parse_args(argv)
    dev = runtime_device()
    corpus, source = load_text_corpus()
    data_limit = int(os.environ.get("TDM_DATA_LIMIT", "0"))
    if data_limit:
        corpus = corpus[:data_limit]

    ckpt = load_checkpoint(args.ckpt)
    if not (isinstance(ckpt, dict) and "diffusion_model" in ckpt):
        raise SystemExit("text_fidelity needs a dict-format text checkpoint")
    model, rounding, embed_matrix, sched, tokenizer, parameterization = \
        _load_denoiser(ckpt, corpus, dev)
    embed_dim = model.cfg.dim

    # The judge LM, shared by the replicate seeds (and the guided base LM).
    lm_cfg = TinyGPTConfig(vocab_size=tokenizer.vocab_size, dim=256,
                           n_heads=4, depth=4,
                           max_len=max(args.seq_len + 1, 64))
    lm = load_or_train_lm(args.lm_ckpt, corpus, tokenizer, lm_cfg,
                          epochs=args.lm_epochs, seed=args.seed, device=dev)
    decoder = None
    if args.mode == "guided":
        decoder = GuidedDecoder(
            lm, args.n, args.seq_len,
            tokenizer.bos_token_id or tokenizer.eos_token_id or 0,
            alpha=args.alpha, normalize=args.guidance_norm)

    def generate(seed: int) -> list[str]:
        key = substream(prng_key(seed), "sample")
        if args.mode == "pure":
            return sample_text(
                model, sched, tokenizer, rounding=rounding,
                embed_matrix=embed_matrix, n_samples=args.n,
                seq_len=args.seq_len, embed_dim=embed_dim,
                use_learned_rounding=True, method=args.sampler,
                num_steps=args.steps, clamp=args.clamp, save=False,
                parameterization=parameterization,
                temperature=args.temperature, key=key,
                log_fn=lambda *_: None)
        z = sample_diffusion_embeddings(
            model, sched, n=args.n, seq_len=args.seq_len,
            embed_dim=embed_dim, method=args.sampler, num_steps=args.steps,
            parameterization=parameterization,
            temperature=args.temperature, key=key)
        return guided_sample_text(
            decoder, None, z, tokenizer, rounding=rounding,
            embed_matrix=embed_matrix, use_learned_rounding=True,
            alpha=args.alpha, normalize=args.guidance_norm, save=False,
            log_fn=lambda *_: None)

    # Corpus references, once: the held-out floor, the matched-window
    # diversity ceilings and the corpus 8-grams for the novelty metric.
    train_chunks, val = tokenize_corpus(corpus, tokenizer, args.seq_len, 0.1)
    val_seqs = [np.asarray(c) for c in (val if len(val) else train_chunks)[:32]]
    corpus_ids = np.asarray(tokenizer.encode(corpus[:200_000]))
    corpus_grams = {tuple(corpus_ids[i:i + 8])
                    for i in range(len(corpus_ids) - 7)}

    def score(token_seqs) -> dict:
        out = {
            "lm_perplexity": round(
                lm_perplexity(lm, token_seqs, lm_cfg.max_len), 3),
            **ngram_stats(token_seqs),
        }
        gen_grams = [tuple(seq[i:i + 8])
                     for seq in token_seqs for i in range(len(seq) - 7)]
        if gen_grams:
            out["corpus_8gram_overlap"] = round(
                sum(1 for g in gen_grams if g in corpus_grams)
                / len(gen_grams), 4)
        return out

    per_seed = []
    for rep in range(max(1, args.seeds)):
        texts = generate(args.seed + 1000 * rep)
        per_seed.append(score([np.asarray(tokenizer.encode(t))
                               for t in texts]))
        print(f"[fidelity] seed {args.seed + 1000 * rep}: {per_seed[-1]}",
              file=sys.stderr)

    result = {
        "mode": args.mode,
        "guidance_norm": bool(args.guidance_norm),
        "n_samples": args.n,
        "n_seeds": len(per_seed),
        "corpus_perplexity": round(
            lm_perplexity(lm, val_seqs, lm_cfg.max_len), 3),
        "uniform_perplexity": tokenizer.vocab_size,
    }
    for k in sorted({k for d in per_seed for k in d}):
        vals = np.asarray([d[k] for d in per_seed if k in d], dtype=float)
        result[k] = round(float(vals.mean()), 4)
        if len(per_seed) > 1:
            result[f"{k}_stderr"] = round(
                float(vals.std(ddof=1) / np.sqrt(len(vals))), 4)
            result[f"{k}_per_seed"] = [round(float(v), 4) for v in vals]

    # The diversity ceiling of real text at the same n and seq_len.
    rng = np.random.RandomState(args.seed)
    ref_seqs = []
    for _ in range(args.n):
        i = rng.randint(0, max(1, len(corpus_ids) - args.seq_len))
        ref_seqs.append(corpus_ids[i:i + args.seq_len])
    result.update({f"corpus_{k}": v for k, v in ngram_stats(ref_seqs).items()})
    result["data_source"] = source
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
