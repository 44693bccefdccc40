"""Count the Jacobi verification rounds of the exact guided decode (port of
``tools/jacobi_rounds.py``).

    python -m tinydiffusionmodels_torch.jacobi_rounds [--lm_ckpt lm_ckpt.pth]

The rounds set the exact decode's cost beyond its draft: each is one f32
full-context TinyGPT forward. For random and trained weights, the ``fused``
and ``scan_bf16`` drafts and each batch of ``--batches`` (8 and 256), it
runs a ``sample.guided.GuidedDecoder`` (replayed CUDA graphs on the card)
on N(0, 1) diffusion logits (the bench's distribution) with the verifier
stopped after ``--max_rounds``, and prints per case either "converged at
round r" (round r changed no token: the tokens are the fixpoint) or "not
converged within m rounds" (round m still changed some). The JAX tool
returns ``max_rounds`` for both.

TinyGPT is the guided CLI's (dim 256, 4 heads, depth 4, L 64, alpha 0.3,
BOS 1). Trained weights: ``--lm_ckpt``, a checkpoint in the CLIs' format
(the guided CLI's ``lm_ckpt.pth``), whose vocabulary and position table
then size the random model too; otherwise a TinyGPT trained for
``--epochs`` (3) on the corpus under ``--data_root`` (the built-in one when
there is none), cut to ``--chars`` characters when given, with the char
tokenizer. Runs on the card unless ``TDM_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse

import torch

ALPHA = 0.3
BOS = 1
DRAFTS = ("fused", "scan_bf16")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Jacobi verification rounds of the exact guided decode")
    p.add_argument("--lm_ckpt", type=str, default=None,
                   help="trained TinyGPT ({'params': JAX tree}); trained on "
                        "the corpus when not given")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--data_root", type=str, default="./data")
    p.add_argument("--chars", type=int, default=0,
                   help="cut the corpus to this many characters (0: all)")
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--batches", type=int, nargs="+", default=[8, 256])
    p.add_argument("--max_rounds", type=int, default=None,
                   help="stop the verifier after this many rounds "
                        "(default seq_len + 1, past the bound of L)")
    return p


def _models(args, device):
    """{"random": TinyGPT, "trained": TinyGPT}, both on ``device``."""
    from tinydiffusionmodels_torch.io import (
        load_checkpoint,
        tiny_gpt_state_from_jax,
    )
    from tinydiffusionmodels_torch.core.rng import prng_key
    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig

    if args.lm_ckpt:
        params = load_checkpoint(args.lm_ckpt)["params"]
        vocab, dim = params["tok_emb"].shape
        cfg = TinyGPTConfig(vocab_size=int(vocab), dim=int(dim),
                            n_heads=args.heads, depth=len(params["blocks"]),
                            max_len=int(params["pos_emb"].shape[0]))
        trained = torch.nn.utils.skip_init(TinyGPT, cfg)
        trained.load_state_dict(tiny_gpt_state_from_jax(params), strict=True)
        print(f"trained: {args.lm_ckpt}")
    else:
        from tinydiffusionmodels_torch.data import (
            CharTokenizer,
            load_text_corpus,
            tokenize_corpus,
        )
        from tinydiffusionmodels_torch.train.lm_train import train_lm

        corpus, source = load_text_corpus(args.data_root)
        if args.chars:
            corpus = corpus[:args.chars]
        tokenizer = CharTokenizer(corpus)
        cfg = TinyGPTConfig(vocab_size=tokenizer.vocab_size, dim=args.dim,
                            n_heads=args.heads, depth=args.depth,
                            max_len=args.seq_len + 1)
        chunks, _ = tokenize_corpus(corpus, tokenizer, args.seq_len + 1, 0.0)
        print(f"trained: {args.epochs} epochs on {len(corpus)} characters "
              f"({source} corpus)")
        trained = train_lm(chunks, cfg, epochs=args.epochs, seed=0,
                           device=device)
    random = TinyGPT(cfg, key=prng_key(0), device=device)
    return {"random": random.to(device).eval(),
            "trained": trained.to(device).eval()}


def main(argv=None) -> list[dict]:
    """Print and return one record per (weights, batch, draft): rounds run,
    whether the last changed nothing, and the limit."""
    from tinydiffusionmodels_torch import runtime
    from tinydiffusionmodels_torch.sample.guided import GuidedDecoder

    args = build_parser().parse_args(argv)
    device = runtime.device()
    max_rounds = args.max_rounds or args.seq_len + 1
    models = _models(args, device)
    cfg = models["random"].cfg
    print(f"# Jacobi verify rounds: vocab {cfg.vocab_size}, dim {cfg.dim}, "
          f"depth {cfg.depth}, L {args.seq_len}, alpha {ALPHA}, diffusion "
          f"logits N(0, 1), at most {max_rounds} rounds, on {device}")
    records = []
    for label, model in models.items():
        for b in args.batches:
            g = torch.Generator(device=device).manual_seed(7)
            diff = torch.randn((b, args.seq_len, cfg.vocab_size),
                               generator=g, device=device)
            for draft in DRAFTS:
                decoder = GuidedDecoder(model, b, args.seq_len, BOS,
                                        alpha=ALPHA, draft=draft)
                _, rounds = decoder(diff, return_rounds=True,
                                    max_rounds=max_rounds)
                record = {"params": label, "batch": b, "draft": draft,
                          "rounds": rounds, "converged": decoder.converged,
                          "max_rounds": max_rounds}
                records.append(record)
                verdict = (f"converged at round {rounds}"
                           if decoder.converged else
                           f"not converged within {rounds} rounds")
                print(f"params={label:7s} bs={b:3d} draft={draft:9s} "
                      f"{verdict}")
                del decoder
    return records


if __name__ == "__main__":
    main()
