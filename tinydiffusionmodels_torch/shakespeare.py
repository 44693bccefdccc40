"""Shakespeare text-diffusion CLI on PyTorch (port of the ``--sample`` path
of ``tinydiffusionmodels_tpu.shakespeare``).

    python -m tinydiffusionmodels_torch.shakespeare --sample --ckpt X.pth

The parser is the JAX CLI's own (``build_parser``), so every flag keeps its
name and meaning. ``--sample`` reads a checkpoint the JAX CLI (or
``io.convert.text_checkpoint_dict``) wrote and configures itself from it:
parameterization, noise schedule, positions, embedding norm,
self-conditioning, width, depth and tokenizer, plus the legacy bare-state-
dict branch that decodes by cosine similarity. It runs on the GPU unless
``TDM_PLATFORM=cpu``; attention runs through the CUDA flash kernel there.
``--train`` and ``--guided_sample`` are not yet ported and exit non-zero.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tinydiffusionmodels_tpu.shakespeare import _load_hf, build_parser

_NOT_PORTED = "is not yet ported to the torch package; use python -m " \
    "tinydiffusionmodels_tpu.shakespeare"


def main(argv=None) -> torch.Tensor | None:
    """Run the CLI; returns the sampled (n, seq_len, dim) embeddings."""
    args = build_parser().parse_args(argv)
    if not (args.train or args.sample or args.guided_sample):
        print("Nothing to do. Try --train or --guided_sample.")
        return None
    for flag, given in (("--train", args.train),
                        ("--guided_sample", args.guided_sample),
                        ("--seq_parallel", args.seq_parallel),
                        ("--profile_dir", args.profile_dir)):
        if given:
            raise SystemExit(f"{flag} {_NOT_PORTED}")

    from tinydiffusionmodels_torch.core import make_schedule
    from tinydiffusionmodels_torch.core.schedule import DEFAULT_TIMESTEPS
    from tinydiffusionmodels_torch.data import (
        BPETokenizer,
        CharTokenizer,
        load_text_corpus,
        parse_bpe_spec,
        tokenizer_from_state,
    )
    from tinydiffusionmodels_torch.io import (
        config_from_state_dict,
        load_checkpoint,
        state_from_checkpoint,
    )
    from tinydiffusionmodels_torch.models import (
        LearnedEmbedding,
        LearnedRounding,
        TinyTransformer,
        TransformerConfig,
        embedding_matrix,
    )
    from tinydiffusionmodels_torch.runtime import device
    from tinydiffusionmodels_torch.sample.text import sample_text

    dev = device()
    # Parameters are drawn on the CPU so a seed gives the same weights on
    # every device; sampling noise is drawn on the device.
    init_gen = torch.Generator().manual_seed(args.seed)

    # --- tokenizer / pretrained-matrix resolution -------------------------
    hf_tok, pretrained_matrix = None, None
    is_bpe = bool(args.model_id) and args.model_id.split(":")[0] == "bpe"
    if args.model_id and args.model_id != "char" and not is_bpe:
        hf_tok, pretrained_matrix, _ = _load_hf(args.model_id)

    corpus, corpus_source = load_text_corpus(args.data_root)
    if corpus_source == "builtin":
        print("[data] tiny_shakespeare unavailable -> built-in fallback corpus")
    data_limit = int(os.environ.get("TDM_DATA_LIMIT", "0"))
    if data_limit:
        corpus = corpus[:data_limit]
    if hf_tok is not None:
        tokenizer = hf_tok
    elif is_bpe:
        tokenizer = BPETokenizer.train(corpus, parse_bpe_spec(args.model_id))
        print(f"[tok] trained corpus BPE (vocab={tokenizer.vocab_size})")
    else:
        tokenizer = CharTokenizer(corpus)
    vocab_size = tokenizer.vocab_size

    use_learned_embeddings = args.use_learned_embeddings
    if pretrained_matrix is None:
        if not use_learned_embeddings:
            print("[cfg] no pretrained embedding matrix available -> "
                  "forcing --use_learned_embeddings")
            use_learned_embeddings = True
        pretrained_dim = None
    else:
        vocab_size = pretrained_matrix.shape[0]
        pretrained_dim = pretrained_matrix.shape[1]

    embedding = None
    if use_learned_embeddings:
        embed_dim = args.embed_dim or pretrained_dim or 256
        embedding = LearnedEmbedding(
            vocab_size, embed_dim,
            pretrained=(pretrained_matrix if args.init_from_pretrained
                        else None),
            generator=init_gen,
        )
        print(f"Using learned embeddings (dim={embed_dim}, "
              f"init_from_pretrained={args.init_from_pretrained})")
    else:
        embed_dim = pretrained_dim
        print(f"Using pre-trained embeddings (dim={embed_dim})")

    cfg = TransformerConfig(
        dim=embed_dim, n_heads=4, depth=args.depth, dropout=args.dropout,
        timesteps=DEFAULT_TIMESTEPS, self_cond=args.self_cond,
        pos_emb=args.pos_emb, max_len=max(512, args.seq_len),
    )

    # --- checkpoint loading -----------------------------------------------
    use_cosine_fallback = args.use_cosine_fallback
    checkpoint = load_checkpoint(args.ckpt)
    is_dict = isinstance(checkpoint, dict)
    if is_dict and "parameterization" in checkpoint:
        if checkpoint["parameterization"] != args.parameterization:
            print(f"[ckpt] parameterization="
                  f"{checkpoint['parameterization']} (from checkpoint)")
        args.parameterization = checkpoint["parameterization"]
    if is_dict and "noise_schedule" in checkpoint:
        if checkpoint["noise_schedule"] != args.noise_schedule:
            print(f"[ckpt] noise_schedule="
                  f"{checkpoint['noise_schedule']} (from checkpoint)")
            args.noise_schedule = checkpoint["noise_schedule"]
    if is_dict and "pos_emb" in checkpoint:
        if checkpoint["pos_emb"] != args.pos_emb:
            print(f"[ckpt] pos_emb={checkpoint['pos_emb']} "
                  "(from checkpoint)")
        args.pos_emb = checkpoint["pos_emb"]
        cfg = dataclasses.replace(cfg, pos_emb=args.pos_emb)
    if is_dict and "embed_norm" in checkpoint:
        if checkpoint["embed_norm"] != args.embed_norm:
            print(f"[ckpt] embed_norm={checkpoint['embed_norm']} "
                  "(from checkpoint)")
        args.embed_norm = checkpoint["embed_norm"]
    if is_dict:
        ckpt_sc = bool(checkpoint.get("self_cond")) or (
            isinstance(checkpoint.get("diffusion_model"), dict)
            and "selfcond_proj.weight" in checkpoint["diffusion_model"]
        )
        if ckpt_sc != cfg.self_cond:
            print(f"[ckpt] self_cond={ckpt_sc} (from checkpoint)")
            cfg = dataclasses.replace(cfg, self_cond=ckpt_sc)
    if is_dict and "rounding_fn" in checkpoint:
        ckpt_dim = int(
            np.asarray(checkpoint["rounding_fn"]["decoder.weight"]).shape[1]
        )
        if ckpt_dim != embed_dim:
            print(f"[ckpt] embed_dim={ckpt_dim} (from checkpoint)")
            embed_dim = ckpt_dim
            cfg = dataclasses.replace(cfg, dim=ckpt_dim)

    if is_dict and "diffusion_model" in checkpoint:
        diff_sd = checkpoint["diffusion_model"]
        rounding_sd = checkpoint["rounding_fn"]
        v_ckpt, d_ckpt = np.shape(rounding_sd["decoder.weight"])
        rounding = LearnedRounding(int(d_ckpt), int(v_ckpt))
        rounding.load_state_dict(state_from_checkpoint(rounding_sd))
        if use_learned_embeddings and "embedding_fn" in checkpoint:
            emb_sd = checkpoint["embedding_fn"]
            embedding = LearnedEmbedding(
                *np.shape(emb_sd["embeddings.weight"])
            )
            embedding.load_state_dict(state_from_checkpoint(emb_sd))
        elif use_learned_embeddings:
            print("Warning: Learned embeddings requested but not found in "
                  "checkpoint. Using pre-trained fallback.")
            use_learned_embeddings = False
        if "tokenizer" in checkpoint and hf_tok is None:
            tokenizer = tokenizer_from_state(checkpoint["tokenizer"])
            if tokenizer.vocab_size != vocab_size:
                print(f"[ckpt] vocab_size={tokenizer.vocab_size} "
                      "(from checkpoint tokenizer)")
                vocab_size = tokenizer.vocab_size
    else:
        # Old single-model checkpoint (reference src/shakespeare.py:556-562).
        diff_sd = checkpoint
        rounding = None
        print("Warning: Using old checkpoint format. Falling back to "
              "pre-trained embeddings and cosine similarity.")
        use_cosine_fallback = True
        use_learned_embeddings = False

    cfg = config_from_state_dict(diff_sd, cfg)
    embed_dim = cfg.dim
    model = TinyTransformer(cfg)
    model.load_state_dict(state_from_checkpoint(diff_sd), strict=True)
    model.to(dev).eval()
    if rounding is not None:
        rounding.to(dev).eval()
    sched = make_schedule(kind=args.noise_schedule, device=dev)

    embed_matrix = None
    if use_learned_embeddings:
        embed_matrix = embedding_matrix(
            embedding.embeddings.weight.detach().to(dev), norm=args.embed_norm
        )
    elif pretrained_matrix is not None:
        embed_matrix = embedding_matrix(
            torch.as_tensor(np.asarray(pretrained_matrix), dtype=torch.float32,
                            device=dev),
            norm=args.embed_norm,
        )
    elif embedding is not None:
        # Legacy checkpoint + no HF matrix (hermetic env): the only usable
        # decoding space is the freshly initialized learned embedding.
        print("Warning: no pre-trained embedding matrix available; cosine "
              "decoding will use randomly-initialized embeddings.")
        if embedding.embeddings.weight.shape[1] != embed_dim:
            embedding = LearnedEmbedding(vocab_size, embed_dim,
                                         generator=init_gen)
        embed_matrix = embedding_matrix(
            embedding.embeddings.weight.detach().to(dev), norm=args.embed_norm
        )

    # --- plain sampling ---------------------------------------------------
    sample_gen = torch.Generator(device=dev).manual_seed(args.seed)
    _, z = sample_text(
        model, sched, tokenizer,
        rounding=rounding, embed_matrix=embed_matrix,
        n_samples=args.n, seq_len=args.seq_len, embed_dim=embed_dim,
        use_learned_rounding=not use_cosine_fallback,
        method=args.sampler, num_steps=args.steps, clamp=args.clamp,
        parameterization=args.parameterization,
        generator=sample_gen, return_embeddings=True,
    )
    return z


if __name__ == "__main__":
    main()
