"""Shakespeare text-diffusion CLI on PyTorch (port of
``tinydiffusionmodels_tpu.shakespeare``).

    python -m tinydiffusionmodels_torch.shakespeare --train --ckpt X.pth
    python -m tinydiffusionmodels_torch.shakespeare --sample --ckpt X.pth
    python -m tinydiffusionmodels_torch.shakespeare --guided_sample \
        --base_lm tinygpt --ckpt X.pth
    python -m tinydiffusionmodels_torch.shakespeare --guided_sample \
        --base_lm hf --model_id google/gemma-2b-it --ckpt X.pth

The parser is the port's own copy of the JAX CLI's (``build_parser``), so
every flag keeps its name, default and meaning. ``--train`` trains the
denoiser, rounding head and learned embeddings from modules initialized from
``--seed`` (``train/text_train.py``) and writes best and final checkpoints
in the JAX CLI's dict format; ``--train --sample`` then samples from the
trained weights. ``--sample`` alone reads a checkpoint the JAX CLI or the
port wrote and configures itself from it: parameterization, noise schedule,
positions, embedding norm, self-conditioning, width, depth and tokenizer,
plus the legacy bare-state-dict branch that decodes by cosine similarity.
``--guided_sample`` mixes a base LM's KV-cached greedy decode with the
diffusion logits of the sampled embeddings and writes
``guided_sample_{i}.txt``. Its base LM is the Hugging Face LM of
``--model_id`` (``--base_lm hf``, or ``auto`` when one loads): a Gemma
checkpoint runs as the port's own ``models.gemma.Gemma`` on the device, its
weights copied there once, with the KV-cached decode; any other causal LM
takes the reference's full-prefix torch loop (``_guided_with_torch_lm``).
Else it is TinyGPT (``--base_lm tinygpt``, or ``auto`` when no Hugging Face
LM loads), loaded from ``--lm_ckpt`` (the JAX CLI's format) or trained and
saved there when that file is missing or stale (another vocabulary, too
short a position table). It runs on the GPU
unless ``TDM_PLATFORM=cpu``; attention runs through the CUDA flash kernels
there, forward and backward. ``--train --dtype bf16`` trains in bf16
(``train/precision.py``: the parameters are cast inside the loss, the
masters, AdamW's state and the checkpoints stay f32). The guided decode
of TinyGPT or Gemma runs through a ``sample.guided.GuidedDecoder``
(``guided_decode``): on the card its whole scan is one CUDA graph,
replayed. ``--profile_dir DIR`` profiles the run with ``torch.profiler``
(``runtime.profile_trace``: ``DIR/trace.json`` and the per-op table
``DIR/ops.txt``). ``--train --resume`` writes the whole train state to
``<ckpt>_state.pth`` every ``--resume_every`` epochs and resumes from it
when it is there (``train/state.py``): the JAX CLI's file, so either CLI
resumes a run the other wrote.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
-m tinydiffusionmodels_torch.shakespeare --train ...``) each process takes
one GPU and ``--train`` is data-parallel over all of them, ``--batch_size``
the global batch (``parallel/``). ``--seq_parallel`` shards the token
sequence over a ring of every rank, ``--seq_parallel RING`` over rings of
RING ranks with the batch over the rest ({'data': N / RING, 'seq': RING});
attention is then ring attention on the flash kernels. The ring is
registered before training, so ``--sample`` in the same run samples
through it too. Only rank 0 writes checkpoints and samples.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
from torch.nn.utils import skip_init

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    # Reference surface (src/shakespeare.py:474-497).
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--sample", action="store_true",
                        help="plain diffusion sample")
    parser.add_argument("--guided_sample", action="store_true",
                        help="AR + diffusion guidance")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--seq_len", type=int, default=64)
    parser.add_argument(
        "--ckpt", type=str,
        default="gs://text-diffusion/diffusion/outputs/model/text-model.pth"
        if "AIP_MODEL_DIR" in os.environ
        else "text_ckpt.pth",
    )
    parser.add_argument("--model_id", type=str, default="google/gemma-2b-it")
    parser.add_argument("--n", type=int, default=10)
    parser.add_argument("--alpha", type=float, default=0.3)
    parser.add_argument("--rounding_weight", type=float, default=1.0,
                        help="Weight for learned rounding loss")
    parser.add_argument("--use_cosine_fallback", action="store_true",
                        help="Use cosine similarity instead of learned rounding")
    parser.add_argument("--use_learned_embeddings", action="store_true",
                        help="Use custom learned embedding space")
    parser.add_argument("--embed_dim", type=int, default=None,
                        help="Custom embedding dimension")
    parser.add_argument("--init_from_pretrained", action="store_true",
                        help="Initialize learned embeddings from pre-trained weights")
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--patience", type=int, default=5)
    parser.add_argument("--use_lr_scheduling", action="store_true", default=True)
    parser.add_argument("--warmup_steps", type=int, default=100)
    parser.add_argument("--val_split", type=float, default=0.1)
    parser.add_argument("--lr", type=float, default=1e-4)
    # Framework extensions.
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_root", type=str, default="./data")
    parser.add_argument("--sampler", type=str, default="ancestral",
                        choices=["ancestral", "ddim", "dpm++"])
    parser.add_argument("--steps", type=int, default=None,
                        help="sampler steps (ddim)")
    parser.add_argument("--base_lm", type=str, default="auto",
                        choices=["auto", "hf", "tinygpt"],
                        help="base LM for guided sampling")
    parser.add_argument("--lm_epochs", type=int, default=3,
                        help="TinyGPT base-LM training epochs (guided fallback)")
    parser.add_argument("--lm_ckpt", type=str, default="lm_ckpt.pth")
    parser.add_argument("--resume", action="store_true",
                        help="checkpoint full train state each epoch and "
                             "resume if present")
    parser.add_argument("--resume_every", type=int, default=1,
                        help="epochs between resume-state checkpoints")
    parser.add_argument("--clamp", action="store_true",
                        help="Diffusion-LM clamping trick: snap x0 to the "
                             "nearest embedding at every reverse step")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="guided-sampling logit temperature (the "
                             "reference hardcodes 1.0)")
    parser.add_argument("--parameterization", choices=["eps", "x0"],
                        default="eps",
                        help="denoiser output: eps (reference) or x0 "
                             "(original Diffusion-LM; samplers auto-detect "
                             "from the checkpoint)")
    parser.add_argument("--noise_schedule", choices=["linear", "cosine",
                        "sqrt"], default="linear",
                        help="beta schedule: linear (reference), cosine, or "
                             "sqrt (Diffusion-LM's text schedule; sampling "
                             "auto-detects from the checkpoint)")
    parser.add_argument("--embed_norm",
                        choices=["none", "rms", "zscore"],
                        default="none",
                        help="pin embedding rows to the unit-RMS noise "
                             "sphere during training/decoding (fixes the "
                             "Diffusion-LM embedding-scale collapse; "
                             "sampling auto-detects from the checkpoint)")
    parser.add_argument("--pos_emb", nargs="?", const="abs",
                        default="none", choices=["none", "abs", "rope"],
                        help="positional encoding in the denoiser (the "
                             "reference transformer has none and is "
                             "permutation-equivariant, "
                             "src/shakespeare.py:105-120): 'abs' = learned "
                             "absolute table (Diffusion-LM), 'rope' = "
                             "rotary relative (parameter-free; language "
                             "structure is translation-invariant); "
                             "sampling auto-detects from the checkpoint)")
    parser.add_argument("--freeze_embeddings", action="store_true",
                        help="train around a FIXED embedding table "
                             "(stop-gradient; Analog Bits/CDCD-style fixed "
                             "encodings — with --embed_norm zscore the "
                             "random init is near-orthogonal and immune to "
                             "scale collapse)")
    parser.add_argument("--self_cond", action="store_true",
                        help="self-conditioning: feed the previous x0 "
                             "estimate back into the denoiser (Analog Bits "
                             "style; samplers auto-detect from the "
                             "checkpoint)")
    parser.add_argument("--clamp_train", action="store_true",
                        help="clamp-aware training: add a straight-through "
                             "loss term against the nearest-embedding "
                             "clamped prediction the sampler uses "
                             "(requires --parameterization x0)")
    parser.add_argument("--anchor_ce", type=float, default=0.0,
                        help="weight of Diffusion-LM's anchor term: the "
                             "rounding head's CE on the PREDICTED x0, "
                             "gradient flowing into the denoiser so its "
                             "outputs are decodable (0 = off; designed "
                             "for --parameterization x0)")
    parser.add_argument("--depth", type=int, default=3,
                        help="denoiser encoder layers (reference hardcodes "
                             "3, src/shakespeare.py:106; sampling infers "
                             "depth from the checkpoint)")
    parser.add_argument("--ema_decay", type=float, default=None,
                        help="EMA of the joint weights (e.g. 0.999); "
                             "val/best/final checkpoints use the EMA "
                             "(framework extension)")
    parser.add_argument("--seq_parallel", nargs="?", const=-1, type=int,
                        default=None, metavar="RING",
                        help="sequence-parallel training: shard the token "
                             "sequence and route attention through the ring "
                             "(parallel/ring_attention). No value = ring "
                             "over ALL devices; an integer RING builds a "
                             "combined {'data': n/RING, 'seq': RING} mesh "
                             "(batch sharded AND ring attention)")
    parser.add_argument("--guidance_norm", action="store_true",
                        help="mix log-probabilities instead of raw logits in "
                             "guided sampling (framework extension; default "
                             "is exact reference mixing — see "
                             "sample.guided.mix_logits)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="capture a torch.profiler trace (trace.json) "
                             "and per-op table (ops.txt) to this directory")
    parser.add_argument("--metrics_path", type=str, default=None,
                        help="write per-epoch JSONL metrics here "
                             "(or set TDM_METRICS_PATH)")
    parser.add_argument("--dtype", type=str,
                        default=os.environ.get("TDM_DTYPE", "f32"),
                        choices=["f32", "bf16"],
                        help="compute dtype for the train step "
                             "(master params stay f32)")
    return parser


def _load_hf(model_id: str):
    """Try to load the HF tokenizer + embedding matrix (+ torch LM).

    Returns (tokenizer_adapter, pretrained_matrix, torch_lm) or
    (None, None, None) when unavailable. The reference always loads the full
    2B LM just for its embedding matrix (src/shakespeare.py:509-510); we do
    the same only when HF is actually reachable.
    """
    try:
        # Hermetic-first: only hit the network when explicitly allowed;
        # otherwise restrict to the local HF cache (fails fast offline).
        local_only = os.environ.get("TDM_ALLOW_DOWNLOADS") != "1"
        from transformers import AutoModelForCausalLM, AutoTokenizer  # type: ignore

        from tinydiffusionmodels_torch.data.tokenizer import HFTokenizerAdapter

        tok = AutoTokenizer.from_pretrained(model_id, local_files_only=local_only)
        lm = AutoModelForCausalLM.from_pretrained(
            model_id, local_files_only=local_only
        )
        matrix = lm.get_input_embeddings().weight.detach().cpu().numpy()
        return HFTokenizerAdapter(tok), matrix, lm
    except Exception as e:  # pragma: no cover - network/path dependent
        print(f"[hf] {model_id} unavailable ({type(e).__name__}); "
              "falling back to char tokenizer / TinyGPT base LM")
        return None, None, None


def _guided_with_torch_lm(lm, tokenizer, diff_logits_all, *, alpha,
                          temperature=1.0, return_tokens: bool = False):
    """Guided decode against a torch HF LM, the reference loop (src/
    shakespeare.py:445-470) with its no-KV-cache full-prefix forwards and
    raw logits mixed, kept for exact behavioral parity on the HF path of a
    model that is not a Gemma. The inputs go on the device of the LM's
    parameters. Returns the decoded texts; with ``return_tokens`` also the
    (B, L) int64 tokens."""
    dev = next(lm.parameters()).device
    diff = torch.as_tensor(diff_logits_all, device=dev)
    b, seq_len, _ = diff.shape
    bos = tokenizer.bos_token_id or tokenizer.eos_token_id
    input_ids = torch.full((b, 1), bos, dtype=torch.long, device=dev)
    with torch.no_grad():
        for pos in range(seq_len):
            ar_logits = lm(input_ids).logits[:, -1, :] / temperature
            mixed = (1 - alpha) * ar_logits + alpha * (
                diff[:, pos, :] / temperature
            )
            next_id = torch.argmax(mixed, dim=-1, keepdim=True)
            input_ids = torch.cat([input_ids, next_id], dim=1)
    tokens = input_ids[:, 1:]
    texts = tokenizer.batch_decode(tokens.cpu().numpy(),
                                   skip_special_tokens=True)
    return (texts, tokens) if return_tokens else texts


def guided_decode(lm, tokenizer, z: torch.Tensor, *, rounding=None,
                  embed_matrix=None, use_learned_rounding: bool = True,
                  alpha: float = 0.3, temperature: float = 1.0,
                  normalize: bool = False, save: bool = True) -> torch.Tensor:
    """The guided decode of the CLI's TinyGPT and Gemma base LMs: the
    diffusion logits of the sampled embeddings ``z`` (``rounding``, or
    cosine against ``embed_matrix``), then a ``GuidedDecoder`` of ``lm``
    for z's batch and length, the tokenizer's BOS and this mix (its scan
    one CUDA graph on the card, replayed), and ``guided_sample_{i}.txt``
    when ``save``. Returns the (B, L) int32 tokens."""
    from tinydiffusionmodels_torch.sample.guided import GuidedDecoder
    from tinydiffusionmodels_torch.sample.text import guided_sample_text

    decoder = GuidedDecoder(
        lm, z.shape[0], z.shape[1],
        tokenizer.bos_token_id or tokenizer.eos_token_id or 0,
        alpha=alpha, temperature=temperature, normalize=normalize)
    _, tokens = guided_sample_text(
        decoder, None, z, tokenizer, rounding=rounding,
        embed_matrix=embed_matrix, use_learned_rounding=use_learned_rounding,
        alpha=alpha, temperature=temperature, normalize=normalize,
        return_tokens=True, save=save,
    )
    return tokens


def main(argv=None):
    """Run the CLI. Returns the sampled (n, seq_len, dim) embeddings of
    ``--sample``, the (n, seq_len) int32 guided tokens of
    ``--guided_sample``, both as a pair when both are asked for, else the
    ``text_train.TrainResult`` of ``--train``."""
    args = build_parser().parse_args(argv)
    if not (args.train or args.sample or args.guided_sample):
        print("Nothing to do. Try --train or --guided_sample.")
        return None
    from tinydiffusionmodels_torch.runtime import profile_trace

    with profile_trace(args.profile_dir):
        return _run(args)


def _run(args):
    """``main`` past its argument checks."""
    from tinydiffusionmodels_torch.core import make_schedule, rng
    from tinydiffusionmodels_torch.core.schedule import DEFAULT_TIMESTEPS
    from tinydiffusionmodels_torch.data import (
        BPETokenizer,
        CharTokenizer,
        load_text_corpus,
        parse_bpe_spec,
        tokenize_corpus,
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
    from tinydiffusionmodels_torch.parallel import multihost
    from tinydiffusionmodels_torch.runtime import device
    from tinydiffusionmodels_torch.sample.text import sample_text

    dev = device()
    multihost.initialize()
    # Every draw is the JAX CLI's, from its key tree (core/rng.py), made on
    # the run's device: the initial weights from the substreams
    # "embedding", "diffusion" and "rounding" of PRNGKey(--seed), as the
    # JAX package's shakespeare.py draws them, then noise, masks and
    # dropout seeds.
    root = rng.prng_key(args.seed)

    # --- tokenizer / pretrained-matrix resolution -------------------------
    hf_tok, pretrained_matrix, torch_lm = None, None, None
    is_bpe = bool(args.model_id) and args.model_id.split(":")[0] == "bpe"
    if args.model_id and args.model_id != "char" and not is_bpe:
        hf_tok, pretrained_matrix, torch_lm = _load_hf(args.model_id)
    if args.guided_sample and args.base_lm == "hf" and torch_lm is None:
        raise SystemExit(
            f"--base_lm hf requested but {args.model_id} not loadable"
        )

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
    tokenizer_state = (
        tokenizer.state()
        if isinstance(tokenizer, (CharTokenizer, BPETokenizer)) else None
    )
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
            key=rng.substream(root, "embedding"), device=dev,
        )
        print(f"Using learned embeddings (dim={embed_dim}, "
              f"init_from_pretrained={args.init_from_pretrained})")
    else:
        embed_dim = pretrained_dim
        print(f"Using pre-trained embeddings (dim={embed_dim})")

    train_mesh, seq_axis = _parallel_mesh(args)
    main_rank = train_mesh is None or train_mesh.rank == 0
    cfg = TransformerConfig(
        dim=embed_dim, n_heads=4, depth=args.depth, dropout=args.dropout,
        timesteps=DEFAULT_TIMESTEPS, self_cond=args.self_cond,
        pos_emb=args.pos_emb, max_len=max(512, args.seq_len),
        seq_axis=seq_axis,
    )

    # --- train ------------------------------------------------------------
    result = None
    use_cosine_fallback = args.use_cosine_fallback
    if args.train:
        from tinydiffusionmodels_torch.train import text_train
        from tinydiffusionmodels_torch.train.precision import (
            resolve_compute_dtype,
        )

        joint = torch.nn.ModuleDict({
            "diffusion_model": TinyTransformer(
                cfg, key=rng.substream(root, "diffusion"), device=dev),
            "rounding_fn": LearnedRounding(
                embed_dim, vocab_size, key=rng.substream(root, "rounding"),
                device=dev),
        })
        if use_learned_embeddings:
            joint["embedding_fn"] = embedding
        joint.to(dev)
        train_chunks, val_chunks = tokenize_corpus(
            corpus, tokenizer, args.seq_len, args.val_split
        )
        print(f"Training on {len(train_chunks)} chunks, "
              f"validating on {len(val_chunks)} chunks")
        result = text_train.train(
            joint, train_chunks, val_chunks,
            sched=make_schedule(kind=args.noise_schedule, device=dev),
            ckpt_path=args.ckpt, epochs=args.epochs,
            batch_size=args.batch_size, lr=args.lr,
            weight_decay=args.weight_decay,
            rounding_weight=args.rounding_weight,
            use_learned_embeddings=use_learned_embeddings,
            pretrained_matrix=pretrained_matrix,
            patience=args.patience,
            use_lr_scheduling=args.use_lr_scheduling,
            warmup_steps=args.warmup_steps,
            seed=args.seed,
            tokenizer_state=tokenizer_state,
            metrics_path=args.metrics_path,
            ema_decay=args.ema_decay,
            parameterization=args.parameterization,
            clamp_train=args.clamp_train,
            noise_schedule=args.noise_schedule,
            embed_norm=args.embed_norm,
            freeze_embeddings=args.freeze_embeddings,
            anchor_ce=args.anchor_ce,
            compute_dtype=resolve_compute_dtype(args.dtype),
            mesh=train_mesh,
            resume=args.resume,
            resume_every=args.resume_every,
        )
        model = result.joint["diffusion_model"]
        rounding = result.joint["rounding_fn"]
        if use_learned_embeddings:
            embedding = result.joint["embedding_fn"]
    if not (args.sample or args.guided_sample):
        return result

    # --- checkpoint loading (sampling without --train) ---------------------
    if not args.train:
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
            rounding = skip_init(LearnedRounding, int(d_ckpt), int(v_ckpt))
            rounding.load_state_dict(state_from_checkpoint(rounding_sd))
            if use_learned_embeddings and "embedding_fn" in checkpoint:
                emb_sd = checkpoint["embedding_fn"]
                embedding = skip_init(
                    LearnedEmbedding, *np.shape(emb_sd["embeddings.weight"])
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
        model = skip_init(TinyTransformer, cfg)
        model.load_state_dict(state_from_checkpoint(diff_sd), strict=True)
    embed_dim = cfg.dim
    model.to(dev).eval()
    if seq_axis is not None:
        # Every rank of the ring samples the whole batch, each its positions
        # through the ring.
        from tinydiffusionmodels_torch.parallel import SequenceSharded

        model = SequenceSharded(model, train_mesh)
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
            embedding = LearnedEmbedding(
                vocab_size, embed_dim, key=rng.substream(root, "embedding"),
                device=dev)
        embed_matrix = embedding_matrix(
            embedding.embeddings.weight.detach().to(dev), norm=args.embed_norm
        )

    # --- plain sampling ---------------------------------------------------
    z = None
    if args.sample:
        _, z = sample_text(
            model, sched, tokenizer,
            rounding=rounding, embed_matrix=embed_matrix,
            n_samples=args.n, seq_len=args.seq_len, embed_dim=embed_dim,
            use_learned_rounding=not use_cosine_fallback,
            method=args.sampler, num_steps=args.steps, clamp=args.clamp,
            parameterization=args.parameterization,
            key=rng.substream(rng.prng_key(args.seed), "sample"),
            return_embeddings=True, save=main_rank,
        )
    if not args.guided_sample:
        return z

    # --- guided sampling --------------------------------------------------
    lm_choice = args.base_lm
    if lm_choice == "auto":
        lm_choice = "hf" if torch_lm is not None else "tinygpt"
    if lm_choice == "tinygpt":
        lm = _load_or_train_lm(args, vocab_size, corpus, tokenizer, dev,
                               save=main_rank)
    elif torch_lm.config.model_type == "gemma":
        from tinydiffusionmodels_torch.models.gemma import gemma_from_hf

        # The HF weights go to the device once; no fallback to the torch
        # loop when the conversion fails.
        lm = gemma_from_hf(torch_lm, max_len=max(args.seq_len + 1, 64),
                           device=dev)
        print("[lm] running Gemma natively (KV-cached decode)")
    else:
        lm = torch_lm.to(dev).eval()

    from tinydiffusionmodels_torch.sample.text import (
        diffusion_position_logits,
        sample_diffusion_embeddings,
        write_guided_samples,
    )

    # Unclamped, as the JAX CLI's guided draw; its key from --seed.
    z_guided = sample_diffusion_embeddings(
        model, sched, n=args.n, seq_len=args.seq_len, embed_dim=embed_dim,
        method=args.sampler, num_steps=args.steps,
        parameterization=args.parameterization,
        key=rng.substream(rng.prng_key(args.seed), "guided"),
    )
    heads = dict(rounding=rounding, embed_matrix=embed_matrix,
                 use_learned_rounding=not use_cosine_fallback)
    mix = dict(alpha=args.alpha, temperature=args.temperature)
    if lm is torch_lm:
        # Not a Gemma: the reference's full-prefix torch loop.
        texts, tokens = _guided_with_torch_lm(
            lm, tokenizer, diffusion_position_logits(z_guided, **heads),
            **mix, return_tokens=True)
        tokens = tokens.to(torch.int32)
        if main_rank:
            write_guided_samples(texts)
    else:
        tokens = guided_decode(lm, tokenizer, z_guided, **heads, **mix,
                               normalize=args.guidance_norm, save=main_rank)
    return tokens if z is None else (z, tokens)


def _parallel_mesh(args):
    """(training mesh, sequence axis) of the run: with ``--seq_parallel``
    a ring over every rank (a value RING: rings of RING ranks, the batch
    over the rest), registered for ``ops.attention`` here, before any
    training or sampling, with the JAX CLI's checks and its ``[parallel]``
    line; else, in a process group, every rank on 'data'; else (None,
    None)."""
    import torch.distributed as dist

    from tinydiffusionmodels_torch import ops
    from tinydiffusionmodels_torch.parallel import make_mesh

    if not args.seq_parallel:
        return (make_mesh() if dist.is_initialized() else None), None
    if args.seq_parallel == -1:
        mesh = make_mesh({"seq": -1})  # ring over every device
    else:
        mesh = make_mesh({"data": -1, "seq": args.seq_parallel})
    ops.register_sequence_mesh(mesh, "seq")
    if args.seq_len % mesh.shape["seq"]:
        raise SystemExit(
            f"--seq_parallel needs seq_len divisible by the ring size "
            f"{mesh.shape['seq']}"
        )
    dp = mesh.shape.get("data", 1)
    if args.batch_size % dp:
        raise SystemExit(
            f"--seq_parallel {args.seq_parallel}: batch_size "
            f"{args.batch_size} not divisible by the {dp}-way data axis"
        )
    if mesh.rank == 0:
        print(f"[parallel] sequence-parallel: ring({mesh.shape['seq']})"
              + (f" x dp({dp})" if dp > 1 else "") + " (ring attention)")
    return mesh, "seq"


def _load_or_train_lm(args, vocab_size: int, corpus: str, tokenizer, dev,
                      save: bool = True):
    """The guided sampler's TinyGPT base LM: ``--lm_ckpt`` when it holds an
    LM for this vocabulary with a long enough position table, else one
    trained for ``--lm_epochs`` on the corpus and saved there in the JAX
    CLI's format (``{"params": <JAX tree>}``)."""
    from tinydiffusionmodels_torch.data import tokenize_corpus
    from tinydiffusionmodels_torch.io import (
        load_checkpoint,
        save_checkpoint,
        tiny_gpt_params_dict,
        tiny_gpt_state_from_jax,
    )
    from tinydiffusionmodels_torch.models import TinyGPT, TinyGPTConfig

    lm_cfg = TinyGPTConfig(vocab_size=vocab_size, dim=256, n_heads=4,
                           depth=4, max_len=max(args.seq_len + 1, 64))
    if os.path.exists(args.lm_ckpt):
        try:
            params = load_checkpoint(args.lm_ckpt)["params"]
            # A cached LM trained under another tokenizer (char-54 vs
            # bpe-96, say) would crash, or silently misguide, in the mix.
            v_ckpt = int(np.shape(params["tok_emb"])[0])
            t_ckpt = int(np.shape(params["pos_emb"])[0])
            if v_ckpt != lm_cfg.vocab_size:
                raise ValueError(f"cached base-LM vocab {v_ckpt} != "
                                 f"tokenizer vocab {lm_cfg.vocab_size}")
            if t_ckpt < lm_cfg.max_len:
                raise ValueError(f"cached base-LM max_len {t_ckpt} < "
                                 f"required {lm_cfg.max_len}")
            lm = skip_init(TinyGPT, dataclasses.replace(lm_cfg,
                                                        max_len=t_ckpt))
            lm.load_state_dict(tiny_gpt_state_from_jax(params), strict=True)
            print(f"[lm] loaded TinyGPT from {args.lm_ckpt}")
            return lm.to(dev).eval()
        except Exception as e:
            print(f"[lm] could not load {args.lm_ckpt}: {e} — retraining")
    from tinydiffusionmodels_torch.train.lm_train import train_lm

    print(f"[lm] training TinyGPT base LM for {args.lm_epochs} epochs")
    train_chunks, _ = tokenize_corpus(corpus, tokenizer, args.seq_len + 1, 0.0)
    lm = train_lm(train_chunks, lm_cfg, epochs=args.lm_epochs, seed=args.seed,
                  device=dev)
    if save:
        save_checkpoint({"params": tiny_gpt_params_dict(lm)}, args.lm_ckpt)
    return lm


if __name__ == "__main__":
    main()
