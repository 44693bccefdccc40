"""Guided AR + diffusion text generation (port of ``sample/guided.py``).

Rebuild of reference src/shakespeare.py:429-470: at each position, mix the
base LM's next-token logits with the diffusion-derived logits
(``mixed = (1-alpha)*ar + alpha*diff``) and take the greedy argmax.

The JAX package's ``lax.scan`` over positions is a Python loop here, one
KV-cached decode step per position with no host read inside it: the tokens
stay on the device until the caller reads them. ``guided_generate_verified``
is the exact decode: a bf16 draft of all L tokens (the persistent CUDA
kernel, ``ops.decode_kernel``, or a bf16 scan), refined by Jacobi iteration
to the greedy fixpoint of the f32 full-context forward.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from tinydiffusionmodels_torch.ops.decode_kernel import (
    DecodeWeights,
    fused_guided_decode,
)

# (cache, token (B,)[, attn_len]) -> (logits (B, V), cache)
CachedDecodeFn = Callable[..., tuple[torch.Tensor, dict]]


def mix_logits(ar_logits: torch.Tensor, diff_logits: torch.Tensor,
               alpha: float, temperature: float = 1.0, *,
               normalize: bool = False) -> torch.Tensor:
    """Reference mixing rule (src/shakespeare.py:449,454,466).

    ``normalize=False`` mixes raw logits (exact reference behavior);
    ``normalize=True`` mixes probabilities, (1-alpha)*p_ar + alpha*p_diff,
    and returns its log (a linear opinion pool: either head's influence is
    bounded by its mixture weight whatever its logit scale)."""
    a = ar_logits / temperature
    d = diff_logits / temperature
    if normalize:
        mix = (1.0 - alpha) * torch.softmax(a, dim=-1) + alpha * torch.softmax(
            d, dim=-1)
        return torch.log(mix + 1e-20)
    return (1.0 - alpha) * a + alpha * d


def guided_generate_scan(decode_step: CachedDecodeFn, init_cache: dict,
                         diff_logits_all: torch.Tensor, bos_token: int, *,
                         alpha: float = 0.5, temperature: float = 1.0,
                         normalize: bool = False,
                         seg: int | None = None) -> torch.Tensor:
    """Generate (B, L) int32 token ids guided by per-position diffusion
    logits (B, L, V), one ``decode_step`` per position.

    ``seg``: positions run in segments of ``seg``; within segment s the step
    is called as ``decode_step(cache, token, attn_len=(s+1)*seg)``, the JAX
    package's growing attention window. The port's decode step always
    attends to the filled prefix, so ``seg`` changes no result; it is kept
    for parity with the JAX signature, and the port's callers leave it
    None. Ties take the lowest index (``torch.argmax`` returns the first
    maximum, as ``jnp.argmax``)."""
    b, seq_len, _ = diff_logits_all.shape
    token = torch.full((b,), int(bos_token), dtype=torch.long,
                       device=diff_logits_all.device)
    cache = init_cache
    out = []
    with torch.inference_mode():
        for pos in range(seq_len):
            if seg is None or seg >= seq_len:
                logits, cache = decode_step(cache, token)
            else:
                attn_len = min((pos // seg + 1) * seg, seq_len)
                logits, cache = decode_step(cache, token, attn_len)
            mixed = mix_logits(logits, diff_logits_all[:, pos, :], alpha,
                               temperature, normalize=normalize)
            token = torch.argmax(mixed, dim=-1)
            out.append(token)
    return torch.stack(out, dim=1).to(torch.int32)


def _scan_bf16_draft(model16, diff_logits_all: torch.Tensor, bos_token: int,
                     *, alpha: float, temperature: float,
                     normalize: bool) -> torch.Tensor:
    """Draft decoder: the KV-cached scan with bf16 weights and a bf16 cache,
    its logits mixed in f32 with the bf16-rounded diffusion logits. Draft
    precision only; the verifier restores exactness."""
    b, seq_len, _ = diff_logits_all.shape
    diff16 = diff_logits_all.to(torch.bfloat16)
    token = torch.full((b,), int(bos_token), dtype=torch.long,
                       device=diff16.device)
    cache = model16.init_cache(b)
    out = []
    with torch.inference_mode():
        for pos in range(seq_len):
            logits, cache = model16.decode_step(cache, token)
            mixed = mix_logits(logits.float(), diff16[:, pos, :].float(),
                               alpha, temperature, normalize=normalize)
            token = torch.argmax(mixed, dim=-1)
            out.append(token)
    return torch.stack(out, dim=1).to(torch.int32)


def guided_generate_verified(model, diff_logits_all: torch.Tensor,
                             bos_token: int, *, alpha: float = 0.5,
                             temperature: float = 1.0,
                             normalize: bool = False, draft: str = "auto",
                             weights: DecodeWeights | None = None,
                             return_rounds: bool = False):
    """Exact greedy guided decode of a TinyGPT ``model``.

    ``draft`` selects the implementation:

    - ``"fused"``: the persistent guided-decode kernel drafts all L tokens
      in one launch (``ops.decode_kernel``; its plain version on the CPU),
      then the Jacobi verifier below refines them to the f32 fixpoint;
    - ``"scan_bf16"``: a KV-cached scan with bf16 weights and cache drafts,
      with the same refinement;
    - ``"plain"``: the f32 KV-cached scan (``guided_generate_scan``), exact
      greedy by construction, with no verification;
    - ``"auto"``: ``"fused"`` at every batch. The JAX package's rule
      (fused while the state fits TPU VMEM, else plain) measured a TPU.
      The port's bench (``python -m tinydiffusionmodels_torch.bench``,
      an H100 80GB HBM3 at 700 W) measured the fused draft with
      verification far ahead of the plain scan at batch 8 (16.1k against
      5.7k tokens/s) and the two inside each other's envelopes at batch
      256 (143.8k-146.1k against 144.6k-174.7k): no batch where the scan
      is faster beyond the noise, so no batch rule.

    ``weights``: the fused draft's bf16 weights, ``ops.decode_kernel.
    pack_weights(model)``, for a caller that decodes many batches with one
    model; packed from ``model`` on each call when None.

    Jacobi verification: ``tokens <- verify(tokens)`` until unchanged,
    where ``verify`` is one full-context f32 forward recomputing every
    position's mixed greedy token with the current tokens as context. The
    agreed prefix grows by at least one per round, so it ends within L
    rounds. The loop reads one boolean on the host per round (the JAX
    package's ``while_loop`` tests the same on the device).

    Returns (B, L) int32 tokens: the greedy FIXPOINT of the f32
    full-context forward, token p = argmax(mix(logits(prefix_p))), the graph
    the reference runs per token (src/shakespeare.py:445-470). With
    ``return_rounds`` also the number of verify forwards run (0 for
    ``"plain"``).
    """
    b = diff_logits_all.shape[0]
    if draft == "auto":
        draft = "fused"
    if draft not in ("plain", "scan_bf16", "fused"):
        raise ValueError(f"unknown draft mode {draft!r}")
    if draft == "plain":
        tokens = guided_generate_scan(
            model.decode_step, model.init_cache(b), diff_logits_all,
            bos_token, alpha=alpha, temperature=temperature,
            normalize=normalize)
        return (tokens, 0) if return_rounds else tokens

    bos = torch.full((b, 1), int(bos_token), dtype=torch.long,
                     device=diff_logits_all.device)

    def verify(toks: torch.Tensor) -> torch.Tensor:
        """Exact per-position greedy tokens given ``toks`` as context."""
        ar_all = model(torch.cat([bos, toks[:, :-1].long()], dim=1))
        mixed = mix_logits(ar_all, diff_logits_all, alpha, temperature,
                           normalize=normalize)
        return torch.argmax(mixed, dim=-1).to(torch.int32)

    with torch.inference_mode():
        if draft == "scan_bf16":
            tokens = _scan_bf16_draft(
                copy.deepcopy(model).to(torch.bfloat16), diff_logits_all,
                bos_token, alpha=alpha, temperature=temperature,
                normalize=normalize)
        else:
            tokens = fused_guided_decode(
                model if weights is None else weights, diff_logits_all,
                bos_token, alpha=alpha,
                temperature=temperature, normalize=normalize)
        exact = verify(tokens)
        rounds = 1
        while bool((tokens != exact).any()):
            tokens, exact = exact, verify(exact)
            rounds += 1
    return (tokens, rounds) if return_rounds else tokens
