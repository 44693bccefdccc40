"""Guided AR + diffusion text generation (port of ``sample/guided.py``).

Rebuild of reference src/shakespeare.py:429-470: at each position, mix the
base LM's next-token logits with the diffusion-derived logits
(``mixed = (1-alpha)*ar + alpha*diff``) and take the greedy argmax.

The JAX package runs its decodes as single device programs: the KV-cached
scan over positions and the bf16 draft scan are ``lax.scan``s, the exact
decode's Jacobi verifier a ``lax.while_loop``. Here they are a
``GuidedDecoder``, which serves one configuration (base LM, batch, length,
mix, draft) from static device buffers. The base LM is a TinyGPT or a
Gemma (``models.gemma``): any model with ``cfg.vocab_size``, ``cfg.max_len``,
``init_cache`` and ``decode_step``; the bf16 and fused drafts take TinyGPT
alone. On the card each kind of work is
one CUDA graph (``graphs.Step``): the whole L-position scan, unrolled (the
decode step writes the cache in place at a Python-int position and reads
the filled prefix as a strided view, so the capture launches exactly the
eager kernels on the eager shapes), the fused draft's one kernel launch,
and one Jacobi round. A call copies the caller's logits into the static
buffer and replays; the verifier replays one round at a time and reads a
device "changed" flag (4 bytes) after each, as the JAX ``while_loop``
tests its condition on the device. On the CPU every step runs eagerly.

``guided_generate_scan`` and ``guided_generate_verified`` are the same
decodes as plain eager loops, one call each: the semantics the decoder's
replays are held against. ``guided_generate_verified`` is the exact decode:
a bf16 draft of all L tokens (the persistent CUDA kernel,
``ops.decode_kernel``, or a bf16 scan), refined by Jacobi iteration to the
greedy fixpoint of the f32 full-context forward.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch

from tinydiffusionmodels_torch import graphs
from tinydiffusionmodels_torch.models.ar_lm import TinyGPT
from tinydiffusionmodels_torch.ops.decode_kernel import (
    DecodeWeights,
    fused_guided_decode,
    pack_weights,
)

# (cache, token (B,)[, attn_len]) -> (logits (B, V), cache)
CachedDecodeFn = Callable[..., tuple[torch.Tensor, dict]]

DRAFTS = ("plain", "scan_bf16", "fused")


def _check_draft(draft: str) -> str:
    """``draft`` with "auto" resolved; ValueError for an unknown one."""
    if draft == "auto":
        draft = AUTO_DRAFT
    if draft not in DRAFTS:
        raise ValueError(f"unknown draft mode {draft!r}")
    return draft


def _bf16_copy(model):
    """The bf16 draft scan's copy of a TinyGPT; ValueError for another base
    LM (the bf16 scan serves TinyGPT alone, as in the JAX CLI)."""
    if not isinstance(model, TinyGPT):
        raise ValueError(f"the bf16 draft scan serves TinyGPT only; a "
                         f"{type(model).__name__} decodes with draft='plain'")
    return copy.deepcopy(model).to(torch.bfloat16)


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


def _scan_into(decode_step: CachedDecodeFn, cache: dict,
               diff_logits_all: torch.Tensor, token: torch.Tensor,
               out: torch.Tensor, *, alpha: float, temperature: float,
               normalize: bool, seg: int | None = None,
               upcast: bool = False) -> None:
    """The KV-cached greedy scan from ``token`` (B,): one ``decode_step`` a
    position, position p's token written to ``out[:, p]``. ``upcast`` mixes
    in f32 the logits of a low-precision model and its low-precision
    diffusion logits. No host read: the positions' shapes are fixed by the
    Python loop, so the scan is capturable as it stands."""
    seq_len = diff_logits_all.shape[1]
    for pos in range(seq_len):
        if seg is None or seg >= seq_len:
            logits, cache = decode_step(cache, token)
        else:
            attn_len = min((pos // seg + 1) * seg, seq_len)
            logits, cache = decode_step(cache, token, attn_len)
        diff = diff_logits_all[:, pos, :]
        if upcast:
            logits, diff = logits.float(), diff.float()
        mixed = mix_logits(logits, diff, alpha, temperature,
                           normalize=normalize)
        token = torch.argmax(mixed, dim=-1)
        out[:, pos] = token


def guided_generate_scan(decode_step: CachedDecodeFn, init_cache: dict,
                         diff_logits_all: torch.Tensor, bos_token: int, *,
                         alpha: float = 0.5, temperature: float = 1.0,
                         normalize: bool = False,
                         seg: int | None = None) -> torch.Tensor:
    """Generate (B, L) int32 token ids guided by per-position diffusion
    logits (B, L, V), one ``decode_step`` per position, eagerly.

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
    with torch.inference_mode():
        out = torch.empty((b, seq_len), dtype=torch.int32, device=token.device)
        _scan_into(decode_step, init_cache, diff_logits_all, token, out,
                   alpha=alpha, temperature=temperature, normalize=normalize,
                   seg=seg)
    return out


def _scan_bf16_draft(model16, diff_logits_all: torch.Tensor, bos_token: int,
                     *, alpha: float, temperature: float,
                     normalize: bool) -> torch.Tensor:
    """Draft decoder: the KV-cached scan with bf16 weights and a bf16 cache,
    its logits mixed in f32 with the bf16-rounded diffusion logits. Draft
    precision only; the verifier restores exactness."""
    b, seq_len, _ = diff_logits_all.shape
    with torch.inference_mode():
        token = torch.full((b,), int(bos_token), dtype=torch.long,
                           device=diff_logits_all.device)
        out = torch.empty((b, seq_len), dtype=torch.int32, device=token.device)
        _scan_into(model16.decode_step, model16.init_cache(b),
                   diff_logits_all.to(torch.bfloat16), token, out,
                   alpha=alpha, temperature=temperature, normalize=normalize,
                   upcast=True)
    return out


def _verify(model, bos: torch.Tensor, tokens: torch.Tensor,
            diff_logits_all: torch.Tensor, *, alpha: float,
            temperature: float, normalize: bool) -> torch.Tensor:
    """One Jacobi round: the exact per-position greedy tokens, (B, L)
    int32, of the f32 full-context forward with ``tokens`` as context after
    the (B, 1) ``bos`` column."""
    ar_all = model(torch.cat([bos, tokens[:, :-1].long()], dim=1))
    mixed = mix_logits(ar_all, diff_logits_all, alpha, temperature,
                       normalize=normalize)
    return torch.argmax(mixed, dim=-1).to(torch.int32)


# ``draft="auto"``: the plain f32 scan at every batch. The JAX package's
# rule (fused while the state fits TPU VMEM, else plain) measured a TPU. On
# the card, both replayed as CUDA graphs (``GuidedDecoder``;
# ``chip_smoke.py`` phase 27, TinyGPT V 4096, D 256, depth 4, L 64, an H100
# 80GB HBM3 at 700 W), the plain scan took 12.1 ms a call at batch 8 and
# 36.2 ms at batch 256, the fused draft with its Jacobi rounds 14.7 ms (13
# rounds of 0.53 ms) and 107.9 ms (18 of 5.2 ms): the scan is ahead at
# both, and device-bound at both, so no batch rule (the bench's replayed
# scan: 42.6k and 454.7k tokens/s).
AUTO_DRAFT = "plain"


def guided_generate_verified(model, diff_logits_all: torch.Tensor,
                             bos_token: int, *, alpha: float = 0.5,
                             temperature: float = 1.0,
                             normalize: bool = False, draft: str = "auto",
                             weights: DecodeWeights | None = None,
                             return_rounds: bool = False):
    """Exact greedy guided decode of a base LM ``model``, as eager loops
    (one call; ``GuidedDecoder`` replays the same decode). A model other
    than TinyGPT takes ``"plain"`` (or ``"auto"``) alone: ValueError else.

    ``draft`` selects the implementation:

    - ``"fused"``: the persistent guided-decode kernel drafts all L tokens
      in one launch (``ops.decode_kernel``; its plain version on the CPU),
      then the Jacobi verifier below refines them to the f32 fixpoint;
    - ``"scan_bf16"``: a KV-cached scan with bf16 weights and cache drafts,
      with the same refinement;
    - ``"plain"``: the f32 KV-cached scan (``guided_generate_scan``), exact
      greedy by construction, with no verification;
    - ``"auto"``: ``AUTO_DRAFT``, the plain scan (measured on the card).

    ``weights``: the fused draft's bf16 weights, ``ops.decode_kernel.
    pack_weights(model)``, for a caller that decodes many batches with one
    model; packed from ``model`` on each call when None.

    Jacobi verification: ``tokens <- verify(tokens)`` until unchanged,
    where ``verify`` is one full-context f32 forward recomputing every
    position's mixed greedy token with the current tokens as context. The
    agreed prefix grows by at least one per round, so it ends within L
    rounds. The loop reads one boolean on the host per round (the JAX
    package's ``while_loop`` tests the same on the device).

    Returns (B, L) int32 tokens: the greedy FIXPOINT of the f32 full-context
    forward, token p = argmax(mix(logits(prefix_p))), the graph the
    reference runs per token (src/shakespeare.py:445-470). With
    ``return_rounds`` also the number of verify forwards run (0 for
    ``"plain"``).
    """
    b = diff_logits_all.shape[0]
    draft = _check_draft(draft)
    mix = dict(alpha=alpha, temperature=temperature, normalize=normalize)
    if draft == "plain":
        tokens = guided_generate_scan(
            model.decode_step, model.init_cache(b), diff_logits_all,
            bos_token, **mix)
        return (tokens, 0) if return_rounds else tokens

    bos = torch.full((b, 1), int(bos_token), dtype=torch.long,
                     device=diff_logits_all.device)
    with torch.inference_mode():
        if draft == "scan_bf16":
            tokens = _scan_bf16_draft(_bf16_copy(model), diff_logits_all,
                                      bos_token, **mix)
        else:
            tokens = fused_guided_decode(
                model if weights is None else weights, diff_logits_all,
                bos_token, **mix)
        exact = _verify(model, bos, tokens, diff_logits_all, **mix)
        rounds = 1
        while bool((tokens != exact).any()):
            tokens, exact = exact, _verify(model, bos, exact,
                                           diff_logits_all, **mix)
            rounds += 1
    return (tokens, rounds) if return_rounds else tokens


class GuidedDecoder:
    """The greedy guided decode of one configuration, run as often as
    called: a base LM ``model`` (TinyGPT, or any model with
    ``cfg.vocab_size``, ``cfg.max_len``, ``init_cache`` and ``decode_step``,
    such as ``models.gemma.Gemma``, whose draft is ``"plain"``), ``batch``
    rows of ``seq_len`` tokens after ``bos_token``, the mix (``alpha``,
    ``temperature``, ``normalize``) and the ``draft`` (as
    ``guided_generate_verified``'s; ValueError for a bf16 or fused draft of
    a model other than TinyGPT). The device is that of the model's
    parameters.

    It holds static device buffers (the (B, L, V) diffusion logits, the KV
    cache, the BOS column, the tokens, a round counter and a "changed"
    flag), the draft's bf16 copy of the model or its packed
    ``DecodeWeights`` (``weights``, packed from ``model`` when None), both
    made once, and one ``graphs.Step`` per kind of work:

    - ``"plain"``: the f32 scan, all L positions unrolled in one graph;
    - ``"scan_bf16"``: the bf16 scan, likewise, then Jacobi rounds;
    - ``"fused"``: the decode kernel's one launch, then Jacobi rounds.

    A Jacobi round (``verify_round``) is one graph: the f32 full-context
    forward, the mix and argmax, the comparison with the current tokens
    into the flag, the swap and the count; the host reads the flag after
    each replay. A finished fixpoint is stable, so the decode equals
    ``guided_generate_verified``'s, tokens and rounds, bit for bit.

    On the card each step's first call primes it on a side stream with a
    sliver of real work (one decode position, one verify forward, the
    kernel on one position: the lazy set-up of cuBLAS and the kernel
    library), captures it and replays it, so the first call already
    replays, and every later one; the graphs live as long as the decoder.
    A failed capture raises. On the CPU every step runs eagerly.
    """

    def __init__(self, model, batch: int, seq_len: int, bos_token: int, *,
                 alpha: float = 0.5, temperature: float = 1.0,
                 normalize: bool = False, draft: str = "plain",
                 weights: DecodeWeights | None = None):
        draft = _check_draft(draft)
        cfg = model.cfg
        if batch < 1 or not 1 <= seq_len <= cfg.max_len:
            raise ValueError(f"batch {batch}, length {seq_len}: the model "
                             f"decodes 1..{cfg.max_len} positions")
        if not 0 <= int(bos_token) < cfg.vocab_size:
            raise ValueError(f"bos token {bos_token} outside the vocab of "
                             f"{cfg.vocab_size}")
        self.model, self.draft = model, draft
        self.bos_token = int(bos_token)
        self.mix = dict(alpha=float(alpha), temperature=float(temperature),
                        normalize=bool(normalize))
        self.device = device = next(model.parameters()).device
        self.converged = True
        with torch.inference_mode():
            self.diff = torch.zeros((batch, seq_len, cfg.vocab_size),
                                    device=device)
            self.bos = torch.full((batch, 1), self.bos_token,
                                  dtype=torch.long, device=device)
            self.tokens = torch.zeros((batch, seq_len), dtype=torch.int32,
                                      device=device)
            self.rounds = torch.zeros((), dtype=torch.int32, device=device)
            self.changed = torch.zeros((), dtype=torch.bool, device=device)
            if draft == "fused":
                self.weights = pack_weights(model) if weights is None \
                    else weights
                self.draft_step = self._step(self._fused, self._fused_prime)
            else:
                lm = model
                if draft == "scan_bf16":
                    lm = self.model16 = _bf16_copy(model)
                self.cache = lm.init_cache(batch)
                self.draft_step = self._step(self._scan, self._scan_prime)
            self.round_step = self._step(self._round, self._round_prime)

    def _step(self, fn, prime) -> graphs.Step:
        return graphs.Step(fn, self.device, warmup=0, prime=prime)

    @property
    def _lm(self):
        return self.model16 if self.draft == "scan_bf16" else self.model

    def _scan(self) -> None:
        """All L positions into ``tokens`` (the slots of the cache that a
        position reads were written earlier in the same scan, so the cache
        needs no zeroing between calls)."""
        diff = self.diff
        if self.draft == "scan_bf16":
            diff = diff.to(torch.bfloat16)
        _scan_into(self._lm.decode_step, self.cache, diff, self.bos[:, 0],
                   self.tokens, upcast=self.draft == "scan_bf16", **self.mix)

    def _scan_prime(self) -> None:
        self._lm.decode_step(self.cache, self.bos[:, 0])

    def _fused(self) -> None:
        self.tokens.copy_(fused_guided_decode(self.weights, self.diff,
                                              self.bos_token, **self.mix))

    def _fused_prime(self) -> None:
        fused_guided_decode(self.weights, self.diff[:, :1], self.bos_token,
                            **self.mix)

    def _round(self) -> None:
        exact = _verify(self.model, self.bos, self.tokens, self.diff,
                        **self.mix)
        self.changed.copy_((exact != self.tokens).any())
        self.tokens.copy_(exact)
        self.rounds.add_(1)

    def _round_prime(self) -> None:
        _verify(self.model, self.bos, self.tokens, self.diff, **self.mix)

    def verify_round(self) -> bool:
        """One Jacobi round on the current tokens; whether it changed any
        (one 1-byte read of the device flag)."""
        with torch.inference_mode():
            self.round_step()
            return bool(self.changed)

    def __call__(self, diff_logits_all: torch.Tensor, *,
                 return_rounds: bool = False,
                 max_rounds: int | None = None):
        """(B, L) int32 tokens of the decode of ``diff_logits_all`` (B, L,
        V), a new tensor; with ``return_rounds`` also the Jacobi rounds run
        (0 for ``"plain"``). ``max_rounds`` stops the verifier after that
        many rounds; ``converged`` then says whether the last one changed
        nothing (the tokens are the fixpoint) or not."""
        if tuple(diff_logits_all.shape) != tuple(self.diff.shape):
            raise ValueError(f"diffusion logits {tuple(diff_logits_all.shape)}"
                             f", the decoder serves {tuple(self.diff.shape)}")
        with torch.inference_mode():
            self.diff.copy_(diff_logits_all)
            self.draft_step()
            self.converged = True
            if self.draft != "plain":
                self.rounds.zero_()
                run = 1
                while self.verify_round():
                    if max_rounds is not None and run >= max_rounds:
                        self.converged = False
                        break
                    run += 1
            tokens = self.tokens.clone()
        if not return_rounds:
            return tokens
        return tokens, 0 if self.draft == "plain" else int(self.rounds)
