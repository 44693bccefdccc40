"""Tokenizers: a hermetic char-level tokenizer plus an HF adapter.

The port's own copy of ``tinydiffusionmodels_tpu/data/tokenizer.py``; both
packages give the same ids and tokenizer state
(``tests/test_torch_package.py`` checks it).

The reference always loads an HF tokenizer + the full CausalLM
(src/shakespeare.py:508-512), even for training that only needs the
embedding matrix. Here the tokenizer is an interface:

- ``CharTokenizer``: deterministic char-level vocab built from the corpus,
  no downloads. The default in hermetic environments.
- ``HFTokenizerAdapter``: wraps a HuggingFace tokenizer when the model is
  available (cached or network-reachable), preserving the reference's
  ``--model_id`` surface.

``get_tokenizer(model_id, corpus)`` tries HF, falls back to chars.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np


class Tokenizer(Protocol):
    vocab_size: int
    bos_token_id: int | None
    eos_token_id: int | None

    def encode(self, text: str) -> np.ndarray: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def batch_decode(self, ids) -> list[str]: ...


class CharTokenizer:
    """Char-level tokenizer with a BOS token, vocab from the corpus."""

    BOS = "\x02"  # STX control char as BOS sentinel

    def __init__(self, corpus: str):
        chars = sorted(set(corpus))
        self._itos = [self.BOS] + chars
        self._stoi = {c: i for i, c in enumerate(self._itos)}
        self.vocab_size = len(self._itos)
        self.bos_token_id = 0
        self.eos_token_id = 0

    def encode(self, text: str) -> np.ndarray:
        return np.array(
            [self._stoi[c] for c in text if c in self._stoi], dtype=np.int64
        )

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(
            self._itos[int(i)]
            for i in ids
            if 0 < int(i) < self.vocab_size  # skip BOS/invalid
        )

    def batch_decode(self, ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row) for row in np.asarray(ids)]

    def state(self) -> dict:
        """Serializable vocab (stored in checkpoints for offline reload)."""
        return {"itos": "".join(self._itos[1:])}

    @classmethod
    def from_state(cls, state: dict) -> "CharTokenizer":
        tok = cls.__new__(cls)
        tok._itos = [cls.BOS] + list(state["itos"])
        tok._stoi = {c: i for i, c in enumerate(tok._itos)}
        tok.vocab_size = len(tok._itos)
        tok.bos_token_id = 0
        tok.eos_token_id = 0
        return tok


class BPETokenizer:
    """Hermetic byte-pair-encoding tokenizer trained on the corpus.

    Framework extension: the reference's only subword option is a gated HF
    tokenizer (src/shakespeare.py:508); this trains standard word-internal
    BPE merges locally (deterministic, no downloads), giving the text
    stack a subword operating point — the regime the original Diffusion-LM
    actually works in. Tokens are literal strings; a leading space is part
    of the token (GPT-2 style word boundary).
    """

    BOS_ID = 0

    def __init__(self, vocab: list[str], merges: list[tuple[str, str]]):
        self._itos = ["\x02"] + vocab
        self._stoi = {t: i for i, t in enumerate(self._itos)}
        self._ranks = {m: r for r, m in enumerate(merges)}
        self._merges = merges
        self._cache: dict[str, list[str]] = {}
        self.vocab_size = len(self._itos)
        self.bos_token_id = self.BOS_ID
        self.eos_token_id = self.BOS_ID

    # -- training ---------------------------------------------------------
    @classmethod
    def train(cls, corpus: str, vocab_size: int = 512) -> "BPETokenizer":
        import collections
        import re

        # \x02 is the reserved BOS string; a literal one in the corpus
        # would shadow the BOS row in _stoi. (\x00/\x01 no longer matter
        # for serialization — state() is JSON now — but strip them too so
        # vocab entries stay printable-ish.)
        corpus = corpus.translate({0: None, 1: None, 2: None})
        words = collections.Counter(re.findall(r"\s?\S+|\s+", corpus))
        # word -> tuple of symbols (chars initially)
        table = {w: tuple(w) for w in words}
        base = sorted({c for w in words for c in w})
        merges: list[tuple[str, str]] = []
        vocab = set(base)
        while len(vocab) + 1 < vocab_size:  # +1 for BOS
            pairs: collections.Counter = collections.Counter()
            for w, syms in table.items():
                n = words[w]
                for a, b in zip(syms, syms[1:]):
                    pairs[(a, b)] += n
            if not pairs:
                break
            # Deterministic: max count, ties broken lexicographically.
            (a, b), _ = max(
                pairs.items(), key=lambda kv: (kv[1], kv[0])
            )
            merges.append((a, b))
            vocab.add(a + b)
            new_table = {}
            for w, syms in table.items():
                out, i = [], 0
                while i < len(syms):
                    if (i + 1 < len(syms) and syms[i] == a
                            and syms[i + 1] == b):
                        out.append(a + b)
                        i += 2
                    else:
                        out.append(syms[i])
                        i += 1
                new_table[w] = tuple(out)
            table = new_table
        return cls(sorted(vocab), merges)

    # -- encode/decode ----------------------------------------------------
    def _bpe_word(self, word: str) -> list[str]:
        if word in self._cache:
            return self._cache[word]
        syms = list(word)
        while len(syms) > 1:
            best, best_rank, best_i = None, None, -1
            for i, pair in enumerate(zip(syms, syms[1:])):
                r = self._ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank, best_i = pair, r, i
            if best is None:
                break
            syms[best_i:best_i + 2] = [best[0] + best[1]]
        self._cache[word] = syms
        return syms

    def encode(self, text: str) -> np.ndarray:
        import re

        ids = []
        for word in re.findall(r"\s?\S+|\s+", text):
            for sym in self._bpe_word(word):
                i = self._stoi.get(sym)
                if i is None:  # unseen char: emit known chars one by one
                    ids.extend(
                        self._stoi[c] for c in sym if c in self._stoi
                    )
                else:
                    ids.append(i)
        return np.array(ids, dtype=np.int64)

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(
            self._itos[int(i)]
            for i in ids
            if 0 < int(i) < self.vocab_size
        )

    def batch_decode(self, ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row) for row in np.asarray(ids)]

    # -- checkpoint state -------------------------------------------------
    def state(self) -> dict:
        # JSON lists: safe for any corpus content (the legacy \x00/\x01
        # joined-string format silently corrupted on control characters).
        import json

        return {
            "kind": "bpe",
            "vocab": json.dumps(self._itos[1:]),
            "merges": json.dumps(self._merges),
        }

    @classmethod
    def from_state(cls, state: dict) -> "BPETokenizer":
        import json

        try:  # round-4+ JSON format
            vocab = json.loads(state["vocab"]) if state["vocab"] else []
            merges = [tuple(m) for m in json.loads(state["merges"])]
        except (json.JSONDecodeError, TypeError):
            # legacy (round-3 checkpoints): \x00-joined vocab,
            # \x00-joined "a\x01b" merge pairs
            vocab = state["vocab"].split("\x00") if state["vocab"] else []
            merges = [
                tuple(m.split("\x01"))
                for m in state["merges"].split("\x00")
                if m
            ]
        return cls(vocab, merges)


def tokenizer_from_state(state: dict):
    """Rebuild a checkpoint-stored tokenizer (kind-dispatched; legacy
    states without a 'kind' key are char vocabularies)."""
    if state.get("kind") == "bpe":
        return BPETokenizer.from_state(state)
    return CharTokenizer.from_state(state)


class HFTokenizerAdapter:
    """Thin adapter over a HuggingFace tokenizer."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.vocab_size = len(hf_tokenizer)
        self.bos_token_id = hf_tokenizer.bos_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id

    def encode(self, text: str) -> np.ndarray:
        ids = self._tok(
            text, add_special_tokens=False, return_attention_mask=False
        ).input_ids
        return np.asarray(ids, dtype=np.int64)

    def decode(self, ids) -> str:
        return self._tok.decode(list(map(int, ids)), skip_special_tokens=True)

    def batch_decode(self, ids, skip_special_tokens: bool = True) -> list[str]:
        return self._tok.batch_decode(
            np.asarray(ids), skip_special_tokens=skip_special_tokens
        )


def parse_bpe_spec(model_id: str) -> int:
    """Parse a ``bpe`` / ``bpe:VOCAB`` model-id into a vocab size, with a
    usable error message (shared by get_tokenizer and the shakespeare CLI).
    """
    parts = model_id.split(":")
    try:
        vocab = int(parts[1]) if len(parts) > 1 else 512
        if len(parts) > 2 or vocab < 2:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--model_id {model_id!r}: expected 'bpe' or 'bpe:VOCAB' with "
            "an integer VOCAB >= 2 (e.g. bpe:512)"
        )
    return vocab


def get_tokenizer(model_id: str | None, corpus: str):
    """Tokenizer for ``model_id``: 'char', 'bpe[:VOCAB]' (hermetic,
    trained on the corpus), or an HF id if loadable — falling back to
    chars. Returns (tokenizer, kind) with kind in {'hf', 'bpe', 'char'}.
    """
    if model_id and model_id.split(":")[0] == "bpe":
        vocab = parse_bpe_spec(model_id)
        return BPETokenizer.train(corpus, vocab), "bpe"
    if model_id and model_id != "char":
        try:
            from transformers import AutoTokenizer  # type: ignore

            return HFTokenizerAdapter(AutoTokenizer.from_pretrained(model_id)), "hf"
        except Exception:
            pass
    return CharTokenizer(corpus), "char"
