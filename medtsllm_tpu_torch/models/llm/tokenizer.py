"""Tokenizer resolution (port of medtsllm_tpu/models/llm/tokenizer.py).

Copied whole: importing the JAX module would import its package's
transformer (and jax). The BPE asset is a byte-for-byte copy of the JAX
package's (tests/test_torch_mamba.py holds the two equal). The reference uses AutoTokenizer with pad=eos fallback
(models/medtsllm.py:206-217). Resolution order here:
  1. HF tokenizer from a local snapshot (no network),
  2. a real byte-level BPE trained in-repo (assets/fallback_bpe.json,
     built by tools/build_fallback_bpe.py) — exact round-trips, no
     collisions, Llama-2-style digit-per-token counts,
  3. a word-hash tokenizer, only when the backbone's embedding table is
     smaller than the BPE vocab (tiny test presets) or the `tokenizers`
     package is unavailable.
"""

from __future__ import annotations

import re
from pathlib import Path

_BPE_ASSET = Path(__file__).resolve().parent / "assets" / "fallback_bpe.json"


class _SpecialTokensMixin:
    """Shared encode-with-specials protocol + the minimal HF-shaped
    ``__call__``. Special tokens are matched as literal substrings via a
    regex split — plain text (including bare numerals that happen to
    equal a special id) is never reinterpreted as a special token."""

    def _specials(self) -> dict[str, int]:
        return {self.bos_token: self.bos_token_id,
                self.eos_token: self.eos_token_id,
                self.pad_token: self.pad_token_id}

    def encode(self, text: str) -> list[int]:
        specials = self._specials()
        pattern = "(" + "|".join(re.escape(s) for s in specials) + ")"
        out: list[int] = []
        for part in re.split(pattern, text):
            if not part:
                continue
            if part in specials:
                out.append(specials[part])
            else:
                out.extend(self._encode_plain(part))
        return out

    def __call__(self, text, **kw):
        class _Enc:
            pass
        enc = _Enc()
        enc.input_ids = self.encode(text)
        return enc


class BPETokenizer(_SpecialTokensMixin):
    """Hermetic fallback: a real byte-level BPE (vocab 16384) trained on
    stdlib-docstring English + this framework's prompt domain with
    Llama-2-style digit splitting (see tools/build_fallback_bpe.py).
    Unlike the word-hash fallback it has no collisions and decodes
    exactly."""

    def __init__(self):
        from tokenizers import Tokenizer
        self._tok = Tokenizer.from_file(str(_BPE_ASSET))
        self.vocab_size = self._tok.get_vocab_size()
        self.pad_token_id = self._tok.token_to_id("<pad>")
        self.bos_token_id = self._tok.token_to_id("<s>")
        self.eos_token_id = self._tok.token_to_id("</s>")
        self.pad_token = "<pad>"
        self.bos_token = "<s>"
        self.eos_token = "</s>"

    def _encode_plain(self, chunk: str) -> list[int]:
        return self._tok.encode(chunk).ids

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids]).strip()


class WordTokenizer(_SpecialTokensMixin):
    """Hermetic fallback tokenizer: word/number/punctuation pieces hashed
    into the vocab. Produces token counts comparable to a real subword
    tokenizer (~1 token per word), unlike a byte-level fallback which
    inflates prompts ~4x and distorts throughput measurements. Decoding
    uses a reverse map accumulated during encoding."""

    _PIECE = re.compile(r"\w+|[^\w\s]|\s")

    def __init__(self, vocab_size: int = 512):
        import zlib
        self.vocab_size = vocab_size
        self._crc = zlib.crc32
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id = 3
        self.bos_token = "<s>"
        self.eos_token = "</s>"
        self.pad_token = "<pad>"
        self._reverse: dict[int, str] = {1: "<s>", 2: "</s>", 3: "<pad>"}

    def _piece_id(self, piece: str) -> int:
        reserved = 8  # specials + headroom
        tid = reserved + self._crc(piece.encode()) % (self.vocab_size - reserved)
        self._reverse[tid] = piece
        return tid

    def _encode_plain(self, chunk: str) -> list[int]:
        return [self._piece_id(p) for p in self._PIECE.findall(chunk)
                if not p.isspace()]  # whitespace implicit, like joiners

    def decode(self, ids) -> str:
        return " ".join(self._reverse.get(int(i), "<unk>") for i in ids
                        if int(i) != self.pad_token_id)


def get_tokenizer(llm_id: str, cache_dir: str | None = None,
                  vocab_size: int = 512):
    """Returns an object with `.encode(str) -> list[int]` plus
    bos/eos/pad token-id attributes."""
    try:
        from transformers import AutoTokenizer
        from .config import find_snapshot
        snap = find_snapshot(llm_id, cache_dir)
        src = str(snap) if snap is not None else llm_id
        tok = AutoTokenizer.from_pretrained(src, local_files_only=True)
        if tok.pad_token is None:
            if tok.eos_token:
                tok.pad_token = tok.eos_token
            else:
                tok.add_special_tokens({"pad_token": "[PAD]"})
        return tok
    except Exception:
        pass
    if _BPE_ASSET.exists():
        try:
            bpe = BPETokenizer()
            if bpe.vocab_size <= vocab_size:  # ids must fit the embedding
                return bpe
        except Exception:
            pass
    return WordTokenizer(vocab_size=vocab_size)
