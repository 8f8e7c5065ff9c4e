"""CLIP-compatible byte-level BPE tokenizer (pure host-side Python).

Produces token ids identical to the OpenAI CLIP ``SimpleTokenizer`` used by the
reference (`reference/CLIP/clip/simple_tokenizer.py`,
`reference/CLIP/clip/clip.py:200-240`), so pre-trained text towers see
the exact same inputs. The vocabulary asset ``bpe_simple_vocab_16e6.txt.gz``
is the public OpenAI CLIP release (data, not code).

Divergence note: the reference pipes text through ``ftfy.fix_text`` (mojibake
repair). ftfy is not available here; we apply NFC normalization + HTML
unescape, which is byte-identical for the ASCII referring expressions in
RefCOCO/ReferIt.

Copy of the JAX package's tokenizer; ``regex`` is imported at first use so
that importing this module needs numpy alone.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import Iterable, List, Sequence, Union

import numpy as np

_VOCAB_SIZE = 49408  # 256 bytes + 256 byte+'</w>' + 48894 merges + 2 specials
_NUM_MERGES = 49152 - 256 - 2
SOT_TOKEN = 49406
EOT_TOKEN = 49407

_WORD_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)


@functools.lru_cache()
def _word_regex():
    import regex

    return regex.compile(_WORD_PATTERN, regex.IGNORECASE)


def _default_vocab_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache()
def _byte_unicode_table() -> dict:
    """Map every byte 0..255 to a printable unicode char (GPT-2 scheme)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    chars = {b: chr(b) for b in printable}
    shift = 0
    for b in range(256):
        if b not in chars:
            chars[b] = chr(256 + shift)
            shift += 1
    return chars


def _clean(text: str) -> str:
    import regex

    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = regex.sub(r"\s+", " ", text.strip())
    return text.strip()


class ClipBPETokenizer:
    """Byte-level BPE with the CLIP merge table and ``</w>`` end-of-word marker."""

    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or _default_vocab_path()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merge_lines = lines[1 : 1 + _NUM_MERGES]
        merges = [tuple(line.split()) for line in merge_lines]

        byte_chars = list(_byte_unicode_table().values())
        tokens: List[str] = list(byte_chars)
        tokens += [c + "</w>" for c in byte_chars]
        tokens += ["".join(pair) for pair in merges]
        tokens += ["<|startoftext|>", "<|endoftext|>"]
        assert len(tokens) == _VOCAB_SIZE, len(tokens)

        self.token_to_id = {tok: i for i, tok in enumerate(tokens)}
        self.id_to_token = {i: tok for tok, i in self.token_to_id.items()}
        self.merge_rank = {pair: i for i, pair in enumerate(merges)}
        self._byte_enc = _byte_unicode_table()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._word_cache: dict = {}

    # ---- core BPE ----------------------------------------------------------

    def _merge_word(self, word: str) -> List[str]:
        """Apply BPE merges to one whitespace-free word (already byte-mapped)."""
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached

        parts: List[str] = list(word[:-1]) + [word[-1] + "</w>"]
        if len(parts) == 1:
            self._word_cache[word] = parts
            return parts

        while len(parts) > 1:
            # find the lowest-rank adjacent pair
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                rank = self.merge_rank.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_idx = i
            if best_rank is None:
                break
            first, second = parts[best_idx], parts[best_idx + 1]
            # merge every (first, second) occurrence, matching classic BPE order
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        self._word_cache[word] = parts
        return parts

    # ---- public API ---------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for word in _word_regex().findall(text):
            mapped = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            ids.extend(self.token_to_id[piece] for piece in self._merge_word(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.id_to_token[int(i)] for i in ids)
        raw = bytearray(self._byte_dec[c] for c in text if c in self._byte_dec)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _shared_tokenizer() -> ClipBPETokenizer:
    return ClipBPETokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = 77,
    truncate: bool = True,
) -> np.ndarray:
    """Tokenize to a fixed-shape ``[N, context_length]`` int32 array.

    Matches the reference's ``clip.tokenize`` layout: ``<sot> tokens <eot>``
    zero-padded. With ``truncate`` the last slot is forced to ``<eot>``.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = _shared_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT_TOKEN] + tok.encode(text) + [EOT_TOKEN]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"input too long for context {context_length}: {text!r}")
            ids = ids[:context_length]
            ids[-1] = EOT_TOKEN
        out[i, : len(ids)] = ids
    return out
