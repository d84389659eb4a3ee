"""CLIP byte-pair-encoding tokenizer (the port's copy of
``med_tpu.models.clip_tokenizer``; host-side, pure Python).

Together with :mod:`med_tpu_torch.models.clip_text` it encodes COG's prompt
strings at construction, as the reference does (models_COG.py:404-445):
text -> token ids (here) -> embeddings (the text tower).

The merges table is CLIP's standard ``bpe_simple_vocab_16e6.txt.gz``,
supplied by the user alongside the checkpoint. The vocabulary layout
matches openai/CLIP simple_tokenizer.py: 256 byte symbols, their ``</w>``
word-final variants, 48894 merge tokens, then ``<|startoftext|>`` /
``<|endoftext|>`` — 49408 entries.

Documented deviation, as in ``med_tpu``: CLIP canonicalizes text with
``ftfy.fix_text`` before the html-unescape + whitespace cleanup; only the
latter two run here. For ASCII prompt strings (all of the reference's) the
result is identical.

CLIP splits words with the ``regex`` pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``.
Python's ``re`` has no ``\\p{L}``/``\\p{N}`` classes, so :func:`_words`
walks the same alternatives by hand, with the Unicode categories from
``unicodedata``; the port then needs no package beyond the standard
library.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77  # clip.tokenize default
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
_SPECIALS = (SOT, EOT)
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache()
def _byte_encoder() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 convention): the 188
    printable latin-1 bytes map to themselves, the rest to U+0100+n."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    mapping = {b: chr(b) for b in keep}
    n = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + n)
            n += 1
    return mapping


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _words(text: str) -> List[str]:
    """CLIP's word pattern (module docstring) over lower-cased ``text``, as
    ``regex.findall`` takes it: at each position the first alternative
    that matches, in the pattern's order; a position none matches (white
    space) is skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        match = next((s for s in _SPECIALS + _CONTRACTIONS if text.startswith(s, i)), None)
        if match is not None:
            j = i + len(match)
        elif _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif not ch.isspace():
            j = i + 1
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        out.append(text[i:j])
        i = j
    return out


class ClipTokenizer:
    """BPE tokenizer over a CLIP merges file (``bpe_simple_vocab_16e6
    .txt.gz`` or an uncompressed/truncated variant for tests)."""

    def __init__(self, bpe_path: str, n_merges: int = 48894):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        merges: List[Tuple[str, str]] = []
        for line in lines[1: n_merges + 1]:  # line 0 is a version banner
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        byte_syms = list(_byte_encoder().values())
        vocab = byte_syms + [s + "</w>" for s in byte_syms]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.rank: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, List[str]] = {SOT: [SOT], EOT: [EOT]}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1
                        and (word[i], word[i + 1]) == best):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        be = _byte_encoder()
        ids: List[int] = []
        for tok in _words(_clean(text).lower()):
            sym = "".join(be[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(sym))
        return ids

    def tokenize(self, texts: Sequence[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """clip.tokenize semantics: ``<sot> ids <eot>`` zero-padded to
        ``context_length``; over-long sequences are truncated with the
        final slot forced to EOT."""
        out = np.zeros((len(texts), context_length), np.int64)
        sot, eot = self.encoder[SOT], self.encoder[EOT]
        for r, text in enumerate(texts):
            ids = [sot] + self.encode(text) + [eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = eot
            out[r, : len(ids)] = ids
        return out
