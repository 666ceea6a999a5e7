"""CLIP's byte-level BPE tokenizer, for Stable Diffusion's text prompts.

``sige_tpu`` calls ``transformers.CLIPTokenizer`` (reference:
stable-diffusion/ldm/modules/encoders/modules.py FrozenCLIPEmbedder).
The port needs neither ``transformers`` nor ``ftfy`` nor ``regex``, so
this module copies that tokenizer's behaviour where ``ftfy`` is absent
(as on the machine with the card):

  * the clean-up of its ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False)``: control characters dropped, whitespace
    runs collapsed, spaces put around CJK characters, NFC, lower case
    (accents kept);
  * the split pattern ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|
    'll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``, with ``\\p{L}`` /
    ``\\p{N}`` read from ``unicodedata`` categories;
  * byte-level BPE over a snapshot's ``vocab.json`` and ``merges.txt``;
  * ``<|startoftext|>`` ... ``<|endoftext|>`` around every prompt,
    truncation to ``max_length`` that keeps the end token, and padding
    with the snapshot's ``pad_token`` (``special_tokens_map.json``).

:meth:`CLIPTokenizer.__call__` takes ``transformers``' arguments, so the
text encoder calls either tokenizer the same way.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
#: the merges ``transformers`` reads from ``merges.txt``: the first line
#: (the version header) skipped, at most 49152 - 256 - 2 merges
MAX_MERGES = 49152 - 256 - 2
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte -> printable character table of byte-level BPE:
    printable bytes map to themselves, the others (whitespace, control) to
    characters from 256 on."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def clean_text(text: str) -> str:
    """``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``
    joined by single spaces: invalid and control characters dropped,
    whitespace to spaces, CJK characters spaced, NFC, whitespace split,
    lower case."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def split_words(text: str) -> List[str]:
    """The CLIP split pattern over ``text`` (already cleaned, so its only
    whitespace is the space): the specials, the contractions, runs of
    letters, single digits, and runs of anything else."""
    words, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        special = next((s for s in (BOS, EOS) if text.startswith(s, i)),
                       None)
        if special is not None:
            words.append(special)
            i += len(special)
            continue
        if ch == "'":
            rest = text[i + 1:i + 3].lower()
            c = next((c for c in _CONTRACTIONS if rest.startswith(c)), None)
            if c is not None:
                words.append(text[i:i + 1 + len(c)])
                i += 1 + len(c)
                continue
        if _is_letter(ch):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(ch):
            j = i + 1
        elif ch.isspace():
            i += 1
            continue
        else:
            j = i + 1
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _special_token(value, default: str) -> str:
    """A token of ``special_tokens_map.json``: a string or an added-token
    dict with ``content``."""
    if value is None:
        return default
    return value["content"] if isinstance(value, dict) else str(value)


class CLIPTokenizer:
    """Byte-level BPE over ``vocab`` ({token: id}) and ``merges`` (pairs in
    rank order). ``from_pretrained`` reads a snapshot directory."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]], bos_token: str = BOS,
                 eos_token: str = EOS, unk_token: str = EOS,
                 pad_token: str = EOS):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_token, self.eos_token = bos_token, eos_token
        self.unk_token, self.pad_token = unk_token, pad_token
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self.pad_token_id = self.encoder[pad_token]
        self.unk_token_id = self.encoder[unk_token]
        self._specials = (bos_token, eos_token, unk_token, pad_token)
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """From a snapshot directory holding ``vocab.json``, ``merges.txt``
        and optionally ``special_tokens_map.json``."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        special = {}
        sp = os.path.join(path, "special_tokens_map.json")
        if os.path.exists(sp):
            with open(sp, encoding="utf-8") as f:
                special = json.load(f)
        return cls(vocab, merges,
                   **{name: _special_token(special.get(name), default)
                      for name, default in (("bos_token", BOS),
                                            ("eos_token", EOS),
                                            ("unk_token", EOS),
                                            ("pad_token", EOS))})

    def bpe(self, word: str) -> List[str]:
        """The BPE symbols of one byte-encoded word: its characters, the
        last with ``</w>``, merged by rank until no ranked pair is left."""
        if word in self._cache:
            return self._cache[word]
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = set(zip(symbols, symbols[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, np.inf))
            if best not in self.bpe_ranks:
                break
            merged, i = [], 0
            while i < len(symbols):
                if (i < len(symbols) - 1
                        and (symbols[i], symbols[i + 1]) == best):
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        self._cache[word] = symbols
        return symbols

    def _chunk_tokens(self, text: str) -> List[str]:
        tokens = []
        for word in split_words(clean_text(text)):
            if word in (BOS, EOS):
                tokens.append(word)
                continue
            encoded = "".join(self.byte_encoder[b]
                              for b in word.encode("utf-8"))
            tokens.extend(self.bpe(encoded))
        return tokens

    def tokenize(self, text: str) -> List[str]:
        """The BPE tokens of ``text``; a special token written in the text
        stays one token."""
        tokens, i = [], 0
        while i < len(text):
            hits = [(text.find(s, i), s) for s in self._specials]
            hits = [(j, s) for j, s in hits if j >= 0]
            if not hits:
                break
            j, s = min(hits, key=lambda h: (h[0], -len(h[1])))
            tokens += self._chunk_tokens(text[i:j]) + [s]
            i = j + len(s)
        return tokens + self._chunk_tokens(text[i:])

    def encode(self, text: str, max_length: int = 77) -> List[int]:
        """``<|startoftext|>`` + ids + ``<|endoftext|>``, the ids truncated
        so the whole fits ``max_length``."""
        ids = [self.encoder.get(t, self.unk_token_id)
               for t in self.tokenize(text)]
        return [self.bos_token_id] + ids[:max_length - 2] + \
            [self.eos_token_id]

    def __call__(self, text: Union[str, Sequence[str]],
                 truncation: bool = True, max_length: int = 77,
                 padding: str = "max_length", return_tensors: str = "np"):
        """``{"input_ids": int64 [B, max_length]}``, as ``transformers``
        returns for ``truncation=True, padding="max_length",
        return_tensors="np"`` (the only call this port makes)."""
        if not (truncation and padding == "max_length"
                and return_tensors == "np"):
            raise ValueError("only truncation=True, padding='max_length', "
                             "return_tensors='np' are supported")
        texts = [text] if isinstance(text, str) else list(text)
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int64)
        for row, t in enumerate(texts):
            enc = self.encode(t, max_length)
            ids[row, :len(enc)] = enc
        return {"input_ids": ids}
