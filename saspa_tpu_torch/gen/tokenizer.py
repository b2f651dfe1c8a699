"""CLIP BPE tokenizer (numpy only): the port's copy of saspa_tpu/gen/tokenizer.py.

Byte-level BPE with CLIP's pre-tokenize pattern and text cleaning; the merge
table loads from a standard `merges.txt` / `bpe_simple_vocab_16e6` file.
Without one, a deterministic hash fallback keeps every path runnable: stable
ids in the CLIP vocab range with the same SOT/EOT framing and 77-token
padding.  Kept id-for-id equal to the JAX package's tokenizer (tested).
"""

from __future__ import annotations

import gzip
import hashlib
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import List, Optional

import numpy as np

try:
    import regex as _re_mod

    _HAVE_REGEX = True
except ImportError:  # vendored installs without the declared `regex` dep
    import re as _re_mod

    _HAVE_REGEX = False

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407

# CLIP's exact pre-tokenize pattern (openai/CLIP simple_tokenizer.py and
# transformers CLIPTokenizer use this same regex, IGNORECASE).  Without the
# `regex` module (declared in pyproject, but keep a vendoring fallback),
# stdlib `re` approximates it: [^\W\d_] ≈ \p{L} (plus the rare Nl/No number
# forms, e.g. Roman numerals, which stdlib classes as alphanumeric — they
# join the letter run instead of the single-number class), \d = \p{Nd},
# and (?:[^\s\w]|_) is exactly [^\s\p{L}\p{N}] up to that same Nl/No set.
if _HAVE_REGEX:
    _PAT = _re_mod.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re_mod.IGNORECASE,
    )
else:
    _PAT = _re_mod.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
        _re_mod.IGNORECASE | _re_mod.UNICODE,
    )

_WS = _re_mod.compile(r"\s+")


@lru_cache()
def bytes_to_unicode():
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_cjk(cp: int) -> bool:
    """BERT BasicTokenizer's CJK block test (transformers
    tokenization_bert.py::BasicTokenizer._is_chinese_char)."""
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _basic_clean(text: str) -> str:
    """transformers CLIPTokenizer's no-ftfy cleaning, exactly:
    `" ".join(BasicTokenizer(strip_accents=False, do_split_on_punc=False)
    .tokenize(text))` = drop control chars, surround CJK chars with spaces,
    whitespace-split, lowercase, re-join with single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        if ch in ("\t", "\n", "\r"):
            out.append(" ")
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C"):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif cat == "Zs":
            out.append(" ")
        else:
            out.append(ch)
    return " ".join("".join(out).lower().split())


class CLIPTokenizer:
    def __init__(self, merges_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.bpe_ranks = {}
        self.encoder = {}
        # full-vocab ids; _load_merges overrides from the encoder (differs
        # only for toy vocabs, where parity with transformers needs the
        # encoder's own ids)
        self.sot, self.eot = SOT, EOT
        if merges_path and Path(merges_path).exists():
            self._load_merges(merges_path)
        self._cache = {}

    # ---- vocab construction from a merges file (CLIP's exact recipe) -------
    def _load_merges(self, path: str):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # CLIP's file has a header line and is truncated to 48894 merges
        start = 1 if lines and (" " not in lines[0] or lines[0].startswith("#")) else 0
        merges = [tuple(m.split()) for m in lines[start : 49152 - 256 - 2 + start] if m and len(m.split()) == 2]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @property
    def has_vocab(self) -> bool:
        return bool(self.encoder)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = list(word)
        self._cache[token] = out
        return out

    # ---- encoding ----------------------------------------------------------
    def _encode_text(self, text: str) -> List[int]:
        text = _basic_clean(text)
        ids: List[int] = []
        for tok in _PAT.findall(text):
            if tok in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.sot if tok == "<|startoftext|>" else self.eot)
                continue
            tok_bytes = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            if self.has_vocab:
                ids.extend(self.encoder[t] for t in self._bpe(tok_bytes))
            else:
                # deterministic fallback: stable id per word-piece
                h = int.from_bytes(hashlib.sha256(tok_bytes.encode()).digest()[:4], "little")
                ids.append(h % (VOCAB_SIZE - 1000))
        return ids

    def __call__(
        self,
        texts,
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = True,
        pad: str = "zero",
    ) -> np.ndarray:
        """texts: str or list[str] -> (B, 77) int32 of SOT ... EOT + padding.

        pad="zero" matches openai clip.tokenize (the CLIP filter contract,
        all_utils/utils.py:253); pad="eot" matches transformers/diffusers
        (pad_token = <|endoftext|>) — the SD text-conditioning contract, where
        padded positions DO feed cross-attention."""
        if isinstance(texts, str):
            texts = [texts]
        sot, eot = self.sot, self.eot
        fill = 0 if pad == "zero" else eot
        out = np.full((len(texts), context_length), fill, np.int32)
        for i, text in enumerate(texts):
            ids = [sot] + self._encode_text(text or "") + [eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"text too long: {text!r}")
                ids = ids[: context_length - 1] + [eot]
            out[i, : len(ids)] = ids
        return out


# SD's default negative prompt (the generation stage's GenerationConfig default)
NEGATIVE_PROMPT = (
    "over-exposure, under-exposure, saturated, duplicate, out of frame, lowres, "
    "cropped, worst quality, low quality, jpeg artifacts, morbid, mutilated, out "
    "of frame, ugly, bad anatomy, bad proportions, deformed, blurry, duplicate"
)

_DEFAULT: dict = {}  # weights_dir -> CLIPTokenizer


def default_tokenizer(weights_dir: Optional[str] = None) -> CLIPTokenizer:
    """Cached tokenizer, keyed by weights_dir — a process-wide singleton
    would let an early weights-less pipeline pin the hash-fallback tokenizer
    for a later pipeline constructed WITH real merges."""
    global _DEFAULT
    if weights_dir not in _DEFAULT:
        merges = None
        for cand in [
            Path(weights_dir or "") / "tokenizer/merges.txt",
            Path(weights_dir or "") / "bpe_simple_vocab_16e6.txt.gz",
            Path("weights/tokenizer/merges.txt"),
            Path("weights/bpe_simple_vocab_16e6.txt.gz"),
        ]:
            if str(cand) != "." and cand.exists():
                merges = str(cand)
                break
        if merges is None:
            import logging

            logging.warning(
                "no CLIP merges file (weights_dir=%r, cwd=%s) — using the "
                "HASH-FALLBACK tokenizer; token ids are stable but NOT real "
                "BPE, text conditioning is only meaningful with random "
                "weights", weights_dir, Path.cwd(),
            )
        _DEFAULT[weights_dir] = CLIPTokenizer(merges)
    return _DEFAULT[weights_dir]
