"""BERT WordPiece tokenizer of the BLIP models (counterpart of the tokenizer
in saspa_tpu/models/blip_caption.py).

BLIP-Diffusion's Q-Former reads the source subject category through it.
Greedy longest-match WordPiece over a standard bert-base-uncased vocab.txt;
without one, each lower-cased word gets a deterministic id from its sha256
(1000 + h % (VOCAB - 2000)), as the JAX package's fallback gives it, so both
packages tokenize alike when no vocabulary ships.  The captioning model
itself is ROADMAP Queue 1 item [14].
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import List, Optional, Sequence

BOS_ID = 30522  # LAVIS [DEC] token opens caption decoding
SEP_ID = 102  # BERT [SEP] terminates it
PAD_ID = 0
VOCAB = 30524


class WordPieceTokenizer:
    """encode(text) -> ids without [CLS]/[SEP]; decode(ids) -> text."""

    def __init__(self, vocab_path: Optional[str] = None):
        self.vocab: dict = {}
        self.inv: dict = {}
        if vocab_path and Path(vocab_path).exists():
            words = Path(vocab_path).read_text(encoding="utf-8").splitlines()
            self.vocab = {w: i for i, w in enumerate(words)}
            self.inv = {i: w for w, i in self.vocab.items()}

    @property
    def has_vocab(self) -> bool:
        return bool(self.vocab)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower()):
            if not self.has_vocab:
                h = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
                ids.append(1000 + h % (VOCAB - 2000))
                continue
            start, pieces = 0, []
            while start < len(word):
                end = len(word)
                piece = None
                while end > start:
                    cand = ("##" if start else "") + word[start:end]
                    if cand in self.vocab:
                        piece = cand
                        break
                    end -= 1
                if piece is None:
                    pieces = [self.vocab.get("[UNK]", 100)]
                    break
                pieces.append(self.vocab[piece])
                start = end
            ids.extend(pieces)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks: List[str] = []
        for i in ids:
            i = int(i)
            if i in (PAD_ID, BOS_ID, SEP_ID):
                continue
            t = self.inv.get(i, f"[{i}]")
            if t.startswith("##") and toks:
                toks[-1] += t[2:]
            else:
                toks.append(t)
        return " ".join(toks)
