"""T5 encoder-decoder (t5-base) for keytotext prompt prep (counterpart of
saspa_tpu/models/t5.py).

The reference's txt2sentence prompt pool comes from
mrm8488/t5-base-finetuned-common_gen (prompts_engineering/
txt2sentance_prompts.py:97-99).  t5-base's semantics: RMS norms in f32
(scale only), pre-LN blocks, UNSCALED dot-product attention, a bucketed
relative-position bias held by layer 0 and shared by every layer, a ReLU
feed-forward, and the lm_head tied to the embedding with the d_model^-0.5
output scale.  Everything runs in f32, as the JAX package runs it.

`relative_position_bucket` computes its f32 log with XLA's (utils/rng.py
`_log_f32`) on the host, so every distance gets JAX's bucket.
`t5_generate_ids` decodes greedily, or samples top-k 50 at a temperature as
`jax.random.categorical` over `split(key, total - 1)` does: the Gumbel
noise of every step is drawn on the host with the port's threefry, bit for
bit JAX's (a full-width call's million values through a table of the 2^23
values gumbel can take), and goes to the device in one upload; the top-k
mask, the divide and the argmax run on the device, with no host
synchronisation per step, from a CUDA graph on the card; the wrapper draws
the next call's noise while the card decodes.
The whole prefix is recomputed at each position (<= 32 new tokens), as the
JAX package's scan does.

The tokenizer is SentencePiece when the `sentencepiece` wheel imports and a
spiece.model exists; otherwise it gives the JAX package's sha256 fallback
ids (and its warning where a model file exists but the wheel does not).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch import resolve_device, to_device
from saspa_tpu_torch.models.layers import Dense, Embed
from saspa_tpu_torch.utils import graphs, rng

T5_PAD_ID = 0  # also the decoder start token
T5_EOS_ID = 1


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    layers: int = 12
    heads: int = 12
    rel_buckets: int = 32
    rel_max_distance: int = 128


class RMSNorm(nn.Module):
    """T5LayerNorm: x * rsqrt(mean(x^2) + eps) * weight, in f32."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device), requires_grad=False)

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def relative_position_bucket(relative_position, bidirectional: bool, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """HF T5's bucket function of relative_position = memory_pos - query_pos
    (any int array), on the host: the log of the far buckets is XLA's f32
    log, so each bucket equals the JAX package's."""
    n = -np.asarray(relative_position, np.int64)
    ret = np.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).astype(np.int64) * num_buckets
        n = np.abs(n)
    else:
        n = np.maximum(n, 0)
    max_exact = num_buckets // 2
    ratio = np.maximum(n, 1).astype(np.float32) / np.float32(max_exact)
    scaled = rng._log_f32(ratio) / np.float32(np.log(max_distance / max_exact)) * np.float32(num_buckets - max_exact)
    val_large = np.minimum(max_exact + scaled.astype(np.int32), num_buckets - 1)
    return ret + np.where(n < max_exact, n, val_large)


class T5Attention(nn.Module):
    """q, k, v, o without bias; layer 0 of a stack holds the relative
    position bias table (buckets, heads) that every layer reuses."""

    def __init__(self, cfg: T5Config, has_rel_bias: bool = False, bidirectional: bool = True, device=None):
        super().__init__()
        self.cfg, self.has_rel_bias, self.bidirectional = cfg, has_rel_bias, bidirectional
        inner = cfg.heads * cfg.d_kv
        self.q = Dense(cfg.d_model, inner, bias=False, device=device)
        self.k = Dense(cfg.d_model, inner, bias=False, device=device)
        self.v = Dense(cfg.d_model, inner, bias=False, device=device)
        self.o = Dense(inner, cfg.d_model, bias=False, device=device)
        if has_rel_bias:
            self.relative_attention_bias = nn.Parameter(torch.zeros(cfg.rel_buckets, cfg.heads, device=device),
                                                        requires_grad=False)
        self._buckets = {}  # (Lq, Lk) -> the buckets on the device, uploaded once (a graphed decode uploads none)

    def position_bias(self, lq: int, lk: int) -> torch.Tensor:
        cfg = self.cfg
        table = self.relative_attention_bias
        bucket = self._buckets.get((lq, lk))
        if bucket is None:
            rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]  # memory - query
            bucket = self._buckets[(lq, lk)] = to_device(
                relative_position_bucket(rel, self.bidirectional, cfg.rel_buckets, cfg.rel_max_distance), table.device)
        return table[bucket].permute(2, 0, 1)[None]  # (1, H, Lq, Lk)

    def forward(self, x, kv, pos_bias=None, causal: bool = False, extra_bias=None):
        """x (B, Lq, D), kv (B, Lk, D) -> (out, pos_bias): layer 0 hands its
        bias on to the layers above it.  `extra_bias` (the padding mask) is
        added in every layer."""
        cfg = self.cfg
        b, lq, _ = x.shape
        lk = kv.shape[1]
        q = self.q(x).reshape(b, lq, cfg.heads, cfg.d_kv).transpose(1, 2)
        k = self.k(kv).reshape(b, lk, cfg.heads, cfg.d_kv).transpose(1, 2)
        v = self.v(kv).reshape(b, lk, cfg.heads, cfg.d_kv).transpose(1, 2)
        logits = q @ k.transpose(-1, -2)
        if self.has_rel_bias and pos_bias is None:
            pos_bias = self.position_bias(lq, lk)
        if pos_bias is not None:
            logits = logits + pos_bias
        if extra_bias is not None:
            logits = logits + extra_bias
        if causal:
            logits = logits + torch.triu(torch.full((lq, lk), -1e9, device=x.device), diagonal=1)[None, None]
        out = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(b, lq, cfg.heads * cfg.d_kv)
        return self.o(out), pos_bias


class _T5FFN(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.layer_norm = RMSNorm(cfg.d_model, device=device)
        self.wi = Dense(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, bias=False, device=device)

    def forward(self, x):
        return x + self.wo(F.relu(self.wi(self.layer_norm(x))))


def _mask_bias(mask):
    return None if mask is None else (1.0 - mask[:, None, None, :].float()) * -1e9


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.layers):
            setattr(self, f"block_{i}_ln0", RMSNorm(cfg.d_model, device=device))
            setattr(self, f"block_{i}_attn", T5Attention(cfg, i == 0, True, device))
            setattr(self, f"block_{i}_ffn", _T5FFN(cfg, device))
        self.final_ln = RMSNorm(cfg.d_model, device=device)

    def forward(self, x, attn_mask=None):
        """x (B, L, D) embedded; attn_mask (B, L) 1 = keep."""
        bias, pos_bias = _mask_bias(attn_mask), None
        for i in range(self.cfg.layers):
            h = getattr(self, f"block_{i}_ln0")(x)
            a, pos_bias = getattr(self, f"block_{i}_attn")(h, h, None if i == 0 else pos_bias, extra_bias=bias)
            x = getattr(self, f"block_{i}_ffn")(x + a)
        return self.final_ln(x)


class T5Decoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.layers):
            setattr(self, f"block_{i}_ln0", RMSNorm(cfg.d_model, device=device))
            setattr(self, f"block_{i}_self", T5Attention(cfg, i == 0, False, device))
            setattr(self, f"block_{i}_ln1", RMSNorm(cfg.d_model, device=device))
            setattr(self, f"block_{i}_cross", T5Attention(cfg, device=device))
            setattr(self, f"block_{i}_ffn", _T5FFN(cfg, device))
        self.final_ln = RMSNorm(cfg.d_model, device=device)

    def forward(self, x, enc, enc_mask=None):
        enc_bias, pos_bias = _mask_bias(enc_mask), None
        for i in range(self.cfg.layers):
            h = getattr(self, f"block_{i}_ln0")(x)
            a, pos_bias = getattr(self, f"block_{i}_self")(h, h, None if i == 0 else pos_bias, causal=True)
            x = x + a
            h = getattr(self, f"block_{i}_ln1")(x)
            c, _ = getattr(self, f"block_{i}_cross")(h, enc, enc_bias)
            x = getattr(self, f"block_{i}_ffn")(x + c)
        return self.final_ln(x)


class T5ForGeneration(nn.Module):
    """Tied-embedding T5: logits = (decoder out * d_model^-0.5) @ shared^T."""

    def __init__(self, cfg: T5Config = T5Config(), device=None):
        super().__init__()
        self.cfg = cfg
        self.shared = Embed(cfg.vocab_size, cfg.d_model, device=device)
        self.encoder = T5Encoder(cfg, device)
        self.decoder = T5Decoder(cfg, device)

    def encode(self, input_ids, attn_mask=None):
        return self.encoder(self.shared(input_ids), attn_mask)

    def decoder_hidden(self, decoder_ids, enc, enc_mask=None):
        return self.decoder(self.shared(decoder_ids), enc, enc_mask)

    def lm_logits(self, h):
        return (h * (self.cfg.d_model ** -0.5)) @ self.shared.embedding.T

    def decode_logits(self, decoder_ids, enc, enc_mask=None):
        return self.lm_logits(self.decoder_hidden(decoder_ids, enc, enc_mask))

    def forward(self, input_ids, decoder_ids, attn_mask=None):
        return self.decode_logits(decoder_ids, self.encode(input_ids, attn_mask), attn_mask)


TABLE_DRAWS = 1 << 20  # from this many values a call on, the noise is looked up (rng.gumbel_by_table)


def sampling_noise(key, batch: int, max_new_tokens: int, vocab: int) -> np.ndarray:
    """The Gumbel noise of t5_generate_ids' sampled steps, (steps, B, V)
    f32: step i draws jax.random.categorical's gumbel(split(key, steps)[i],
    (B, V))."""
    draw = rng.gumbel_by_table if max_new_tokens * batch * vocab >= TABLE_DRAWS else rng.gumbel
    return np.stack([draw(k, (batch, vocab)) for k in rng.split(key, max_new_tokens)])


@torch.no_grad()
def t5_generate_ids(model: T5ForGeneration, input_ids, attn_mask=None, max_new_tokens: int = 32, key=None,
                    temperature: float = 1.0, top_k: int = 50, return_margins: bool = False, noise=None):
    """Batched decode on the inputs' device: greedy when `key` is None, else
    top-k temperature sampling (top_k 50: transformers' generate default;
    0 disables the filter; `noise`: sampling_noise(key, ...) drawn
    beforehand).  Returns (B, 1 + max_new_tokens) ids starting with the
    pad/start token; with return_margins also each step's top-2 margin of
    what the argmax picks from (the logits, or the noise plus the masked
    logits over the temperature) (B, steps).  On the card the decode loop
    replays from a CUDA graph (utils/graphs.py)."""
    if attn_mask is None:  # a mask of ones adds -0.0: the same logits
        attn_mask = torch.ones_like(input_ids)
    enc = model.encode(input_ids, attn_mask)
    b = enc.shape[0]
    total = 1 + max_new_tokens
    ids = torch.full((b, total), T5_PAD_ID, dtype=torch.long, device=enc.device)
    sampled = () if key is None else (to_device(noise if noise is not None else sampling_noise(
        key, b, max_new_tokens, model.cfg.vocab_size), enc.device),)

    def loop(ids, enc, attn_mask, *noise):
        done = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)
        margins = []
        for pos in range(1, total):
            score = model.lm_logits(model.decoder_hidden(ids, enc, attn_mask)[:, pos - 1]).float()
            if noise:
                if top_k:
                    kth = score.topk(top_k, dim=-1).values[:, -1:]
                    score = score.masked_fill(score < kth, float("-inf"))
                score = noise[0][pos - 1] + score / temperature
            nxt = score.argmax(dim=-1)
            if return_margins:
                top2 = score.topk(2, dim=-1).values
                margins.append(top2[:, 0] - top2[:, 1])
            nxt = torch.where(done, torch.full_like(nxt, T5_PAD_ID), nxt)
            ids[:, pos] = nxt
            done = done | (nxt == T5_EOS_ID)
        return ids, (torch.stack(margins, dim=1) if return_margins else None)

    ids, margins = graphs.replay(model, ("generate", bool(sampled), temperature, top_k, return_margins), loop,
                                 ids, enc, attn_mask, *sampled)
    return (ids, margins) if return_margins else ids


# ---------------------------------------------------------------------------
# SentencePiece tokenizer (T5 unigram vocab)
# ---------------------------------------------------------------------------
class T5Tokenizer:
    """A local spiece.model through the `sentencepiece` wheel where both
    exist; otherwise a deterministic hash fallback (`has_vocab` False)."""

    def __init__(self, model_path: Optional[str] = None):
        self.sp = None
        if model_path and Path(model_path).exists():
            try:
                import sentencepiece as spm

                self.sp = spm.SentencePieceProcessor(model_file=model_path)
            except ImportError:
                logging.warning("sentencepiece not installed; T5 tokenizer falls back to hash ids")

    @property
    def has_vocab(self) -> bool:
        return self.sp is not None

    def encode(self, text: str) -> List[int]:
        if self.sp is not None:
            return list(self.sp.encode(text)) + [T5_EOS_ID]
        ids = []
        for w in text.lower().split():
            h = int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
            ids.append(2 + h % 32000)
        return ids + [T5_EOS_ID]

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) not in (T5_PAD_ID, T5_EOS_ID)]
        if self.sp is not None:
            return self.sp.decode(ids)
        return " ".join(f"[{i}]" for i in ids)


class TorchKeytotextT5:
    """Callable keywords -> sentence (the gen/caption_tools.py plug), on
    `device` (None: the card).  Sampling advances the key per call, as the
    JAX wrapper's does."""

    def __init__(self, weights_dir: Optional[str] = None, cfg: Optional[T5Config] = None, params=None,
                 seed: int = 0, max_new_tokens: int = 32, sample: bool = True, device=None):
        from saspa_tpu_torch.weights.load import load_or_init

        self.device = resolve_device(device)
        self.cfg = cfg or T5Config()
        self.model = T5ForGeneration(self.cfg, self.device).eval()
        self.max_new_tokens = max_new_tokens
        self.sample = sample
        self._key = rng.prng_key(seed)
        self._ahead = None  # (batch, key, noise) of the next sampled call, drawn ahead on the host
        sp = Path(weights_dir or "") / "tokenizer" / "spiece.model"
        self.tokenizer = T5Tokenizer(str(sp) if weights_dir and sp.exists() else None)
        self.load_reports = load_or_init(self.model, "t5_keytotext", "keytotext T5 file", weights_dir, params, seed)

    def encode_batch(self, texts: Sequence[str]):
        """Token ids and mask (B, L) of the texts, padded to the longest, on the device."""
        enc = [self.tokenizer.encode(t) for t in texts]
        length = max(len(e) for e in enc)
        ids = np.full((len(enc), length), T5_PAD_ID, np.int64)
        mask = np.zeros((len(enc), length), np.int64)
        for i, e in enumerate(enc):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return to_device(ids, self.device), to_device(mask, self.device)

    def next_key(self):
        """The key of the next sampled call (None when greedy); advances."""
        if not self.sample:
            return None
        self._key, k = rng.split(self._key)
        return k

    def _noise(self, key, batch: int):
        """The call's sampling noise: drawn while the card ran the previous
        call's decode when that one had the same batch size, else now."""
        ahead, self._ahead = self._ahead, None
        if ahead is not None and ahead[0] == batch and np.array_equal(ahead[1], key):
            return ahead[2]
        return sampling_noise(key, batch, self.max_new_tokens, self.cfg.vocab_size)

    def generate_batch(self, texts: Sequence[str]) -> List[str]:
        ids, mask = self.encode_batch(texts)
        key = self.next_key()
        noise = None if key is None else self._noise(key, len(texts))
        out = t5_generate_ids(self.model, ids, mask, self.max_new_tokens, key=key, noise=noise)
        if key is not None and out.is_cuda:  # the next call's noise, while the card decodes this one
            nxt = rng.split(self._key)[1]
            self._ahead = (len(texts), nxt, sampling_noise(nxt, len(texts), self.max_new_tokens, self.cfg.vocab_size))
        return [self.tokenizer.decode(row[1:]) for row in out.cpu().numpy()]

    def __call__(self, keywords: str) -> str:
        return self.generate_batch([keywords])[0]
