"""BLIP image captioning (counterpart of saspa_tpu/models/blip_caption.py).

LAVIS's blip_caption base_coco, which the reference captions a dataset with
(prompts_engineering/blip_utils.py:34-42):

  * `BlipViT`: timm's ViT-B/16 over 384x384 inputs: a conv patch embed with
    bias, the class token and a learned position embedding, pre-LN blocks
    (eps 1e-6) with a fused qkv projection with bias and an exact-GELU MLP,
    and a final LayerNorm; it returns every token;
  * `BlipTextDecoder`: BERT-base with causal self-attention, cross-attention
    to the image tokens and post-LN blocks (eps 1e-12), then BERT's MLM head
    (dense, GELU, LayerNorm, the vocabulary projection);
  * `greedy_caption_ids`: greedy decoding with the whole prefix recomputed
    at each position, as the JAX package's scan does (<= 40 tokens, fixed
    shapes); the argmax, the done flag and the PAD/SEP writes stay on the
    device, so a caption costs one host read at the end.  On the card the
    loop's kernels replay from a CUDA graph (utils/graphs.py).

The LayerNorms are flax's (f32, the fast variance clamped at 0); the
attention is the plain product and softmax, as the JAX modules compute
them outside any Pallas kernel.  Everything runs in f32, as the JAX package
runs it.  `blip_preprocess` divides by 255 and by the std (the JAX function
runs eagerly, so nothing folds the division into a multiply) after
jax.image's antialiased Keys-cubic resize.  `TorchBlipCaptioner` reads
images without PIL (gen/image_io.py) and its weights from LAVIS's public
checkpoint (weights/sources.py: "blip_caption").

The WordPiece tokenizer reads a bert-base-uncased vocab.txt; without one,
each lower-cased word gets a deterministic id from its sha256
(1000 + h % (VOCAB - 2000)), as the JAX package's fallback gives it, so both
packages tokenize alike when no vocabulary ships.  BLIP-Diffusion's
Q-Former reads the source subject category through it too.
"""

from __future__ import annotations

import hashlib
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch import resolve_device, to_device
from saspa_tpu_torch.models.clip import CLIP_MEAN, CLIP_STD, jax_cubic_resize
from saspa_tpu_torch.models.layers import Conv, Dense, Embed, NormParams, flax_layer_norm
from saspa_tpu_torch.utils import graphs
from saspa_tpu_torch.weights.load import load_or_init

BOS_ID = 30522  # LAVIS [DEC] token opens caption decoding
SEP_ID = 102  # BERT [SEP] terminates it
PAD_ID = 0
VOCAB = 30524
CAPTION_PROMPT = "a picture of "  # LAVIS blip_caption prompt


@dataclass(frozen=True)
class BlipViTConfig:
    image_size: int = 384
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12


@dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = VOCAB
    width: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512


def _ln(p: NormParams, x, eps: float):
    return flax_layer_norm(x, p.scale, p.bias, eps).to(x.dtype)


def mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, Lk) 1 = attendable -> the additive bias (B, 1, 1, Lk): 0 or -1e9."""
    return (1.0 - mask[:, None, None, :].float()) * -1e9


def causal_bias(length: int, device) -> torch.Tensor:
    """(1, 1, L, L): -1e9 above the diagonal (jnp.triu(full(-1e9), k=1))."""
    return torch.triu(torch.full((length, length), -1e9, device=device), diagonal=1)[None, None]


def attend(q, k, v, heads: int, bias=None):
    """Packed (B, L, H*D) q, k, v -> (B, Lq, H*D): softmax(q k^T / sqrt(D)
    + bias) v, in f32."""
    b, lq, w = q.shape
    lk = k.shape[1]
    d = w // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, lk, heads, d).transpose(1, 2)
    vh = v.reshape(b, lk, heads, d).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(d)
    if bias is not None:
        logits = logits + bias
    return (torch.softmax(logits, dim=-1) @ vh).transpose(1, 2).reshape(b, lq, w)


class _ViTBlock(nn.Module):
    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.norm1 = NormParams(width, device)
        self.attn_qkv = Dense(width, 3 * width, device=device)
        self.attn_proj = Dense(width, width, device=device)
        self.norm2 = NormParams(width, device)
        self.mlp_fc1 = Dense(width, 4 * width, device=device)
        self.mlp_fc2 = Dense(4 * width, width, device=device)

    def forward(self, x):
        h = _ln(self.norm1, x, 1e-6)
        q, k, v = self.attn_qkv(h).chunk(3, dim=-1)
        x = x + self.attn_proj(attend(q, k, v, self.heads))
        h = _ln(self.norm2, x, 1e-6)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(h)))


class BlipViT(nn.Module):
    """timm-style ViT: forward(images (B, H, W, 3) normalised) -> every
    token (B, 1 + (H/p)(W/p), width).  The patch embed runs as one product
    over the non-overlapping patches (the flax conv's 'SAME' padding is
    empty at sizes the patch divides)."""

    def __init__(self, cfg: BlipViTConfig = BlipViTConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embed = Conv(3, w, cfg.patch_size, stride=cfg.patch_size, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, w, device=device), requires_grad=False)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, w, device=device), requires_grad=False)
        for i in range(cfg.layers):
            setattr(self, f"blocks_{i}", _ViTBlock(w, cfg.heads, device))
        self.norm = NormParams(w, device)

    def forward(self, images):
        cfg, p = self.cfg, self.cfg.patch_size
        b, h, w, c = images.shape
        if h % p or w % p:
            raise ValueError(f"BlipViT: a {h}x{w} input is not a whole number of {p}x{p} patches")
        patches = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4).reshape(b, -1, c * p * p)
        x = F.linear(patches, self.patch_embed.kernel.reshape(cfg.width, -1), self.patch_embed.bias)
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        x = x + self.pos_embed[:, : x.shape[1]]
        for i in range(cfg.layers):
            x = getattr(self, f"blocks_{i}")(x)
        return _ln(self.norm, x, 1e-6)


class _BertLayer(nn.Module):
    """Self-attention, cross-attention to the encoder tokens and the FFN,
    each followed by a post-LN (eps 1e-12)."""

    def __init__(self, cfg: BlipTextConfig, device=None):
        super().__init__()
        self.heads = cfg.heads
        w = cfg.width
        for pre in ("self", "cross"):
            for name in ("query", "key", "value", "out_dense"):
                setattr(self, f"{pre}_{name}", Dense(w, w, device=device))
            setattr(self, f"{pre}_out_ln", NormParams(w, device))
        self.intermediate_dense = Dense(w, cfg.intermediate, device=device)
        self.output_dense = Dense(cfg.intermediate, w, device=device)
        self.output_ln = NormParams(w, device)

    def _mha(self, pre, q_in, kv_in, bias):
        q, k, v = (getattr(self, f"{pre}_{n}") for n in ("query", "key", "value"))
        return attend(q(q_in), k(kv_in), v(kv_in), self.heads, bias)

    def forward(self, x, enc_tokens, self_bias=None, cross_bias=None):
        x = _ln(self.self_out_ln, x + self.self_out_dense(self._mha("self", x, x, self_bias)), 1e-12)
        x = _ln(self.cross_out_ln, x + self.cross_out_dense(self._mha("cross", x, enc_tokens, cross_bias)), 1e-12)
        h = self.output_dense(F.gelu(self.intermediate_dense(x)))
        return _ln(self.output_ln, x + h, 1e-12)


class BlipTextEncoder(nn.Module):
    """BERT fusion encoder: bidirectional self-attention over the question
    (its pad positions masked) and cross-attention to the image tokens in
    every layer (LAVIS med.py's BertModel in multimodal mode, blip_vqa's
    text_encoder).  forward -> the last hidden states (B, L, W)."""

    def __init__(self, cfg: BlipTextConfig = BlipTextConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.word_embeddings = Embed(cfg.vocab_size, w, device=device)
        self.position_embeddings = nn.Parameter(torch.zeros(cfg.max_positions, w, device=device),
                                                requires_grad=False)
        # BERT's token type 0 row is a learned constant added to every position
        self.token_type_embeddings = nn.Parameter(torch.zeros(2, w, device=device), requires_grad=False)
        self.embeddings_ln = NormParams(w, device)
        for i in range(cfg.layers):
            setattr(self, f"layer_{i}", _BertLayer(cfg, device))

    def hidden(self, token_ids, enc_tokens, self_bias=None, cross_bias=None):
        length = token_ids.shape[1]
        x = self.word_embeddings(token_ids) + self.position_embeddings[None, :length] + self.token_type_embeddings[0]
        x = _ln(self.embeddings_ln, x, 1e-12)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, enc_tokens, self_bias, cross_bias)
        return x

    def forward(self, token_ids, image_tokens, attention_mask=None):
        """token_ids (B, L); attention_mask (B, L) 1 = real token."""
        return self.hidden(token_ids, image_tokens, None if attention_mask is None else mask_bias(attention_mask))


class BlipTextDecoder(BlipTextEncoder):
    """BERT decoder: causal self-attention, cross-attention to the encoder
    tokens (`cross_mask` (B, Lk), 1 = attendable: the VQA decoder's padded
    question states), then BERT's MLM head."""

    def __init__(self, cfg: BlipTextConfig = BlipTextConfig(), device=None):
        super().__init__(cfg, device)
        w = cfg.width
        self.transform_dense = Dense(w, w, device=device)
        self.transform_ln = NormParams(w, device)
        self.decoder = Dense(w, cfg.vocab_size, device=device)

    def decoder_hidden(self, token_ids, enc_tokens, cross_mask=None):
        cross = None if cross_mask is None else mask_bias(cross_mask)
        return self.hidden(token_ids, enc_tokens, causal_bias(token_ids.shape[1], token_ids.device), cross)

    def head(self, h):
        """The MLM head of hidden states (..., W) -> logits (..., vocab)."""
        return self.decoder(_ln(self.transform_ln, F.gelu(self.transform_dense(h)), 1e-12))

    def forward(self, token_ids, image_tokens, cross_mask=None):
        """token_ids (B, L) -> logits (B, L, vocab)."""
        return self.head(self.decoder_hidden(token_ids, image_tokens, cross_mask))


class BlipCaptioner(nn.Module):
    def __init__(self, vit: BlipViTConfig = BlipViTConfig(), text: BlipTextConfig = BlipTextConfig(), device=None):
        super().__init__()
        self.vit = vit
        self.visual_encoder = BlipViT(vit, device)
        self.text_decoder = BlipTextDecoder(text, device)

    def forward(self, images, token_ids):
        """Teacher-forced logits (B, L, vocab)."""
        return self.text_decoder(token_ids, self.visual_encoder(images))

    def encode_image(self, images):
        return self.visual_encoder(images)

    def decode_step_logits(self, token_ids, image_tokens):
        return self.text_decoder(token_ids, image_tokens)


@torch.no_grad()
def greedy_decode(hidden: Callable, head: Callable, ids: torch.Tensor, start: int, return_margins: bool = False):
    """Greedy decoding in place over ids (B, max_len) from position `start`:
    at each position the whole prefix is recomputed (hidden(ids) -> (B, L,
    W)), the head scores row pos - 1, and its argmax (PAD once a row has
    emitted SEP) is written at pos.  No host synchronisation.  Returns
    (ids, the top-2 margin of each step's logits (B, steps) or None)."""
    b, max_len = ids.shape
    done = torch.zeros(b, dtype=torch.bool, device=ids.device)
    margins = []
    for pos in range(start, max_len):
        logits = head(hidden(ids)[:, pos - 1])
        nxt = logits.argmax(dim=-1)
        if return_margins:
            top2 = logits.topk(2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
        nxt = torch.where(done, torch.full_like(nxt, PAD_ID), nxt)
        ids[:, pos] = nxt
        done = done | (nxt == SEP_ID)
    return ids, (torch.stack(margins, dim=1) if return_margins else None)


def greedy_caption_ids(model: BlipCaptioner, images, prompt_ids: Sequence[int], max_len: int = 40,
                       return_margins: bool = False):
    """Batched greedy captions of normalised images (B, H, W, 3): (B,
    max_len) ids on the images' device, the prompt, the generated tokens,
    SEP, PAD...; with return_margins also each step's top-2 logit margin."""
    prompt = list(prompt_ids)
    n0 = len(prompt)
    assert 0 < n0 < max_len
    with torch.no_grad():
        image_tokens = model.encode_image(images)
    ids = torch.full((images.shape[0], max_len), PAD_ID, dtype=torch.long, device=images.device)
    ids[:, :n0] = torch.as_tensor(prompt, device=images.device)
    dec = model.text_decoder

    def loop(ids, image_tokens):
        return greedy_decode(lambda t: dec.decoder_hidden(t, image_tokens), dec.head, ids, n0, return_margins)

    ids, margins = graphs.replay(model, ("caption", n0, return_margins), loop, ids, image_tokens)
    return (ids, margins) if return_margins else ids


# ---------------------------------------------------------------------------
# WordPiece tokenizer (bert-base-uncased vocab)
# ---------------------------------------------------------------------------
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


def vocab_path(weights_dir) -> Optional[str]:
    """weights_dir/tokenizer/vocab.txt where it exists (the JAX wrappers' place)."""
    if not weights_dir:
        return None
    vp = Path(weights_dir) / "tokenizer" / "vocab.txt"
    return str(vp) if vp.exists() else None


def blip_preprocess(images_uint8, size: int = 384, device="cpu") -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalised f32 (B, size, size, 3) on `device`:
    / 255, jax.image's antialiased Keys-cubic resize, (x - mean) / std."""
    x = to_device(np.asarray(images_uint8), device).float() / 255.0
    if tuple(x.shape[1:3]) != (size, size):
        x = jax_cubic_resize(x, size, size)
    mean = to_device(np.asarray(CLIP_MEAN, np.float32), x.device)
    std = to_device(np.asarray(CLIP_STD, np.float32), x.device)
    return (x - mean) / std


class TorchBlipCaptioner:
    """Callable path -> caption (the gen/caption_tools.py plug), on `device`
    (None: the card)."""

    def __init__(self, weights_dir: Optional[str] = None, max_len: int = 40, vit: Optional[BlipViTConfig] = None,
                 text: Optional[BlipTextConfig] = None, params=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = BlipCaptioner(vit or BlipViTConfig(), text or BlipTextConfig(), self.device).eval()
        self.max_len = max_len
        self.tokenizer = WordPieceTokenizer(vocab_path(weights_dir))
        self.load_reports = load_or_init(self.model, "blip_caption", "BLIP caption file", weights_dir, params, seed)

    def prompt_ids(self) -> List[int]:
        return [BOS_ID] + self.tokenizer.encode(CAPTION_PROMPT.strip())

    def caption_ids(self, images_uint8: np.ndarray, return_margins: bool = False):
        images = blip_preprocess(images_uint8, self.model.vit.image_size, self.device)
        return greedy_caption_ids(self.model, images, self.prompt_ids(), self.max_len, return_margins)

    def caption_batch(self, images_uint8: np.ndarray) -> List[str]:
        ids = self.caption_ids(images_uint8).cpu().numpy()
        n0 = len(self.prompt_ids())
        return [self.tokenizer.decode(row[n0:]) for row in ids]

    def __call__(self, path: str) -> str:
        from saspa_tpu_torch.gen.image_io import read_rgb

        return self.caption_batch(read_rgb(path)[None])[0]
