"""CLIP text towers (counterpart of saspa_tpu/models/text_encoder.py):
SD1.5's conditioning tower (ViT-L/14 text, last_hidden_state), SDXL's two
(ViT-L and OpenCLIP bigG, both the raw penultimate layer; bigG's pooled
output through its 1280-wide projection) and the CLIP RN50 filter's tower
(12 layers of 512 with a 1024-wide text_projection).

Causal masking, the MLP's activation (quick-gelu for the OpenAI towers,
exact-erf GELU for OpenCLIP's), f32 LayerNorm islands, `output_layer`
selection, the final LayerNorm, EOT pooling (argmax over the token ids) and
the optional projection, with the flax tree's names.  Attention over 77
tokens is plain torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import Dense, Embed, NormParams, flax_layer_norm


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    context_length: int = 77
    projection_dim: Optional[int] = None  # set for CLIP similarity towers
    act: str = "quick_gelu"  # quick_gelu (OpenAI) | gelu (OpenCLIP, exact erf)
    output_layer: int = -1  # -1 = last (after ln_final); -2 = raw penultimate


SD15_TEXT = CLIPTextConfig()
SDXL_TEXT_L = CLIPTextConfig(output_layer=-2)
SDXL_TEXT_BIGG = CLIPTextConfig(width=1280, layers=32, heads=20, act="gelu", output_layer=-2, projection_dim=1280)
CLIP_RN50_TEXT = CLIPTextConfig(width=512, layers=12, heads=8, projection_dim=1024)


class CLIPTextBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype, device):
        super().__init__()
        w = cfg.width
        self.heads = cfg.heads
        self.ln_1 = NormParams(w, device)
        self.attn_qkv = Dense(w, 3 * w, dtype=dtype, device=device)
        self.attn_out = Dense(w, w, dtype=dtype, device=device)
        self.ln_2 = NormParams(w, device)
        self.mlp_fc = Dense(w, 4 * w, dtype=dtype, device=device)
        self.mlp_proj = Dense(4 * w, w, dtype=dtype, device=device)
        if cfg.act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown text tower activation {cfg.act!r}")
        self.act = cfg.act

    def forward(self, x, mask_bias):
        b, l, w = x.shape
        d = w // self.heads
        h = flax_layer_norm(x, self.ln_1.scale, self.ln_1.bias).to(x.dtype)
        q, k, v = self.attn_qkv(h).reshape(b, l, 3, self.heads, d).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
        probs = torch.softmax(logits + mask_bias, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, w)
        x = x + self.attn_out(out)
        h = self.mlp_fc(flax_layer_norm(x, self.ln_2.scale, self.ln_2.bias).to(x.dtype))
        # OpenCLIP's nn.GELU() is the exact erf form, not the tanh approximation
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.mlp_proj(h)


class CLIPTextEncoder(nn.Module):
    """forward(token_ids (B, 77)) -> {"hidden": (B, 77, width), "pooled": (B, width)},
    and "proj": (B, projection_dim) where the config has a projection."""

    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = Embed(cfg.vocab_size, cfg.width, dtype=dtype, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.width, dtype=dtype, device=device), requires_grad=False)
        for i in range(cfg.layers):
            setattr(self, f"resblocks_{i}", CLIPTextBlock(cfg, dtype, device))
        self.ln_final = NormParams(cfg.width, device)
        if cfg.projection_dim is not None:
            self.text_projection = Dense(cfg.width, cfg.projection_dim, bias=False, dtype=dtype, device=device)

    def forward(self, token_ids, spliced_embeddings: Optional[torch.Tensor] = None):
        """spliced_embeddings (B, l, width) replaces the token-embedding
        lookup (BLIP-Diffusion's subject splice); the positional embedding,
        the causal mask and the EOT pooling still follow token_ids."""
        cfg = self.cfg
        b, l = token_ids.shape
        tok = self.token_embedding(token_ids)
        if spliced_embeddings is not None:
            tok = spliced_embeddings.to(tok.dtype)
        x = tok + self.positional_embedding[None, :l].to(tok.dtype)
        causal = torch.full((l, l), -1e9, dtype=torch.float32, device=tok.device).triu(1)[None, None]
        hiddens = []
        for i in range(cfg.layers):
            x = getattr(self, f"resblocks_{i}")(x, causal)
            hiddens.append(x)
        final = flax_layer_norm(hiddens[-1], self.ln_final.scale, self.ln_final.bias).to(x.dtype)
        hidden = final if cfg.output_layer == -1 else hiddens[cfg.output_layer]
        pooled = final[torch.arange(b, device=tok.device), token_ids.argmax(dim=-1)]
        out = {"hidden": hidden, "pooled": pooled}
        if cfg.projection_dim is not None:
            out["proj"] = self.text_projection(pooled)
        return out
