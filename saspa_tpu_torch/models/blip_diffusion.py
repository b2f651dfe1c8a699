"""BLIP-Diffusion: SD1.5 conditioned on subject embeddings from a Q-Former
(counterpart of saspa_tpu/models/blip_diffusion.py).

SaSPA's backbone for CompCars, Cars and DTD, and `cli gen`'s default for
every dataset but planes:
  * vision tower: CLIP ViT-L/14 (width 1024, 24 layers, 16 heads; 257 tokens
    at 224^2), the plain attention path;
  * Q-Former: 16 learned queries and the source subject category as BERT
    text; post-LN layers (eps 1e-12, f32) whose attention logits are f32,
    divided by sqrt(d) after the product, with a -1e9 padding bias;
    cross-attention to the image tokens for the query half on layers
    i % cross_freq == 0; split query and text FFNs with exact GELU; the
    text half dropped after the last layer; a ProjLayer head (pre-LN,
    residual, QuickGELU, no trailing norm) to the CLIP text width;
  * the CLIP text tower with the 16 subject embeddings spliced into its
    token embeddings at CTX_BEGIN_POS; the prompt is "a {subject} {p}"
    repeated 20 times, comma-joined, tokenized to 77 - 16 positions;
  * the SD1.5 UNet, canny ControlNet and VAE of `DiffusionPipeline`.
The fused function runs the towers once a batch, then the SD1.5 denoise.
`edit` is the `blip_diffusion-edit` subject swap (LAVIS' edit): the source
DDIM-inverted under its plain description (`invert`: the VAE encoder, then
49 UNet calls up the ascending schedule of 50 steps, no CFG), then sampled
back under the subject-spliced prompt.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
from saspa_tpu_torch.gen.tokenizer import CONTEXT_LENGTH
from saspa_tpu_torch.models.blip_caption import WordPieceTokenizer
from saspa_tpu_torch.models.clip import CLIPVisionViT, CLIPVisionViTConfig, clip_preprocess
from saspa_tpu_torch.models.layers import Dense, Embed, NormParams, flax_layer_norm, init_weights
from saspa_tpu_torch.ops.switches import KernelSwitches

CTX_BEGIN_POS = 2
NUM_QUERY_TOKENS = 16
# fixed BERT-token budget for the source subject category: [CLS] + 22 + [SEP]
_CAT_LEN = 24

# LAVIS blip-diffusion's vision tower (vit_model="clip_L")
BLIP_VISION = CLIPVisionViTConfig(patch_size=14, width=1024, layers=24, heads=16, output_dim=None)


@dataclass(frozen=True)
class QFormerConfig:
    width: int = 768
    layers: int = 12
    heads: int = 12
    num_queries: int = NUM_QUERY_TOKENS
    out_dim: int = 768  # CLIP text width
    encoder_width: int = 1024  # the vision tower's width (cross-attention keys and values)
    cross_freq: int = 2
    vocab_size: int = 30523
    max_positions: int = 512


def _ln(x, norm: NormParams, dtype):
    """flax LayerNorm(epsilon=1e-12, dtype=float32), cast to dtype."""
    return flax_layer_norm(x, norm.scale, norm.bias, eps=1e-12).to(dtype)


def _bert_attention(x, kv, heads: int, query: Dense, key: Dense, value: Dense, mask_bias=None):
    """Post-LN BERT attention without its output block: f32 logits divided
    by sqrt(d) after the product, optional additive f32 mask bias,
    probabilities cast to v's dtype."""
    b, lq, w = x.shape
    d = w // heads
    q = query(x).reshape(b, lq, heads, d)
    k = key(kv).reshape(b, kv.shape[1], heads, d)
    v = value(kv).reshape(b, kv.shape[1], heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / float(np.sqrt(d))
    if mask_bias is not None:
        logits = logits + mask_bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, lq, w)


class QFormerLayer(nn.Module):
    """One Blip2QFormerLayer: self-attention over [queries ; text],
    cross-attention for the query part (has_cross), split FFNs."""

    def __init__(self, width: int, heads: int, has_cross: bool, encoder_width: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.has_cross = heads, has_cross
        for p, kv_width in [("self", width)] + ([("cross", encoder_width)] if has_cross else []):
            for name, in_width in (("query", width), ("key", kv_width), ("value", kv_width), ("out_dense", width)):
                setattr(self, f"{p}_{name}", Dense(in_width, width, dtype=dtype, device=device))
            setattr(self, f"{p}_out_ln", NormParams(width, device))
        for p in ("q", "t"):
            setattr(self, f"ffn_{p}_fc", Dense(width, 4 * width, dtype=dtype, device=device))
            setattr(self, f"ffn_{p}_proj", Dense(4 * width, width, dtype=dtype, device=device))
            setattr(self, f"ffn_{p}_ln", NormParams(width, device))

    def _attend(self, p: str, x, kv, mask_bias=None):
        """The output block after the attention: LN(x + dense(attention))."""
        a = _bert_attention(x, kv, self.heads, getattr(self, f"{p}_query"), getattr(self, f"{p}_key"),
                            getattr(self, f"{p}_value"), mask_bias)
        a = getattr(self, f"{p}_out_dense")(a)
        return _ln(x + a, getattr(self, f"{p}_out_ln"), a.dtype)

    def _ffn(self, p: str, h):
        f = getattr(self, f"ffn_{p}_proj")(F.gelu(getattr(self, f"ffn_{p}_fc")(h)))  # exact (erf) GELU
        return _ln(h + f, getattr(self, f"ffn_{p}_ln"), f.dtype)

    def forward(self, hidden, image_tokens, query_len: int, mask_bias=None):
        hidden = self._attend("self", hidden, hidden, mask_bias)
        hq = hidden[:, :query_len]
        if self.has_cross:
            hq = self._attend("cross", hq, image_tokens)
        hq = self._ffn("q", hq)
        if hidden.shape[1] == query_len:
            return hq
        return torch.cat([hq, self._ffn("t", hidden[:, query_len:])], dim=1)


class QFormer(nn.Module):
    """forward(image_tokens (B, L, E), text_ids (B, T)?, text_mask (B, T)?)
    -> (B, num_queries, out_dim) subject embeddings.  text_mask: 1 = real
    token; padded positions are masked out of self-attention and their FFN
    outputs dropped with the text half."""

    def __init__(self, cfg: QFormerConfig = QFormerConfig(), dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        w = cfg.width
        self.query_tokens = nn.Parameter(torch.zeros(1, cfg.num_queries, w, dtype=dtype, device=device),
                                         requires_grad=False)
        self.word_embeddings = Embed(cfg.vocab_size, w, dtype=dtype, device=device)
        self.position_embeddings = nn.Parameter(torch.zeros(cfg.max_positions, w, dtype=dtype, device=device),
                                                requires_grad=False)
        self.embeddings_ln = NormParams(w, device)
        for i in range(cfg.layers):
            setattr(self, f"layer_{i}", QFormerLayer(w, cfg.heads, i % cfg.cross_freq == 0, cfg.encoder_width,
                                                     dtype, device))
        self.proj_ln = NormParams(w, device)
        self.proj_dense1 = Dense(w, 4 * w, dtype=dtype, device=device)
        self.proj_dense2 = Dense(4 * w, cfg.out_dim, dtype=dtype, device=device)

    def forward(self, image_tokens, text_ids=None, text_mask=None):
        cfg = self.cfg
        b = image_tokens.shape[0]
        x = self.query_tokens.to(image_tokens.dtype).expand(b, -1, -1)
        mask_bias = None
        if text_ids is not None:
            text_ids = torch.as_tensor(text_ids, device=image_tokens.device).long()
            tok = self.word_embeddings(text_ids)
            tok = tok + self.position_embeddings[None, :text_ids.shape[1]].to(tok.dtype)
            x = torch.cat([x, tok], dim=1)
            if text_mask is not None:
                text_mask = torch.as_tensor(text_mask, device=image_tokens.device)
                full = torch.cat([torch.ones((b, cfg.num_queries), dtype=text_mask.dtype, device=text_mask.device),
                                  text_mask], dim=1)
                mask_bias = (1.0 - full[:, None, None, :].float()) * -1e9
        x = _ln(x, self.embeddings_ln, x.dtype)
        for i in range(cfg.layers):
            x = getattr(self, f"layer_{i}")(x, image_tokens, cfg.num_queries, mask_bias)
        x = x[:, :cfg.num_queries]
        f = self.proj_dense1(_ln(x, self.proj_ln, x.dtype))
        return x + self.proj_dense2(f * torch.sigmoid(1.702 * f))  # QuickGELU


class BlipDiffusionPipeline(DiffusionPipeline):
    """The SD1.5 pipeline (switches as DiffusionPipeline's) plus
    params["blip_vision"] (CLIP ViT) and params["blip_qformer"];
    `make_fused_generate` takes the category ids and the reference images
    besides the SD arguments."""

    def __init__(self, controlnet: Optional[str] = "canny", sampler: str = "ddim", weights_dir: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, device=None, init_seed: Optional[int] = 0, unet_cfg=None,
                 vae_cfg=None, text_cfgs=None, vision_cfg: CLIPVisionViTConfig = BLIP_VISION,
                 qformer_cfg: QFormerConfig = QFormerConfig(), switches: Optional[KernelSwitches] = None):
        self.vision_cfg, self.qformer_cfg = vision_cfg, qformer_cfg
        super().__init__("blip_diffusion-controlnet" if controlnet else "blip_diffusion", controlnet=controlnet,
                         sampler=sampler, dtype=dtype, device=device, weights_dir=weights_dir, init_seed=init_seed,
                         unet_cfg=unet_cfg, vae_cfg=vae_cfg, text_cfgs=text_cfgs, switches=switches)
        vocab = Path(weights_dir or "") / "tokenizer" / "vocab.txt"
        self.bert_tokenizer = WordPieceTokenizer(str(vocab) if vocab.exists() else None)

    def _extra_modules(self) -> dict:
        # the Q-Former and the ViT-L tower load from one file (weights/load.py)
        return {"blip_vision": CLIPVisionViT(self.vision_cfg, self.dtype, self.device),
                "blip_qformer": QFormer(self.qformer_cfg, self.dtype, self.device)}

    def _random_init(self, seed: int, names=None) -> None:
        names = list(self.params) if names is None else names
        own = {"blip_vision": seed + 11, "blip_qformer": seed + 12}
        super()._random_init(seed, [n for n in names if n not in own])
        for n in names:
            if n in own:
                init_weights(self.params[n], own[n])

    def bert_category_ids(self, category: str, batch: int):
        """(ids, mask), (batch, _CAT_LEN) int32: [CLS] category [SEP], zero-padded."""
        ids = [101] + self.bert_tokenizer.encode(category or "")[: _CAT_LEN - 2] + [102]
        arr = np.zeros((batch, _CAT_LEN), np.int32)
        arr[:, :len(ids)] = ids
        mask = np.zeros((batch, _CAT_LEN), np.int32)
        mask[:, :len(ids)] = 1
        return arr, mask

    def build_subject_prompt_ids(self, prompts: List[str], target_subject: str, prompt_strength: float = 1.0,
                                 prompt_reps: int = 20) -> np.ndarray:
        """diffusers BlipDiffusionPipeline._build_prompt: 'a {subject} {p}'
        comma-joined prompt_reps times, tokenized to 77 - num_queries
        positions (EOT-padded), so the splice gives exactly 77."""
        reps = max(int(prompt_strength * prompt_reps), 1)
        texts = [", ".join([f"a {target_subject} {p}"] * reps) for p in prompts]
        return self.tokenizer(texts, context_length=CONTEXT_LENGTH - self.qformer_cfg.num_queries, pad="eot")

    def _encode_with_ctx(self, params, token_ids, ctx):
        """The text tower's hidden states with the subject embeddings ctx
        (B, nq, width) spliced in at CTX_BEGIN_POS.  token_ids (B, 77 - nq);
        the full-length ids carry zeros at the spliced positions."""
        te = params["text"][0]
        b, nq = ctx.shape[0], ctx.shape[1]
        want = CONTEXT_LENGTH - nq
        token_ids = torch.as_tensor(token_ids, device=ctx.device).long()
        if token_ids.shape[1] != want:
            raise ValueError(
                f"ctx-splice token_ids must be ({b}, {want}) = context_length - num_query_tokens (use "
                f"build_subject_prompt_ids), got {tuple(token_ids.shape)}: full-length ids would splice past the "
                f"{CONTEXT_LENGTH}-position table")
        tok = te.token_embedding(token_ids).to(ctx.dtype)
        spliced = torch.cat([tok[:, :CTX_BEGIN_POS], ctx, tok[:, CTX_BEGIN_POS:]], dim=1)
        zeros = torch.zeros((b, nq), dtype=token_ids.dtype, device=token_ids.device)
        ids_full = torch.cat([token_ids[:, :CTX_BEGIN_POS], zeros, token_ids[:, CTX_BEGIN_POS:]], dim=1)
        return te(ids_full, spliced_embeddings=spliced)["hidden"]

    @torch.no_grad()
    def subject_embeddings(self, params, ref_images, cat_ids, cat_mask):
        """ref_images (B, H, W, 3) in [0, 1] -> clip_preprocess -> vision
        tokens -> Q-Former with the category text: (B, nq, text width)."""
        ref = clip_preprocess(torch.as_tensor(ref_images, device=self.device).float())
        tokens = params["blip_vision"](ref.permute(0, 3, 1, 2), return_tokens=True)
        return params["blip_qformer"](tokens, cat_ids, cat_mask)

    def make_fused_generate(self, height: int, width: int, num_inference_steps: int, guidance_scale: float,
                            controlnet_scale: float = 0.75, canny_low: float = 120.0, canny_high: float = 200.0):
        """Returns fn(params, ids, neg_ids, cat_ids, cat_mask, ref_images,
        src_images, latents) -> (B, H, W, 3) uint8 images on the pipeline's
        device.  ids: (B, 61) from build_subject_prompt_ids; neg_ids (B, 77);
        cat_ids/cat_mask: bert_category_ids of the source category;
        ref_images: (B, 224, 224, 3) in [0, 1]; src_images and latents as
        DiffusionPipeline's.  return_images=True also returns the [0, 1]
        images before quantisation."""
        dev = self.device
        denoise = self._denoise(height, width, num_inference_steps, guidance_scale, controlnet_scale, canny_low,
                                canny_high)

        @torch.no_grad()
        def fused(params, ids, neg_ids, cat_ids, cat_mask, ref_images, src_images, latents,
                  return_images: bool = False):
            subject = self.subject_embeddings(params, ref_images, cat_ids, cat_mask)
            ctx = self._encode_with_ctx(params, ids, subject)
            nctx = None
            if guidance_scale > 1.0:
                nctx = params["text"][0](torch.as_tensor(neg_ids, device=dev).long())["hidden"]
            return denoise(params, ctx, nctx, src_images, latents, return_images)

        return fused


    @torch.no_grad()
    def invert(self, images, context, num_inversion_steps: int = 50) -> torch.Tensor:
        """DDIM inversion (the JAX package's `invert`): (B, H, W, 3) images
        in [0, 1] -> the scaled posterior mean -> len(ts) - 1 deterministic
        DDIM steps t_i -> t_{i+1} up the ascending timesteps ts of
        num_inversion_steps, each one UNet call under `context` (B, 77, D)
        without CFG.  Returns (B, H/8, W/8, 4) f32 latents; the latents are
        f32 from the start (the UNet's eps is)."""
        ac = self.scheduler.alphas_cumprod
        ts = [int(t) for t in self.scheduler.timesteps(num_inversion_steps)[::-1]]
        unet = self.params["unet"]
        lat = self.encode_image(images).float().permute(0, 3, 1, 2)
        for t, t_next in zip(ts[:-1], ts[1:]):
            eps = unet(lat, t, context, None, None, None)
            a_t, a_next = ac[t], ac[t_next]
            x0 = (lat - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
            lat = torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * eps
        return lat.permute(0, 2, 3, 1)

    @torch.no_grad()
    def edit(self, source_images, subject_images, prompts, source_subject: str, target_subject: str,
             guidance_scale: float = 7.5, num_inference_steps: int = 50, num_inversion_steps: int = 50,
             negative_prompt: Optional[str] = None) -> torch.Tensor:
        """Subject-swap edit (the JAX package's `edit`): the subject
        embeddings of subject_images (B, h, w, 3) in [0, 1] with the source
        category; source_images (B, H, W, 3) in [0, 1] inverted under the plain
        text of "a {source_subject}"; then the DDIM loop from the inverted
        latents under the prompts with the target subject spliced in, with
        CFG against negative_prompt when guidance_scale > 1 (the path draws
        no noise).  Returns (B, H, W, 3) f32 images in [0, 1]."""
        b, params, dev = len(prompts), self.params, self.device
        text = params["text"][0]
        cat_ids, cat_mask = self.bert_category_ids(source_subject, b)
        subject = self.subject_embeddings(params, subject_images, cat_ids, cat_mask)
        ctx = self._encode_with_ctx(params, self.build_subject_prompt_ids(list(prompts), target_subject), subject)
        nctx = None
        if guidance_scale > 1:
            nids = self.tokenizer([negative_prompt or ""] * b, pad="eot")
            nctx = text(torch.as_tensor(nids, device=dev).long())["hidden"]
        src_ids = self.tokenizer([f"a {source_subject}"] * b, pad="eot")
        inv_ctx = text(torch.as_tensor(src_ids, device=dev).long())["hidden"]
        latents = self.invert(source_images, inv_ctx, num_inversion_steps)
        return self._sample(params, latents, ctx, nctx, self.scheduler.timesteps(num_inference_steps),
                            guidance_scale=float(guidance_scale))
