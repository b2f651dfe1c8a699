"""SD1.5, SD2.1 and SDXL conditional UNets in PyTorch (counterpart of saspa_tpu/models/unet.py).

SD2.1 (`SD21_UNET`) keeps SD1.5's four levels with heads of d 64 (5, 10,
20, 20 heads), a 1024-wide context and linear proj_in/proj_out.

SDXL (`SDXL_UNET`: three levels 320/640/1280, transformer depth 1/2/10,
heads of d 64, cross-attention width 2048) adds linear proj_in/proj_out
(`use_linear_projection`) and the text_time added conditions: the pooled
text embedding and six time ids (five for the refiner, `SDXL_REFINER_UNET`:
four levels 384/768/1536/1536, depth 4, heads of d 64, cross-attention
width 1280) enter `temb` through `add_embedding`, in
`UNetEncoder.temb`, so the ControlNet takes them too.  Since they feed
every resnet, XL runs without the CFG shared prefix (below): its sampler
hands the UNet 2B latents under CFG.

NCHW inside (channels-last in memory from the latents on, the format the
convolutions keep); module and parameter names follow the flax tree.  By default
it runs what the JAX package runs by default: self-attention over >= 256
tokens runs the packed-heads kernel (K1) with head dims padded in the
weights where its guard admits the shape, else (level 0 at 1024^2) the
streamed flash kernel (K6) on the unpadded projections, every transformer
block's norm3 + feed-forward runs the fused
LN+GEGLU kernel (K2), norm1/norm2 the one-pass LayerNorm (K4), every
GroupNorm the GroupNorm kernel (K3) in `_xla_group_norm`'s order, and
cross-attention over the 77 text tokens is plain torch.

Two options select the counterpart of the JAX package's opt-in kernels
(SASPA_PALLAS_GN=1 SASPA_ATTN_MEGAKERNEL=1): `pallas_group_norm` gives K3 the
TPU kernel's bf16 numerics wherever that kernel's `_split_plan` admits the
site, and `attention_megakernel` runs each self-attention that
`attention_block_eligible` admits, with its residual add, through the block
kernel (K5).

CFG shared prefix (`cfg_tile`): under classifier-free guidance both halves
share one latent, so the network runs at batch B until the first
cross-attention, which meets the 2B [uncond, cond] context and forks the
batch to 2B; pre-fork tensors are tiled wherever they join post-fork ones.
A sample batch equal to the context's (no CFG, SDXL's CFG, InstructPix2Pix's
3-way CFG at 3B) runs plain, with no fork.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from saspa_tpu_torch.models.layers import Conv, Dense, NormParams
from saspa_tpu_torch.ops.attention import (
    LOG2E,
    attention,
    attention_block_eligible,
    attention_block_fused,
    flash_attention_packed,
    fold_scale,
    packed_flash_eligible,
    pad_head_dim,
)
from saspa_tpu_torch.ops.geglu import fused_ln_geglu
from saspa_tpu_torch.ops.groupnorm import group_norm, groups_for, split_plan
from saspa_tpu_torch.ops.layernorm import layer_norm_one_pass
from saspa_tpu_torch.ops.layernorm import layer_norm_one_pass_plain as _ln32_forward  # noqa: F401


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)  # head COUNT per block (diffusers' naming)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None  # None | "text_time" (SDXL)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None  # SDXL: 2816 = 1280 pooled + 6 x 256
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True

    def depth(self, block_idx: int) -> int:
        return self.transformer_layers_per_block[min(block_idx, len(self.transformer_layers_per_block) - 1)]


SD15_UNET = UNetConfig()

# SD2.1 (stabilityai/stable-diffusion-2-1): SD1.5's levels with heads of d 64
# (5/10/20/20 heads), OpenCLIP-H's 1024-wide context and linear projections
SD21_UNET = UNetConfig(
    num_attention_heads=(5, 10, 20, 20),
    cross_attention_dim=1024,
    use_linear_projection=True,
)

SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    transformer_layers_per_block=(1, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=2816,
)

# the SDXL refiner (stabilityai/stable-diffusion-xl-refiner-1.0): plain
# blocks at levels 0 and 3, 4-deep transformers at levels 1 and 2 and in
# the mid block (which reads the last entry), heads of d 64, bigG-only
# text (1280), add_embedding input 2560 = pooled 1280 + 5 time ids x 256
SDXL_REFINER_UNET = UNetConfig(
    block_out_channels=(384, 768, 1536, 1536),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    transformer_layers_per_block=(1, 4, 4, 4),
    num_attention_heads=(6, 12, 24, 24),
    cross_attention_dim=1280,
    use_linear_projection=True,
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=2560,
)

UNET_CONFIGS = {
    "sd_v1.5": SD15_UNET,
    "sd_v2.1": SD21_UNET,
    "sd_xl": SDXL_UNET,
    "sd_xl-turbo": SDXL_UNET,
    "sd_xl-refiner": SDXL_REFINER_UNET,
    "blip_diffusion": SD15_UNET,  # BLIP-Diffusion rides an SD1.5 UNet
    "blip_diffusion-controlnet": SD15_UNET,
    "ip2p": replace(SD15_UNET, in_channels=8),  # InstructPix2Pix: latents ++ image latents
}


def timestep_embedding(t, dim: int, flip_sin_to_cos=True, freq_shift=0.0, max_period=10000.0):
    """Sinusoidal embedding (diffusers get_timestep_embedding); f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim, dim, dtype, device):
        super().__init__()
        self.linear_1 = Dense(in_dim, dim, dtype=dtype, device=device)
        self.linear_2 = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm32(nn.Module):
    """GroupNorm with f32 statistics (params under <name>.GroupNorm_0), K3.
    tpu_numerics: the TPU kernel's numerics at the sites its split plan
    admits (decided per call from the input's shape and dtype)."""

    def __init__(self, channels, num_groups=32, eps=1e-5, act=None, device=None, tpu_numerics=False):
        super().__init__()
        self.GroupNorm_0 = NormParams(channels, device)
        self.num_groups, self.eps, self.act, self.tpu_numerics = num_groups, eps, act, tpu_numerics

    def forward(self, x):
        p = self.GroupNorm_0
        c = x.shape[1]
        tpu = self.tpu_numerics and split_plan(
            math.prod(x.shape[2:]), c, groups_for(c, self.num_groups), x.element_size()) is not None
        return group_norm(x, p.scale, p.bias, self.num_groups, self.eps, self.act, tpu_numerics=tpu)


class LayerNorm32(NormParams):
    """LayerNorm with f32 statistics and a normalize pass in x's dtype (K4;
    `_ln32_forward` is its plain version)."""

    def __init__(self, features, eps=1e-5, device=None):
        super().__init__(features, device)
        self.eps = eps

    def forward(self, x):
        return layer_norm_one_pass(x, self.scale, self.bias, self.eps)


def cfg_tile(x, n: int):
    """Tile a pre-fork (B) tensor to the post-fork batch n = 2B."""
    if x.shape[0] == n:
        return x
    assert 2 * x.shape[0] == n, (tuple(x.shape), n)
    return torch.cat([x, x], dim=0)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, dtype, device, groups=32, pallas_group_norm=False):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, groups, act="silu", device=device, tpu_numerics=pallas_group_norm)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1, dtype=dtype, device=device)
        self.time_emb_proj = Dense(temb_dim, out_ch, dtype=dtype, device=device)
        self.norm2 = GroupNorm32(out_ch, groups, act="silu", device=device, tpu_numerics=pallas_group_norm)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, dtype=dtype, device=device)
        self.conv_shortcut = Conv(in_ch, out_ch, 1, dtype=dtype, device=device) if in_ch != out_ch else None

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb))
        h = h + cfg_tile(t, h.shape[0])[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, dtype, device, megakernel=False):
        super().__init__()
        self.heads = heads
        self.megakernel = megakernel
        self.to_q = Dense(query_dim, query_dim, bias=False, dtype=dtype, device=device)
        self.to_k = Dense(context_dim, query_dim, bias=False, dtype=dtype, device=device)
        self.to_v = Dense(context_dim, query_dim, bias=False, dtype=dtype, device=device)
        # the bias stays an f32 master: K5 adds it in f32, as the JAX block
        # kernel does; the other paths cast it to the compute dtype per call
        self.to_out = Dense(query_dim, query_dim, dtype=dtype, device=device, bias_dtype=torch.float32)
        self._padded = None  # (key, (wq, wk, wv, wo, wq_scaled)) head-padded weights

    def padded_weights(self):
        """Head-padded (H*D_pad, in) q/k/v kernels, (out, H*D_pad) to_out
        kernel and the q kernel with softmax_scale*log2(e) folded in (rounded
        to the compute dtype, as the JAX block path folds it); built once per
        weight version, not per call.  Zero pad rows make the padded q/k/v
        columns zero, so attention is unchanged and the padded output columns
        are exactly zero."""
        wq = self.to_q.kernel
        key = (wq.dtype, wq.device, wq.data_ptr(), wq._version)
        if self._padded is None or self._padded[0] != key:
            h = self.heads
            inner = wq.shape[0]
            d = inner // h
            dp = pad_head_dim(d)

            def rows(w):
                return F.pad(w.reshape(h, d, -1), (0, 0, 0, dp - d)).reshape(h * dp, -1).contiguous()

            wo = F.pad(self.to_out.kernel.reshape(inner, h, d), (0, dp - d)).reshape(inner, h * dp).contiguous()
            wqp = rows(wq)
            self._padded = (key, (wqp, rows(self.to_k.kernel), rows(self.to_v.kernel), wo,
                                  fold_scale(wqp, LOG2E / math.sqrt(d))))
        return self._padded[1]

    def forward(self, x, context=None, residual=None):
        is_self = context is None
        context = x if context is None else context
        inner = x.shape[-1]
        d = inner // self.heads
        if packed_flash_eligible(x.shape[1], context.shape[1], self.heads, d, x.element_size()):
            wq, wk, wv, wo, wq_scaled = self.padded_weights()
            dt = wq.dtype
            if self.megakernel and is_self and residual is not None and attention_block_eligible(
                    x.shape[1], context.shape[1], self.heads, d, inner, x.element_size()):
                return attention_block_fused(x.to(dt), residual, wq_scaled, wk, wv, wo, self.to_out.bias, self.heads)
            q = F.linear(x.to(dt), wq)
            k = F.linear(context.to(dt), wk)
            v = F.linear(context.to(dt), wv)
            q = cfg_tile(q, context.shape[0])
            qs = fold_scale(q, LOG2E / math.sqrt(d))
            out = F.linear(flash_attention_packed(qs, k, v, self.heads), wo, self.to_out.bias.to(dt))
        else:  # unpadded projections: cross-attention, and self-attention past the packed guard (K6)
            q = cfg_tile(self.to_q(x), context.shape[0])
            out = self.to_out(attention(q, self.to_k(context), self.to_v(context), self.heads))
        return out if residual is None else residual + out


class FeedForwardGEGLU(nn.Module):
    """GEGLU feed-forward weights; the block runs them through fused_ln_geglu (K2)."""

    def __init__(self, dim, dtype, device, mult=4):
        super().__init__()
        self.proj_in = Dense(dim, dim * mult * 2, dtype=dtype, device=device)
        self.proj_out = Dense(dim * mult, dim, dtype=dtype, device=device)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, context_dim, heads, dtype, device, megakernel=False):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dtype, device, megakernel=megakernel)
        self.attn2 = CrossAttention(dim, context_dim, heads, dtype, device)
        self.norm1 = LayerNorm32(dim, device=device)
        self.norm2 = LayerNorm32(dim, device=device)
        self.norm3 = LayerNorm32(dim, device=device)
        self.ff = FeedForwardGEGLU(dim, dtype, device)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x).to(x.dtype), residual=x)
        a2 = self.attn2(self.norm2(x).to(x.dtype), context)
        x = cfg_tile(x, a2.shape[0]) + a2  # CFG fork point (B -> 2B)
        ff = self.ff
        return fused_ln_geglu(x, self.norm3.scale, self.norm3.bias, ff.proj_in.kernel, ff.proj_in.bias,
                              ff.proj_out.kernel, ff.proj_out.bias, self.norm3.eps)


class Transformer2D(nn.Module):
    """proj_in/proj_out: 1x1 convs, or dense layers on the tokens with
    use_linear_projection (SD2.x, SDXL)."""

    def __init__(self, channels, context_dim, heads, depth, dtype, device, pallas_group_norm=False,
                 attention_megakernel=False, use_linear_projection=False):
        super().__init__()
        # diffusers' Transformer2DModel uses eps 1e-6 for this norm
        self.norm = GroupNorm32(channels, 32, eps=1e-6, device=device, tpu_numerics=pallas_group_norm)
        self.linear = use_linear_projection
        if use_linear_projection:
            self.proj_in = Dense(channels, channels, dtype=dtype, device=device)
        else:
            self.proj_in = Conv(channels, channels, 1, dtype=dtype, device=device)
        for i in range(depth):
            setattr(self, f"blocks_{i}", BasicTransformerBlock(channels, context_dim, heads, dtype, device,
                                                               megakernel=attention_megakernel))
        self.depth = depth
        if use_linear_projection:
            self.proj_out = Dense(channels, channels, dtype=dtype, device=device)
        else:
            self.proj_out = Conv(channels, channels, 1, dtype=dtype, device=device)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.linear:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x, context)
        # the batch may have grown B -> 2B at the CFG fork inside the blocks
        n = x.shape[0]
        if self.linear:
            x = self.proj_out(x).reshape(n, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(n, h, w, c).permute(0, 3, 1, 2))
        return x + cfg_tile(residual, n)


class Downsample2D(nn.Module):
    def __init__(self, channels, dtype, device):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels, dtype, device):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, cfg: UNetConfig, temb_dim, dtype, device, pallas_group_norm=False,
                 attention_megakernel=False):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        heads = cfg.num_attention_heads[len(cfg.block_out_channels) - 1]
        gn = pallas_group_norm
        self.resnets_0 = ResnetBlock2D(ch, ch, temb_dim, dtype, device, pallas_group_norm=gn)
        self.attentions_0 = Transformer2D(ch, cfg.cross_attention_dim, heads, cfg.transformer_layers_per_block[-1],
                                          dtype, device, gn, attention_megakernel, cfg.use_linear_projection)
        self.resnets_1 = ResnetBlock2D(ch, ch, temb_dim, dtype, device, pallas_group_norm=gn)

    def forward(self, x, temb, context):
        x = self.resnets_0(x, temb)
        x = self.attentions_0(x, context)
        return self.resnets_1(x, temb)


class UNetEncoder(nn.Module):
    """time embedding + conv_in + down blocks + mid block: the part the UNet
    and the ControlNet share (names as in the flax tree).  pallas_group_norm
    and attention_megakernel select the opt-in kernel configuration (module
    docstring)."""

    def __init__(self, cfg: UNetConfig, dtype, device, pallas_group_norm=False, attention_megakernel=False):
        super().__init__()
        gn, mk = pallas_group_norm, attention_megakernel
        self.cfg = cfg
        boc = cfg.block_out_channels
        temb_dim = boc[0] * 4
        self.time_embedding = TimestepEmbedding(boc[0], temb_dim, dtype, device)
        if cfg.addition_embed_type == "text_time":
            if cfg.projection_class_embeddings_input_dim is None:
                raise ValueError("text_time added conditions need projection_class_embeddings_input_dim")
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_dim, dtype, device)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"unknown addition_embed_type {cfg.addition_embed_type!r}")
        self.conv_in = Conv(cfg.in_channels, boc[0], 3, padding=1, dtype=dtype, device=device)
        self.skip_channels = [boc[0]]
        cur = boc[0]
        for i, block_type in enumerate(cfg.down_block_types):
            ch = boc[i]
            for j in range(cfg.layers_per_block):
                setattr(self, f"down_{i}_resnets_{j}", ResnetBlock2D(cur, ch, temb_dim, dtype, device,
                                                                     pallas_group_norm=gn))
                cur = ch
                if block_type == "CrossAttnDownBlock2D":
                    setattr(self, f"down_{i}_attentions_{j}", Transformer2D(
                        ch, cfg.cross_attention_dim, cfg.num_attention_heads[i], cfg.depth(i), dtype, device, gn, mk,
                        cfg.use_linear_projection))
                self.skip_channels.append(ch)
            if i < len(boc) - 1:
                setattr(self, f"down_{i}_downsample", Downsample2D(ch, dtype, device))
                self.skip_channels.append(ch)
        self.mid_block = UNetMidBlock2DCrossAttn(cfg, temb_dim, dtype, device, gn, mk)

    def temb(self, sample, timesteps, added_cond=None):
        """The time embedding; with text_time added conditions
        ({"text_embeds": (B, pooled), "time_ids": (B, n)}, B the sample's
        batch) plus add_embedding of [text_embeds, the time ids' sinusoidal
        embeddings]."""
        cfg = self.cfg
        dt = self.conv_in.kernel.dtype
        t = torch.as_tensor(timesteps, device=sample.device)
        if t.ndim == 0:
            t = t.expand(sample.shape[0])
        t_freq = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_freq.to(dt))
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("SDXL needs added_cond {text_embeds, time_ids}")
            b = sample.shape[0]
            # added conditions enter temb, which feeds every resnet: no CFG shared prefix for XL
            if added_cond["text_embeds"].shape[0] != b:
                raise ValueError(f"text_time added_cond batch {added_cond['text_embeds'].shape[0]} must match the "
                                 f"sample's {b} (no CFG shared prefix for XL)")
            time_ids = torch.as_tensor(added_cond["time_ids"], device=sample.device).reshape(-1)
            tid = timestep_embedding(time_ids, cfg.addition_time_embed_dim, cfg.flip_sin_to_cos, cfg.freq_shift)
            add = torch.cat([added_cond["text_embeds"].float(), tid.reshape(b, -1)], dim=-1).to(dt)
            temb = temb + self.add_embedding(add)
        return temb

    def down(self, x, temb, context):
        """Runs the down blocks; returns (x, skip list)."""
        cfg = self.cfg
        res = [x]
        for i, block_type in enumerate(cfg.down_block_types):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_resnets_{j}")(x, temb)
                if block_type == "CrossAttnDownBlock2D":
                    x = getattr(self, f"down_{i}_attentions_{j}")(x, context)
                res.append(x)
            if i < len(cfg.block_out_channels) - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                res.append(x)
        return x, res


class UNet2DCondition(UNetEncoder):
    """forward(sample (B, C, h, w), timesteps, context (B or 2B, 77, D),
    down_res, mid_res, added_cond) -> eps (B or 2B, C, h, w) in f32;
    added_cond as UNetEncoder.temb's (SDXL)."""

    def __init__(self, cfg: UNetConfig = SD15_UNET, dtype=torch.float32, device=None, pallas_group_norm=False,
                 attention_megakernel=False):
        super().__init__(cfg, dtype, device, pallas_group_norm, attention_megakernel)
        gn, mk = pallas_group_norm, attention_megakernel
        boc = cfg.block_out_channels
        temb_dim = boc[0] * 4
        skips = list(self.skip_channels)
        cur = boc[-1]
        rev = list(boc)[::-1]
        for i, block_type in enumerate(cfg.up_block_types):
            ch = rev[i]
            block_idx = len(boc) - 1 - i
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up_{i}_resnets_{j}", ResnetBlock2D(cur + skips.pop(), ch, temb_dim, dtype, device,
                                                                   pallas_group_norm=gn))
                cur = ch
                if block_type == "CrossAttnUpBlock2D":
                    setattr(self, f"up_{i}_attentions_{j}", Transformer2D(
                        ch, cfg.cross_attention_dim, cfg.num_attention_heads[block_idx], cfg.depth(block_idx),
                        dtype, device, gn, mk, cfg.use_linear_projection))
            if i < len(cfg.up_block_types) - 1:
                setattr(self, f"up_{i}_upsample", Upsample2D(ch, dtype, device))
        self.conv_norm_out = GroupNorm32(boc[0], cfg.norm_num_groups, act="silu", device=device, tpu_numerics=gn)
        self.conv_out = Conv(boc[0], cfg.out_channels, 3, padding=1, dtype=dtype, device=device)

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None, added_cond: Optional[dict] = None):
        cfg = self.cfg
        dt = self.conv_in.kernel.dtype
        temb = self.temb(sample, timesteps, added_cond)
        context = encoder_hidden_states.to(dt)
        x = self.conv_in(sample.to(dt))
        x, down_res = self.down(x, temb, context)

        if down_block_additional_residuals is not None:
            # pre-fork (B) heads and post-fork (2B) tails: tile whichever side is pre-fork
            down_res = [
                cfg_tile(r, max(r.shape[0], c.shape[0])) + cfg_tile(c, max(r.shape[0], c.shape[0]))
                for r, c in zip(down_res, down_block_additional_residuals)
            ]
        x = self.mid_block(x, temb, context)
        if mid_block_additional_residual is not None:
            x = x + cfg_tile(mid_block_additional_residual, x.shape[0])

        for i, block_type in enumerate(cfg.up_block_types):
            for j in range(cfg.layers_per_block + 1):
                skip = cfg_tile(down_res.pop(), x.shape[0])
                x = getattr(self, f"up_{i}_resnets_{j}")(torch.cat([x, skip], dim=1), temb)
                if block_type == "CrossAttnUpBlock2D":
                    x = getattr(self, f"up_{i}_attentions_{j}")(x, context)
            if i < len(cfg.up_block_types) - 1:
                x = getattr(self, f"up_{i}_upsample")(x)
        x = self.conv_out(self.conv_norm_out(x))
        return x.float()
