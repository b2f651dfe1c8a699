"""Public torch state_dicts -> flax-shaped param trees (numpy copies of the
converters in tools/convert_weights.py, for the port's models).

Each converter gives the tree the JAX package's module holds, key for key
and bit for bit: torch conv OIHW -> HWIO, linear (out, in) -> (in, out),
BatchNorm -> {params: {scale, bias}, batch_stats: {mean, var}}.  The port
then loads that tree through `bridge` (weights/load.py), the path its
tests already hold against JAX, at the cost of a second transpose of each
tensor at load.  The UNet, ControlNet and VAE converters take the port's
configs (models/unet.py UNET_CONFIGS, models/vae.py): the SDXL refiner's
UNet converts through `convert_sd_unet` with SDXL_REFINER_UNET.

Converters read their source through `sd[key]` only, so a dict that
records its reads (weights/load.py) tells which keys of a file went
unused.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from saspa_tpu_torch.models.lpips import _SCALE, _SHIFT


def t2f_conv(w: np.ndarray) -> np.ndarray:
    """torch conv kernel OIHW -> flax HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def t2f_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _set(tree: dict, path: str, value: np.ndarray):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


class _KeyRemapView:
    """Read-through view exposing a state dict under renamed key prefixes
    (a view, so the reads land on the original keys)."""

    def __init__(self, sd, fwd_prefix_map: Dict[str, str]):
        self._sd = sd
        self._inv = {v: k for k, v in fwd_prefix_map.items()}

    def _src_key(self, k: str) -> str:
        parts = k.split(".")
        for cut in (2, 1):
            head = ".".join(parts[:cut])
            if head in self._inv:
                remapped = self._inv[head] + k[len(head):]
                return remapped if remapped in self._sd else k
        return k

    def __getitem__(self, k):
        return self._sd[self._src_key(k)]

    def __contains__(self, k):
        return self._src_key(k) in self._sd


# --------------------------------------------------------------------------
# torchvision ResNet and the released WSDAN-CAL
# --------------------------------------------------------------------------
def convert_torchvision_resnet(sd, prefix: str = ""):
    """(params, batch_stats) of ResNet(features_only=True)."""
    params: dict = {}
    stats: dict = {}

    def bn(src, dst):
        _set(params, f"{dst}/scale", sd[f"{src}.weight"])
        _set(params, f"{dst}/bias", sd[f"{src}.bias"])
        _set(stats, f"{dst}/mean", sd[f"{src}.running_mean"])
        _set(stats, f"{dst}/var", sd[f"{src}.running_var"])

    def conv(src, dst):
        _set(params, f"{dst}/kernel", t2f_conv(sd[f"{src}.weight"]))

    conv(f"{prefix}conv1", "conv1")
    bn(f"{prefix}bn1", "bn1")
    li = 1
    while f"{prefix}layer{li}.0.conv1.weight" in sd:
        bi = 0
        while f"{prefix}layer{li}.{bi}.conv1.weight" in sd:
            src = f"{prefix}layer{li}.{bi}"
            dst = f"layer{li}_{bi}"
            for c in ("conv1", "conv2", "conv3"):
                conv(f"{src}.{c}", f"{dst}/{c}")
            for b in ("bn1", "bn2", "bn3"):
                bn(f"{src}.{b}", f"{dst}/{b}")
            if f"{src}.downsample.0.weight" in sd:
                conv(f"{src}.downsample.0", f"{dst}/downsample_conv")
                bn(f"{src}.downsample.1", f"{dst}/downsample_bn")
            bi += 1
        li += 1
    return params, stats


def cal_net(sd) -> str:
    """ResNet-101 when layer3 has a 23rd block, else ResNet-50."""
    return "resnet101" if any(k in sd for k in ("features.layer3.22.conv1.weight", "features.6.22.conv1.weight")) \
        else "resnet50"


def convert_cal(sd):
    """The reference's WSDAN_CAL state_dict (ResNet nets): the backbone is an
    index-named nn.Sequential (features.0 = conv1, .1 = bn1, .4-.7 =
    layer1-4), the attention head a BasicConv2d, fc bias-free."""
    remap = {"features.0": "features.conv1", "features.1": "features.bn1",
             "features.4": "features.layer1", "features.5": "features.layer2",
             "features.6": "features.layer3", "features.7": "features.layer4"}
    sd = _KeyRemapView(sd, remap)
    params: dict = {}
    stats: dict = {}
    params["features"], stats["features"] = convert_torchvision_resnet(sd, prefix="features.")
    _set(params, "attentions_conv/kernel", t2f_conv(sd["attentions.conv.weight"]))
    _set(params, "attentions_bn/scale", sd["attentions.bn.weight"])
    _set(params, "attentions_bn/bias", sd["attentions.bn.bias"])
    _set(stats, "attentions_bn/mean", sd["attentions.bn.running_mean"])
    _set(stats, "attentions_bn/var", sd["attentions.bn.running_var"])
    _set(params, "fc/kernel", t2f_linear(sd["fc.weight"]))
    return params, stats


# --------------------------------------------------------------------------
# diffusers UNet2DConditionModel / ControlNetModel / AutoencoderKL
# --------------------------------------------------------------------------
def convert_sd_unet(sd, cfg, include_up: bool = True):
    p: dict = {}

    def conv(src, dst):
        _set(p, f"{dst}/kernel", t2f_conv(sd[f"{src}.weight"]))
        if f"{src}.bias" in sd:
            _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    def dense(src, dst, bias=True):
        _set(p, f"{dst}/kernel", t2f_linear(sd[f"{src}.weight"]))
        if bias and f"{src}.bias" in sd:
            _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    def norm(src, dst):
        _set(p, f"{dst}/GroupNorm_0/scale", sd[f"{src}.weight"])
        _set(p, f"{dst}/GroupNorm_0/bias", sd[f"{src}.bias"])

    def layernorm(src, dst):
        _set(p, f"{dst}/scale", sd[f"{src}.weight"])
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    def resnet(src, dst):
        norm(f"{src}.norm1", f"{dst}/norm1")
        conv(f"{src}.conv1", f"{dst}/conv1")
        dense(f"{src}.time_emb_proj", f"{dst}/time_emb_proj")
        norm(f"{src}.norm2", f"{dst}/norm2")
        conv(f"{src}.conv2", f"{dst}/conv2")
        if f"{src}.conv_shortcut.weight" in sd:
            conv(f"{src}.conv_shortcut", f"{dst}/conv_shortcut")

    def attn(src, dst):
        dense(f"{src}.to_q", f"{dst}/to_q", bias=False)
        dense(f"{src}.to_k", f"{dst}/to_k", bias=False)
        dense(f"{src}.to_v", f"{dst}/to_v", bias=False)
        dense(f"{src}.to_out.0", f"{dst}/to_out")

    def transformer(src, dst, depth):
        norm(f"{src}.norm", f"{dst}/norm")
        if cfg.use_linear_projection:
            dense(f"{src}.proj_in", f"{dst}/proj_in")
            dense(f"{src}.proj_out", f"{dst}/proj_out")
        else:
            conv(f"{src}.proj_in", f"{dst}/proj_in")
            conv(f"{src}.proj_out", f"{dst}/proj_out")
        for i in range(depth):
            b_src = f"{src}.transformer_blocks.{i}"
            b_dst = f"{dst}/blocks_{i}"
            attn(f"{b_src}.attn1", f"{b_dst}/attn1")
            attn(f"{b_src}.attn2", f"{b_dst}/attn2")
            layernorm(f"{b_src}.norm1", f"{b_dst}/norm1")
            layernorm(f"{b_src}.norm2", f"{b_dst}/norm2")
            layernorm(f"{b_src}.norm3", f"{b_dst}/norm3")
            dense(f"{b_src}.ff.net.0.proj", f"{b_dst}/ff/proj_in")
            dense(f"{b_src}.ff.net.2", f"{b_dst}/ff/proj_out")

    conv("conv_in", "conv_in")
    dense("time_embedding.linear_1", "time_embedding/linear_1")
    dense("time_embedding.linear_2", "time_embedding/linear_2")
    if cfg.addition_embed_type == "text_time":
        dense("add_embedding.linear_1", "add_embedding/linear_1")
        dense("add_embedding.linear_2", "add_embedding/linear_2")

    n_blocks = len(cfg.block_out_channels)
    for i, btype in enumerate(cfg.down_block_types):
        for j in range(cfg.layers_per_block):
            resnet(f"down_blocks.{i}.resnets.{j}", f"down_{i}_resnets_{j}")
            if btype == "CrossAttnDownBlock2D":
                transformer(f"down_blocks.{i}.attentions.{j}", f"down_{i}_attentions_{j}", cfg.depth(i))
        if i < n_blocks - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", f"down_{i}_downsample/conv")

    resnet("mid_block.resnets.0", "mid_block/resnets_0")
    transformer("mid_block.attentions.0", "mid_block/attentions_0", cfg.transformer_layers_per_block[-1])
    resnet("mid_block.resnets.1", "mid_block/resnets_1")

    if not include_up:  # ControlNet: encoder + mid only
        return p

    for i, btype in enumerate(cfg.up_block_types):
        block_idx = n_blocks - 1 - i
        for j in range(cfg.layers_per_block + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", f"up_{i}_resnets_{j}")
            if btype == "CrossAttnUpBlock2D":
                transformer(f"up_blocks.{i}.attentions.{j}", f"up_{i}_attentions_{j}", cfg.depth(block_idx))
        if i < len(cfg.up_block_types) - 1:
            conv(f"up_blocks.{i}.upsamplers.0.conv", f"up_{i}_upsample/conv")

    norm("conv_norm_out", "conv_norm_out")
    conv("conv_out", "conv_out")
    return p


def convert_controlnet(sd, cfg):
    """diffusers ControlNetModel: the UNet's encoder naming, then the
    conditioning embedding and the zero convs."""
    p = convert_sd_unet(sd, cfg, include_up=False)

    def conv(src, dst):
        _set(p, f"{dst}/kernel", t2f_conv(sd[f"{src}.weight"]))
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    conv("controlnet_cond_embedding.conv_in", "controlnet_cond_embedding/conv_in")
    i = 0
    while f"controlnet_cond_embedding.blocks.{i}.weight" in sd:
        conv(f"controlnet_cond_embedding.blocks.{i}", f"controlnet_cond_embedding/blocks_{i}")
        i += 1
    conv("controlnet_cond_embedding.conv_out", "controlnet_cond_embedding/conv_out")
    i = 0
    while f"controlnet_down_blocks.{i}.weight" in sd:
        conv(f"controlnet_down_blocks.{i}", f"controlnet_down_blocks_{i}")
        i += 1
    conv("controlnet_mid_block", "controlnet_mid_block")
    return p


def convert_vae(sd, cfg):
    """Both attention namings: the 2022 exports' query/key/value/proj_attn
    (SD1.5's VAE file) and the post-0.18 to_q/to_k/to_v/to_out.0
    (sdxl-vae-fp16-fix)."""
    p: dict = {}

    def conv(src, dst):
        _set(p, f"{dst}/kernel", t2f_conv(sd[f"{src}.weight"]))
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    def norm(src, dst):
        _set(p, f"{dst}/GroupNorm_0/scale", sd[f"{src}.weight"])
        _set(p, f"{dst}/GroupNorm_0/bias", sd[f"{src}.bias"])

    def res(src, dst):
        norm(f"{src}.norm1", f"{dst}/norm1")
        conv(f"{src}.conv1", f"{dst}/conv1")
        norm(f"{src}.norm2", f"{dst}/norm2")
        conv(f"{src}.conv2", f"{dst}/conv2")
        if f"{src}.conv_shortcut.weight" in sd:
            conv(f"{src}.conv_shortcut", f"{dst}/conv_shortcut")

    def attnblock(src, dst):
        norm(f"{src}.group_norm", f"{dst}/group_norm")
        legacy = f"{src}.query.weight" in sd
        pairs = ((("query", "to_q"), ("key", "to_k"), ("value", "to_v")) if legacy
                 else (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v")))
        for a, b in pairs:
            _set(p, f"{dst}/{b}/kernel", t2f_linear(sd[f"{src}.{a}.weight"]))
            _set(p, f"{dst}/{b}/bias", sd[f"{src}.{a}.bias"])
        out_src = f"{src}.proj_attn" if legacy else f"{src}.to_out.0"
        _set(p, f"{dst}/to_out/kernel", t2f_linear(sd[f"{out_src}.weight"]))
        _set(p, f"{dst}/to_out/bias", sd[f"{out_src}.bias"])

    n = len(cfg.block_out_channels)
    conv("encoder.conv_in", "encoder/conv_in")
    for i in range(n):
        for j in range(cfg.layers_per_block):
            res(f"encoder.down_blocks.{i}.resnets.{j}", f"encoder/down_{i}_block_{j}")
        if i < n - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", f"encoder/down_{i}_downsample")
    res("encoder.mid_block.resnets.0", "encoder/mid_block_1")
    attnblock("encoder.mid_block.attentions.0", "encoder/mid_attn")
    res("encoder.mid_block.resnets.1", "encoder/mid_block_2")
    norm("encoder.conv_norm_out", "encoder/conv_norm_out")
    conv("encoder.conv_out", "encoder/conv_out")
    conv("quant_conv", "encoder/quant_conv")
    conv("post_quant_conv", "decoder/post_quant_conv")
    conv("decoder.conv_in", "decoder/conv_in")
    res("decoder.mid_block.resnets.0", "decoder/mid_block_1")
    attnblock("decoder.mid_block.attentions.0", "decoder/mid_attn")
    res("decoder.mid_block.resnets.1", "decoder/mid_block_2")
    for i in range(n):
        for j in range(cfg.layers_per_block + 1):
            res(f"decoder.up_blocks.{i}.resnets.{j}", f"decoder/up_{i}_block_{j}")
        if i < n - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", f"decoder/up_{i}_upsample")
    norm("decoder.conv_norm_out", "decoder/conv_norm_out")
    conv("decoder.conv_out", "decoder/conv_out")
    return p


# --------------------------------------------------------------------------
# CLIP text towers (HF) and OpenAI CLIP RN50
# --------------------------------------------------------------------------
def convert_clip_text_hf(sd, num_layers: int):
    """HF CLIPTextModel(WithProjection): q/k/v fused into one projection."""
    p: dict = {}
    pre = "text_model."
    _set(p, "token_embedding/embedding", sd[f"{pre}embeddings.token_embedding.weight"])
    p["positional_embedding"] = np.asarray(sd[f"{pre}embeddings.position_embedding.weight"])
    for i in range(num_layers):
        src = f"{pre}encoder.layers.{i}"
        dst = f"resblocks_{i}"
        qkv_w = [sd[f"{src}.self_attn.{m}_proj.weight"] for m in ("q", "k", "v")]
        qkv_b = [sd[f"{src}.self_attn.{m}_proj.bias"] for m in ("q", "k", "v")]
        _set(p, f"{dst}/attn_qkv/kernel", t2f_linear(np.concatenate(qkv_w, axis=0)))
        _set(p, f"{dst}/attn_qkv/bias", np.concatenate(qkv_b))
        _set(p, f"{dst}/attn_out/kernel", t2f_linear(sd[f"{src}.self_attn.out_proj.weight"]))
        _set(p, f"{dst}/attn_out/bias", sd[f"{src}.self_attn.out_proj.bias"])
        _set(p, f"{dst}/ln_1/scale", sd[f"{src}.layer_norm1.weight"])
        _set(p, f"{dst}/ln_1/bias", sd[f"{src}.layer_norm1.bias"])
        _set(p, f"{dst}/ln_2/scale", sd[f"{src}.layer_norm2.weight"])
        _set(p, f"{dst}/ln_2/bias", sd[f"{src}.layer_norm2.bias"])
        _set(p, f"{dst}/mlp_fc/kernel", t2f_linear(sd[f"{src}.mlp.fc1.weight"]))
        _set(p, f"{dst}/mlp_fc/bias", sd[f"{src}.mlp.fc1.bias"])
        _set(p, f"{dst}/mlp_proj/kernel", t2f_linear(sd[f"{src}.mlp.fc2.weight"]))
        _set(p, f"{dst}/mlp_proj/bias", sd[f"{src}.mlp.fc2.bias"])
    _set(p, "ln_final/scale", sd[f"{pre}final_layer_norm.weight"])
    _set(p, "ln_final/bias", sd[f"{pre}final_layer_norm.bias"])
    if "text_projection.weight" in sd:
        _set(p, "text_projection/kernel", t2f_linear(sd["text_projection.weight"]))
    return p


def convert_hed(sd):
    """controlnet_aux ControlNetHED_Apache2 (lllyasviel/Annotators
    ControlNetHED.pth): `norm` (1, 3, 1, 1), the learned input offset,
    blockN.convs.M.{weight,bias}, blockN.projection.{weight,bias}."""
    p: dict = {}
    p["norm"] = np.asarray(sd["norm"]).reshape(1, 1, 1, 3)
    for bi, n in enumerate((2, 2, 3, 3, 3), start=1):
        for ci in range(n):
            src = f"block{bi}.convs.{ci}"
            dst = f"block{bi}_conv{ci + 1}"
            _set(p, f"{dst}/kernel", t2f_conv(sd[f"{src}.weight"]))
            _set(p, f"{dst}/bias", sd[f"{src}.bias"])
        _set(p, f"block{bi}_projection/kernel", t2f_conv(sd[f"block{bi}.projection.weight"]))
        _set(p, f"block{bi}_projection/bias", sd[f"block{bi}.projection.bias"])
    return p


def convert_clip_rn50(sd):
    """OpenAI CLIP naming (visual.*, transformer.resblocks.*) -> (params,
    batch_stats) of CLIPModel."""
    params: dict = {}
    stats: dict = {}

    def bn(src, dst):
        _set(params, f"visual/{dst}/scale", sd[f"visual.{src}.weight"])
        _set(params, f"visual/{dst}/bias", sd[f"visual.{src}.bias"])
        _set(stats, f"visual/{dst}/mean", sd[f"visual.{src}.running_mean"])
        _set(stats, f"visual/{dst}/var", sd[f"visual.{src}.running_var"])

    def conv(src, dst):
        _set(params, f"visual/{dst}/kernel", t2f_conv(sd[f"visual.{src}.weight"]))

    for i in (1, 2, 3):
        conv(f"conv{i}", f"conv{i}")
        bn(f"bn{i}", f"bn{i}")
    li = 1
    while f"visual.layer{li}.0.conv1.weight" in sd:
        bi = 0
        while f"visual.layer{li}.{bi}.conv1.weight" in sd:
            src, dst = f"layer{li}.{bi}", f"layer{li}_{bi}"
            for c in (1, 2, 3):
                conv(f"{src}.conv{c}", f"{dst}/conv{c}")
                bn(f"{src}.bn{c}", f"{dst}/bn{c}")
            if f"visual.{src}.downsample.0.weight" in sd:  # avgpool(-1), conv(0), bn(1)
                conv(f"{src}.downsample.0", f"{dst}/downsample_conv")
                bn(f"{src}.downsample.1", f"{dst}/downsample_bn")
            bi += 1
        li += 1
    params["visual"]["attnpool"] = {"positional_embedding": np.asarray(sd["visual.attnpool.positional_embedding"])}
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _set(params, f"visual/attnpool/{name}/kernel", t2f_linear(sd[f"visual.attnpool.{name}.weight"]))
        _set(params, f"visual/attnpool/{name}/bias", sd[f"visual.attnpool.{name}.bias"])

    text: dict = {}
    _set(text, "token_embedding/embedding", sd["token_embedding.weight"])
    text["positional_embedding"] = np.asarray(sd["positional_embedding"])
    i = 0
    while f"transformer.resblocks.{i}.attn.in_proj_weight" in sd:
        src, dst = f"transformer.resblocks.{i}", f"resblocks_{i}"
        _set(text, f"{dst}/attn_qkv/kernel", t2f_linear(sd[f"{src}.attn.in_proj_weight"]))
        _set(text, f"{dst}/attn_qkv/bias", sd[f"{src}.attn.in_proj_bias"])
        _set(text, f"{dst}/attn_out/kernel", t2f_linear(sd[f"{src}.attn.out_proj.weight"]))
        _set(text, f"{dst}/attn_out/bias", sd[f"{src}.attn.out_proj.bias"])
        _set(text, f"{dst}/ln_1/scale", sd[f"{src}.ln_1.weight"])
        _set(text, f"{dst}/ln_1/bias", sd[f"{src}.ln_1.bias"])
        _set(text, f"{dst}/ln_2/scale", sd[f"{src}.ln_2.weight"])
        _set(text, f"{dst}/ln_2/bias", sd[f"{src}.ln_2.bias"])
        _set(text, f"{dst}/mlp_fc/kernel", t2f_linear(sd[f"{src}.mlp.c_fc.weight"]))
        _set(text, f"{dst}/mlp_fc/bias", sd[f"{src}.mlp.c_fc.bias"])
        _set(text, f"{dst}/mlp_proj/kernel", t2f_linear(sd[f"{src}.mlp.c_proj.weight"]))
        _set(text, f"{dst}/mlp_proj/bias", sd[f"{src}.mlp.c_proj.bias"])
        i += 1
    _set(text, "ln_final/scale", sd["ln_final.weight"])
    _set(text, "ln_final/bias", sd["ln_final.bias"])
    _set(text, "text_projection/kernel", np.asarray(sd["text_projection"]))  # already (width, out)
    params["text"] = text
    # the flax param is 0-d; a safetensors round trip makes torch's 0-d scalar (1,)
    params["logit_scale"] = np.asarray(sd["logit_scale"]).reshape(())
    return params, stats


# --------------------------------------------------------------------------
# LPIPS (alexnet)
# --------------------------------------------------------------------------
def convert_lpips(sd):
    """lpips.LPIPS(net='alex').state_dict(): the alexnet convs keep
    torchvision's feature indices inside net.slice{1..5} (or a bare
    net.features.{idx} dump), the heads are lin{i}.model.1; the
    scaling_layer buffers are checked against the model's constants."""
    p: dict = {}
    slice_map = {"conv1": ("net.slice1.0", "net.features.0"),
                 "conv2": ("net.slice2.3", "net.features.3"),
                 "conv3": ("net.slice3.6", "net.features.6"),
                 "conv4": ("net.slice4.8", "net.features.8"),
                 "conv5": ("net.slice5.10", "net.features.10")}
    for dst, srcs in slice_map.items():
        src = next((s for s in srcs if f"{s}.weight" in sd), srcs[0])
        _set(p, f"alex/{dst}/kernel", t2f_conv(sd[f"{src}.weight"]))
        _set(p, f"alex/{dst}/bias", sd[f"{src}.bias"])
    for i in range(5):
        _set(p, f"lin{i}/kernel", t2f_conv(sd[f"lin{i}.model.1.weight"]))
    if "scaling_layer.shift" in sd:
        for key, want in (("scaling_layer.shift", _SHIFT), ("scaling_layer.scale", _SCALE)):
            got = np.ravel(sd[key]).astype(np.float64)
            if got.shape != (3,) or np.abs(got - np.asarray(want)).max() > 1e-3:
                raise ValueError(f"{key} = {got.tolist()}, the model's constants are {list(want)}")
    return p


# --------------------------------------------------------------------------
# BLIP-Diffusion: Q-Former and the ViT-L/14 vision tower (one file)
# --------------------------------------------------------------------------
def convert_blip_diffusion_qformer(sd, layers: int = 12, cross_freq: int = 2):
    """diffusers Blip2QFormerModel / LAVIS BertModel naming -> QFormer."""
    p: dict = {}

    def dense(src, dst):
        _set(p, f"{dst}/kernel", t2f_linear(sd[f"{src}.weight"]))
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    def ln(src, dst):
        _set(p, f"{dst}/scale", sd[f"{src}.weight"])
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    p["query_tokens"] = np.asarray(sd["query_tokens"])
    if "embeddings.word_embeddings.weight" in sd:
        _set(p, "word_embeddings/embedding", sd["embeddings.word_embeddings.weight"])
        p["position_embeddings"] = np.asarray(sd["embeddings.position_embeddings.weight"])
        ln("embeddings.LayerNorm", "embeddings_ln")
    else:  # transformers' query-only Blip2QFormerModel
        ln("layernorm", "embeddings_ln")

    for i in range(layers):
        src = f"encoder.layer.{i}"
        dst = f"layer_{i}"
        for m in ("query", "key", "value"):
            dense(f"{src}.attention.attention.{m}", f"{dst}/self_{m}")
        dense(f"{src}.attention.output.dense", f"{dst}/self_out_dense")
        ln(f"{src}.attention.output.LayerNorm", f"{dst}/self_out_ln")
        if i % cross_freq == 0:
            for m in ("query", "key", "value"):
                dense(f"{src}.crossattention.attention.{m}", f"{dst}/cross_{m}")
            dense(f"{src}.crossattention.output.dense", f"{dst}/cross_out_dense")
            ln(f"{src}.crossattention.output.LayerNorm", f"{dst}/cross_out_ln")
        dense(f"{src}.intermediate_query.dense", f"{dst}/ffn_q_fc")
        dense(f"{src}.output_query.dense", f"{dst}/ffn_q_proj")
        ln(f"{src}.output_query.LayerNorm", f"{dst}/ffn_q_ln")
        if f"{src}.intermediate.dense.weight" in sd:  # the text branch
            dense(f"{src}.intermediate.dense", f"{dst}/ffn_t_fc")
            dense(f"{src}.output.dense", f"{dst}/ffn_t_proj")
            ln(f"{src}.output.LayerNorm", f"{dst}/ffn_t_ln")
    if "proj_layer.dense1.weight" in sd:
        dense("proj_layer.dense1", "proj_dense1")
        dense("proj_layer.dense2", "proj_dense2")
        ln("proj_layer.LayerNorm", "proj_ln")
    return p


def convert_blip_diffusion_vision(sd, layers: int = 24):
    """The CLIP ViT-L/14 tower as `vision_model.*` (diffusers, merged
    self_attn.qkv) or `visual_encoder.*` (LAVIS, split q/k/v) -> CLIPVisionViT."""
    pref = "vision_model" if any(k.startswith("vision_model.") for k in sd) else "visual_encoder"
    g = _KeyRemapView(sd, {f"{pref}.{tail}": tail for tail in (
        "embeddings", "encoder", "pre_layernorm", "post_layernorm")})
    p: dict = {}

    def dense(src, dst):
        _set(p, f"{dst}/kernel", t2f_linear(g[f"{src}.weight"]))
        _set(p, f"{dst}/bias", g[f"{src}.bias"])

    def ln(src, dst):
        _set(p, f"{dst}/scale", g[f"{src}.weight"])
        _set(p, f"{dst}/bias", g[f"{src}.bias"])

    _set(p, "patch_embed/kernel", t2f_conv(g["embeddings.patch_embedding.weight"]))
    p["class_embedding"] = np.asarray(g["embeddings.class_embedding"]).reshape(-1)
    pos = np.asarray(g["embeddings.position_embedding"])
    p["positional_embedding"] = pos.reshape(pos.shape[-2], pos.shape[-1])
    ln("pre_layernorm", "ln_pre")
    for i in range(layers):
        src = f"encoder.layers.{i}"
        dst = f"blk_{i}"
        ln(f"{src}.layer_norm1", f"{dst}_ln1")
        if f"{src}.self_attn.qkv.weight" in g:
            w = np.asarray(g[f"{src}.self_attn.qkv.weight"])
            b = np.asarray(g[f"{src}.self_attn.qkv.bias"])
            width = w.shape[1]
            for j, m in enumerate(("q", "k", "v")):
                _set(p, f"{dst}_{m}/kernel", t2f_linear(w[j * width:(j + 1) * width]))
                _set(p, f"{dst}_{m}/bias", b[j * width:(j + 1) * width])
            dense(f"{src}.self_attn.projection", f"{dst}_attn_out")
        else:
            for m in ("q", "k", "v"):
                dense(f"{src}.self_attn.{m}_proj", f"{dst}_{m}")
            dense(f"{src}.self_attn.out_proj", f"{dst}_attn_out")
        ln(f"{src}.layer_norm2", f"{dst}_ln2")
        dense(f"{src}.mlp.fc1", f"{dst}_mlp_fc")
        dense(f"{src}.mlp.fc2", f"{dst}_mlp_proj")
    ln("post_layernorm", "ln_post")
    return p


# --------------------------------------------------------------------------
# LAVIS BLIP: the captioner and VQA (models/blip_caption.py, blip_vqa.py)
# --------------------------------------------------------------------------
def _blip_dense_ln(sd, p):
    def dense(src, dst):
        _set(p, f"{dst}/kernel", t2f_linear(sd[f"{src}.weight"]))
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    def ln(src, dst):
        _set(p, f"{dst}/scale", sd[f"{src}.weight"])
        _set(p, f"{dst}/bias", sd[f"{src}.bias"])

    return dense, ln


def _convert_blip_vit(sd, p: dict, layers: int):
    """LAVIS's timm ViT visual_encoder.* -> BlipViT (fused qkv with bias)."""
    dense, ln = _blip_dense_ln(sd, p)
    v = "visual_encoder"
    p.setdefault(v, {})
    p[v]["cls_token"] = np.asarray(sd[f"{v}.cls_token"])
    p[v]["pos_embed"] = np.asarray(sd[f"{v}.pos_embed"])
    _set(p, f"{v}/patch_embed/kernel", t2f_conv(sd[f"{v}.patch_embed.proj.weight"]))
    _set(p, f"{v}/patch_embed/bias", sd[f"{v}.patch_embed.proj.bias"])
    for i in range(layers):
        src, dst = f"{v}.blocks.{i}", f"{v}/blocks_{i}"
        ln(f"{src}.norm1", f"{dst}/norm1")
        dense(f"{src}.attn.qkv", f"{dst}/attn_qkv")
        dense(f"{src}.attn.proj", f"{dst}/attn_proj")
        ln(f"{src}.norm2", f"{dst}/norm2")
        dense(f"{src}.mlp.fc1", f"{dst}/mlp_fc1")
        dense(f"{src}.mlp.fc2", f"{dst}/mlp_fc2")
    ln(f"{v}.norm", f"{v}/norm")


def _convert_blip_bert(sd, p: dict, src_root: str, dst_root: str, layers: int):
    """med.py's BertModel (embeddings, layers with self- and cross-attention)
    -> BlipTextDecoder / BlipTextEncoder."""
    dense, ln = _blip_dense_ln(sd, p)
    tb, t = src_root, dst_root
    _set(p, f"{t}/word_embeddings/embedding", sd[f"{tb}.embeddings.word_embeddings.weight"])
    _set(p, f"{t}/position_embeddings", sd[f"{tb}.embeddings.position_embeddings.weight"])
    _set(p, f"{t}/token_type_embeddings", sd[f"{tb}.embeddings.token_type_embeddings.weight"])
    ln(f"{tb}.embeddings.LayerNorm", f"{t}/embeddings_ln")
    for i in range(layers):
        src, dst = f"{tb}.encoder.layer.{i}", f"{t}/layer_{i}"
        for kind, pre in (("attention", "self"), ("crossattention", "cross")):
            dense(f"{src}.{kind}.self.query", f"{dst}/{pre}_query")
            dense(f"{src}.{kind}.self.key", f"{dst}/{pre}_key")
            dense(f"{src}.{kind}.self.value", f"{dst}/{pre}_value")
            dense(f"{src}.{kind}.output.dense", f"{dst}/{pre}_out_dense")
            ln(f"{src}.{kind}.output.LayerNorm", f"{dst}/{pre}_out_ln")
        dense(f"{src}.intermediate.dense", f"{dst}/intermediate_dense")
        dense(f"{src}.output.dense", f"{dst}/output_dense")
        ln(f"{src}.output.LayerNorm", f"{dst}/output_ln")


def _convert_blip_mlm_head(sd, p: dict, src_root: str, dst_root: str):
    """BERT's MLM head; HF ties cls.predictions.bias to decoder.bias, and
    either key carries it (both, where both are present, must agree)."""
    dense, ln = _blip_dense_ln(sd, p)
    pred, t = f"{src_root}.cls.predictions", dst_root
    dense(f"{pred}.transform.dense", f"{t}/transform_dense")
    ln(f"{pred}.transform.LayerNorm", f"{t}/transform_ln")
    _set(p, f"{t}/decoder/kernel", t2f_linear(sd[f"{pred}.decoder.weight"]))
    bias_key = f"{pred}.bias" if f"{pred}.bias" in sd else f"{pred}.decoder.bias"
    _set(p, f"{t}/decoder/bias", sd[bias_key])
    if bias_key == f"{pred}.bias" and f"{pred}.decoder.bias" in sd \
            and not np.array_equal(sd[f"{pred}.decoder.bias"], sd[bias_key]):
        raise ValueError(f"{pred}.bias and {pred}.decoder.bias differ")


def convert_blip_caption(sd, vit_layers: int = 12, text_layers: int = 12):
    """LAVIS's blip_caption checkpoint: visual_encoder.* (timm ViT),
    text_decoder.bert.* (BERT decoder), text_decoder.cls.predictions.*."""
    p: dict = {}
    _convert_blip_vit(sd, p, vit_layers)
    _convert_blip_bert(sd, p, "text_decoder.bert", "text_decoder", text_layers)
    _convert_blip_mlm_head(sd, p, "text_decoder", "text_decoder")
    return p


def convert_blip_vqa(sd, vit_layers: int = 12, text_layers: int = 12):
    """LAVIS's blip_vqa (vqav2) checkpoint: visual_encoder.* at 480^2,
    text_encoder.* (the question encoder, no .bert. wrapper) and the answer
    decoder text_decoder.bert.* + text_decoder.cls.*."""
    p: dict = {}
    _convert_blip_vit(sd, p, vit_layers)
    _convert_blip_bert(sd, p, "text_encoder", "text_encoder", text_layers)
    _convert_blip_bert(sd, p, "text_decoder.bert", "text_decoder", text_layers)
    _convert_blip_mlm_head(sd, p, "text_decoder", "text_decoder")
    return p


# --------------------------------------------------------------------------
# HF T5ForConditionalGeneration (models/t5.py)
# --------------------------------------------------------------------------
T5_TIED = ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight", "lm_head.weight")


def convert_t5(sd, layers: int = 12):
    """mrm8488/t5-base-finetuned-common_gen's HF layout: shared.weight (the
    tied lm_head), {encoder,decoder}.block.N.layer.K.{SelfAttention,
    EncDecAttention,DenseReluDense}.*, scale-only layer norms, the relative
    attention bias on block 0 only.  The tied copies a .bin holds
    (T5_TIED) are read and must equal shared.weight: an untied lm_head
    (T5 v1.1) does not fit the tied model."""
    p: dict = {}

    def dense(src, dst):
        _set(p, f"{dst}/kernel", t2f_linear(sd[f"{src}.weight"]))

    def rms(src, dst):
        _set(p, f"{dst}/weight", sd[f"{src}.weight"])

    def attn(src, dst, rel_bias: bool):
        for m in ("q", "k", "v", "o"):
            dense(f"{src}.{m}", f"{dst}/{m}")
        if rel_bias:
            _set(p, f"{dst}/relative_attention_bias", sd[f"{src}.relative_attention_bias.weight"])

    shared = np.asarray(sd["shared.weight"])
    _set(p, "shared/embedding", shared)
    for key in T5_TIED:
        if key in sd and not np.array_equal(sd[key], shared):
            raise ValueError(f"{key} differs from shared.weight: an untied T5 does not fit T5ForGeneration")
    for i in range(layers):
        src, dst = f"encoder.block.{i}", f"encoder/block_{i}"
        rms(f"{src}.layer.0.layer_norm", f"{dst}_ln0")
        attn(f"{src}.layer.0.SelfAttention", f"{dst}_attn", rel_bias=(i == 0))
        rms(f"{src}.layer.1.layer_norm", f"{dst}_ffn/layer_norm")
        dense(f"{src}.layer.1.DenseReluDense.wi", f"{dst}_ffn/wi")
        dense(f"{src}.layer.1.DenseReluDense.wo", f"{dst}_ffn/wo")
    rms("encoder.final_layer_norm", "encoder/final_ln")
    for i in range(layers):
        src, dst = f"decoder.block.{i}", f"decoder/block_{i}"
        rms(f"{src}.layer.0.layer_norm", f"{dst}_ln0")
        attn(f"{src}.layer.0.SelfAttention", f"{dst}_self", rel_bias=(i == 0))
        rms(f"{src}.layer.1.layer_norm", f"{dst}_ln1")
        attn(f"{src}.layer.1.EncDecAttention", f"{dst}_cross", rel_bias=False)
        rms(f"{src}.layer.2.layer_norm", f"{dst}_ffn/layer_norm")
        dense(f"{src}.layer.2.DenseReluDense.wi", f"{dst}_ffn/wi")
        dense(f"{src}.layer.2.DenseReluDense.wo", f"{dst}_ffn/wo")
    rms("decoder.final_layer_norm", "decoder/final_ln")
    return p
