"""Parity of the filter stage's models with the JAX package, on the CPU, in f32.

CLIP RN50's image tower at CLIPVisionRNConfig(layers=(1, 1, 1, 1),
width=16) on 64^2 inputs, a 2-layer text tower with a projection, the whole
CLIPModel, ResNet at stage_sizes=(1, 1, 1, 1), BAP, and WSDAN_CAL's eval
forward on that small ResNet, each loaded through the bridge from the flax
variables, with BatchNorm statistics made non-trivial.  Tolerance: |diff| <=
2e-5 of the largest output (1e-5 for BAP): XLA and torch convolve and sum in
different orders on the CPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.models import cal as jcal
from saspa_tpu.models import clip as jclip
from saspa_tpu.models import resnet as jresnet
from saspa_tpu.models import text_encoder as jtext
from saspa_tpu_torch.bridge import params_from_flax, state_dict_from_flax_variables
from saspa_tpu_torch.models import cal as tcal
from saspa_tpu_torch.models import clip as tclip
from saspa_tpu_torch.models import resnet as tresnet
from saspa_tpu_torch.models import text_encoder as ttext

TINY_VISION = dict(layers=(1, 1, 1, 1), width=16, output_dim=48, image_size=64)
TINY_TEXT = dict(vocab_size=1000, width=32, layers=2, heads=2, projection_dim=48)


def _close(got, want, rel=2e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _stats(variables, seed):
    """Non-trivial BatchNorm statistics and affine parameters."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _nhwc(seed, n=2, size=64):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _ids(n=3, vocab=1000):
    rng = np.random.RandomState(7)
    ids = np.zeros((n, 77), np.int32)
    for i in range(n):
        k = 3 + 4 * i
        ids[i, 0] = vocab - 2
        ids[i, 1:k] = rng.randint(1, vocab - 2, k - 1)
        ids[i, k] = vocab - 1  # EOT, the largest id
    return ids


def _load(module, variables):
    module.load_state_dict(state_dict_from_flax_variables(variables))  # strict: no key dropped or missing
    return module


def test_clip_vision_rn_matches():
    x = _nhwc(0)
    jm = jclip.CLIPVisionRN(jclip.CLIPVisionRNConfig(**TINY_VISION))
    v = _stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tm = _load(tclip.CLIPVisionRN(tclip.CLIPVisionRNConfig(**TINY_VISION)), v)
    _close(tm(_nchw(x)), jm.apply(v, jnp.asarray(x)))


def test_text_tower_with_projection_matches():
    ids = _ids()
    jm = jtext.CLIPTextEncoder(jtext.CLIPTextConfig(**TINY_TEXT))
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(ids))
    tm = _load(ttext.CLIPTextEncoder(ttext.CLIPTextConfig(**TINY_TEXT)), v)
    want, got = jm.apply(v, jnp.asarray(ids)), tm(torch.from_numpy(ids).long())
    for key in ("hidden", "pooled", "proj"):
        _close(got[key], want[key], rel=1e-5)


class _TinyJaxCLIP(jclip.CLIPModel):
    """The flax CLIPModel builds its image tower at full width; this one
    swaps in the tiny tower with the same tree."""

    def setup(self):
        self.visual = jclip.CLIPVisionRN(jclip.CLIPVisionRNConfig(**TINY_VISION), dtype=self.dtype)
        self.text = jtext.CLIPTextEncoder(cfg=self.text_cfg, dtype=self.dtype)
        self.logit_scale = self.param("logit_scale", jax.nn.initializers.constant(4.6052), ())


def test_clip_model_encoders_and_logits_match():
    x, ids = _nhwc(3), _ids()
    jm = _TinyJaxCLIP(text_cfg=jtext.CLIPTextConfig(**TINY_TEXT))
    v = _stats(jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(ids)), 5)
    tm = tclip.CLIPModel(vision_cfg=tclip.CLIPVisionRNConfig(**TINY_VISION),
                         text_cfg=ttext.CLIPTextConfig(**TINY_TEXT))
    sds = params_from_flax({"clip": v})
    tm.load_state_dict(sds["clip"])
    assert len(sds["clip"]) == sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    _close(tm.encode_image(_nchw(x)), jm.apply(v, jnp.asarray(x), method=jclip.CLIPModel.encode_image))
    _close(tm.encode_text(torch.from_numpy(ids).long()),
           jm.apply(v, jnp.asarray(ids), method=jclip.CLIPModel.encode_text))
    _close(tm(_nchw(x), torch.from_numpy(ids).long()), jm.apply(v, jnp.asarray(x), jnp.asarray(ids)))
    assert float(tm.logit_scale) == float(np.asarray(v["params"]["logit_scale"]))


def test_resnet_features_match_at_stride_16():
    x = _nhwc(6)
    jm = jresnet.ResNet(stage_sizes=(1, 1, 1, 1))
    v = _stats(jm.init(jax.random.PRNGKey(6), jnp.asarray(x)), 7)
    tm = _load(tresnet.ResNet(stage_sizes=(1, 1, 1, 1)), v)
    got = tm(_nchw(x))
    assert tuple(got.shape) == (2, 2048, 4, 4)  # layer4 does not downsample: 64 / 16
    _close(got.permute(0, 2, 3, 1), jm.apply(v, jnp.asarray(x)))


def test_resnet101_layout():
    m = tresnet.resnet101(device="meta")
    assert [n for n in m.blocks if n.startswith("layer3_")][-1] == "layer3_22"
    assert m.layer4_0.conv2.stride == 1 and m.layer4_0.downsample_conv.stride == 1
    cbam = tresnet.BACKBONES["resnet101_cbam"](device="meta")
    assert [n for n in cbam.blocks] == m.blocks and all(hasattr(getattr(cbam, n), "cbam") for n in cbam.blocks)


def test_bap_matches():
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 5, 6, 40).astype(np.float32)
    atts = np.maximum(rng.randn(2, 5, 6, 8), 0).astype(np.float32)
    want = jcal.bap(jnp.asarray(feats), jnp.asarray(atts))
    got = tcal.bap(_nchw(feats), _nchw(atts))
    for g, w in zip(got, want):
        _close(g, w, rel=1e-5)


@pytest.fixture()
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(jresnet.BACKBONES, "resnet_tiny", partial(jresnet.ResNet, stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setitem(tresnet.BACKBONES, "resnet_tiny", partial(tresnet.ResNet, stage_sizes=(1, 1, 1, 1)))
    return "resnet_tiny"


def test_wsdan_cal_eval_forward_matches(tiny_backbone):
    x = _nhwc(9)
    jm = jcal.WSDAN_CAL(num_classes=5, M=32, net=tiny_backbone)
    v = _stats(jm.init({"params": jax.random.PRNGKey(9)}, jnp.asarray(x), train=False), 10)
    assert "batch_stats" in v and "attentions_bn" in v["batch_stats"]
    tm = tcal.WSDAN_CAL(num_classes=5, M=32, net=tiny_backbone)
    sds = params_from_flax({"cal": v})
    n_flax = sum(len(jax.tree_util.tree_leaves(v[c])) for c in ("params", "batch_stats"))
    assert len(sds["cal"]) == n_flax == len(tm.state_dict())
    tm.load_state_dict(sds["cal"])
    want = jm.apply(v, jnp.asarray(x), train=False)
    got = tm(_nchw(x))
    _close(got[0], want[0])  # logits
    _close(got[1], want[1], rel=1e-4)  # p - p_counterfactual: a difference of near-equal logits
    _close(got[2], want[2])  # feature matrix
    _close(got[3], np.asarray(want[3]))  # mean attention map (B, 1, h, w)


def test_what_the_train_slice_brings_raises(tiny_backbone):
    m = tcal.WSDAN_CAL(num_classes=3, net=tiny_backbone)
    with pytest.raises(ValueError, match="rng key"):  # the training forward is ported; it needs its draws
        m(torch.zeros(1, 3, 32, 32), train=True)
    # the backbones and the CLIP pairing of the later slice build (tests/test_torch_{cbam,inception,clip_vitb16}.py)
    assert hasattr(tresnet.BACKBONES["resnet50_cbam"](device="meta").layer1_0, "cbam")
    assert not hasattr(tcal.WSDAN_CAL(num_classes=3, net="inception_mixed_7c", device="meta"), "attentions_conv")
    assert tclip.CLIPModel(vision_kind="vit-b-16", device="meta").output_dim == 512
    with pytest.raises(ValueError, match="Unsupported net"):
        tcal.WSDAN_CAL(num_classes=3, net="inception_mixed_5b", device="meta")


def test_bridge_rejects_unknown_collections_and_clashes():
    with pytest.raises(KeyError, match="collections"):
        state_dict_from_flax_variables({"params": {}, "cache": {}})
    with pytest.raises(KeyError, match="both"):
        state_dict_from_flax_variables({"params": {"bn": {"mean": np.zeros(2)}},
                                        "batch_stats": {"bn": {"mean": np.zeros(2)}}})
