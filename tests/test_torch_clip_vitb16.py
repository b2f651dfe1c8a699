"""CLIP ViT-B/16 in the port against the JAX package's pairing, on the CPU.

* CLIPModel(vision_kind="vit-b-16") at its published widths (ViT-B/16:
  patch 16, width 768, 12 layers, projection 512; the text tower 512 wide,
  12 layers, 8 heads, projection 512), loaded through the bridge from one
  seeded flax tree: encode_image on two 224^2 inputs, encode_text on two
  token rows and the scaled logits, in f32, within 1e-5 of the largest
  output (XLA and torch sum in different orders through 12 layers).
* CLIPScorer("vit-b-16"): no public file rule exists for it in either
  package, so it takes the seeded init with a warning, raises under
  SASPA_STRICT_WEIGHTS=1 and refuses the JAX package's converted
  directory; its image features of two PNG files are the model's unit
  features of the host preprocess, 512 wide.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.models import clip as jclip
from saspa_tpu_torch.bridge import state_dict_from_flax
from saspa_tpu_torch.filters import clip_filters as tclip_filters
from saspa_tpu_torch.gen.image_io import write_png
from saspa_tpu_torch.models import clip as tclip
from tests.test_torch_inception import rel_err, seeded_variables


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share a few cores: torch's thread a core would
    oversubscribe them (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_clip_vitb16_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 224, 224, 3).astype(np.float32)
    ids = rng.randint(1, 49000, (2, 77)).astype(np.int32)
    ids[0, 5], ids[1, 76] = 49407, 49407  # the end-of-text token, where the tower pools
    jm = jclip.CLIPModel(vision_kind="vit-b-16")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                                            jnp.zeros((1, 77), jnp.int32)))
    v = seeded_variables(shapes, 1)
    v["params"]["logit_scale"] = np.float32(4.6052)

    def run(v, x, ids):
        img = jm.apply(v, x, method=jclip.CLIPModel.encode_image)
        txt = jm.apply(v, ids, method=jclip.CLIPModel.encode_text)
        return img, txt, jnp.exp(v["params"]["logit_scale"]) * img @ txt.T  # CLIPModel.__call__, towers once

    want = jax.device_get(jax.jit(run)(v, x, ids))
    tm = tclip.CLIPModel(vision_kind="vit-b-16")
    assert tm.output_dim == 512 and tm.text.cfg.projection_dim == 512 and tm.visual.cfg.patch_size == 16
    tm.load_state_dict(state_dict_from_flax(v["params"]))
    with torch.no_grad():
        img = tm.encode_image(torch.from_numpy(x).permute(0, 3, 1, 2))
        txt = tm.encode_text(torch.from_numpy(ids).long())
        logits = tm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ids).long())
    assert tuple(img.shape) == (2, 512) and tuple(txt.shape) == (2, 512)
    for got, w in zip((img, txt, logits), want):
        assert rel_err(got, w) <= 1e-5


def test_clip_scorer_vitb16_seeded_strict_and_orbax(tmp_path, monkeypatch, caplog):
    paths = []
    rng = np.random.RandomState(2)
    for i, hw in enumerate(((240, 300), (260, 224))):
        paths.append(str(tmp_path / f"aug_{i}.png"))
        write_png(paths[-1], rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
    with caplog.at_level(logging.WARNING):
        scorer = tclip_filters.CLIPScorer("vit-b-16", device="cpu")
    assert scorer.load_report is None and "seeded random init" in caplog.text
    feats = scorer.image_features(paths, batch_size=2)
    with torch.no_grad():
        x = torch.from_numpy(np.stack([tclip_filters.clip_preprocess_path(p) for p in paths])).permute(0, 3, 1, 2)
        want = scorer.model.encode_image(x).numpy()
    assert feats.shape == (2, 512) and rel_err(feats, want) <= 1e-6
    txt = scorer.text_features(["a photo of a plane", "an image"])
    assert txt.shape == (2, 512)
    assert scorer.logits(feats, txt).shape == (2, 2)

    monkeypatch.setenv("SASPA_STRICT_WEIGHTS", "1")
    with pytest.raises(FileNotFoundError, match="vit-b-16"):
        tclip_filters.CLIPScorer("vit-b-16", device="cpu")
    monkeypatch.delenv("SASPA_STRICT_WEIGHTS")
    (tmp_path / "w" / "clip_vit-b-16").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        tclip_filters.CLIPScorer("vit-b-16", weights_dir=str(tmp_path / "w"), device="cpu")
