"""The port's LPIPS filter against the JAX package's, on the CPU.

`pil_convert_l` against PIL bit for bit; the gray-RGB 256^2 load against
the JAX filter's PIL one; the port's LPIPS loaded from the lpips package's
.pth (tools/synth_checkpoints.py's layout, seeded) against flax's LPIPS in
f32 on convert_weights' tree; `batched_lpips` on a tiny tree of image files
against JAX's (its model swapped for the f32 one); the aug-JSON with
lpips_min/lpips_max byte-equal to JAX's, with both packages' distances
stubbed alike and with real distances; and the import test: the loader and
the filter bring in no JAX.
"""

import json
import logging
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from saspa_tpu.filters import aug_json as jaug
from saspa_tpu.filters import lpips_filter as jlp
from saspa_tpu.models.lpips import LPIPS as JaxLPIPS
from saspa_tpu_torch.filters import aug_json as taug
from saspa_tpu_torch.filters import lpips_filter as tlp
from saspa_tpu_torch.ops.image import pil_convert_l
from saspa_tpu_torch.weights.load import WeightsMismatch
from tests.test_torch_blip import _close
from tests.test_torch_filters import stub_env  # noqa: F401  (fixture)
from tools import convert_weights as jconv
from tools import synth_checkpoints as synth

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed,shape", [(0, (37, 53, 3)), (1, (256, 256, 3)), (2, (1, 1, 3))])
def test_pil_convert_l_is_bit_exact(seed, shape):
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    img[0, 0] = (255, 255, 255)
    assert np.array_equal(pil_convert_l(img), np.asarray(Image.fromarray(img).convert("L")))


@pytest.mark.parametrize("size,ext", [((300, 200), ".png"), ((64, 90), ".jpg")])
def test_gray_rgb_load_matches_jax(tmp_path, size, ext):
    img = np.random.RandomState(3).randint(0, 256, (*size, 3)).astype(np.uint8)
    path = tmp_path / f"x{ext}"
    Image.fromarray(img).save(path)
    got = tlp._load_gray_rgb(str(path), (256, 256))
    want = jlp._load_gray_rgb(str(path), (256, 256))
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.fixture(scope="module")
def lpips_tree(tmp_path_factory):
    """A weights dir holding the lpips package's alex .pth (the full
    LPIPS(net='alex') state_dict, scaling layer included)."""
    root = tmp_path_factory.mktemp("w")
    sd = synth.lpips_alex_state_dict(fill=np.random.RandomState(21))
    (root / "lpips").mkdir()
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, root / "lpips" / "alex.pth")
    return root, {"params": jconv.convert_lpips(sd)}


def _images(seed, n=3, size=64):
    return (np.random.RandomState(seed).rand(n, size, size, 3) * 2 - 1).astype(np.float32)


def test_lpips_from_the_file_matches_jax(lpips_tree):
    root, variables = lpips_tree
    model = tlp.load_lpips(str(root), device="cpu")
    assert model.load_report[0]["unconsumed"] == 0 and model.load_report[0]["params"] == 15
    a, b = _images(4), _images(5)
    want = JaxLPIPS(dtype=jnp.float32).apply(variables, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = model(torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(b).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3,)
    _close(got, want, 1e-5)
    with torch.no_grad():  # identical images are at distance 0
        assert float(model(torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(a).permute(0, 3, 1, 2))
                     .abs().max()) == 0.0


def test_lpips_scaling_layer_is_checked(tmp_path):
    sd = synth.lpips_alex_state_dict(fill=np.random.RandomState(1))
    sd["scaling_layer.scale"] = sd["scaling_layer.scale"] * 2
    (tmp_path / "lpips").mkdir()
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmp_path / "lpips" / "alex.pth")
    with pytest.raises(ValueError, match="scaling_layer.scale"):
        tlp.load_lpips(str(tmp_path), device="cpu")
    del sd["lin3.model.1.weight"]
    sd["scaling_layer.scale"] = sd["scaling_layer.scale"] / 2
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmp_path / "lpips" / "alex.pth")
    with pytest.raises(WeightsMismatch, match="lin3"):
        tlp.load_lpips(str(tmp_path), device="cpu")


def _jax_f32_model(monkeypatch, variables):
    """JAX's batched_lpips with its cached model swapped for the f32 one on
    `variables` (the filter's own model is bf16)."""
    model = JaxLPIPS(dtype=jnp.float32)
    monkeypatch.setitem(jlp._CACHE, "model", jax.jit(lambda a, b: model.apply(variables, a, b)))


def _pairs(root: Path, n: int):
    rng = np.random.RandomState(6)
    origs, augs = [], []
    for i in range(n):
        for kind, paths in (("orig", origs), ("aug", augs)):
            h, w = rng.randint(40, 120, 2)
            p = root / f"{kind}_{i}.png"
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(p)
            paths.append(str(p))
    return origs, augs


def test_batched_lpips_matches_jax(tmp_path, lpips_tree, monkeypatch):
    """7 pairs of PNGs of other sizes, batches of 4 (the last one padded):
    the same distances as JAX's batched_lpips in f32."""
    root, variables = lpips_tree
    _jax_f32_model(monkeypatch, variables)
    origs, augs = _pairs(tmp_path, 7)
    want = jlp.batched_lpips(origs, augs, batch_size=4)
    timings = {"preprocess_s": 0.0, "device_s": 0.0, "images": 0, "batches": 0}
    got = tlp.batched_lpips(origs, augs, weights_dir=str(root), batch_size=4, device="cpu", timings=timings)
    assert got.shape == (7,) and got.dtype == np.float32
    _close(got, want, 1e-5)
    assert timings["images"] == 7 and timings["batches"] == 2
    with pytest.raises(ValueError, match="originals"):
        tlp.batched_lpips(origs, augs[:3], weights_dir=str(root), device="cpu")


def _stub_distances(monkeypatch):
    def dist(origs, augs, *a, **k):
        return np.asarray([zlib.crc32(Path(p).name.encode()) % 1000 / 1000 for p in augs], np.float32)

    monkeypatch.setattr(jlp, "batched_lpips", dist)
    monkeypatch.setattr(tlp, "batched_lpips", dist)


def _build(package, aug_dir, kw, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        path = package.create_json_of_image_name_to_augmented_images_paths("planes", str(aug_dir), init_log=False,
                                                                           **kw)
    counters = [r.getMessage() for r in caplog.records if r.getMessage().startswith("For filter = ")]
    return path, Path(path).read_bytes(), counters


@pytest.mark.parametrize("kw", [dict(lpips_min=0.3), dict(lpips_max=0.6), dict(lpips_min=0.2, lpips_max=0.7),
                                dict(lpips_min=0.25, lpips_max=0.8, semantic_filtering=True,
                                     model_confidence_based_filtering=True, conf_top_k=3)])
def test_builder_with_lpips_writes_jax_bytes_and_counters(stub_env, monkeypatch, caplog, kw):  # noqa: F811
    """Both packages' distances stubbed alike (seeded from each aug's name):
    the JSON's name and bytes and the lpips_min/lpips_max counters equal
    JAX's."""
    _stub_distances(monkeypatch)
    j_path, j_bytes, j_counters = _build(jaug, stub_env, kw, caplog)
    t_path, t_bytes, t_counters = _build(taug, stub_env, kw, caplog)
    assert t_path == j_path and "lpips_" in Path(t_path).name
    assert t_bytes == j_bytes
    assert t_counters == j_counters and any("lpips_" in c for c in t_counters)
    kept = sum(len(v) for v in json.loads(t_bytes).values())
    assert 0 < kept < 8


def test_builder_with_real_lpips_matches_jax(stub_env, lpips_tree, monkeypatch, caplog):  # noqa: F811
    """The real distances (the port's LPIPS from the .pth on the CPU, JAX's
    in f32 on convert_weights' tree) on the stub tree's 8 pairs, thresholds
    halfway between neighbouring distances: the same JSON bytes."""
    root, variables = lpips_tree
    _jax_f32_model(monkeypatch, variables)
    augs = sorted(str(p) for p in Path(stub_env).glob("*_prompt_*.png"))
    origs = [str(Path(stub_env).parent.parent / "orig" / (Path(a).name.split("_")[0] + ".jpg")) for a in augs]
    d = np.sort(jlp.batched_lpips(origs, augs, batch_size=4))
    kw = dict(lpips_min=float((d[1] + d[2]) / 2), lpips_max=float((d[5] + d[6]) / 2), weights_dir=str(root),
              batch_size=4)
    j_path, j_bytes, j_counters = _build(jaug, stub_env, kw, caplog)
    t_path, t_bytes, t_counters = _build(taug, stub_env, dict(kw, device="cpu"), caplog)
    assert t_path == j_path and t_bytes == j_bytes and t_counters == j_counters
    assert sum(len(v) for v in json.loads(t_bytes).values()) == 4
    assert t_counters == ["For filter = lpips_min, filtered 2 images", "For filter = lpips_max, filtered 2 images"]


def test_loader_and_lpips_filter_import_no_jax():
    code = ("import sys, saspa_tpu_torch.weights, saspa_tpu_torch.weights.load, saspa_tpu_torch.filters.lpips_filter;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'saspa_tpu', 'tools', 'flax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
