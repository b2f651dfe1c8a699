"""The port's filter stage against the JAX package's, on the CPU.

The aug-JSON builder of both packages runs on one stub tree (built as
tests/test_filters.py builds it), with the CLIP scorer and the baseline's
logits replaced in both by the same numpy features and logits: the JSONs
must be byte-equal and the per-filter counters equal, for the semantic,
per-class, top-k, too-high-confidence and ALIA filters.  The merge tools and
the JSON's name are held the same way.  Then the entry points (`cli
filter`, `cli merge-jsons`, `run_generation_and_filter`) run on the CPU with
the scorers' towers cut to a few narrow layers.
"""

import dataclasses
import json
import logging
import zlib
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import saspa_tpu.data.registry as JR
import saspa_tpu_torch.data.registry as TR
from saspa_tpu.filters import aug_json as jaug
from saspa_tpu.filters import clip_filters as jclip_filters
from saspa_tpu.filters import confidence as jconf
from saspa_tpu_torch import cli as tcli
from saspa_tpu_torch.filters import aug_json as taug
from saspa_tpu_torch.filters import clip_filters as tclip_filters
from saspa_tpu_torch.filters import confidence as tconf
from saspa_tpu_torch.gen import driver as tdriver
from saspa_tpu_torch.models import resnet as tresnet
from saspa_tpu_torch.models.clip import CLIPVisionRNConfig
from saspa_tpu_torch.models.text_encoder import CLIPTextConfig
from saspa_tpu_torch.utils.config import FilterConfig, GenerationConfig

CLASSES = ["Boeing 737-800", "Airbus A320", "Cessna 172"]


def _seeded(name: str, shape, scale=1.0):
    return (np.random.RandomState(zlib.crc32(name.encode())).randn(*shape) * scale).astype(np.float32)


class StubScorer:
    """CLIPScorer with features drawn from each file's and prompt's name;
    half the images lean towards the battery's first prompt."""

    def __init__(self, *args, **kwargs):
        pass

    def text_features(self, prompts):
        return np.stack([_seeded(p, (16,)) for p in prompts])

    def image_features(self, paths, batch_size=64, timings=None):
        lean = self.text_features(["a photo of an aircraft"])[0]
        return np.stack([_seeded(Path(p).name, (16,)) + (zlib.crc32(Path(p).name.encode()) % 2) * lean
                         for p in paths])

    def logits(self, image_features, text_features):
        return np.float32(100.0) * image_features @ text_features.T


def _logits(paths):
    return np.stack([_seeded("logits " + Path(p).name, (len(CLASSES),), 2.0) for p in paths])


@pytest.fixture()
def stub_env(tmp_path, monkeypatch):
    """4 originals, 2 augs each, a _source side file and a corrupt PNG, with
    both packages' dataset utils, scorer and baseline logits stubbed alike."""
    rng = np.random.RandomState(0)
    orig_dir = tmp_path / "orig"
    orig_dir.mkdir()
    orig_paths = []
    for i in range(4):
        p = orig_dir / f"{1000000 + i}.jpg"
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(p)
        orig_paths.append(str(p))
    aug_dir = tmp_path / "augset" / "images"
    aug_dir.mkdir(parents=True)
    for i in range(4):
        stem = f"{1000000 + i}"
        for k in range(2):
            Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
                aug_dir / f"{stem}_prompt_a photo of an airplane_{k}.png")
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(aug_dir / f"{stem}_source.png")

    class StubUtils:
        name = "planes"
        num_classes = len(CLASSES)
        original_images_paths = orig_paths

        def __init__(self, print_func=print):
            pass

        def get_classes(self):
            return list(CLASSES)

        def get_basic_prompt(self):
            return "a photo of an aircraft"

        def get_image_stem_to_class_str_dict(self):
            return {Path(p).stem: CLASSES[i % 3] for i, p in enumerate(orig_paths)}

        def get_image_path_to_class_id_dict(self, split="train"):
            return {p: i % 3 for i, p in enumerate(orig_paths)}

        def load_baseline_model(self, **kw):
            return (None, None, None) if not kw else (None, None)

        def get_baseline_conf_threshold(self, **kw):
            return {"0": 0.5, "1": -0.5, "2": 0.0}

    monkeypatch.setitem(JR.DS_UTILS_DICT, "planes", StubUtils)
    monkeypatch.setitem(TR.DS_UTILS_DICT, "planes", StubUtils)
    monkeypatch.setattr(jclip_filters, "CLIPScorer", StubScorer)
    monkeypatch.setattr(tclip_filters, "CLIPScorer", StubScorer)
    monkeypatch.setattr(jconf, "batched_logits", lambda model, variables, paths, *a, **k: _logits(paths))
    monkeypatch.setattr(tconf, "batched_logits", lambda model, paths, *a, **k: _logits(paths))
    return aug_dir


FILTERS = {
    "recipe": dict(semantic_filtering=True, model_confidence_based_filtering=True),
    "semantic": dict(semantic_filtering=True),
    "per_class": dict(clip_filtering="per_class", clip_filtering_discount=2),
    "top_k": dict(model_confidence_based_filtering=True, conf_top_k=1),
    "too_high_confidence": dict(model_confidence_based_filtering=True, conf_top_k=2,
                                filter_confidence_higher_than=0.6),
    "alia": dict(alia_conf_filtering=True, semantic_filtering=True),
}


def _build(package, aug_dir, kw, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        path = package.create_json_of_image_name_to_augmented_images_paths("planes", str(aug_dir), init_log=False,
                                                                           **kw)
    counters = [r.getMessage() for r in caplog.records if r.getMessage().startswith("For filter = ")]
    return path, Path(path).read_bytes(), counters


@pytest.mark.parametrize("name", list(FILTERS))
def test_builder_writes_jax_bytes_and_counters(stub_env, caplog, name):
    kw = FILTERS[name]
    j_path, j_bytes, j_counters = _build(jaug, stub_env, kw, caplog)
    t_path, t_bytes, t_counters = _build(taug, stub_env, kw, caplog)
    assert t_path == j_path
    assert t_bytes == j_bytes
    assert t_counters == j_counters and t_counters
    d = json.loads(t_bytes)
    assert sorted(d) == [f"{1000000 + i}.jpg" for i in range(4)]
    kept = sum(len(v) for v in d.values())
    assert all("_source" not in p for v in d.values() for p in v)
    if name != "recipe":  # top-10 of 3 classes keeps all; semantic keeps some: every other filter drops some
        assert 0 < kept < 8, (name, kept, t_counters)


def test_builder_deletes_corrupt_files_as_jax_does(stub_env, tmp_path):
    (stub_env / "1000001_prompt_broken_9.png").write_bytes(b"not a png")
    taug.create_json_of_image_name_to_augmented_images_paths("planes", str(stub_env), init_log=False,
                                                             semantic_filtering=False)
    assert not (stub_env / "1000001_prompt_broken_9.png").exists()
    d = json.loads(Path(taug.get_aug_json_path(str(stub_env))).read_text())
    assert all(len(v) == 2 for v in d.values())


def test_lpips_is_not_ported_yet(stub_env, caplog):
    # the LPIPS filter is ported now (tests/test_torch_lpips.py): without an lpips file it runs on a seeded init
    with caplog.at_level(logging.WARNING):
        path = taug.create_json_of_image_name_to_augmented_images_paths(
            "planes", str(stub_env), init_log=False, lpips_min=0.1, semantic_filtering=False, device="cpu")
    assert Path(path).name == "lpips_min_0.1-aug.json" and "no LPIPS alex file" in caplog.text


@pytest.mark.parametrize("kw", [
    {}, dict(semantic_filtering=True, model_confidence_based_filtering=True),
    dict(lpips_min=0.1, lpips_max=0.6), dict(clip_filtering="per_class", clip_filtering_discount=2),
    dict(model_confidence_based_filtering=True, conf_top_k=3, filter_confidence_higher_than=0.9),
    dict(alia_conf_filtering=True, semantic_filtering=True),
])
def test_aug_json_path_matches_jax(kw):
    assert taug.get_aug_json_path("/x/y/images", **kw) == jaug.get_aug_json_path("/x/y/images", **kw)


def _jsons(root):
    a, b = root / "a-aug.json", root / "b-aug.json"
    a.write_text(json.dumps({"1.jpg": ["/i/1_x_0.png", "/i/1_x_1.png", "/i/1_x_2.png"], "2.jpg": []}))
    b.write_text(json.dumps({"1.jpg": ["/i/1_y_0.png"], "2.jpg": ["/i/2_y_0.png", "/i/2_y_1.png"], "3.jpg": []}))
    return [str(a), str(b)]


def test_merge_and_edit_tools_match_jax(tmp_path):
    ins = _jsons(tmp_path)
    for tool, args in ((lambda m, out: m.merge_aug_jsons(ins, out), "merged.json"),
                       (lambda m, out: m.merge_aug_jsons_with_amount_per_json({j: 1 for j in ins}, out, seed=3),
                        "amount.json"),
                       (lambda m, out: m.remove_all_augs_w_sub_str_and_save(ins[0], ["_x_1"], out), "removed.json")):
        outs = {}
        for name, m in (("jax", jaug), ("port", taug)):
            out = tmp_path / name / args
            out.parent.mkdir(exist_ok=True)
            assert tool(m, str(out)) is not None
            written = out if out.exists() else out.with_name(out.name.replace(".json", "-merged.json"))
            outs[name] = written.read_bytes()
        assert outs["port"] == outs["jax"], args


# ---- entry points on the CPU --------------------------------------------------

def _planes_tree(root, n=3, size=64):
    """FGVC-Aircraft's layout with the annotation files PlanesUtils and
    FGVCAircraftFiles read; PNG bytes under .jpg names."""
    data = root / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    rng = np.random.RandomState(1)
    ids = [f"{2000000 + i}" for i in range(n)]
    for i in ids:
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(data / "images" / f"{i}.jpg", "PNG")
    makers = [("Boeing", "737-800"), ("Airbus", "A320"), ("Cessna", "172")]
    (data / "images_train.txt").write_text("".join(f"{i}\n" for i in ids))
    (data / "images_manufacturer_train.txt").write_text("".join(f"{i} {makers[k % 3][0]}\n" for k, i in enumerate(ids)))
    (data / "images_variant_train.txt").write_text("".join(f"{i} {makers[k % 3][1]}\n" for k, i in enumerate(ids)))
    (data / "variants.txt").write_text("".join(f"{m[1]}\n" for m in makers))
    return data, ids


@pytest.fixture()
def tiny_scorers(monkeypatch):
    """The real scorers with their towers cut to one block a stage and
    narrow widths, on the CPU."""
    monkeypatch.setattr(tclip_filters, "VISION_CFG", CLIPVisionRNConfig(layers=(1, 1, 1, 1), width=16, output_dim=32))
    monkeypatch.setattr(tclip_filters, "TEXT_CFG", CLIPTextConfig(width=32, layers=2, heads=2, projection_dim=32))
    monkeypatch.setitem(tresnet.BACKBONES, "resnet101", partial(tresnet.ResNet, stage_sizes=(1, 1, 1, 1)))
    cpu = lambda device=None: torch.device("cpu")  # noqa: E731
    monkeypatch.setattr(tclip_filters, "resolve_device", cpu)
    monkeypatch.setattr(tconf, "resolve_device", cpu)


def _aug_folder(data, ids, size=64):
    folder = data / "aug_data" / "images"
    folder.mkdir(parents=True)
    rng = np.random.RandomState(2)
    for i in ids:
        for k in range(2):
            Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(folder / f"{i}_prompt_a plane_{k}.png")
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(folder / f"{i}_source.png")
    return folder


def test_cli_filter_and_merge_jsons(tmp_path, monkeypatch, tiny_scorers):
    monkeypatch.setenv("SASPA_DATA_ROOT", str(tmp_path))
    monkeypatch.delenv("SASPA_STRICT_WEIGHTS", raising=False)
    monkeypatch.setenv("SASPA_CHECKPOINTS", str(tmp_path / "no_checkpoints"))
    data, ids = _planes_tree(tmp_path)
    folder = _aug_folder(data, ids)
    recipe = tcli.main(["filter", "--dataset", "planes", "--aug_folder", str(folder)])
    assert recipe == str(folder.parent / "semantic_filtering-model_confidence_based_filtering_top_10_classes-aug.json")
    top1 = tcli.main(["filter", "--dataset", "planes", "--aug_folder", str(folder.parent), "--conf_top_k", "1",
                      "--no_semantic_filtering", "--batch_size", "4"])
    assert Path(top1).name == "model_confidence_based_filtering_top_1_classes-aug.json"
    for path in (recipe, top1):
        d = json.loads(Path(path).read_text())
        assert sorted(d) == [f"{i}.jpg" for i in ids]
        for i in ids:
            assert set(d[f"{i}.jpg"]) <= {str(folder / f"{i}_prompt_a plane_{k}.png") for k in range(2)}
        assert list(folder.parent.glob(Path(path).stem + "_*.log"))  # the log beside the JSON
    assert sum(len(v) for v in json.loads(Path(top1).read_text()).values()) < 6  # top-1 of 3 classes drops some
    out = tmp_path / "merged.json"
    merged = tcli.main(["merge-jsons", "--jsons", recipe, top1, "--output", str(out)])
    want = jaug.merge_aug_jsons([recipe, top1], str(tmp_path / "jax_merged.json"))
    assert merged == want and out.read_bytes() == (tmp_path / "jax_merged.json").read_bytes()


def test_checkpoints_and_strict_weights_raise(tmp_path, monkeypatch, tiny_scorers):
    monkeypatch.setenv("SASPA_CHECKPOINTS", str(tmp_path))
    (tmp_path / "planes").mkdir()
    (tmp_path / "planes" / "meta.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        tconf.load_cal_baseline("planes", 3)
    (tmp_path / "w" / "clip_rn50").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        tclip_filters.CLIPScorer(weights_dir=str(tmp_path / "w"))
    monkeypatch.setenv("SASPA_STRICT_WEIGHTS", "1")
    with pytest.raises(FileNotFoundError, match="SASPA_STRICT_WEIGHTS"):
        tconf.load_cal_baseline("cars", 3)
    with pytest.raises(FileNotFoundError, match="SASPA_STRICT_WEIGHTS"):
        tclip_filters.CLIPScorer(weights_dir=str(tmp_path / "nothing"))


def test_run_generation_and_filter_on_a_tiny_pipeline(tmp_path, monkeypatch, tiny_scorers, caplog):
    """3 sources x 2 prompts at 64^2 through the tiny SD1.5 pipeline on the
    CPU, then the recipe's filters on the same device: the JSON lists only
    generated files of each source, and the filter's telemetry line counts
    each aug twice (CLIP, then the baseline)."""
    from tests.test_torch_driver import _pipes

    monkeypatch.setenv("SASPA_DATA_ROOT", str(tmp_path))
    monkeypatch.setenv("SASPA_CHECKPOINTS", str(tmp_path / "no_checkpoints"))
    monkeypatch.delenv("SASPA_STRICT_WEIGHTS", raising=False)
    _, ids = _planes_tree(tmp_path, size=96)
    _, tp = _pipes()
    cfg = GenerationConfig(dataset="planes", num_per_image=2, resolution=64, num_inference_steps=2, batch_size=4)
    caplog.set_level(logging.INFO)
    path = tdriver.run_generation_and_filter(cfg, pipe=tp, semantic_filtering=True,
                                             model_confidence_based_filtering=True)
    folder = Path(cfg.with_dataset_overrides().output_folder(str(TR.DS_UTILS_DICT["planes"]().root_path)))
    assert path == str(folder.parent / "semantic_filtering-model_confidence_based_filtering_top_10_classes-aug.json")
    d = json.loads(Path(path).read_text())
    assert sorted(d) == [f"{i}.jpg" for i in ids]
    generated = {str(p) for p in folder.glob("*_prompt_*.png")}
    assert len(generated) == 6 and all(set(v) <= generated for v in d.values())
    tele = [json.loads(r.getMessage().split(": ", 1)[1]) for r in caplog.records
            if r.getMessage().startswith("filter telemetry: ")]
    assert tele and tele[-1]["images"] == 12 and tele[-1]["batches"] == 2


def test_run_generation_and_filter_options_and_ranks(monkeypatch):
    """Keyword precedence (defaults, filter_cfg, filter_kw), the debug run
    that skips the JSON, and a rank other than 0, which meets the barrier
    and returns the writer's path without scoring."""
    seen = {}
    monkeypatch.setattr(tdriver, "run_generation", lambda cfg, pipe=None: "/d/aug/images")
    monkeypatch.setattr(taug, "create_json_of_image_name_to_augmented_images_paths",
                        lambda ds, **kw: seen.setdefault("kw", kw) and "written")
    cfg = GenerationConfig(dataset="planes")
    fc = FilterConfig(dataset="cars", semantic_filtering=False, conf_top_k=5)
    assert tdriver.run_generation_and_filter(cfg, fc, conf_top_k=7) == "written"
    kw = seen["kw"]
    assert kw["conf_top_k"] == 7 and kw["semantic_filtering"] is False and kw["resize"] == (256, 256)
    assert "dataset" not in kw and kw["init_log"] is False and kw["device"] is None
    assert tdriver.run_generation_and_filter(dataclasses.replace(cfg, debug=True, specific_file_strs=("x",))) \
        == "/d/aug/images"
    barriers = []
    monkeypatch.setattr(tdriver, "_process_index_count", lambda: (1, 2))
    monkeypatch.setattr(tdriver, "_host_barrier", barriers.append)
    seen.clear()
    got = tdriver.run_generation_and_filter(cfg, semantic_filtering=True, model_confidence_based_filtering=True)
    assert got == "/d/aug/semantic_filtering-model_confidence_based_filtering_top_10_classes-aug.json"
    assert barriers and not seen
