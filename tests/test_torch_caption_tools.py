"""The port's prompt and caption tools against the JAX package, on the CPU.

  * the captions JSON and LE_{num}_{ds}_all_classes_{b}.json byte-equal
    between the packages, each with its own tiny BLIP captioner, BLIP VQA
    and keytotext T5 (the tiny configs and seeded trees of
    tests/test_torch_blip_caption.py, test_torch_blip_vqa.py and
    test_torch_t5.py), directly and through both CLIs' prep-captions /
    prep-prompts with the default factories monkeypatched to them;
  * extract_unique_alia_prompts, sweep_runs / run_sweep and misc_tools
    against JAX's on the same inputs and temporary trees;
  * the loaders against tools/convert_weights.py: LAVIS's caption and VQA
    layouts from tools/synth_checkpoints.py at tiny width, and an HF T5
    layout written here from convert_t5's keys (a .bin with the tied copies,
    and a safetensors file without them); every key consumed, the loaded
    state equal to the JAX converter's tree, bit for bit;
  * the default factories' errors without files, and the refusal of the
    JAX package's converted directories.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from saspa_tpu import cli as jcli
from saspa_tpu.gen import caption_tools as JT
from saspa_tpu.gen import recipes as JR
from saspa_tpu.models import blip_caption as JC
from saspa_tpu.models import blip_vqa as JV
from saspa_tpu.models import t5 as J5
from saspa_tpu.utils import misc_tools as JM
from saspa_tpu_torch import cli as tcli
from saspa_tpu_torch.bridge import state_dict_from_flax
from saspa_tpu_torch.gen import caption_tools as TT
from saspa_tpu_torch.gen import recipes as TR
from saspa_tpu_torch.models import blip_caption as TC
from saspa_tpu_torch.models import blip_vqa as TV
from saspa_tpu_torch.models import t5 as T5
from saspa_tpu_torch.utils import misc_tools as TM
from saspa_tpu_torch.weights import load as pload
from saspa_tpu_torch.weights.files import write_safetensors
from tests.test_torch_blip_caption import _two_torch_threads, images, seeded_tree  # noqa: F401
from tools import convert_weights as cw
from tools import synth_checkpoints as synth

VIT = dict(image_size=32, patch_size=16, width=16, layers=1, heads=2)
TEXT = dict(width=16, layers=2, heads=2, intermediate=32)
T5_CFG = dict(d_model=16, d_kv=8, d_ff=32, layers=2, heads=2)
QUESTIONS = ["what color is the plane?", "is it day or night?"]


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tools():
    """{"port": (captioner, vqa, t5 factory), "jax": (...)}: one seeded tree
    each, handed to both packages."""
    vit, text = TC.BlipViTConfig(**VIT), TC.BlipTextConfig(**TEXT)
    cap_tree = seeded_tree(TC.BlipCaptioner(vit, text), 7)
    vqa_tree = seeded_tree(TV.BlipVQA(vit, text), 17)
    t5_tree = seeded_tree(T5.T5ForGeneration(T5.T5Config(**T5_CFG)), 27)
    jvit, jtext = JC.BlipViTConfig(**VIT), JC.BlipTextConfig(**TEXT)
    return {
        "port": (TC.TorchBlipCaptioner(max_len=8, vit=vit, text=text, params=cap_tree, device="cpu"),
                 TV.TorchBlipVQA(vit=vit, text=text, params=vqa_tree, device="cpu"),
                 lambda: T5.TorchKeytotextT5(cfg=T5.T5Config(**T5_CFG), params=t5_tree, seed=3, max_new_tokens=6,
                                             device="cpu")),
        "jax": (JC.FlaxBlipCaptioner(max_len=8, vit=jvit, text=jtext, params=_jax_tree(cap_tree)),
                JV.FlaxBlipVQA(vit=jvit, text=jtext, params=_jax_tree(vqa_tree)),
                lambda: J5.FlaxKeytotextT5(cfg=J5.T5Config(**T5_CFG), params=_jax_tree(t5_tree), seed=3,
                                           max_new_tokens=6)),
    }


def keyword_rule(t5):
    """A sentence generator over the tiny T5 whose outputs pass the keyword
    check when their first id is odd (the fallback tokenizer's words are ids)."""
    def gen(keywords: str) -> str:
        s = t5(keywords)
        first = int(s.split()[0].strip("[]")) if s else 0
        return f"{s} a bird texture airplane" if first % 2 else s
    return gen


@pytest.fixture
def sources(tmp_path):
    paths = []
    for i, img in enumerate(images(31, [(40, 56), (30, 44)])):
        p = tmp_path / "src" / f"{1000 + i}.jpg"  # PNG bytes under .jpg names
        p.parent.mkdir(exist_ok=True)
        Image.fromarray(img[0]).save(p, format="PNG")
        paths.append(str(p))
    return paths


def test_captions_json_byte_equal(tools, sources, tmp_path):
    out = {}
    for pkg, mod in (("jax", JT), ("port", TT)):
        cap, vqa, _ = tools[pkg]
        path = tmp_path / pkg / "captions.json"
        mod.write_captions_of_a_dataset_to_json("planes", sources, str(path), questions=QUESTIONS, captioner=cap,
                                                vqa=vqa)
        out[pkg] = path.read_bytes()
    assert out["port"] == out["jax"]
    entry = json.loads(out["port"])[sources[0]]
    assert set(entry) == {"caption", *QUESTIONS}


def test_txt2sentence_json_byte_equal(tools, tmp_path):
    out = {}
    for pkg, mod in (("jax", JT), ("port", TT)):
        path = mod.generate_txt2sentence_prompts("cub", 3, str(tmp_path / pkg), sentence_generator=keyword_rule(
            tools[pkg][2]()))
        assert Path(path).name == "LE_3_cub_all_classes_False.json"
        out[pkg] = Path(path).read_bytes()
    assert out["port"] == out["jax"]
    assert json.loads(out["port"])["bird"]  # some sentences passed the keyword check


@pytest.mark.parametrize("command", ["prep-captions", "prep-prompts"])
def test_both_clis_write_the_same_files(command, tools, sources, tmp_path, monkeypatch, capsys):
    import saspa_tpu.utils

    monkeypatch.setattr(saspa_tpu.utils, "enable_compilation_cache", lambda *a: None)
    monkeypatch.setenv("SASPA_WEIGHTS_DIR", str(tmp_path / "wd"))  # the JAX CLI sets it; restored after
    for pkg, mod in (("jax", JT), ("port", TT)):
        cap, vqa, t5 = tools[pkg]
        monkeypatch.setattr(mod, "_default_captioner", lambda *a, cap=cap: cap)
        monkeypatch.setattr(mod, "_default_vqa", lambda *a, vqa=vqa: vqa)
        monkeypatch.setattr(mod, "_default_sentence_generator", lambda *a, t5=t5: keyword_rule(t5()))
    out = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        if command == "prep-captions":
            target = tmp_path / pkg / "captions.json"
            main(["prep-captions", "--dataset", "planes", "--images", *sources, "--output", str(target),
                  "--questions", *QUESTIONS, "--weights_dir", str(tmp_path / "wd")])
        else:
            main(["prep-prompts", "--dataset", "dtd", "--num", "2", "--output_path", str(tmp_path / pkg)])
            target = Path(capsys.readouterr().out.strip().splitlines()[-1])
            assert target == tmp_path / pkg / "LE_2_dtd_all_classes_False.json"
        out[pkg] = target.read_bytes()
    assert out["port"] == out["jax"]
    assert any(json.loads(out["port"]).values())


def test_port_cli_takes_the_jax_flags():
    parser = tcli.build_parser()
    args = parser.parse_args(["prep-captions", "--dataset", "cars", "--images", "a.jpg", "b.jpg", "--output", "o.json",
                              "--questions", "is the back or front of the car shown?", "--weights_dir", "wd"])
    assert (args.images, args.questions, args.weights_dir) == (["a.jpg", "b.jpg"],
                                                              ["is the back or front of the car shown?"], "wd")
    args = parser.parse_args(["prep-prompts", "--dataset", "planes", "--output_path", "d", "--all_classes"])
    assert (args.num, args.all_classes, args.weights_dir) == (100, True, None)


def test_extract_unique_alia_prompts_matches_jax():
    lines = ['1. "A plane on a runway."', "2. A plane on a runway.", "3) a plane in cloudy skies", "",
             "- A PLANE IN CLOUDY SKIES", '12. "an airliner at dusk"'] + [f"{i}. prompt {i % 7}" for i in range(40)]
    for n in (2, 5, 30):
        assert TT.extract_unique_alia_prompts(lines, n) == JT.extract_unique_alia_prompts(lines, n)
    assert TT.DATASET_TO_LABEL_DICT == JT.DATASET_TO_LABEL_DICT


@pytest.mark.parametrize("few_shot", [False, True])
def test_sweep_runs_and_run_sweep_match_jax(few_shot, monkeypatch):
    import saspa_tpu.fgvc.runner
    import saspa_tpu_torch.fgvc.runner

    assert TR.BEST_RECIPES == JR.BEST_RECIPES
    for ds in JR.BEST_RECIPES:
        want = [vars(r) | {"logdir": r.logdir} for r in JR.sweep_runs(ds, "aug.json", few_shot=few_shot)]
        got = [vars(r) | {"logdir": r.logdir} for r in TR.sweep_runs(ds, "aug.json", few_shot=few_shot)]
        assert got == want
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(saspa_tpu.fgvc.runner, "run_training", lambda a: calls["jax"].append(vars(a)) or 1)
    monkeypatch.setattr(saspa_tpu_torch.fgvc.runner, "run_training",
                        lambda a, device=None: calls["port"].append(vars(a)) or 1)
    kw = dict(net="resnet101", seeds=(4, 5), few_shot=few_shot)
    assert TR.run_sweep("cars", "a.json", device="cpu", **kw) == JR.run_sweep("cars", "a.json", **kw)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == (8 if few_shot else 2)


class _StubSplit:
    STEMS = {f"{i:04d}": f"class_{i % 3}" for i in range(12)}

    def __init__(self, split="train"):
        self.split = split

    def get_image_stem_to_class_str_dict(self):
        return dict(self.STEMS)


@pytest.mark.parametrize("dataset,random_class,direction", [("planes", False, False), ("planes", True, False),
                                                            ("cars", False, True)])
def test_same_class_image_names_match_jax(dataset, random_class, direction, monkeypatch):
    import saspa_tpu.data.registry as JRg
    import saspa_tpu_torch.data.registry as TRg

    for reg in (JRg, TRg):
        monkeypatch.setattr(reg, "PlanesUtils", _StubSplit)
        monkeypatch.setattr(reg, "CarsUtils", _StubSplit)
    captions = {f"/data/{s}.jpg": {TM.CAR_DIRECTION_QUESTION: "front" if int(s) % 4 else "back"}
                for s in _StubSplit.STEMS}
    kw = dict(num_per_image=2, same_car_direction=direction, captions_dict=captions if direction else None,
              random_class=random_class, seed=9)
    assert TM.get_same_class_image_names(dataset, **kw) == JM.get_same_class_image_names(dataset, **kw)


def test_file_tools_match_jax(tmp_path):
    names = ["1001_prompt_a_0.png", "1001_source.png", "1002_prompt_b_1.png", "x_tmp_1.png", "x_tmp_2.png", "k.png"]
    for pkg in ("jax", "port"):
        for n in names:
            (tmp_path / pkg / n).parent.mkdir(exist_ok=True)
            (tmp_path / pkg / n).write_bytes(b"x")
    origs = ["/o/1001.jpg", "/o/1002.jpg", "/o/1003.jpg"]
    want = JM.create_dict_image_path_to_augmented_images_paths(str(tmp_path / "jax"), origs)
    got = TM.create_dict_image_path_to_augmented_images_paths(str(tmp_path / "port"), origs)
    assert {k: sorted(Path(p).name for p in v) for k, v in got.items()} == \
        {k: sorted(Path(p).name for p in v) for k, v in want.items()}
    assert TM.delete_files_in_folder_with_substr(str(tmp_path / "port"), "_tmp_", 1) == \
        JM.delete_files_in_folder_with_substr(str(tmp_path / "jax"), "_tmp_", 1)
    assert len(list((tmp_path / "port").iterdir())) == len(list((tmp_path / "jax").iterdir())) == 5
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = [np.zeros((2, 2, 3)), np.ones((3, 2, 3))]
    grids = []
    for plot in (JM.plot_images_in_row, TM.plot_images_in_row):
        plot(images, titles=["a", "b"])
        fig = plt.gcf()
        grids.append([(ax.get_title(), ax.images[0].get_array().shape, list(ax.get_xticks())) for ax in fig.axes]
                     + [tuple(fig.get_size_inches())])
        plt.close(fig)
    assert grids[0] == grids[1] == [("a", (2, 2, 3), []), ("b", (3, 2, 3), []), (20.0, 20.0)]


# ---- the loaders ------------------------------------------------------------------
def hf_t5_state_dict(rng, vocab: int, d_model: int, d_kv: int, heads: int, d_ff: int, layers: int, tied: bool) -> dict:
    """mrm8488/t5-base-finetuned-common_gen's key layout (the keys
    tools/convert_weights.py::convert_t5 reads) with seeded values; `tied`
    adds the copies a pytorch_model.bin holds and the cross-attention bias
    table old t5 checkpoints carry."""
    d, inner = d_model, heads * d_kv
    sd = {"shared.weight": rng.randn(vocab, d)}

    def attn(prefix, rel):
        for m in "qkv":
            sd[f"{prefix}.{m}.weight"] = rng.randn(inner, d) / np.sqrt(d)
        sd[f"{prefix}.o.weight"] = rng.randn(d, inner) / np.sqrt(inner)
        if rel:
            sd[f"{prefix}.relative_attention_bias.weight"] = rng.randn(32, heads)

    for stack, n_sub in (("encoder", 2), ("decoder", 3)):
        for i in range(layers):
            b = f"{stack}.block.{i}.layer"
            attn(f"{b}.0.SelfAttention", i == 0)
            if stack == "decoder":
                attn(f"{b}.1.EncDecAttention", False)
            for j in range(n_sub):
                sd[f"{b}.{j}.layer_norm.weight"] = 1 + 0.1 * rng.randn(d)
            sd[f"{b}.{n_sub - 1}.DenseReluDense.wi.weight"] = rng.randn(d_ff, d) / np.sqrt(d)
            sd[f"{b}.{n_sub - 1}.DenseReluDense.wo.weight"] = rng.randn(d, d_ff) / np.sqrt(d_ff)
        sd[f"{stack}.final_layer_norm.weight"] = 1 + 0.1 * rng.randn(d)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    if tied:
        for k in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight", "lm_head.weight"):
            sd[k] = sd["shared.weight"].copy()
        sd["decoder.block.0.layer.1.EncDecAttention.relative_attention_bias.weight"] = \
            rng.randn(32, heads).astype(np.float32)
    return sd


def _save_pth(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(obj, path)


def _assert_loaded(module, tree):
    want = state_dict_from_flax(tree)
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("kind", ["blip_caption", "blip_vqa"])
def test_lavis_loaders_match_the_jax_converter(kind, tmp_path):
    make = synth.lavis_blip_caption_state_dict if kind == "blip_caption" else synth.lavis_blip_vqa_state_dict
    sd = make(width=16, vit_layers=1, text_layers=2, image_size=32, patch=16, intermediate=32,
              fill=np.random.RandomState(5))
    sd = {k: np.ascontiguousarray(v) for k, v in sd.items()}
    name = {"blip_caption": "model_base_caption_capfilt_large.pth", "blip_vqa": "model_base_vqa_capfilt_large.pth"}
    _save_pth(tmp_path / name[kind], {"model": {k: torch.from_numpy(v) for k, v in sd.items()}})
    cls = TC.TorchBlipCaptioner if kind == "blip_caption" else TV.TorchBlipVQA
    tool = cls(weights_dir=str(tmp_path), vit=TC.BlipViTConfig(**VIT), text=TC.BlipTextConfig(**TEXT), device="cpu")
    (rep,) = tool.load_reports
    assert rep["unconsumed"] == 0 and rep["params"] == rep["module_params"] and rep["file_keys"] == len(sd)
    convert = cw.convert_blip_caption if kind == "blip_caption" else cw.convert_blip_vqa
    _assert_loaded(tool.model, convert(sd, 1, 2))
    sd["text_decoder.bert.encoder.layer.0.extra.weight"] = np.zeros(2, np.float32)
    _save_pth(tmp_path / name[kind], {"model": {k: torch.from_numpy(v) for k, v in sd.items()}})
    with pytest.raises(pload.WeightsMismatch, match="extra"):
        cls(weights_dir=str(tmp_path), vit=TC.BlipViTConfig(**VIT), text=TC.BlipTextConfig(**TEXT), device="cpu")


@pytest.mark.parametrize("layout", ["bin", "safetensors"])
def test_t5_loader_matches_the_jax_converter(layout, tmp_path):
    sd = hf_t5_state_dict(np.random.RandomState(8), 32128, tied=layout == "bin", **T5_CFG)
    folder = tmp_path / "t5-base-finetuned-common_gen"
    folder.mkdir()
    if layout == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, folder / "pytorch_model.bin")
    else:
        write_safetensors(folder / "model.safetensors", sd)
    gen = T5.TorchKeytotextT5(weights_dir=str(tmp_path), cfg=T5.T5Config(**T5_CFG), device="cpu")
    (rep,) = gen.load_reports
    assert rep["unconsumed"] == 0 and rep["params"] == rep["module_params"] and rep["file_keys"] == len(sd)
    _assert_loaded(gen.model, cw.convert_t5(sd, T5_CFG["layers"]))
    if layout == "bin":  # an untied lm_head does not fit the tied model
        sd["lm_head.weight"] = sd["lm_head.weight"] + 1
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, folder / "pytorch_model.bin")
        with pytest.raises(ValueError, match="lm_head"):
            T5.TorchKeytotextT5(weights_dir=str(tmp_path), cfg=T5.T5Config(**T5_CFG), device="cpu")


def test_default_factories_raise_without_files_and_refuse_converted_dirs(tmp_path):
    for factory, what in ((TT._default_captioner, "BLIP captioner"), (TT._default_vqa, "BLIP VQA"),
                          (TT._default_sentence_generator, "keytotext T5")):
        with pytest.raises(RuntimeError, match=f"No {what} available"):
            factory(str(tmp_path), "cpu")
    for name, factory in (("blip_caption", TT._default_captioner), ("blip_vqa", TT._default_vqa),
                          ("t5_keytotext", TT._default_sentence_generator)):
        (tmp_path / name).mkdir()
        with pytest.raises(NotImplementedError, match="orbax"):
            factory(str(tmp_path), "cpu")
    with pytest.raises(NotImplementedError, match="orbax"):
        TC.TorchBlipCaptioner(weights_dir=str(tmp_path), vit=TC.BlipViTConfig(**VIT), text=TC.BlipTextConfig(**TEXT),
                              device="cpu")


def test_vocab_under_the_weights_dir_is_read(tmp_path):
    vocab = ["[PAD]", "[UNK]", "a", "picture", "of", "plane"]
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "vocab.txt").write_text("\n".join(vocab))
    cap = TC.TorchBlipCaptioner(weights_dir=str(tmp_path), vit=TC.BlipViTConfig(**VIT), text=TC.BlipTextConfig(**TEXT),
                                device="cpu")
    assert cap.tokenizer.has_vocab and cap.prompt_ids() == [TC.BOS_ID, 2, 3, 4]
    want = JC.WordPieceTokenizer(str(tmp_path / "tokenizer" / "vocab.txt"))
    for text in ("a plane of", "a pictures", "planes of a picture"):
        assert cap.tokenizer.encode(text) == want.encode(text)
