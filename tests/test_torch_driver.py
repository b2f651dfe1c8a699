"""Parity of the port's generation entry point with the JAX package's, on the CPU.

The stub planes tree of tests/test_generation_driver.py (three 96x128
PIL-written JPEG sources) goes through both drivers: the JAX package's
`run_generation` with the tiny canny pipeline of tests/test_torch_pipeline.py
and the port's with the same params carried over by the bridge, f32.  The
port reads the JPEGs through PIL here (the card's machine reads PNG only),
resizes them with its own cv2 arithmetic and draws each item's noise with
its numpy copy of jax.random.normal.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import saspa_tpu.data.registry as JR
import saspa_tpu_torch.data.registry as TR
from saspa_tpu.gen.driver import run_generation as jax_run_generation
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, init_pipeline
from saspa_tpu_torch.gen import driver as tdriver
from saspa_tpu_torch.gen.prompts import PromptEngine
from saspa_tpu_torch.utils.config import GenerationConfig
from tests.test_generation_driver import StubPlanesUtils
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _PresetJaxPipeline, tiny_params

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def stub_tree(tmp_path, monkeypatch):
    images = tmp_path / "ds" / "images"
    images.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (96, 128, 3), np.uint8)).save(images / f"{2000000 + i}.jpg")

    def stub(print_func=print):
        return StubPlanesUtils(tmp_path / "ds", print_func)

    monkeypatch.setitem(JR.DS_UTILS_DICT, "planes", stub)
    monkeypatch.setitem(TR.DS_UTILS_DICT, "planes", stub)
    return tmp_path


def _cfg(**kw):
    base = dict(dataset="planes", base_model="sd_v1.5", controlnet="canny", num_per_image=2, seed=1,
                prompt_type="gpt-meta_class", resolution=64, guidance_scale=7.5, num_inference_steps=2,
                batch_size=4)
    base.update(kw)
    return GenerationConfig(**base)


def _jax_cfg(cfg):
    from saspa_tpu.utils.config import GenerationConfig as JaxGenerationConfig

    return JaxGenerationConfig(**dataclasses.asdict(cfg))


def _pipes():
    params = tiny_params()
    _PresetJaxPipeline.preset = params
    jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="canny", sampler="ddim", dtype=jnp.float32,
                            unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
    tp = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                           unet_cfg=P_UNET, vae_cfg=P_VAE, text_cfgs=P_TEXT)
    tp.load_flax_params(params)
    return jp, tp


def _pngs(folder):
    return {p.name: np.asarray(Image.open(p)) for p in sorted(Path(folder).glob("*.png"))}


def test_run_generation_matches_jax(stub_tree, caplog):
    """3 sources x 2 prompts at 64^2 (INTER_AREA from 96x128), batch 4 (the
    second batch padded), 2 DDIM steps, CFG 7.5, canny ControlNet.  Both
    drivers write the same file set (the names carry the prompts); the
    _source and _control PNGs are bit-equal; the generated images agree to
    1 uint8 level on >= 99% of the pixels (the f32 network's rounding, as in
    test_fused_generate_matches_jax, plus the noise's last-ulp
    differences).  The telemetry line carries num_errors = 0."""
    jp, tp = _pipes()
    cfg = _cfg()
    want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jp)
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    caplog.set_level("INFO")
    got_dir = tdriver.run_generation(cfg, pipe=tp)
    assert got_dir == want_dir
    got = _pngs(got_dir)
    assert sorted(got) == sorted(want) and len(got) == 6 + 3 + 3
    gen = [n for n in got if "_source" not in n and "_control" not in n]
    assert len(gen) == 6 and all("_prompt_" in n for n in gen)
    for name in got:
        a, b = got[name].astype(np.int32), want[name].astype(np.int32)
        assert a.shape == b.shape, name
        if name in gen:
            assert a.shape == (64, 64, 3)
            d = np.abs(a - b)
            assert d.max() <= 1 and np.mean(d == 0) >= 0.99, (name, d.max(), np.mean(d == 0))
        else:
            assert np.array_equal(a, b), name
    tele = [r.getMessage() for r in caplog.records if r.getMessage().startswith("generation telemetry: ")]
    assert tele and '"num_errors": 0' in tele[-1] and '"total": 6' in tele[-1]


def test_resume_leaves_no_work(stub_tree):
    """A second run finds every output on disk: an empty worklist, and no
    file is written again."""
    _, tp = _pipes()
    cfg = _cfg(controlnet=None, num_inference_steps=1)
    folder = tdriver.run_generation(cfg, pipe=tp)
    stamps = {p: p.stat().st_mtime_ns for p in Path(folder).glob("*.png")}
    assert len(stamps) == 6 + 3
    ds = TR.DS_UTILS_DICT["planes"]()
    c = cfg.with_dataset_overrides()
    engine = PromptEngine(c, ds, ds.get_image_stem_to_class_str_dict())
    assert tdriver.build_worklist(c, ds, engine, folder) == []
    tdriver.run_generation(cfg, pipe=tp)
    assert {p: p.stat().st_mtime_ns for p in Path(folder).glob("*.png")} == stamps


def test_save_source_and_control_uses_global_index(tmp_path):
    """Shards pass (global index, path) pairs: the first-10 _control.png rule
    follows the global index, as in the JAX driver."""
    paths = []
    for i in range(12):
        p = tmp_path / f"img_{i:02d}.png"
        Image.fromarray((np.random.RandomState(i).rand(32, 32, 3) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    out = tmp_path / "out"
    out.mkdir()
    tdriver._save_source_and_control(GenerationConfig(controlnet="canny", resolution=64),
                                     list(enumerate(paths))[1::2], str(out))
    assert sorted(f.name for f in out.glob("*_control.png")) == [f"img_{i:02d}_control.png" for i in (1, 3, 5, 7, 9)]
    assert len(list(out.glob("*_source.png"))) == 6


@pytest.mark.parametrize("argv", [
    ["gen", "--dataset", "planes", "--resolution", "1024", "--skip_filter"],
    ["gen", "--dataset", "cars", "--controlnet", "none", "--num_per_image", "3", "--seed", "7", "--no_sub_class",
     "--guidance_scale", "5", "--num_inference_steps", "12", "--controlnet_scale", "0.5", "--batch_size", "4",
     "--debug", "--version", "v2", "--prompt_type", "captions", "--skip_filter"],
])
def test_cli_flags_map_to_the_same_config(argv, monkeypatch):
    """The port's `gen` flags build the JAX CLI's GenerationConfig, field for
    field; both CLIs are driven with their run_generation replaced."""
    import saspa_tpu.cli as jcli
    import saspa_tpu.gen.driver as jdriver
    import saspa_tpu.utils.logging_utils as jlog
    import saspa_tpu_torch.cli as tcli

    seen = {}
    monkeypatch.setattr(jdriver, "run_generation", lambda cfg, **kw: seen.setdefault("jax", cfg))
    monkeypatch.setattr(tdriver, "run_generation", lambda cfg, **kw: seen.setdefault("port", cfg))
    monkeypatch.setattr(jlog, "init_logging", lambda **kw: None)
    monkeypatch.setattr("saspa_tpu.utils.enable_compilation_cache", lambda *a, **k: None)
    jcli.main(argv)
    tcli.main(argv)
    assert dataclasses.asdict(seen["port"]) == dataclasses.asdict(seen["jax"])
    assert dataclasses.asdict(seen["port"].with_dataset_overrides()) == \
        dataclasses.asdict(seen["jax"].with_dataset_overrides())
    assert seen["port"].output_folder("/d") == seen["jax"].output_folder("/d")


def test_cli_refuses_what_is_not_ported(monkeypatch):
    """`gen` filters unless --skip_filter is passed (the JAX CLI's
    semantic + top-10 confidence recipe); the presets run with their
    filter recipes, ALIA on planes_biased too (ip2p, tests/test_torch_ip2p.py);
    no generation family is refused any more (SD2.1 and HED build); what
    the JAX package refuses, the port refuses."""
    import saspa_tpu_torch.cli as tcli

    calls = []
    monkeypatch.setattr(tdriver, "run_generation", lambda cfg, **kw: calls.append(("gen", kw)))
    monkeypatch.setattr(tdriver, "run_generation_and_filter", lambda cfg, **kw: calls.append(("filter", kw)))
    tcli.main(["gen", "--resolution", "1024"])
    tcli.main(["gen", "--resolution", "1024", "--skip_filter"])
    tcli.main(["gen", "--preset", "alia", "--skip_filter"])
    tcli.main(["gen", "--preset", "alia", "--dataset", "planes_biased"])
    alia = ("filter", {"semantic_filtering": True, "model_confidence_based_filtering": False,
                       "alia_conf_filtering": True})
    assert calls == [("filter", {"semantic_filtering": True, "model_confidence_based_filtering": True}),
                     ("gen", {}), alia, alia]
    monkeypatch.undo()
    tdriver._check_supported(GenerationConfig.alia("planes_biased").with_dataset_overrides())
    # weights_dir reaches the pipeline, which loads the tree's files (tests/test_torch_weights.py)
    import saspa_tpu_torch.diffusion.pipelines as tpipelines

    with monkeypatch.context() as m:
        m.setattr(tpipelines, "DiffusionPipeline", lambda *a, **kw: ("sd", a, kw))
        assert init_pipeline("sd_v1.5", "canny", weights_dir="/nowhere") == \
            ("sd", ("sd_v1.5",), {"controlnet": "canny", "sampler": "ddim", "dtype": None, "device": None,
                                  "weights_dir": "/nowhere", "init_seed": 0})
        # SDEdit builds for every base model the port has, canny or not (the
        # pipeline runs it when generate is given an init_image); sd_xl with
        # canny is no refiner
        plain = {"sampler": "ddim", "dtype": None, "device": None, "weights_dir": None, "init_seed": 0}
        for base in ("sd_v1.5", "sd_xl-turbo", "sd_xl"):
            assert init_pipeline(base, "canny", SDEdit=True) == ("sd", (base,), {"controlnet": "canny", **plain})
        assert init_pipeline("sd_v1.5", None, SDEdit=True) == ("sd", ("sd_v1.5",), {"controlnet": None, **plain})
        # sd_xl + SDEdit without a ControlNet is the refiner, and UniPC builds
        assert init_pipeline("sd_xl", None, SDEdit=True) == ("sd", ("sd_xl-refiner",), {"controlnet": None, **plain})
        assert init_pipeline("sd_v1.5", "canny", sampler="unipcmultistep") == \
            ("sd", ("sd_v1.5",), {"controlnet": "canny", **plain, "sampler": "unipcmultistep"})
        # SD2.1 and the HED ControlNet build (tests/test_torch_sd21.py, tests/test_torch_hed.py)
        assert init_pipeline("sd_v2.1", "canny") == ("sd", ("sd_v2.1",), {"controlnet": "canny", **plain})
        assert init_pipeline("sd_v1.5", "hed", SDEdit=True) == ("sd", ("sd_v1.5",), {"controlnet": "hed", **plain})
    tdriver._check_supported(GenerationConfig(controlnet="hed"))
    tdriver._check_supported(GenerationConfig(base_model="sd_v2.1", sdedit=True, controlnet="hed"))
    tdriver._check_supported(GenerationConfig(sdedit=True, controlnet=None))
    tdriver._check_supported(GenerationConfig(sdedit=True, controlnet="canny"))
    # BLIP-Diffusion + canny builds (its constructor stubbed: the full-width
    # towers are the card's), and so does cub's SDXL-Turbo + canny; BLIP's
    # edit path builds without a ControlNet; so does BLIP-Diffusion + HED
    import saspa_tpu_torch.models.blip_diffusion as tblip

    monkeypatch.setattr(tblip, "BlipDiffusionPipeline", lambda **kw: ("blip", kw))
    assert init_pipeline("blip_diffusion", "canny") == \
        ("blip", {"controlnet": "canny", "sampler": "ddim", "dtype": None, "device": None, "weights_dir": None,
                  "init_seed": 0})
    tdriver._check_supported(GenerationConfig(dataset="dtd", base_model="blip_diffusion", controlnet="canny"))
    assert init_pipeline("blip_diffusion-edit", "canny") == \
        ("blip", {"controlnet": None, "sampler": "ddim", "dtype": None, "device": None, "weights_dir": None,
                  "init_seed": 0})
    tdriver._check_supported(GenerationConfig(base_model="blip_diffusion-edit"))
    tdriver._check_supported(GenerationConfig(dataset="cub", base_model="blip_diffusion").with_dataset_overrides())
    tdriver._check_supported(GenerationConfig(dataset="cub", base_model="blip_diffusion",
                                              controlnet="hed").with_dataset_overrides())
    assert init_pipeline("blip_diffusion", "hed") == \
        ("blip", {"controlnet": "hed", "sampler": "ddim", "dtype": None, "device": None, "weights_dir": None,
                  "init_seed": 0})
    with pytest.raises(ValueError, match="SDEdit is not supported with blip_diffusion"):
        init_pipeline("blip_diffusion", "canny", SDEdit=True)
    with pytest.raises(ValueError, match="SDEdit is not supported with blip_diffusion"):
        tdriver._check_supported(GenerationConfig(base_model="blip_diffusion-edit", sdedit=True))


DTD_SOURCES = ["banded/banded_0005.jpg", "banded/banded_0011.jpg", "blotchy/blotchy_0009.jpg",
               "blotchy/blotchy_0019.jpg"]  # names the shipped DTD captions cover


@pytest.fixture()
def dtd_tree(tmp_path, monkeypatch):
    """A DTD train split of 4 sources in 2 classes (PNG bytes under the
    .jpg names, 96x128) at data/DTD/dtdataset/dtd under the working
    directory, where the captions JSON's keys point."""
    from saspa_tpu.data.registry import DTDUtils as JaxDTD
    from saspa_tpu_torch.data.registry import DTDUtils as PortDTD

    monkeypatch.chdir(tmp_path)
    root = Path("data/DTD/dtdataset/dtd")
    (root / "labels").mkdir(parents=True)
    rng = np.random.RandomState(1)
    for name in DTD_SOURCES:
        (root / "images" / name).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (96, 128, 3), np.uint8)).save(root / "images" / name, format="PNG")
    (root / "labels" / "train1.txt").write_text("\n".join(DTD_SOURCES) + "\n")
    monkeypatch.setitem(JR.DS_UTILS_DICT, "dtd", lambda print_func=print: JaxDTD(root_path=str(root),
                                                                                  print_func=print_func))
    monkeypatch.setitem(TR.DS_UTILS_DICT, "dtd", lambda print_func=print: PortDTD(root_path=str(root),
                                                                                  print_func=print_func))
    return root


def test_run_generation_blip_matches_jax(dtd_tree, caplog):
    """BLIP-Diffusion + canny (the dtd recipe's model) through both
    drivers: 4 sources x 1 prompt at 64^2, batch 3 (the second batch
    padded), 2 DDIM steps, CFG 7.5, the tiny pipelines of
    tests/test_torch_blip.py with the same params.  The output folder
    (which names `_style_img_from_diff_img`) and the file names are
    equal; the _source, _control and _subject_ PNGs are bit-equal; the
    generated images agree to 1 uint8 level on >= 99% of the pixels."""
    from tests.test_torch_blip import blip_params, jax_pipe, port_pipe

    params = blip_params()["canny"]
    cfg = _cfg(dataset="dtd", base_model="blip_diffusion", num_per_image=1, batch_size=3)
    want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jax_pipe(params, "canny"))
    assert "_style_img_from_diff_img" in want_dir
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    caplog.set_level("INFO")
    got_dir = tdriver.run_generation(cfg, pipe=port_pipe(params, "canny"))
    assert got_dir == want_dir
    got = _pngs(got_dir)
    assert sorted(got) == sorted(want) and len(got) == 4 * 4
    gen = [n for n in got if "_prompt_" in n]
    assert len(gen) == 4 and sum("_subject_0" in n for n in got) == 4
    for name in got:
        a, b = got[name].astype(np.int32), want[name].astype(np.int32)
        assert a.shape == b.shape, name
        if name in gen:
            d = np.abs(a - b)
            assert d.max() <= 1 and np.mean(d == 0) >= 0.99, (name, d.max(), np.mean(d == 0))
        else:
            assert np.array_equal(a, b), name
    tele = [r.getMessage() for r in caplog.records if r.getMessage().startswith("generation telemetry: ")]
    assert tele and '"num_errors": 0' in tele[-1] and '"total": 4' in tele[-1]


CUB_SOURCES = ["001.Black_footed_Albatross/Black_Footed_Albatross_9001_1.jpg",
               "001.Black_footed_Albatross/Black_Footed_Albatross_9002_2.jpg",
               "002.Laysan_Albatross/Laysan_Albatross_9003_3.jpg"]  # not in datasets_files/cub_val.txt


@pytest.fixture()
def cub_tree(tmp_path, monkeypatch):
    """A CUB-200-2011 train split of 3 sources in 2 classes (96x128 PNG
    bytes under .jpg names): images.txt, train_test_split.txt, classes.txt,
    image_class_labels.txt."""
    from saspa_tpu.data.registry import CUBUtils as JaxCUB
    from saspa_tpu_torch.data.registry import CUBUtils as PortCUB

    root = tmp_path / "CUB/CUB_200_2011"
    rng = np.random.RandomState(2)
    for name in CUB_SOURCES:
        (root / "images" / name).parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (96, 128, 3), np.uint8)).save(root / "images" / name, format="PNG")
    (root / "images.txt").write_text("".join(f"{i + 1} {n}\n" for i, n in enumerate(CUB_SOURCES)))
    (root / "train_test_split.txt").write_text("".join(f"{i + 1} 1\n" for i in range(len(CUB_SOURCES))))
    (root / "classes.txt").write_text("1 001.Black_footed_Albatross\n2 002.Laysan_Albatross\n")
    (root / "image_class_labels.txt").write_text("".join(f"{i + 1} {n[:3].lstrip('0')}\n"
                                                         for i, n in enumerate(CUB_SOURCES)))
    monkeypatch.setitem(JR.DS_UTILS_DICT, "cub", lambda print_func=print: JaxCUB(root_path=str(root),
                                                                                  print_func=print_func))
    monkeypatch.setitem(TR.DS_UTILS_DICT, "cub", lambda print_func=print: PortCUB(root_path=str(root),
                                                                                  print_func=print_func))
    return root


def test_cli_gen_cub_matches_jax(cub_tree, monkeypatch, caplog):
    """`gen --dataset cub --skip_filter --num_per_image 1 --resolution 64
    --batch_size 2` through both CLIs.  cub resolves to the same
    configuration in both: SDXL-Turbo + canny, 2 DDIM steps, guidance 0, no
    negative prompt; both ask init_pipeline for sd_xl-turbo + canny, ddim,
    no SDEdit, and get the tiny XL pipelines of tests/test_torch_xl.py with
    the same params (the port's samples on trailing steps).  Both write the
    same files under the same folder (controlnet/sd_xl-turbo/canny/...):
    _source and _control PNGs bit-equal, the generated images within 1
    uint8 level on >= 99% of the pixels."""
    import saspa_tpu.cli as jcli
    import saspa_tpu.diffusion.pipelines as jpipelines
    import saspa_tpu.gen.driver as jdriver
    import saspa_tpu.utils.logging_utils as jlog
    import saspa_tpu_torch.cli as tcli
    import saspa_tpu_torch.diffusion.pipelines as tpipelines
    from tests.test_torch_xl import jax_pipe, port_pipe, xl_params

    params = xl_params()
    asked, cfgs, pipes = {}, {}, {}

    def fake_init(kind, make):
        def init(base_model, controlnet, SDEdit=False, sampler="ddim", weights_dir=None):
            asked[kind] = (base_model, controlnet, SDEdit, sampler, weights_dir)
            pipes[kind] = make(params, base_model, controlnet)
            return pipes[kind]
        return init

    def recording(kind, run):
        def run_generation(cfg, **kw):
            cfgs[kind] = cfg
            return run(cfg, **kw)
        return run_generation

    monkeypatch.setattr(jpipelines, "init_pipeline", fake_init("jax", jax_pipe))
    monkeypatch.setattr(tpipelines, "init_pipeline", fake_init("port", port_pipe))
    monkeypatch.setattr(jdriver, "run_generation", recording("jax", jdriver.run_generation))
    monkeypatch.setattr(tdriver, "run_generation", recording("port", tdriver.run_generation))
    monkeypatch.setattr(jlog, "init_logging", lambda **kw: None)
    monkeypatch.setattr("saspa_tpu.utils.enable_compilation_cache", lambda *a, **k: None)
    argv = ["gen", "--dataset", "cub", "--skip_filter", "--num_per_image", "1", "--resolution", "64",
            "--batch_size", "2"]
    jcli.main(argv)
    want_dir = cfgs["jax"].with_dataset_overrides().output_folder(str(cub_tree))
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    caplog.set_level("INFO")
    got_dir = tcli.main(argv)

    resolved = cfgs["port"].with_dataset_overrides()
    assert dataclasses.asdict(resolved) == dataclasses.asdict(cfgs["jax"].with_dataset_overrides())
    assert (resolved.base_model, resolved.controlnet, resolved.num_inference_steps, resolved.guidance_scale,
            resolved.negative_prompt) == ("sd_xl-turbo", "canny", 2, 0.0, None)
    assert asked["port"] == asked["jax"] == ("sd_xl-turbo", "canny", False, "ddim", None)
    assert pipes["port"].scheduler.cfg.timestep_spacing == "trailing"
    assert got_dir == want_dir and "/aug_data/controlnet/sd_xl-turbo/canny/" in got_dir
    got = _pngs(got_dir)
    assert sorted(got) == sorted(want) and len(got) == 3 * 3
    gen = [n for n in got if "_prompt_" in n]
    assert len(gen) == 3
    for name in got:
        a, b = got[name].astype(np.int32), want[name].astype(np.int32)
        assert a.shape == b.shape, name
        if name in gen:
            d = np.abs(a - b)
            assert d.max() <= 1 and np.mean(d == 0) >= 0.99, (name, d.max(), np.mean(d == 0))
        else:
            assert np.array_equal(a, b), name
    tele = [r.getMessage() for r in caplog.records if r.getMessage().startswith("generation telemetry: ")]
    assert tele and '"num_errors": 0' in tele[-1] and '"total": 3' in tele[-1]


def test_importing_the_entry_point_loads_no_jax_pil_or_cv2():
    code = (
        "import sys, saspa_tpu_torch.cli, saspa_tpu_torch.gen.driver, saspa_tpu_torch.gen.image_io, "
        "saspa_tpu_torch.diffusion.pipelines, saspa_tpu_torch.data.registry, saspa_tpu_torch.gen.prompts, "
        "saspa_tpu_torch.data.datasets, saspa_tpu_torch.filters, saspa_tpu_torch.filters.clip_filters, "
        "saspa_tpu_torch.filters.confidence, saspa_tpu_torch.models.clip, saspa_tpu_torch.models.cal, "
        "saspa_tpu_torch.models.resnet, saspa_tpu_torch.utils.logging_utils, saspa_tpu_torch.bridge, "
        "saspa_tpu_torch.fgvc.train, saspa_tpu_torch.fgvc.runner, saspa_tpu_torch.fgvc.losses, "
        "saspa_tpu_torch.fgvc.metrics, saspa_tpu_torch.data.pipeline, saspa_tpu_torch.ops.augment, "
        "saspa_tpu_torch.ops.batch_augment, saspa_tpu_torch.ops.host_resize, saspa_tpu_torch.utils.checkpoint\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'saspa_tpu', 'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
