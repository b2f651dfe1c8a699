"""Parity of the port's HED ControlNet (`--controlnet hed`) with the JAX
package, on the CPU.

`models/hed.py` against `saspa_tpu.models.hed` in f32 at sizes that 16
does not divide (40x56, 72x40, 33x47: the floor pooling leaves stage 5 at
2x3, 4x2, 2x2, and the side outputs are resized back from those grids:
jax.image.resize's "linear" against F.interpolate's bilinear, edges
included), the control image,
the converter against tools/convert_weights.py::convert_hed on
tools/synth_checkpoints.py's layout and the strict load of a
ControlNetHED.pth; then the HED ControlNet on the tiny SD1.5 pipelines of
tests/test_torch_pipeline.py (the fused function), and both drivers'
SDEdit + HED and BLIP-Diffusion + HED runs on the stub trees of
tests/test_torch_driver.py.  Both packages take the same numpy params
through the bridge and the same numpy inputs.  Tolerances: HED's edge map
(in (0, 1)) within 1e-5: thirteen f32 convolutions of inputs in the
hundreds, summed in other orders by XLA and oneDNN, move the side outputs
by a few 1e-6 of their size before the sigmoid (3.3e-6 seen); float images within 1e-4 of the largest; uint8 images within
1 level on >= 99% of the pixels (tests/test_torch_blip.py::_images_close);
the drivers' side files bit-equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.gen.driver import run_generation as jax_run_generation
from saspa_tpu.models import hed as jhed
from saspa_tpu_torch.bridge import state_dict_from_flax
from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, quantize
from saspa_tpu_torch.gen import driver as tdriver
from saspa_tpu_torch.models import hed as thed
from saspa_tpu_torch.models.layers import init_weights
from saspa_tpu_torch.weights import convert as pconv
from saspa_tpu_torch.weights import load as pload
from saspa_tpu_torch.weights.files import write_safetensors
from saspa_tpu_torch.weights.sources import controlnet_part
from tests.test_golden_generation import G_TEXT, G_UNET, G_VAE
from tests.test_torch_blip import _close, _images_close, random_flax_tree
from tests.test_torch_driver import _cfg, _jax_cfg, _pngs, dtd_tree, stub_tree  # noqa: F401 (fixtures)
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, _PresetJaxPipeline, _ids, _inputs, tiny_params
from tools import convert_weights as jconv
from tools import synth_checkpoints as synth

F32 = torch.float32
NORM = np.array([104.0, 117.0, 123.0], np.float32)  # an offset of the annotator's order, per channel


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several worker processes share a few cores (tests/test_torch_sdedit.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def hed_params(seed=13) -> dict:
    """A seeded flax tree of HED's shape (kernels N(0, 1/fan_in), biases
    N(0, 0.1^2)) with an offset of realistic size."""
    tree = random_flax_tree(thed.HED(), np.random.RandomState(seed))
    tree["norm"] = NORM.reshape(1, 1, 1, 3)
    return tree


def _port_hed(params) -> thed.HED:
    model = thed.HED()
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


@pytest.mark.parametrize("h,w", [(40, 56), (72, 40), (33, 47)])
def test_hed_matches_flax(h, w):
    """f32 HED on (2, h, w, 3) images in [0, 1]: the five side outputs'
    linear resize, the floor pooling of odd sizes, mean and sigmoid; the
    edge maps vary (not a constant sigmoid)."""
    params = hed_params()
    x = np.random.RandomState(h * w).rand(2, h, w, 3).astype(np.float32)
    want = np.asarray(jhed.HED(dtype=jnp.float32).apply({"params": params}, jnp.asarray(x)))
    got = _port_hed(params)(torch.from_numpy(x))
    assert tuple(got.shape) == (2, h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert float(np.ptp(want)) > 0.05


def test_hed_resize_is_jax_linear_at_the_edges():
    """One side output alone: F.interpolate's bilinear (align_corners=False)
    from 5x7, 2x3 and 1x1 grids to 40x56 equals jax.image.resize's "linear"
    within f32 rounding, edges included."""
    rng = np.random.RandomState(3)
    for hh, ww in ((5, 7), (2, 3), (1, 1), (20, 28)):
        side = rng.randn(2, hh, ww, 1).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(side), (2, 40, 56, 1), method="linear"))
        got = torch.nn.functional.interpolate(torch.from_numpy(side).permute(0, 3, 1, 2), size=(40, 56),
                                              mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_hed_control_image_matches_jax():
    """(B, H, W, 3) in [0, 1] -> the edge map repeated on 3 channels."""
    params = hed_params()
    x = np.random.RandomState(5).rand(2, 40, 56, 3).astype(np.float32)
    want = np.asarray(jhed.hed_control_image(jhed.HED(dtype=jnp.float32), {"params": params}, jnp.asarray(x)))
    got = thed.hed_control_image(_port_hed(params), torch.from_numpy(x))
    assert tuple(got.shape) == (2, 40, 56, 3) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_convert_hed_matches_tools_and_loads_strictly(tmp_path):
    """The port's convert_hed gives tools/convert_weights.py's tree bit for
    bit on controlnet_aux's ControlNetHED.pth layout; the file loads into
    HED strictly (every key read, every parameter from the file)."""
    sd = synth.controlnet_aux_hed_state_dict(fill=np.random.RandomState(7))
    want, got = jconv.convert_hed(sd), pconv.convert_hed(sd)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    assert flat(got).keys() == flat(want).keys()
    assert all(np.array_equal(np.asarray(flat(got)[k]), np.asarray(v)) for k, v in flat(want).items())
    path = tmp_path / "ControlNetHED.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    model = thed.HED()
    (rep,) = pload.load_file(path, "hed", model)
    assert rep["model"] == "hed" and rep["unconsumed"] == 0 and rep["params"] == rep["module_params"] == 37
    assert np.array_equal(model.norm.detach().numpy().ravel(), np.asarray(sd["norm"]).ravel())


_PIPES = {}


def hed_pipes():
    """The JAX and port SD1.5 + HED ControlNet pipelines on
    tests/test_torch_pipeline.py's params plus HED's, built once."""
    if not _PIPES:
        params = {**tiny_params(), "hed": hed_params()}
        _PresetJaxPipeline.preset = params
        jp = _PresetJaxPipeline(base_model="sd_v1.5", controlnet="hed", sdedit=True, sampler="ddim",
                                dtype=jnp.float32, unet_cfg=G_UNET, vae_cfg=G_VAE, text_cfgs=G_TEXT)
        tp = DiffusionPipeline(controlnet="hed", device="cpu", dtype=F32, init_seed=None, unet_cfg=P_UNET,
                               vae_cfg=P_VAE, text_cfgs=P_TEXT)
        tp.load_flax_params(params)
        _PIPES["sd"] = jp, tp
    return _PIPES["sd"]


def test_hed_fused_generate_matches_jax():
    """The fused function with the HED ControlNet at 32^2, 3 DDIM steps, CFG
    7.5, scale 0.75: HED's control image of the uint8 sources / 255 (equal to
    JAX's _control_from_src within HED's tolerance), then the same loop as
    canny's."""
    jp, tp = hed_pipes()
    src, lat = _inputs(41)
    ids, neg = _ids()
    jcontrol = jp._control_from_src(jp.params, jnp.asarray(src, jnp.float32), 32, 32, 120.0, 200.0)
    control = tp.control_from_src(src, 32, 32)
    assert tuple(control.shape) == (2, 128, 128, 3)  # latent size (16) * 8
    np.testing.assert_allclose(control.numpy(), np.asarray(jcontrol), atol=1e-5, rtol=0)
    want = jp.make_fused_generate(32, 32, 3, 7.5)(jp.params, jnp.asarray(ids), jnp.asarray(neg), jnp.asarray(src),
                                                  jnp.asarray(lat))
    got = tp.make_fused_generate(32, 32, 3, 7.5)(tp.params, ids, neg, src, lat, return_images=True)
    _images_close(got[0].numpy(), np.asarray(want))
    kw = dict(height=32, width=32, num_inference_steps=3, guidance_scale=7.5, controlnet_scale=0.75, token_ids=ids,
              negative_token_ids=neg)
    jp.sdedit = False
    wantf = jp.generate(["a", "b"], jax.random.PRNGKey(0), control_image=jcontrol, latents=jnp.asarray(lat), **kw)
    jp.sdedit = True
    _close(got[1], wantf, 1e-4)


def test_hed_pipeline_seeds_and_loads_its_files(tmp_path):
    """A HED ControlNet pipeline holds params["hed"] beside the ControlNet
    (seeded with seed + 13 where no file is given); with a tree holding
    ControlNetHED.pth and a diffusers HED ControlNet (`*sd-controlnet-hed*/`)
    both load on their own (the base family's files absent: seeded, with a
    warning).  An XL HED ControlNet, which no file rule provides, is refused
    by name."""
    tp = DiffusionPipeline("sd_v1.5", "hed", device="cpu", dtype=F32, unet_cfg=P_UNET, vae_cfg=P_VAE,
                           text_cfgs=P_TEXT)
    assert isinstance(tp.params["hed"], thed.HED) and tp.controlnet_kind == "hed"
    seeded = thed.HED()
    init_weights(seeded, 13)
    assert all(torch.equal(a, b) for a, b in zip(tp.params["hed"].state_dict().values(),
                                                 seeded.state_dict().values()))
    sd = synth.controlnet_aux_hed_state_dict(fill=np.random.RandomState(8))
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmp_path / "ControlNetHED.pth")
    cn_sd = synth.diffusers_controlnet_state_dict(
        dict(synth.SD15_TORCH_CFG, block_out_channels=G_UNET.block_out_channels, layers_per_block=1,
             down_block_types=G_UNET.down_block_types, up_block_types=G_UNET.up_block_types,
             transformer_layers_per_block=(1, 1), cross_attention_dim=16), fill=np.random.RandomState(9))
    (tmp_path / "sd-controlnet-hed").mkdir()
    write_safetensors(tmp_path / "sd-controlnet-hed" / "diffusion_pytorch_model.safetensors", cn_sd)
    tp = DiffusionPipeline("sd_v1.5", "hed", device="cpu", dtype=F32, weights_dir=str(tmp_path), unet_cfg=P_UNET,
                           vae_cfg=P_VAE, text_cfgs=P_TEXT)
    assert sorted(r["model"] for r in tp.load_report) == ["controlnet", "hed"] and not tp.weights_loaded
    assert all(r["unconsumed"] == 0 and r["params"] == r["module_params"] for r in tp.load_report)
    with pytest.raises(FileNotFoundError, match=r"an XL hed ControlNet \(controlnet_hed_xl\)"):
        controlnet_part("sd_xl-turbo", "hed", True)
    assert controlnet_part("sd_xl-turbo", "canny", True) == "controlnet_canny_xl"
    assert controlnet_part("blip_diffusion-controlnet", "hed", False) == "controlnet_hed_sd15"


# ---- the drivers -----------------------------------------------------------------

def test_run_generation_sdedit_hed_matches_jax(stub_tree):
    """`run_generation` with SDEdit and the HED ControlNet (JAX's unfused
    path: `_control_for_batch` / `_hed_control` on the pipeline's HED; the
    port's `control_from_src`) on the stub planes tree: 3 sources x 2
    prompts at 64^2, batch 4, strength 0.5 of 4 steps.  The file sets are
    equal (no _control files: those are canny's), the _source files
    bit-equal, the generated PNGs within 1 uint8 level on >= 99%."""
    jp, tp = hed_pipes()
    cfg = _cfg(controlnet="hed", sdedit=True, sdedit_strength=0.5, num_inference_steps=4)
    want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jp)
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    got_dir = tdriver.run_generation(cfg, pipe=tp)
    assert got_dir == want_dir and "/hed/" in got_dir
    got = _pngs(got_dir)
    assert sorted(got) == sorted(want) and len(got) == 6 + 3
    for name in got:
        if "_prompt_" in name:
            _images_close(got[name], want[name])
        else:
            assert np.array_equal(got[name], want[name]), name


def test_run_generation_blip_hed_matches_jax(dtd_tree):
    """BLIP-Diffusion with `--controlnet hed` through both drivers (the
    fused path, HED inside it): 4 sources x 1 prompt at 64^2, batch 3, 2
    DDIM steps, CFG 7.5, tests/test_torch_blip.py's tiny pipelines with the
    same params plus HED's.  Folders and file names equal, the _source and
    _subject_ PNGs bit-equal, the generated PNGs within 1 uint8 level on
    >= 99%."""
    from tests.test_torch_blip import blip_params, jax_pipe, port_pipe

    params = {**blip_params()["canny"], "hed": hed_params()}
    cfg = _cfg(dataset="dtd", base_model="blip_diffusion", controlnet="hed", num_per_image=1, batch_size=3)
    want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jax_pipe(params, "hed"))
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    got_dir = tdriver.run_generation(cfg, pipe=port_pipe(params, "hed"))
    assert got_dir == want_dir and "/hed/" in got_dir
    got = _pngs(got_dir)
    assert sorted(got) == sorted(want) and len(got) == 4 * 3
    for name in got:
        if "_prompt_" in name:
            _images_close(got[name], want[name])
        else:
            assert np.array_equal(got[name], want[name]), name
