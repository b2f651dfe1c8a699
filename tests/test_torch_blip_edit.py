"""Parity of the port's BLIP-Diffusion inversion edit (`blip_diffusion-edit`)
with the JAX package, on the CPU.

The pipeline of tests/test_blip_edit.py::_tiny_blip_pipe (ViT width 32,
patch 32; Q-Former width 32, 1 layer; the tiny SD1.5 of
tests/test_diffusion_pipeline.py), f32, with the params of
tests/fixtures/golden_gen_blip.npz (VAE encoder included) preset on the JAX
side and carried into the port through the bridge, as
tests/test_torch_blip.py does.  `invert` (DDIM inversion up the ascending
schedule, one UNet call a transition), `edit` (the subject swap), and
`run_generation` with `blip_diffusion-edit` through both drivers.
Tolerances: latents and float images within 1e-4 of the largest |want|,
uint8 images within 1 level on >= 99% of the pixels.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu_torch.diffusion.pipelines import quantize
from saspa_tpu_torch.gen import driver as tdriver
from tests.test_torch_blip import _images_close, blip_params, jax_pipe, port_pipe
from tests.test_torch_driver import _cfg, _jax_cfg, _pngs, dtd_tree  # noqa: F401 (a fixture)
from tests.test_torch_pipeline import _close

META = "texture"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of a thread a core oversubscribes them and its small CPU ops
    then stall (tests/test_torch_train_step.py's fixture)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes():
    params = blip_params()[None]
    jp = jax_pipe(params)

    def subject_embeds(p, images, text_ids, text_mask):  # as _tiny_blip_pipe sets it
        tokens = jp.vision.apply({"params": p["blip_vision"]}, images, return_tokens=True)
        return jp.qformer.apply({"params": p["blip_qformer"]}, tokens, text_ids, text_mask)

    jp._subject_embeds_jit = jax.jit(subject_embeds)
    return jp, port_pipe(params)


def _images(seed, b=2, size=64):
    rng = np.random.RandomState(seed)
    return rng.rand(b, size, size, 3).astype(np.float32), rng.rand(b, 224, 224, 3).astype(np.float32)


@pytest.mark.parametrize("steps", [3, 50])
def test_invert_matches_jax(pipes, steps):
    """invert on 64^2 images under the plain text tower's context: the JAX
    package's latents, after steps - 1 UNet calls (49 of the recipe's 50)."""
    jp, tp = pipes
    src, _ = _images(steps)
    ids = tp.tokenizer([f"a {META}"] * 2, pad="eot")
    want = jp.invert(jnp.asarray(src), jp.text_encoders[0].apply({"params": jp.params["text"][0]},
                                                                 jnp.asarray(ids))["hidden"], steps)
    calls = []
    hook = tp.params["unet"].register_forward_pre_hook(lambda m, a: calls.append(a[1]))
    try:
        with torch.no_grad():
            ctx = tp.params["text"][0](torch.from_numpy(ids).long())["hidden"]
        got = tp.invert(src, ctx, steps)
    finally:
        hook.remove()
    assert calls == [int(t) for t in tp.scheduler.timesteps(steps)[::-1][:-1]] and len(calls) == steps - 1
    assert got.dtype == torch.float32
    _close(got, want, rel=1e-4)


def test_edit_matches_jax(pipes):
    """edit: 3 inversion steps and 3 regeneration steps at CFG 7.5 with
    the default negative prompt, subject references at 224^2, the meta class
    as the source and target subject."""
    jp, tp = pipes
    src, refs = _images(5)
    prompts = ["woven into a basket", "on a wall"]
    kw = dict(source_subject=META, target_subject=META, guidance_scale=7.5, num_inference_steps=3,
              num_inversion_steps=3, negative_prompt="blurry")
    want = jp.edit(jnp.asarray(src), jnp.asarray(refs), prompts, jax.random.PRNGKey(0), **kw)
    got = tp.edit(src, refs, prompts, **kw)
    _close(got, want, rel=1e-4)
    _images_close(quantize(got).numpy(), np.clip(np.round(np.asarray(want) * 255.0), 0, 255).astype(np.uint8))


def test_run_generation_edit_matches_jax(dtd_tree, pipes, caplog):
    """`run_generation` with blip_diffusion-edit (dtd, 4 sources x 1
    prompt at 64^2, one batch of 4, 2 regeneration steps after the 49
    inversion calls) through both drivers: the same folder and files, the _source,
    _control and _subject_ PNGs bit-equal, the edits within 1 uint8 level;
    and the port's PNGs against quantize of its own edit on the same batch
    of the same prompts and sources (the subject references read back from
    the written _subject_ files), within 1 level too: torch's CPU kernels
    can round differently between two calls of one process (the card's
    smoke holds the same replay bit for bit)."""
    import saspa_tpu_torch.data.registry as TR
    from saspa_tpu.gen.driver import run_generation as jax_run_generation
    from saspa_tpu_torch.gen.image_io import read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.ops.image import pil_resize, resize_image

    jp, tp = pipes
    cfg = _cfg(dataset="dtd", base_model="blip_diffusion-edit", num_per_image=1, batch_size=4,
               num_inference_steps=2)
    want_dir = jax_run_generation(_jax_cfg(cfg), pipe=jp)
    want = _pngs(want_dir)
    for p in Path(want_dir).glob("*.png"):
        p.unlink()
    caplog.set_level("INFO")
    got_dir = tdriver.run_generation(cfg, pipe=tp)
    assert got_dir == want_dir and "/blip_diffusion-edit/" in got_dir
    got = _pngs(got_dir)
    assert sorted(got) == sorted(want) and len(got) == 4 * 4
    for name in got:
        if "_prompt_" in name:
            _images_close(got[name], want[name])
        else:
            assert np.array_equal(got[name], want[name]), name
    tele = [r.getMessage() for r in caplog.records if r.getMessage().startswith("generation telemetry: ")]
    assert tele and '"num_errors": 0' in tele[-1] and '"total": 4' in tele[-1]

    c = cfg.with_dataset_overrides()
    ds = TR.DS_UTILS_DICT["dtd"]()
    engine = PromptEngine(c, ds, ds.get_image_path_to_class_str_dict())
    items = [(p, engine.build(p, i, 0)) for i, p in enumerate(ds.original_images_paths)]
    src = np.stack([resize_image(read_rgb(p), 64) for p, _ in items]).astype(np.float32) / 255.0
    refs = np.stack([pil_resize(got[f"{Path(p).stem}_subject_0.png"], (224, 224)) for p, _ in items])
    out = quantize(tp.edit(src, refs.astype(np.float32) / np.float32(255.0), [pr for _, pr in items],
                           source_subject=META, target_subject=META, guidance_scale=7.5, num_inference_steps=2,
                           negative_prompt=c.negative_prompt)).numpy()
    for (p, prompt), img in zip(items, out):
        _images_close(got[f"{Path(p).stem}_prompt_{prompt.replace('/', '-')}_0.png"], img)
