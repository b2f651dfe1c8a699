"""Parity of the PyTorch port's models with the JAX package, on the CPU.

Text tower, UNet (plain and with the CFG shared prefix and ControlNet
residuals), ControlNet and VAE decode at the tiny configs and params of
tests/test_torch_pipeline.py, in f32.  Tolerance: |diff| <= 1e-4 of the
largest output (1e-5 for the text tower): XLA and torch sum and convolve in
different orders on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from saspa_tpu.models.controlnet import ControlNet as JaxControlNet
from saspa_tpu.models.vae import AutoencoderKL as JaxVAE
from tests.test_torch_pipeline import _close, _ids, _inputs, _nchw, pipes  # noqa: F401  (pipes: fixture)


def test_text_tower_matches(pipes):
    jp, tp, _ = pipes
    ids, neg = _ids()
    for x in (ids, neg):
        want = jp.text_encoders[0].apply({"params": jp.params["text"][0]}, jnp.asarray(x))["hidden"]
        got = tp.params["text"][0](torch.from_numpy(x).long())["hidden"]
        _close(got, want, rel=1e-5)


def _context(jp, b=2):
    ids, neg = _ids(b)
    te, p = jp.text_encoders[0], jp.params["text"][0]
    ctx = np.asarray(te.apply({"params": p}, jnp.asarray(ids))["hidden"])
    nctx = np.asarray(te.apply({"params": p}, jnp.asarray(neg))["hidden"])
    return np.concatenate([nctx, ctx], axis=0)


def test_unet_matches(pipes):
    """One UNet call at 16x16 latents (256-token packed self-attention)."""
    jp, tp, _ = pipes
    _, lat = _inputs(1)
    ctx = _context(jp)[:2]
    want = jax.jit(jp.unet.apply)({"params": jp.params["unet"]}, jnp.asarray(lat), jnp.asarray(501), jnp.asarray(ctx))
    got = tp.params["unet"](_nchw(lat), 501, torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    _close(got, want)


def test_controlnet_and_shared_prefix_unet_match(pipes):
    """The ControlNet (embed_cond + residuals, scale 0.75) and one UNet call
    with the CFG shared prefix: B-sized latents against the 2B [uncond, cond]
    context, forking at the first cross-attention, with the residuals."""
    jp, tp, _ = pipes
    src, lat = _inputs(2)
    ctx = _context(jp)  # (4, 77, 16)
    rng = np.random.RandomState(4)
    cimg = (rng.rand(2, 128, 128, 3) > 0.9).astype(np.float32)
    jcn, tcn = jp.params["controlnet"], tp.params["controlnet"]
    jemb = jp.controlnet.apply({"params": jcn}, jnp.asarray(cimg), method=JaxControlNet.embed_cond)
    temb = tcn.embed_cond(_nchw(cimg))
    _close(temb.permute(0, 2, 3, 1), jemb)
    jdown, jmid = jax.jit(jp.controlnet.apply)({"params": jcn}, jnp.asarray(lat), jnp.asarray(301),
                                               jnp.asarray(ctx), None, 0.75, cond_emb=jemb)
    tdown, tmid = tcn(_nchw(lat), 301, torch.from_numpy(ctx), temb, 0.75)
    assert len(tdown) == len(jdown)
    for g, w in zip(tdown, jdown):
        _close(g.permute(0, 2, 3, 1), w)
    _close(tmid.permute(0, 2, 3, 1), jmid)
    assert float(np.abs(np.asarray(jmid)).max()) > 0
    want = jax.jit(jp.unet.apply)({"params": jp.params["unet"]}, jnp.asarray(lat), jnp.asarray(301),
                                  jnp.asarray(ctx), down_block_additional_residuals=jdown,
                                  mid_block_additional_residual=jmid)
    got = tp.params["unet"](_nchw(lat), 301, torch.from_numpy(ctx), tdown, tmid)
    assert got.shape[0] == 4 and want.shape[0] == 4
    _close(got.permute(0, 2, 3, 1), want)


def test_vae_decode_matches(pipes):
    """16x16 latents: the mid attention has 256 tokens but a 16-wide head,
    so both packages take the plain path there."""
    jp, tp, _ = pipes
    _, lat = _inputs(3)
    want = jax.jit(lambda p, z: jp.vae.apply({"params": p}, z, method=JaxVAE.decode))(jp.params["vae"], jnp.asarray(lat))
    got = tp.params["vae"].decode(_nchw(lat)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    _close(got, want)


