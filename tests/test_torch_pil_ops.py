"""The port's PIL counterparts against PIL and the JAX package, on the CPU.

The filter stage reads every generated file through PIL in the JAX package;
the machine with the card has no PIL, so the port carries numpy versions:
`ops.image.pil_resize` (Pillow's 8-bit two-pass resample) and
`gen.image_io.verify_image` (Image.open(p).verify()).  Each is held bit for
bit (resize, both filters' preprocess) or file for file (the corrupt-file
sweep) against PIL and the JAX package.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from saspa_tpu.filters import aug_json as jaug
from saspa_tpu.filters.clip_filters import clip_preprocess_path as j_clip_preprocess
from saspa_tpu.filters.confidence import val_preprocess as j_val_preprocess
from saspa_tpu_torch.filters import aug_json as taug
from saspa_tpu_torch.filters.clip_filters import clip_preprocess_path as t_clip_preprocess
from saspa_tpu_torch.filters.confidence import val_preprocess as t_val_preprocess
from saspa_tpu_torch.gen import image_io
from saspa_tpu_torch.ops.image import pil_resize

PIL_FILTERS = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}


def _image(h, w, seed):
    """Smooth structure with noise: both flat and busy neighbourhoods."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = 128 + 110 * np.sin(np.stack([xx * 9 + yy * 4, xx * 3 - yy * 11, xx * 17], -1))
    return np.clip(img + 25 * rng.randn(h, w, 3), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w,size,method", [
    (512, 512, (224, 224), "bicubic"),  # the CLIP filter at the recipe's 512^2
    (1024, 1024, (224, 224), "bicubic"),  # ... at 1024^2
    (480, 640, (299, 224), "bicubic"),  # 4:3, short side to 224
    (150, 100, (224, 336), "bicubic"),  # upsampled
    (512, 512, (256, 256), "bilinear"),  # the confidence filter's resize/0.875
    (333, 517, (256, 256), "bilinear"),  # ragged, both axes
    (300, 224, (224, 300), "bicubic"),  # one axis each way
    (512, 512, (512, 224), "bicubic"),  # vertical pass only
])
def test_pil_resize_is_bit_exact(h, w, size, method):
    img = _image(h, w, h * 7 + w)
    want = np.asarray(Image.fromarray(img).resize(size, PIL_FILTERS[method]))
    got = pil_resize(img, size, method)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got.astype(int) - want).max()


def test_pil_resize_same_size_is_a_copy():
    img = _image(64, 48, 0)
    out = pil_resize(img, (48, 64))
    assert np.array_equal(out, img) and out is not img


@pytest.mark.parametrize("h,w", [(512, 512), (1024, 768), (200, 300), (240, 240)])
def test_filter_preprocess_matches_jax(tmp_path, h, w):
    """clip_preprocess_path (bicubic, short side, center crop, CLIP
    normalise) and val_preprocess (bilinear to 256^2, center crop, ImageNet
    normalise) equal JAX's element for element on a PNG."""
    p = tmp_path / "aug.png"
    Image.fromarray(_image(h, w, h + 3 * w)).save(p)
    for want, got in ((j_clip_preprocess(str(p)), t_clip_preprocess(str(p))),
                      (j_val_preprocess(str(p)), t_val_preprocess(str(p)))):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want)


def _folder(root):
    """Good PNG, truncated PNG, CRC-flipped PNG, garbage bytes, good JPEG,
    a JPEG cut inside its headers, and a side file (excluded)."""
    d = root / "images"
    d.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (32, 40, 3), np.uint8)).save(d / f"good_{i}.png")
    good = (d / "good_0.png").read_bytes()
    (d / "truncated.png").write_bytes(good[:len(good) // 2])
    flipped = bytearray(good)
    flipped[40] ^= 0xFF  # inside IDAT
    (d / "crc.png").write_bytes(bytes(flipped))
    (d / "garbage.png").write_bytes(b"this is not an image")
    Image.fromarray(rng.randint(0, 255, (32, 40, 3), np.uint8)).save(d / "good.jpg", quality=90)
    (d / "cut_headers.jpg").write_bytes((d / "good.jpg").read_bytes()[:120])
    (d / "x_source.png").write_bytes(b"broken side file, never checked")
    return d


@pytest.mark.parametrize("max_delete", [50, 2])
def test_corrupt_file_sweep_deletes_what_jax_deletes(tmp_path, max_delete):
    jdir = _folder(tmp_path / "jax")
    tdir = tmp_path / "port" / "images"
    shutil.copytree(jdir, tdir)
    order = os.listdir(jdir)
    assert order == os.listdir(tdir)  # the same walk order, so max_delete stops at the same file
    jaug.check_folder_of_images_with_pil(str(jdir), max_delete, jaug.SUBSTRINGS_TO_EXCLUDE)
    taug.check_folder_of_images_with_pil(str(tdir), max_delete, taug.SUBSTRINGS_TO_EXCLUDE)
    left = sorted(os.listdir(tdir))
    assert left == sorted(os.listdir(jdir))
    assert len(order) - len(left) == min(max_delete, 4)
    assert {"good_0.png", "good_1.png", "good.jpg", "x_source.png"} <= set(left)


def test_a_file_that_cannot_be_checked_is_kept_and_stops_the_sweep(tmp_path, monkeypatch):
    """Without PIL a format other than PNG and JPEG cannot be checked:
    verify_image raises RuntimeError, which the sweep does not count as
    corruption, and the file stays."""
    d = tmp_path / "images"
    d.mkdir()
    (d / "a.gif").write_bytes(b"GIF89a" + bytes(20))

    def no_pil(path):
        raise RuntimeError("PIL is not installed here")

    monkeypatch.setattr(image_io, "_pil_image", no_pil)
    with pytest.raises(RuntimeError, match="PIL is not installed"):
        taug.check_folder_of_images_with_pil(str(d))
    assert os.listdir(d) == ["a.gif"]


def test_verify_image_reads_png_and_jpeg_without_pil(tmp_path, monkeypatch):
    d = _folder(tmp_path)
    monkeypatch.setattr(image_io, "_pil_image", lambda path: pytest.fail(f"PIL reached for {path}"))
    verdict = {}
    for name in ("good_0.png", "truncated.png", "crc.png", "good.jpg", "cut_headers.jpg"):
        try:
            image_io.verify_image(d / name)
            verdict[name] = True
        except image_io.CorruptImage:
            verdict[name] = False
    assert verdict == {"good_0.png": True, "truncated.png": False, "crc.png": False, "good.jpg": True,
                       "cut_headers.jpg": False}


@pytest.mark.parametrize("head", [b"", image_io.PNG_SIGNATURE[:5], b"\xff"])
def test_a_file_too_short_for_an_image_is_deleted_without_pil(tmp_path, monkeypatch, head):
    """An empty file (as a killed write leaves) or one that ends inside the
    PNG or JPEG signature: JAX's sweep deletes it through PIL, and the
    port's deletes it with no PIL at all."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        d.mkdir()
        (d / "short.png").write_bytes(head)
    jaug.check_folder_of_images_with_pil(str(jdir))
    monkeypatch.setattr(image_io, "_pil_image", lambda path: pytest.fail(f"PIL reached for {path}"))
    taug.check_folder_of_images_with_pil(str(tdir))
    assert os.listdir(jdir) == os.listdir(tdir) == []
