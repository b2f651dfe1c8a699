"""The port's host image ops against the JAX package's and PIL, on the CPU.

`resize_image` is held against saspa_tpu.ops.image.resize_image, which is
cv2 in this environment (INTER_LANCZOS4 up, INTER_AREA down): bit-exact in
every case below.  The PNG reader and writer (gen/image_io.py) are held
against PIL, and the header probes against PIL's `.size`.
"""

import numpy as np
import pytest
from PIL import Image

from saspa_tpu.ops import image as jimg
from saspa_tpu_torch.gen import image_io
from saspa_tpu_torch.ops import image as timg


def _source(h, w, seed, noise=False):
    rng = np.random.RandomState(seed)
    if noise:
        return rng.randint(0, 256, (h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = 128 + 100 * np.sin(np.stack([xx * 7 + yy * 3, xx * 2 - yy * 9, xx * 13], -1))
    return np.clip(img + 20 * rng.randn(h, w, 3), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w,res,noise", [
    (96, 128, 512, False),   # upscale: INTER_LANCZOS4
    (300, 200, 512, True),   # upscale, portrait
    (500, 1000, 1024, False),  # capped upscale: the 1.2 MP cap fires, INTER_AREA (cv2's bilinear emulation)
    (1000, 700, 512, True),  # downscale: INTER_AREA tables
    (1234, 999, 512, False),  # downscale, ragged
    (2048, 2048, 1024, True),  # integral 2x downscale: INTER_AREA block means
    (1536, 1536, 512, False),  # integral 3x downscale
    (512, 512, 512, True),   # identity
    (640, 640, 512, False),  # 5:4 downscale
])
def test_resize_image_is_bit_exact(h, w, res, noise):
    x = _source(h, w, h + w, noise)
    want = jimg.resize_image(x, res)
    got = timg.resize_image(x, res)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert timg.resize_shape_multiple_of_64(h, w, res) == jimg.resize_shape_multiple_of_64(h, w, res)


def test_hwc3_matches():
    rng = np.random.RandomState(0)
    for shape in ((5, 7), (5, 7, 1), (5, 7, 3), (5, 7, 4)):
        x = rng.randint(0, 256, shape, np.uint8)
        assert np.array_equal(timg.HWC3(x), jimg.HWC3(x))


def test_png_round_trip(tmp_path):
    rng = np.random.RandomState(1)
    for arr in (rng.randint(0, 256, (37, 53, 3), np.uint8), rng.randint(0, 256, (20, 9), np.uint8)):
        p = tmp_path / "x.png"
        image_io.write_png(p, arr)
        assert np.array_equal(image_io.read_png(p).squeeze(-1) if arr.ndim == 2 else image_io.read_png(p), arr)
        assert np.array_equal(np.asarray(Image.open(p)), arr)  # PIL reads it too
        assert image_io.image_size(p) == (arr.shape[1], arr.shape[0])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("opts", [{}, {"optimize": True}, {"compress_level": 1}])
@pytest.mark.parametrize("noise", [0.2, 1.0])
def test_reads_pil_written_pngs(tmp_path, mode, opts, noise):
    """PIL's encoder picks its own scanline filters (all five appear across
    these images: 1-4 on the patterned ones, 0 on pure noise); read_rgb
    equals np.asarray(Image.open(p).convert("RGB"))."""
    h, w = 41, 67
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 3 % 256, yy * 5 % 256, (xx * yy) % 256, (xx + 2 * yy) % 256], -1).astype(np.uint8)
    rng = np.random.RandomState(2)
    img = np.where(rng.rand(h, w, 1) < 0.2, 255 - smooth, smooth) if noise < 1 else \
        rng.randint(0, 256, (h, w, 4), np.uint8)
    p = tmp_path / "pil.png"
    Image.fromarray(img, "RGBA").convert(mode).save(p, **opts)
    assert np.array_equal(image_io.read_rgb(p), np.asarray(Image.open(p).convert("RGB")))
    assert image_io.image_size(p) == Image.open(p).size


def test_other_png_kinds_raise(tmp_path):
    """Palette and gray+alpha PNGs are not read (no source of the pipeline
    is one); they raise instead of decoding wrongly."""
    p = tmp_path / "p.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert("P").save(p)
    with pytest.raises(ValueError, match="colour type 3"):
        image_io.read_rgb(p)


@pytest.mark.parametrize("progressive", [False, True])
def test_probes_match_pil_and_format_is_read_from_content(tmp_path, progressive):
    x = _source(70, 110, 3)
    jpg = tmp_path / "a.png"  # a JPEG named .png
    Image.fromarray(x).save(jpg, format="JPEG", quality=90, progressive=progressive)
    png = tmp_path / "b.jpg"  # a PNG named .jpg, as the card's smoke test writes its sources
    image_io.write_png(png, x)
    assert image_io.sniff(jpg) == "jpeg" and image_io.sniff(png) == "png"
    assert image_io.image_size(jpg) == Image.open(jpg).size == (110, 70)
    assert image_io.image_size(png) == Image.open(png).size
    assert np.array_equal(image_io.read_rgb(png), x)
    assert np.array_equal(image_io.read_rgb(jpg), np.asarray(Image.open(jpg).convert("RGB")))  # through PIL


def test_jpeg_without_pil_raises(tmp_path, monkeypatch):
    """Where PIL is missing (the card's machine) a JPEG source decodes all
    the same, to PIL's pixels (gen/jpeg.py; tests/test_torch_jpeg.py holds
    the decoder), and a format that only PIL reads raises, naming PIL."""
    p = tmp_path / "a.jpg"
    Image.fromarray(_source(16, 16, 0)).save(p, format="JPEG")
    bmp = tmp_path / "a.bmp"
    Image.fromarray(_source(16, 16, 1)).save(bmp, format="BMP")
    want = np.asarray(Image.open(p).convert("RGB"))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    assert np.array_equal(image_io.read_rgb(p), want)
    with pytest.raises(RuntimeError, match="PIL"):
        image_io.read_rgb(bmp)
    assert image_io.image_size(p) == (16, 16)  # the header probe needs no PIL
