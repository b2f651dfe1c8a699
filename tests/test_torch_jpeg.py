"""The port's JPEG decoder (saspa_tpu_torch/gen/jpeg.py) against PIL, the
JAX package's decoder, on the CPU.

PIL's `Image.open(p).convert("RGB")` (libjpeg-turbo: islow IDCT, fancy
upsampling, fixed-point YCbCr) is the reference; every comparison is bit
for bit.  Cases:
  * the committed fixtures (tests/fixtures/jpeg/<name>.jpg beside
    <name>.pil.png, PIL's pixels written with the port's write_png): 4:2:0,
    4:2:2, 4:4:4 and grey; quality 1 to 100; optimised tables; restart
    markers by blocks and by rows; progressive 4:2:0, 4:4:4 and grey;
    sizes 1x1 to 1000x667.  The card's `jpeg` phase holds the same files
    against the same PNGs, where there is no PIL, and builds its JPEG
    source tree from them;
  * 200 seeded encodes made here (sizes 1-300, every quality, subsampling
    0/1/2 and grey, progressive or not, optimised or not, with and without
    restart markers);
  * `read_rgb` with PIL blocked in sys.modules;
  * truncated and corrupt files raise where PIL raises; the layouts the
    decoder refuses (arithmetic coding, lossless, 12-bit, 4 components,
    Adobe transform 0, 1x2 sampling) raise naming the feature;
  * the train pipeline's decode_resize against the JAX package's
    _decode_resize, and `run_generation` on a JPEG source tree against the
    JAX driver.
`python tests/test_torch_jpeg.py --write-fixtures` rewrites the fixtures.
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from saspa_tpu_torch.gen.image_io import read_png, read_rgb, write_png
from saspa_tpu_torch.gen.jpeg import JPEGError, UnsupportedJPEG, decode_jpeg

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"

# name -> (height, width, grey, PIL save options)
FIXTURE_SPECS = {
    "q75_420_375x500": (375, 500, False, dict(quality=75, subsampling=2)),
    "q90_420_667x1000": (667, 1000, False, dict(quality=90, subsampling=2)),
    "q90_420_512x512": (512, 512, False, dict(quality=90, subsampling=2)),
    "q95_422_33x17": (33, 17, False, dict(quality=95, subsampling=1)),
    "q100_444_9x7": (9, 7, False, dict(quality=100, subsampling=0)),
    "q100_420_64x48": (64, 48, False, dict(quality=100, subsampling=2)),
    "q1_420_33x17": (33, 17, False, dict(quality=1, subsampling=2)),
    "q10_422_48x64": (48, 64, False, dict(quality=10, subsampling=1)),
    "q75_420_1x1": (1, 1, False, dict(quality=75, subsampling=2)),
    "grey_q75_17x33": (17, 33, True, dict(quality=75)),
    "grey_q100_1x1": (1, 1, True, dict(quality=100)),
    "opt_420_90x120": (90, 120, False, dict(quality=85, subsampling=2, optimize=True)),
    "rst_blocks_420_70x100": (70, 100, False, dict(quality=80, subsampling=2, restart_marker_blocks=3)),
    "rst_rows_422_60x90": (60, 90, False, dict(quality=80, subsampling=1, restart_marker_rows=1)),
    "prog_420_375x500": (375, 500, False, dict(quality=75, subsampling=2, progressive=True)),
    "prog_420_512x512": (512, 512, False, dict(quality=85, subsampling=2, progressive=True)),
    "prog_444_opt_30x40": (30, 40, False, dict(quality=95, subsampling=0, progressive=True, optimize=True)),
    "prog_grey_47x61": (47, 61, True, dict(quality=70, progressive=True)),
}


def synthetic_image(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients, hard-edged discs and a noisy patch (chip_smoke.py's
    synthetic_sources in kind): what JPEG's blocks, chroma and clamp see."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / max(w - 1, 1) * 255, yy / max(h - 1, 1) * 255,
                    (xx + yy) / max(h + w - 2, 1) * 255], -1)
    for _ in range(4):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.randint(1, max(h, w) // 3 + 2)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    ph, pw = max(h // 4, 1), max(w // 4, 1)
    img[:ph, :pw] += rng.randn(ph, pw, 3) * 40
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(img: np.ndarray, grey: bool, **opts) -> bytes:
    ImageFile.MAXBLOCK = max(ImageFile.MAXBLOCK, 1 << 24)  # PIL's buffer for progressive noise at q100
    im = Image.fromarray(img)
    im = im.convert("L") if grey else im
    buf = io.BytesIO()
    im.save(buf, "JPEG", **opts)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def as_rgb(a: np.ndarray) -> np.ndarray:
    return np.repeat(a, 3, axis=2) if a.shape[2] == 1 else a


def write_fixtures() -> None:
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for i, (name, (h, w, grey, opts)) in enumerate(FIXTURE_SPECS.items()):
        data = encode(synthetic_image(h, w, 100 + i), grey, **opts)
        (FIXTURES / f"{name}.jpg").write_bytes(data)
        write_png(FIXTURES / f"{name}.pil.png", pil_rgb(data))


@pytest.mark.parametrize("name", sorted(FIXTURE_SPECS))
def test_fixture_is_bit_equal_to_pil(name):
    """The decoder on the committed JPEG gives the committed PIL pixels, and
    PIL here still decodes the JPEG to them."""
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    want = read_png(FIXTURES / f"{name}.pil.png")
    h, w, grey, _ = FIXTURE_SPECS[name]
    assert want.shape == (h, w, 3)
    assert np.array_equal(pil_rgb(data), want)
    got = decode_jpeg(data, name)
    assert got.dtype == np.uint8 and got.shape == (h, w, 1 if grey else 3)
    assert np.array_equal(as_rgb(got), want)


def test_fixtures_stay_small():
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 3 << 20


def _seeded_case(k: int):
    rng = np.random.RandomState(1000 + k)
    h, w = (int(v) for v in rng.randint(1, 301, 2))
    grey = rng.rand() < 0.15
    opts = dict(quality=int(rng.randint(1, 101)), progressive=bool(rng.rand() < 0.5),
                optimize=bool(rng.rand() < 0.5))
    if not grey:
        opts["subsampling"] = int(rng.randint(0, 3))
    r = rng.rand()
    if r < 0.15:
        opts["restart_marker_blocks"] = int(rng.randint(1, 9))
    elif r < 0.3:
        opts["restart_marker_rows"] = int(rng.randint(1, 4))
    img = synthetic_image(h, w, k) if k % 2 else rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return img, grey, opts


@pytest.mark.parametrize("chunk", range(20))
def test_seeded_encodes_are_bit_equal_to_pil(chunk):
    """10 encodes a chunk, 200 in all: half synthetic images, half uniform
    noise (which drives the IDCT's clamp at high quality)."""
    for k in range(chunk * 10, chunk * 10 + 10):
        img, grey, opts = _seeded_case(k)
        data = encode(img, grey, **opts)
        got = as_rgb(decode_jpeg(data))
        want = pil_rgb(data)
        assert got.shape == want.shape and np.array_equal(got, want), (k, img.shape, grey, opts)


def test_read_rgb_decodes_jpeg_without_pil(tmp_path, monkeypatch):
    """With PIL blocked, read_rgb reads a JPEG (under any name) and a grey
    JPEG to RGB; a format it cannot read without PIL raises."""
    name = "prog_420_375x500"
    path = tmp_path / "1234567.jpg"
    path.write_bytes((FIXTURES / f"{name}.jpg").read_bytes())
    grey = tmp_path / "grey.png.jpg"
    grey.write_bytes((FIXTURES / "grey_q75_17x33.jpg").read_bytes())
    gif = tmp_path / "x.gif"
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(gif)
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert np.array_equal(read_rgb(path), read_png(FIXTURES / f"{name}.pil.png"))
    assert np.array_equal(read_rgb(grey), read_png(FIXTURES / "grey_q75_17x33.pil.png"))
    with pytest.raises(RuntimeError, match="PIL is not installed"):
        read_rgb(gif)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("keep", [0.99, 0.5, 0.1, 3])
def test_truncated_files_raise_as_pil_does(progressive, keep):
    """Cut at 99%, 50%, 10% of the file or after the SOI marker's 3 bytes:
    PIL raises OSError, and so does the decoder."""
    data = encode(synthetic_image(40, 56, 3), False, quality=80, progressive=progressive)
    cut = data[:keep if isinstance(keep, int) else int(len(data) * keep)]
    with pytest.raises(OSError):
        pil_rgb(cut)
    with pytest.raises(JPEGError, match="truncated"):
        decode_jpeg(cut)


def _segments(data: bytes):
    """[(marker, start, end)] of the marker segments before the first scan's data."""
    out, pos = [], 2
    while True:
        m = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((m, pos, pos + 2 + length))
        if m == 0xDA:
            return out
        pos += 2 + length


def _without(data: bytes, marker: int) -> bytes:
    """`data` less every segment of `marker` before the first scan."""
    cut = [(a, b) for m, a, b in _segments(data) if m == marker]
    assert cut, f"no marker {marker:#x}"
    for a, b in reversed(cut):
        data = data[:a] + data[b:]
    return data


def test_left_out_huffman_tables_are_the_standard_ones():
    """A baseline file without its DHT segments (as motion-JPEG frames come)
    decodes with the standard's tables in slots 0 and 1, as libjpeg
    installs them: PIL's default encode uses those tables, so the pixels
    are the full file's."""
    for k, opts in enumerate((dict(subsampling=2), dict(subsampling=0), dict(subsampling=1))):
        data = encode(synthetic_image(40, 56, 20 + k), False, quality=80, **opts)
        bare = _without(data, 0xC4)
        want = pil_rgb(bare)
        assert np.array_equal(want, pil_rgb(data))
        assert np.array_equal(decode_jpeg(bare), want)


def _corrupt_cases():
    base = encode(synthetic_image(24, 24, 5), False, quality=75)
    sos = next(a for m, a, _ in _segments(base) if m == 0xDA)
    bad_comp = bytearray(base)
    bad_comp[sos + 5] = 9  # the scan's first component id, which the frame lacks
    bad_table = bytearray(base)
    bad_table[sos + 6] = 0x22  # the first component's tables: slot 2, which no DHT defines
    return {"undefined_table": bytes(bad_table), "no_dqt": _without(base, 0xDB),
            "bad_scan_component": bytes(bad_comp), "not_a_jpeg": b"\xff\xd8" + b"\x00" * 40}


@pytest.mark.parametrize("case", ["undefined_table", "no_dqt", "bad_scan_component", "not_a_jpeg"])
def test_corrupt_files_raise_as_pil_does(case):
    data = _corrupt_cases()[case]
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(JPEGError):
        decode_jpeg(data)


def _patch_sof(data: bytes, offset: int, value: int) -> bytes:
    m, a, _ = next(s for s in _segments(data) if s[0] in (0xC0, 0xC1, 0xC2))
    out = bytearray(data)
    out[a + 4 + offset] = value
    return bytes(out)


def _refused_cases():
    base = encode(synthetic_image(24, 24, 6), False, quality=75, subsampling=2)
    sof = next(s for s in _segments(base) if s[0] == 0xC0)
    cmyk = io.BytesIO()
    Image.fromarray(synthetic_image(16, 16, 7)).convert("CMYK").save(cmyk, "JPEG")
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"  # transform 0: no colour transform
    adobe = _without(base, 0xE0)
    adobe = adobe[:2] + app14 + adobe[2:]
    return {
        "arithmetic": (base[:sof[1] + 1] + b"\xc9" + base[sof[1] + 2:], "arithmetic"),
        "lossless": (base[:sof[1] + 1] + b"\xc3" + base[sof[1] + 2:], "lossless"),
        "12-bit": (_patch_sof(base, 0, 12), "12-bit"),
        "cmyk": (cmyk.getvalue(), "4 components"),
        "adobe_rgb": (adobe, "Adobe APP14 colour transform 0"),
        "sampling_1x2": (_patch_sof(base, 7, 0x12), "sampling layout"),
    }


@pytest.mark.parametrize("case", ["arithmetic", "lossless", "12-bit", "cmyk", "adobe_rgb", "sampling_1x2"])
def test_refused_layouts_name_the_feature(case):
    data, feature = _refused_cases()[case]
    with pytest.raises(UnsupportedJPEG, match=feature) as e:
        decode_jpeg(data, "sample.jpg")
    assert "sample.jpg" in str(e.value)


def test_decode_resize_matches_jax(tmp_path):
    """The train pipeline's decode + native resize to the pre-crop size on
    JPEG files equals the JAX package's _decode_resize (PIL + its native
    resize)."""
    from saspa_tpu.data.pipeline import _decode_resize
    from saspa_tpu_torch.data.pipeline import decode_resize

    for name in ("q75_420_375x500", "prog_grey_47x61", "rst_rows_422_60x90"):
        path = str(FIXTURES / f"{name}.jpg")
        assert np.array_equal(decode_resize(path, 256, 256), _decode_resize(path, 256, 256)), name


def _recording(pipe, seen):
    """`pipe` with make_fused_generate wrapped to record each batch's sources."""
    real = pipe.make_fused_generate

    def make(*a, **kw):
        fused = real(*a, **kw)

        def run(params, ids, nids, src, latents):
            seen.append(np.asarray(src))
            return fused(params, ids, nids, src, latents)

        return run

    pipe.make_fused_generate = make
    return pipe


def test_run_generation_reads_jpeg_sources_as_jax_does(tmp_path, monkeypatch):
    """A planes stub tree of 3 JPEG sources (baseline 4:2:0, progressive,
    grey) through both drivers at 64^2, 2 DDIM steps, tiny SD1.5 + canny:
    the source arrays each batch hands the fused function are equal, and
    so are the _source and _control PNGs made from them."""
    import dataclasses

    import saspa_tpu.data.registry as JR
    import saspa_tpu_torch.data.registry as TR
    from saspa_tpu.gen.driver import run_generation as jax_run_generation
    from saspa_tpu.utils.config import GenerationConfig as JaxGenerationConfig
    from saspa_tpu_torch.gen import driver as tdriver
    from saspa_tpu_torch.utils.config import GenerationConfig
    from tests.test_generation_driver import StubPlanesUtils
    from tests.test_torch_driver import _pipes

    images = tmp_path / "ds" / "images"
    images.mkdir(parents=True)
    for i, name in enumerate(("q75_420_375x500", "prog_420_375x500", "q10_422_48x64")):
        (images / f"{2000000 + i}.jpg").write_bytes((FIXTURES / f"{name}.jpg").read_bytes())

    def stub(print_func=print):
        return StubPlanesUtils(tmp_path / "ds", print_func)

    monkeypatch.setitem(JR.DS_UTILS_DICT, "planes", stub)
    monkeypatch.setitem(TR.DS_UTILS_DICT, "planes", stub)
    cfg = GenerationConfig(dataset="planes", base_model="sd_v1.5", controlnet="canny", num_per_image=1, seed=1,
                           resolution=64, num_inference_steps=2, batch_size=4)
    jp, tp = _pipes()
    want_src, got_src = [], []
    out = jax_run_generation(JaxGenerationConfig(**dataclasses.asdict(cfg)), pipe=_recording(jp, want_src))
    want = {p.name: np.asarray(Image.open(p)) for p in Path(out).glob("*_source*.png")}
    for p in Path(out).glob("*.png"):
        p.unlink()
    assert tdriver.run_generation(cfg, pipe=_recording(tp, got_src)) == out
    assert len(got_src) == len(want_src) >= 1
    for g, w in zip(got_src, want_src):
        assert g.shape == w.shape and np.array_equal(g.astype(np.float32), w.astype(np.float32))
    got = {p.name: read_png(p) for p in Path(out).glob("*_source*.png")}
    assert sorted(got) == sorted(want) and len(got) == 3
    for n in got:
        assert np.array_equal(got[n], want[n]), n


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
    else:
        sys.exit("usage: python tests/test_torch_jpeg.py --write-fixtures")
