"""In-repo PNG reader/writer against Pillow-written files and every row
filter, and the encoder's image loader on top of it."""

import io
import zlib

import numpy as np
import pytest

from uvol_tpu.io.png import PNG_SIGNATURE, _chunk, decode_png, encode_png

PIL = pytest.importorskip("PIL.Image")

MODES = {"L": None, "RGB": 3, "RGBA": 4}


def _image(mode, seed=0, h=23, w=37):
    r = np.random.default_rng(seed)
    shape = (h, w) if MODES[mode] is None else (h, w, MODES[mode])
    # smooth ramps plus noise, so Pillow's adaptive filtering picks a mix
    ramp = (np.arange(w)[None, :] * 5 + np.arange(h)[:, None] * 3) % 256
    img = ramp.reshape(h, w, *([1] * (len(shape) - 2))) + r.integers(0, 20, shape)
    return (img % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reads_pillow_written_png(mode):
    img = _image(mode)
    buf = io.BytesIO()
    PIL.fromarray(img, mode).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)


def _filtered_png(img, kind):
    """PNG whose every row uses filter `kind` (spec section 9)."""
    h, w, bpp = img.shape
    raw = img.reshape(h, w * bpp).astype(np.int64)
    rows = []
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        b = prior
        if kind == 0:
            pred = np.zeros_like(x)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        rows.append(np.concatenate([[kind], (x - pred) % 256]))
        prior = x
    body = np.stack(rows).astype(np.uint8).tobytes()
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, 2 if bpp == 3 else 6, 0, 0, 0])
    return (
        PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")
    )


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_every_row_filter(kind):
    img = _image("RGB", seed=kind)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, kind)), img)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_writer_roundtrips_and_pillow_reads_it(mode):
    img = _image(mode, seed=9)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    np.testing.assert_array_equal(np.asarray(PIL.open(io.BytesIO(data))), img)


def test_unsupported_png_raises():
    img = np.zeros((4, 4, 3), np.uint16)
    buf = io.BytesIO()
    PIL.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(buf, "PNG")
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img)


def test_encoder_load_image_gives_rgb(tmp_path):
    from uvol_tpu.encoder_cli import load_image
    from uvol_tpu.io.png import write_png

    gray = _image("L")
    write_png(str(tmp_path / "g.png"), gray)
    got = load_image(str(tmp_path / "g.png"))
    assert got.shape == gray.shape + (3,)
    np.testing.assert_array_equal(got[..., 1], gray)
    rgba = _image("RGBA")
    write_png(str(tmp_path / "a.png"), rgba)
    np.testing.assert_array_equal(load_image(str(tmp_path / "a.png")), rgba[..., :3])
