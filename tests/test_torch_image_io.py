"""The port's OpenCV-free image I/O against OpenCV: `image_io.imread` bit
for bit equal to `cv2.imread(..., IMREAD_UNCHANGED)` (values, dtype,
shape, channel order) on the files OpenCV writes, OpenCV reading the
port's writers' files back bit for bit, each PNG row filter, and a clear
error for every unsupported file."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from deblur_e_nerf_tpu.data import synthetic as jsynthetic
from deblur_e_nerf_tpu_torch.data import image_io


def _same(a, b):
    """Bit-for-bit equality, dtype and shape included."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _cv2_read(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_float32_tiff_matches_cv2_both_ways(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.normal(size=shape).astype(np.float32)
    img.flat[:4] = [0.0, -0.0, np.inf, 1e-40]  # zeros, inf, a subnormal
    cv2.imwrite(str(tmp_path / "cv2.tiff"), img)
    _same(image_io.imread(str(tmp_path / "cv2.tiff")),
          _cv2_read(tmp_path / "cv2.tiff"))
    image_io.imwrite(str(tmp_path / "port.tiff"), img)
    _same(_cv2_read(tmp_path / "port.tiff"), img)
    _same(image_io.imread(str(tmp_path / "port.tiff")), img)


def test_big_endian_tiff_reads_as_cv2(tmp_path):
    """The same image with every field big-endian ("MM" order)."""
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    le = bytearray(image_io._encode_tiff(img))
    fields = image_io._tiff_fields(bytes(le), "<", "le")
    ifd = struct.unpack("<I", le[4:8])[0]
    be = bytearray(le)
    be[:8] = b"MM\x00*" + struct.pack(">I", ifd)
    n = struct.unpack("<H", le[ifd:ifd + 2])[0]
    be[ifd:ifd + 2] = struct.pack(">H", n)
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack("<HHI", le[at:at + 8])
        values = fields[tag]
        be[at:at + 8] = struct.pack(">HHI", tag, typ, count)
        fmt = image_io._TIFF_TYPES[typ]
        packed = struct.pack(f">{count}{fmt}", *values)
        if len(packed) <= 4:
            be[at + 8:at + 12] = packed.ljust(4, b"\x00")
        else:
            (offset,) = struct.unpack("<I", le[at + 8:at + 12])
            be[at + 8:at + 12] = struct.pack(">I", offset)
            be[offset:offset + len(packed)] = packed
    body = 8 + img.nbytes
    be[8:body] = np.frombuffer(bytes(le[8:body]), "<f4").astype(">f4") \
        .tobytes()
    (tmp_path / "be.tiff").write_bytes(bytes(be))
    _same(image_io.imread(str(tmp_path / "be.tiff")),
          _cv2_read(tmp_path / "be.tiff"))
    _same(image_io.imread(str(tmp_path / "be.tiff")), img)


def test_synthetic_generator_views_match_cv2(tmp_path):
    """The JAX generator's views (cv2-written float TIFFs) read as cv2."""
    jsynthetic.make_dataset(str(tmp_path), img_height=12, img_width=16,
                            num_events=500, num_poses=9, num_views=2,
                            simulate_events=False)
    views = sorted((tmp_path / "views").glob("*.tiff"))
    assert len(views) == 6
    for path in views:
        _same(image_io.imread(str(path)), _cv2_read(path))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_matches_cv2(tmp_path, dtype, channels):
    rng = np.random.default_rng(int(channels) + 10 * np.dtype(dtype).itemsize)
    shape = (29, 41) if channels == 1 else (29, 41, channels)
    noise = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    ys, xs = np.mgrid[0:29, 0:41]
    ramp = ((3 * xs + 7 * ys) % 251).astype(dtype)  # libpng picks filters
    if channels > 1:
        ramp = np.stack([ramp + c for c in range(channels)], axis=-1)
    for name, img in (("noise", noise), ("ramp", ramp)):
        path = tmp_path / f"{name}.png"
        cv2.imwrite(str(path), img)
        _same(image_io.imread(str(path)), _cv2_read(path))
        _same(image_io.imread(str(path)), img)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png_with_filters(img, filters, color=None, extra=()):
    """An 8-bit PNG of `img` (file order, (H, W, C)) whose row y uses
    filter filters[y % len(filters)]; `color` overrides the color type in
    the header, `extra` adds (kind, body) chunks before the data."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    raw = b""
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            pa, pb = np.abs(prior - upleft), np.abs(left - upleft)
            pc = np.abs(left + prior - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8) \
            .tobytes()
        prior = cur
    color = {1: 0, 3: 2, 4: 6}[c] if color is None else color
    return (image_io.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                          0))
            + b"".join(_chunk(k, b) for k, b in extra)
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_each_png_row_filter_matches_cv2(tmp_path, kind):
    img = np.random.default_rng(kind).integers(0, 256, (9, 11, 3),
                                               dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, [kind, 0, kind, 2]))
    got = image_io.imread(str(path))
    _same(got, _cv2_read(path))
    _same(got, img[..., ::-1])  # BGR


def test_png_writer_reads_back_in_cv2(tmp_path):
    """8- and 16-bit PNGs of 1, 3 and 4 channels, as cv2 and the reader
    read them."""
    rng = np.random.default_rng(5)
    for shape, dtype in [(s, d) for d in (np.uint8, np.uint16)
                         for s in ((13, 17), (13, 17, 1), (13, 17, 3),
                                   (13, 17, 4))]:
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
        image_io.imwrite(str(tmp_path / "w.png"), img)
        want = img[..., 0] if shape[-1] == 1 else img
        _same(_cv2_read(tmp_path / "w.png"), want)
        _same(image_io.imread(str(tmp_path / "w.png")), want)


def test_unsupported_files_raise(tmp_path):
    img = np.random.default_rng(6).random((6, 8)).astype(np.float32)
    cases = {}
    cv2.imwrite(str(tmp_path / "lzw.tiff"), img,
                [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    cases["lzw.tiff"] = "compressed"
    cv2.imwrite(str(tmp_path / "u8.tiff"), (img * 255).astype(np.uint8),
                [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    cases["u8.tiff"] = "32-bit float"
    cv2.imwrite(str(tmp_path / "img.jpg"), (img * 255).astype(np.uint8))
    cases["img.jpg"] = "not a TIFF or PNG"
    two = np.zeros((2, 2, 1), np.uint8)
    (tmp_path / "ga.png").write_bytes(_png_with_filters(
        np.zeros((2, 2, 2), np.uint8), [0], color=4))
    cases["ga.png"] = "color type 4"
    (tmp_path / "pal.png").write_bytes(_png_with_filters(
        two, [0], color=3, extra=[(b"PLTE", bytes(6))]))
    cases["pal.png"] = "PLTE"
    (tmp_path / "trns.png").write_bytes(_png_with_filters(
        two, [0], extra=[(b"tRNS", bytes(2))]))
    cases["trns.png"] = "tRNS"
    bad_crc = bytearray(_png_with_filters(two, [0]))
    bad_crc[29] ^= 1  # in IHDR's CRC
    (tmp_path / "crc.png").write_bytes(bytes(bad_crc))
    cases["crc.png"] = "CRC"
    for name, match in cases.items():
        with pytest.raises(ValueError, match=match):
            image_io.imread(str(tmp_path / name))
    with pytest.raises(ValueError, match="float32"):
        image_io.imwrite(str(tmp_path / "x.tiff"), img.astype(np.float64))
    with pytest.raises(ValueError, match="uint8"):
        image_io.imwrite(str(tmp_path / "x.png"), img)
    with pytest.raises(ValueError, match="extension"):
        image_io.imwrite(str(tmp_path / "x.exr"), img)
