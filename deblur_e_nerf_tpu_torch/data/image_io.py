"""Image files without OpenCV: the readers and writers the posed views need.

`imread(path)` returns what `cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns
for the files the evaluation data holds, with OpenCV's channel order
(BGR, BGRA) and dtype:

  - uncompressed float32 TIFF, 1, 3 or 4 samples per pixel, chunky
    (compression 1, planar configuration 1, sample format 3), in strips,
    either byte order: what `cv2.imwrite` writes for a float32 image;
  - PNG, 8 or 16 bit, gray, RGB or RGBA, not interlaced, with the five row
    filters.

`imwrite(path, img)` writes a float32 TIFF (`.tif`, `.tiff`) or an 8- or
16-bit PNG (`.png`) from an OpenCV-ordered array. Any other format or variant
(compressed or tiled TIFF, integer TIFF, palette or gray-alpha PNG,
interlaced PNG, a transparency chunk, EXR, ...) raises `ValueError`: it is
never approximated.
"""

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
TIFF_MAGIC = {b"II*\x00": "<", b"MM\x00*": ">"}

# TIFF tags
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SAMPLES, _ROWS_PER_STRIP, _STRIP_BYTES = 273, 277, 278, 279
_PLANAR, _PREDICTOR, _TILE_WIDTH, _EXTRA_SAMPLES, _SAMPLE_FORMAT = (
    284, 317, 322, 338, 339)
_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}  # BYTE, SHORT, LONG

# PNG color types
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # gray, RGB, RGBA


def _to_opencv_order(img):
    """File order (RGB, RGBA) -> OpenCV order (BGR, BGRA)."""
    if img.ndim == 3 and img.shape[-1] >= 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    return img


def imread(path):
    """Read a TIFF or PNG file as `cv2.imread(path, IMREAD_UNCHANGED)`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return _read_png(data, path)
    if data[:4] in TIFF_MAGIC:
        return _read_tiff(data, path)
    raise ValueError(f"{path}: not a TIFF or PNG file (unsupported format)")


def imwrite(path, img):
    """Write `img` (OpenCV channel order) as a float32 TIFF or an 8- or
    16-bit PNG, chosen by the file extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        data = _encode_tiff(img)
    elif ext == ".png":
        data = _encode_png(img)
    else:
        raise ValueError(f"{path}: unsupported extension {ext!r} "
                         "(writers: float32 .tiff, 8- and 16-bit .png)")
    with open(path, "wb") as f:
        f.write(data)


def _channels(img, what):
    if img.ndim == 2:
        return 1
    if img.ndim == 3 and img.shape[-1] in (1, 3, 4):
        return img.shape[-1]
    raise ValueError(f"{what}: expected (H, W) or (H, W, 1/3/4), got "
                     f"{img.shape}")


# ----------------------------------------------------------------- TIFF
def _tiff_fields(data, order, path):
    """{tag: tuple of values} of the first IFD."""
    if struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path}: not a classic TIFF (BigTIFF unsupported)")
    ifd = struct.unpack(order + "I", data[4:8])[0]
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    fields = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack(
            order + "HHI4s", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        if typ not in _TIFF_TYPES:
            continue  # a tag this reader does not consult
        fmt = _TIFF_TYPES[typ]
        size = struct.calcsize(fmt) * count
        if size <= 4:
            buf = raw[:size]
        else:
            (offset,) = struct.unpack(order + "I", raw)
            buf = data[offset:offset + size]
        fields[tag] = struct.unpack(f"{order}{count}{fmt}", buf)
    return fields


def _read_tiff(data, path):
    order = TIFF_MAGIC[data[:4]]
    fields = _tiff_fields(data, order, path)

    def one(tag, default=None):
        values = fields.get(tag)
        if values is None:
            if default is None:
                raise ValueError(f"{path}: TIFF tag {tag} missing")
            return default
        if len(set(values)) != 1:
            raise ValueError(f"{path}: TIFF tag {tag} varies by sample "
                             f"({values}); unsupported")
        return values[0]

    width, height = one(_WIDTH), one(_LENGTH)
    spp = one(_SAMPLES, 1)
    photometric = one(_PHOTOMETRIC)
    checks = {
        "compressed data": one(_COMPRESSION, 1) != 1,
        "planar (separate) samples": one(_PLANAR, 1) != 1,
        "a predictor": one(_PREDICTOR, 1) != 1,
        "tiles": _TILE_WIDTH in fields,
        "samples other than 32-bit float": (one(_BITS, 1) != 32
                                            or one(_SAMPLE_FORMAT, 1) != 3),
        f"{spp} samples with photometric {photometric}": not (
            (spp == 1 and photometric == 1)
            or (spp in (3, 4) and photometric == 2)),
    }
    for what, bad in checks.items():
        if bad:
            raise ValueError(f"{path}: unsupported TIFF ({what}); the "
                             "reader takes uncompressed chunky float32")
    offsets, counts = fields[_STRIP_OFFSETS], fields[_STRIP_BYTES]
    raw = b"".join(data[o:o + c] for o, c in zip(offsets, counts))
    need = width * height * spp * 4
    if len(raw) < need:
        raise ValueError(f"{path}: truncated TIFF strips ({len(raw)} of "
                         f"{need} bytes)")
    img = np.frombuffer(raw[:need], dtype=order + "f4").astype(np.float32)
    img = img.reshape(height, width, spp)
    if spp == 1:
        return img[..., 0]
    return _to_opencv_order(img)


def _encode_tiff(img):
    img = np.asarray(img)
    if img.dtype != np.float32:
        raise ValueError(f"the TIFF writer takes float32, got {img.dtype}")
    spp = _channels(img, "TIFF writer")
    height, width = img.shape[:2]
    pixels = img.reshape(height, width, spp)
    if spp > 1:  # OpenCV order -> file order (RGB, RGBA)
        pixels = np.concatenate([pixels[..., 2::-1], pixels[..., 3:]],
                                axis=-1)
    body = np.ascontiguousarray(pixels, dtype="<f4").tobytes()
    # layout: header, pixel data (one strip), per-sample arrays, IFD
    extra = b""
    per_sample = {}
    for tag, value in ((_BITS, 32), (_SAMPLE_FORMAT, 3)):
        if spp <= 2:
            per_sample[tag] = None
            continue
        per_sample[tag] = 8 + len(body) + len(extra)
        extra += struct.pack(f"<{spp}H", *([value] * spp))
    entries = [
        (_WIDTH, 4, 1, width), (_LENGTH, 4, 1, height),
        (_BITS, 3, spp, per_sample[_BITS] or 32),
        (_COMPRESSION, 3, 1, 1),
        (_PHOTOMETRIC, 3, 1, 1 if spp == 1 else 2),
        (_STRIP_OFFSETS, 4, 1, 8), (_SAMPLES, 3, 1, spp),
        (_ROWS_PER_STRIP, 4, 1, height), (_STRIP_BYTES, 4, 1, len(body)),
        (_PLANAR, 3, 1, 1),
    ]
    if spp == 4:
        entries.append((_EXTRA_SAMPLES, 3, 1, 2))  # unassociated alpha
    entries.append((_SAMPLE_FORMAT, 3, spp, per_sample[_SAMPLE_FORMAT] or 3))
    ifd = struct.pack("<H", len(entries))
    for tag, typ, count, value in entries:
        inline = typ == 3 and count == 1
        ifd += struct.pack("<HHI", tag, typ, count)
        ifd += struct.pack("<HH", value, 0) if inline else struct.pack(
            "<I", value)
    ifd += struct.pack("<I", 0)
    ifd_offset = 8 + len(body) + len(extra)
    return b"II*\x00" + struct.pack("<I", ifd_offset) + body + extra + ifd


# ------------------------------------------------------------------ PNG
def _png_chunks(data, path):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND (truncated)")


def _unfilter(raw, height, stride, bpp, path):
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth)."""
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum of each byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:  # Average
                    pred = (a + b) >> 1
                else:  # Paeth
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row filter {kind} unknown")
        out[y] = cur
        prior = out[y]
    return out


def _read_png(data, path):
    header, idat = None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"PLTE", b"tRNS"):
            raise ValueError(f"{path}: unsupported PNG ({kind.decode()} "
                             "chunk: palette or transparency key)")
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, compression, filt, interlace = header
    if (color not in _PNG_CHANNELS or depth not in (8, 16) or compression
            or filt or interlace):
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); the reader takes 8/16-bit "
            "gray, RGB or RGBA, not interlaced")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width * bpp + 1):
        raise ValueError(f"{path}: PNG image data of {len(raw)} bytes, "
                         f"expected {height * (width * bpp + 1)}")
    rows = _unfilter(raw, height, width * bpp, bpp, path)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    img = img.reshape(height, width, channels)
    if channels == 1:
        return img[..., 0]
    return _to_opencv_order(img)


def _encode_png(img):
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"the PNG writer takes uint8 or uint16, got "
                         f"{img.dtype}")
    depth = 8 * img.dtype.itemsize
    channels = _channels(img, "PNG writer")
    height, width = img.shape[:2]
    pixels = img.reshape(height, width, channels)
    if channels > 1:
        pixels = np.concatenate([pixels[..., 2::-1], pixels[..., 3:]],
                                axis=-1)
    color = {1: 0, 3: 2, 4: 6}[channels]
    rows = np.ascontiguousarray(pixels.astype(f">u{depth // 8}")).view(
        np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
