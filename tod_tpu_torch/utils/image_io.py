"""Image files without PIL (counterpart of the JAX package's
``utils/image_io.py``, which goes through PIL; the card's machine has none).

- ``load_image``: a PNG or BMP file to (H, W, 3) uint8, by the rules of
  PIL's ``Image.open(path).convert("RGB")``.
  - PNG (stdlib ``zlib`` and numpy): every bit depth and colour type the
    format allows, plain or Adam7-interlaced, with all five row filters.
    Alpha is dropped, grey replicated, palette indices looked up; grey
    below 8 bits is scaled to 0-255 (x255, x85, x17 at 1, 2, 4 bits); a
    16-bit sample keeps its high byte, except 16-bit grey, which PIL opens
    as "I;16" and clips to 255.
  - BMP (``struct`` and numpy): uncompressed 1-, 4-, 8-, 16-, 24- and
    32-bit files, bottom-up or top-down rows, palettes (BGRX, or BGR under
    the 12-byte OS/2 header) and the ``BI_BITFIELDS`` masks PIL reads.
  Anything else (RLE-compressed BMP, JPEG, GIF, ...) raises ``ValueError``
  naming it.
- ``save_rgb``: an RGB PNG.
- ``save_gray_bmp`` / ``dump_scene_debug``: the reference's debug dumps,
  byte for byte the files PIL writes for an 8-bit "L" image: a 256-entry
  grey palette and bottom-up rows padded to 4 bytes.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples a pixel by colour type


def _chunks(data: bytes):
    """Yield (type, payload) of each chunk, CRCs checked, up to IEND."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        payload = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + payload) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"bad CRC in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> (rows, row_bytes) uint8."""
    out = np.zeros((rows, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.uint8)
    stride = row_bytes + 1
    if len(raw) < rows * stride:
        raise ValueError("PNG image data is shorter than its header says")
    for y in range(rows):
        ftype = raw[y * stride]
        line = np.frombuffer(raw, np.uint8, row_bytes, y * stride + 1)
        if ftype == 0:  # None
            rec = line.copy()
        elif ftype == 1:  # Sub: a running sum along the row, per byte of a pixel
            v = line.reshape(-1, bpp)
            rec = (np.cumsum(v, axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            rec = line + prior
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = rec
        prior = out[y]
    return out


def _samples(rows: np.ndarray, width: int, bits: int, channels: int) -> np.ndarray:
    """Unfiltered rows -> (rows, width, channels) samples: uint16 at 16
    bits (big-endian in the file), else uint8."""
    n = rows.shape[0]
    if bits == 16:
        pairs = rows[:, : width * channels * 2].reshape(n, width, channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    if bits == 8:
        return rows[:, : width * channels].reshape(n, width, channels)
    # sub-byte samples (grey or palette indices), the most significant bits first
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(n, -1)[:, :width, None].astype(np.uint8)


# the bit depths the PNG format allows for each colour type
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _to_8bit(img: np.ndarray, bits: int, ctype: int) -> np.ndarray:
    """Samples -> 0-255 as PIL's modes for the depth map them: grey below 8
    bits scaled up, 16-bit grey ("I;16") clipped, other 16-bit samples
    their high byte."""
    if bits == 16:
        return np.minimum(img, 255).astype(np.uint8) if ctype == 0 else (img >> 8).astype(np.uint8)
    if ctype == 0 and bits < 8:
        return img * np.uint8(255 // ((1 << bits) - 1))
    return img


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as PIL's ``convert("RGB")``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, bits, ctype, compression, filter_method, interlace = header
    if bits not in PNG_DEPTHS.get(ctype, ()) or compression or filter_method or interlace > 1:
        raise ValueError(f"unsupported PNG: bit depth {bits}, colour type {ctype}, compression "
                         f"{compression}, filter {filter_method}, interlace {interlace}")
    channels = CHANNELS[ctype]
    bpp = max(1, bits * channels // 8)
    raw = zlib.decompress(b"".join(idat))
    img = np.zeros((height, width, channels), np.uint16 if bits == 16 else np.uint8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        row_bytes = (pw * bits * channels + 7) // 8
        rows = _unfilter(raw[pos:], ph, row_bytes, bpp)
        pos += ph * (row_bytes + 1)
        img[y0::dy, x0::dx] = _samples(rows, pw, bits, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette[:256]
        return table[img[..., 0]]
    img = _to_8bit(img, bits, ctype)
    if ctype in (0, 4):  # grey (+ alpha): replicate the grey
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


# BI_BITFIELDS masks that PIL reads -> the bit offset and width of R, G, B
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): ((16, 8), (8, 8), (0, 8)),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): ((24, 8), (16, 8), (8, 8)),
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): ((24, 8), (8, 8), (0, 8)),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): ((24, 8), (16, 8), (8, 8)),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): ((0, 8), (8, 8), (16, 8)),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): ((16, 8), (8, 8), (0, 8)),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): ((24, 8), (8, 8), (0, 8)),
    (32, (0x0, 0x0, 0x0, 0x0)): ((16, 8), (8, 8), (0, 8)),
    (24, (0xFF0000, 0xFF00, 0xFF)): ((16, 8), (8, 8), (0, 8)),
    (16, (0xF800, 0x7E0, 0x1F)): ((11, 5), (5, 6), (0, 5)),
    (16, (0x7C00, 0x3E0, 0x1F)): ((10, 5), (5, 5), (0, 5)),
}
_BMP_COMPRESSIONS = {1: "RLE8", 2: "RLE4", 4: "JPEG", 5: "PNG"}


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8, as PIL's ``convert("RGB")``."""
    if not data.startswith(b"BM") or len(data) < 18:
        raise ValueError("not a BMP file")
    offset, header_size = struct.unpack_from("<II", data, 10)
    if header_size == 12:  # OS/2 1.x: u16 sizes, BGR palette, always bottom-up
        width, height, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression, colors, entry, top_down = 0, 0, 3, False
    elif header_size in (40, 52, 56, 64, 108, 124):
        width, height, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
        colors = struct.unpack_from("<I", data, 46)[0]
        entry, top_down = 4, height < 0
        height = abs(height)
    else:
        raise ValueError(f"unsupported BMP header size {header_size}")
    if compression in _BMP_COMPRESSIONS:
        raise ValueError(f"unsupported BMP compression {_BMP_COMPRESSIONS[compression]}")
    if compression not in (0, 3) or bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"unsupported BMP: bit depth {bits}, compression {compression}")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors  # an offset that points at the palette
    if compression == 3:
        # after a 40-byte header or inside a longer one, at the same place;
        # an alpha mask from the 56-byte header on
        n_masks = 4 if header_size >= 56 else 3
        masks = struct.unpack_from(f"<{n_masks}I", data, 14 + 40) + (0,) * (4 - n_masks)
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_MASKS:
            raise ValueError(f"unsupported BMP bitfields layout {bits} bits, masks "
                             f"{[hex(m) for m in masks]}")
        fields = _BMP_MASKS[key]
    else:
        fields = {16: ((10, 5), (5, 5), (0, 5)), 24: ((16, 8), (8, 8), (0, 8)),
                  32: ((16, 8), (8, 8), (0, 8))}.get(bits)
    stride = ((width * bits + 31) >> 3) & ~3
    raw = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not top_down:
        raw = raw[::-1]
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size {colors}")
        pal = np.frombuffer(data, np.uint8, entry * colors, 14 + header_size)
        pal = pal.reshape(colors, entry)
        table = np.zeros((256, 3), np.uint8)
        table[: min(colors, 256)] = pal[:256, 2::-1]  # BGR(X) -> RGB
        return table[_samples(raw, width, bits, 1)[..., 0]]
    nbytes = bits // 8
    px = raw[:, : width * nbytes].reshape(height, width, nbytes).astype(np.uint32)
    pixel = sum(px[..., i] << (8 * i) for i in range(nbytes))  # little-endian
    out = np.empty((height, width, 3), np.uint8)
    for c, (shift, size) in enumerate(fields):
        v = (pixel >> shift) & ((1 << size) - 1)
        out[..., c] = v if size == 8 else v * 255 // ((1 << size) - 1)
    return out


def load_image(path) -> np.ndarray:
    """PNG or BMP file -> (H, W, 3) uint8; another format raises
    ``ValueError`` naming it."""
    data = pathlib.Path(path).read_bytes()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(b"BM"):
        return decode_bmp(data)
    for magic, name in ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"II*\x00", "TIFF"),
                        (b"MM\x00*", "TIFF"), (b"RIFF", "WebP")):
        if data.startswith(magic):
            raise ValueError(f"unsupported image format {name} in {path} (PNG and BMP are read)")
    raise ValueError(f"unknown image format in {path} (PNG and BMP are read)")


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def save_rgb(path, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an RGB PNG file (no row filters, zlib level 6)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    pathlib.Path(path).write_bytes(
        PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_gray_bmp(path, values: np.ndarray) -> None:
    """Float/int map -> 8-bit greyscale BMP, the reference's debug dump
    format (a truncating cast to u8), the bytes PIL writes for mode "L"."""
    arr = (np.asarray(values).astype(np.int64) & 0xFF).astype(np.uint8)
    h, w = arr.shape
    stride = (w + 3) & ~3
    ppm = int(96 * 39.3701 + 0.5)  # PIL's default 96 dpi in pixels a metre
    offset = 14 + 40 + 256 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = arr[::-1]  # bottom-up
    header = (b"BM" + struct.pack("<IIII", offset + stride * h, 0, offset, 40)
              + struct.pack("<iiHHIIiiII", w, h, 1, 8, 0, stride * h, ppm, ppm, 256, 256))
    grey = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    grey[:, 3] = 0
    pathlib.Path(path).write_bytes(header + grey.tobytes() + rows.tobytes())


def dump_scene_debug(scene, out_dir=".", depth=None) -> list[str]:
    """Write map.bmp, connections0.bmp and connections1.bmp (and depth.bmp,
    the depth / 17, when a depth frame is given): the reference's debug
    block.  Returns the paths."""
    out = pathlib.Path(out_dir)

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    height, conns = host(scene.height), host(scene.connections)
    paths = []
    if depth is not None:
        save_gray_bmp(out / "depth.bmp", host(depth) // 17)
        paths.append(str(out / "depth.bmp"))
    save_gray_bmp(out / "map.bmp", height)
    paths.append(str(out / "map.bmp"))
    save_gray_bmp(out / "connections0.bmp", np.nan_to_num(conns[..., 0]))
    paths.append(str(out / "connections0.bmp"))
    save_gray_bmp(out / "connections1.bmp", np.nan_to_num(conns[..., 4]))
    paths.append(str(out / "connections1.bmp"))
    return paths
