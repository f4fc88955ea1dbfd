"""Image files without PIL (counterpart of the JAX package's
``utils/image_io.py``, which goes through PIL; the card's machine has none).

- ``load_image``: a PNG decoder (stdlib ``zlib`` and numpy) to (H, W, 3)
  uint8, by the rules of PIL's ``Image.open(path).convert("RGB")``: alpha
  dropped, grey replicated, palette indices looked up.  It reads 8-bit grey,
  RGB, grey+alpha and RGBA, and palette images at 1, 2, 4 and 8 bits, plain
  or Adam7-interlaced, with all five row filters.  Other PNGs (16 bits a
  sample, or grey below 8 bits) and other formats raise ``ValueError``.
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
    """Unfiltered rows -> (rows, width, channels) uint8 samples."""
    n = rows.shape[0]
    if bits == 8:
        return rows[:, : width * channels].reshape(n, width, channels)
    # sub-byte palette indices, the most significant bits first
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(n, -1)[:, :width, None].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as PIL's ``convert("RGB")``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file (only PNG is read)")
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
    supported = (bits == 8 and ctype in CHANNELS) or (ctype == 3 and bits in (1, 2, 4))
    if not supported or compression or filter_method or interlace not in (0, 1):
        raise ValueError(f"unsupported PNG: bit depth {bits}, colour type {ctype} "
                         f"(8-bit grey, RGB, grey+alpha, RGBA and 1-8 bit palette are read)")
    channels = CHANNELS[ctype]
    bpp = max(1, bits * channels // 8)
    raw = zlib.decompress(b"".join(idat))
    img = np.zeros((height, width, channels), np.uint8)
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
    if ctype in (0, 4):  # grey (+ alpha): replicate the grey
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_image(path) -> np.ndarray:
    """PNG file -> (H, W, 3) uint8."""
    return decode_png(pathlib.Path(path).read_bytes())


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
