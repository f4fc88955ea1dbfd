"""The port's image files and frame sources against PIL and the JAX
package: the PNG decoder (every colour type and bit depth, every row
filter, Adam7), the BMP decoder (every bit depth PIL reads uncompressed,
both row orders, palettes and bitfields), the PNG writer, Pillow's default resize byte for byte,
the debug BMPs byte for byte, ``PNGSource``, the native ``RingSource`` and
``--checkpoint``'s npz loader."""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from tod_tpu.utils.image_io import load_image as jax_load_image
from tod_tpu_torch.utils.image_io import (decode_bmp, decode_png, load_image, save_gray_bmp,
                                           save_rgb)
from tod_tpu_torch.utils.resample import resize_bicubic

# six xdist workers share the cores: one intra-op thread a worker
torch.set_num_threads(1)


def pil_png(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """Gradients with noise: PIL's writer picks several row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3) % 256, (yy * 5) % 256, (xx + yy) % 256, (xx * yy) % 256], -1)
    img = img.astype(np.uint8)
    noise = rng.random((h, w)) < 0.1
    img[noise] = rng.integers(0, 256, (noise.sum(), 4))
    return img


def pil_images(seed: int = 0):
    img = scene(37, 53, seed)
    yield "RGB", Image.fromarray(img[..., :3]), {}
    yield "RGBA", Image.fromarray(img), {}
    yield "L", Image.fromarray(img[..., 0]), {}
    yield "LA", Image.fromarray(img).convert("LA"), {}
    for colours, bits in ((256, 8), (16, 4), (4, 2), (2, 1)):
        yield f"P {bits}-bit", Image.fromarray(img[..., :3]).quantize(colours), {"bits": bits}


# the test's own writer: any colour type, bit depth, row filter and Adam7
def _pred(ftype: int, a: int, b: int, c: int) -> int:
    if ftype == 1:
        return a
    if ftype == 2:
        return b
    if ftype == 3:
        return (a + b) >> 1
    if ftype == 4:
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if pa <= pb and pa <= pc else (b if pb <= pc else c)
    return 0


def _filtered(rows: list[bytes], bpp: int, filters) -> bytes:
    out, prior = bytearray(), bytes(len(rows[0]) if rows else 0)
    for y, row in enumerate(rows):
        ftype = filters[y % len(filters)]
        out.append(ftype)
        for i, v in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            c = prior[i - bpp] if i >= bpp else 0
            out.append((v - _pred(ftype, a, prior[i], c)) & 0xFF)
        prior = row
    return bytes(out)


def _pack_rows(samples: np.ndarray, bits: int) -> list[bytes]:
    """(h, w, channels) samples -> packed scanlines."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if bits == 8:
        return [flat[y].tobytes() for y in range(h)]
    per = 8 // bits
    rows = []
    for y in range(h):
        v = list(flat[y]) + [0] * (-len(flat[y]) % per)
        rows.append(bytes(sum(int(v[i + j]) << (8 - bits * (j + 1)) for j in range(per))
                          for i in range(0, len(v), per)))
    return rows


def encode_test_png(samples: np.ndarray, ctype: int, bits: int = 8, interlace: bool = False,
                    filters=(0, 1, 2, 3, 4), palette: np.ndarray | None = None,
                    header_bits: int | None = None) -> bytes:
    """``header_bits`` (default ``bits``) is the depth the header states."""
    h, w, ch = samples.shape
    bpp = max(1, bits * ch // 8)
    passes = (((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),))
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_pack_rows(sub, bits), bpp, filters)

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, header_bits or bits,
                                                              ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    half = len(raw) // 2  # two IDAT chunks
    z = zlib.compress(raw)
    return out + chunk(b"IDAT", z[:half]) + chunk(b"IDAT", z[half:]) + chunk(b"IEND", b"")


class TestPngDecode:
    @pytest.mark.parametrize("name,im,kw", list(pil_images()), ids=lambda x: x if isinstance(x, str) else "")
    def test_pil_written_files(self, name, im, kw):
        data = pil_png(im, **kw)
        np.testing.assert_array_equal(decode_png(data), pil_rgb(data))

    @pytest.mark.parametrize("interlace", [False, True])
    @pytest.mark.parametrize("ctype,bits", [(0, 8), (2, 8), (3, 8), (3, 4), (3, 2), (3, 1),
                                            (4, 8), (6, 8), (0, 1), (0, 2), (0, 4), (0, 16),
                                            (2, 16), (4, 16), (6, 16)])
    def test_every_filter_and_adam7(self, ctype, bits, interlace):
        """Every depth against PIL: sub-8-bit grey scaled, 16-bit samples
        to their high byte, 16-bit grey ("I;16") clipped to 255."""
        rng = np.random.default_rng(ctype * 10 + bits)
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        h, w = 19, 23  # odd sizes: empty and partial Adam7 passes, padded sub-byte rows
        palette = None
        if ctype == 3:
            samples = rng.integers(0, 1 << bits, (h, w, 1)).astype(np.uint8)
            palette = rng.integers(0, 256, (1 << bits, 3))
        elif bits == 16:
            wide = rng.integers(0, 65536, (h, w, ch)).astype(np.uint16)
            wide[: h // 2] %= 512  # grey values around the clip at 255
            samples = wide.astype(">u2").view(np.uint8).reshape(h, w, 2 * ch)
        elif bits < 8:
            samples = rng.integers(0, 1 << bits, (h, w, 1)).astype(np.uint8)
        else:
            samples = scene(h, w, ctype)[..., :ch].copy()
        data = encode_test_png(samples, ctype, min(bits, 8), interlace, palette=palette,
                               header_bits=bits)
        got = decode_png(data)
        np.testing.assert_array_equal(got, pil_rgb(data))
        assert got.shape == (h, w, 3) and got.dtype == np.uint8

    @pytest.mark.parametrize("ctype,bits", [(2, 4), (3, 16), (6, 1), (4, 2), (0, 3), (5, 8)])
    def test_other_pngs_raise_naming_depth_and_type(self, ctype, bits):
        """Depths the PNG format does not allow for the colour type (PIL
        refuses them too)."""
        data = encode_test_png(np.zeros((4, 5, 1), np.uint8), ctype, 8, filters=(0,),
                               header_bits=bits)
        with pytest.raises(Exception):
            pil_rgb(data)
        with pytest.raises(ValueError, match=f"bit depth {bits}, colour type {ctype}"):
            decode_png(data)

    def test_not_a_png_raises(self, tmp_path):
        """``decode_png`` refuses a BMP; ``load_image`` refuses a JPEG by name."""
        p = tmp_path / "x.bmp"
        save_gray_bmp(p, np.zeros((2, 2)))
        with pytest.raises(ValueError, match="not a PNG"):
            decode_png(p.read_bytes())
        Image.fromarray(scene(8, 8, 0)[..., :3]).save(tmp_path / "x.jpg")
        with pytest.raises(ValueError, match="JPEG"):
            load_image(tmp_path / "x.jpg")

    def test_16_bit_and_low_bit_grey_files_equal_jax(self, tmp_path):
        """Files PIL writes at 16 bits ("I;16" grey) and 1 bit, through both
        packages' ``load_image``."""
        wide = np.random.default_rng(5).integers(0, 600, (21, 17)).astype(np.uint16)
        Image.fromarray(wide).save(tmp_path / "g16.png")
        Image.fromarray(scene(21, 17, 5)[..., 0] > 128).save(tmp_path / "g1.png")
        for name in ("g16.png", "g1.png"):
            got = load_image(tmp_path / name)
            np.testing.assert_array_equal(got, jax_load_image(tmp_path / name))
        assert got.max() == 255 and set(np.unique(got)) <= {0, 255}

    def test_save_rgb_round_trips(self, tmp_path):
        img = scene(31, 45, 7)[..., :3]
        save_rgb(tmp_path / "a.png", img)
        np.testing.assert_array_equal(load_image(tmp_path / "a.png"), img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)


# --- BMP ---------------------------------------------------------------------

def encode_test_bmp(pixels: np.ndarray, bits: int, palette: np.ndarray | None = None,
                    top_down: bool = False, header_size: int = 40,
                    masks: tuple | None = None) -> bytes:
    """A BMP of ``pixels`` (palette indices (h, w) at 1-8 bits, else the
    packed little-endian pixel values (h, w) at 16/24/32 bits), its rows
    padded to 4 bytes; ``masks`` writes ``BI_BITFIELDS``; ``header_size``
    12 the OS/2 header (BGR palette entries)."""
    h, w = pixels.shape
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for y in range(h):
        row = pixels[y]
        if bits <= 8:
            per = 8 // bits
            v = list(row) + [0] * (-len(row) % per)
            line = bytes(sum(int(v[i + j]) << (8 - bits * (j + 1)) for j in range(per))
                         for i in range(0, len(v), per))
        else:
            line = b"".join(int(p).to_bytes(bits // 8, "little") for p in row)
        rows.append(line + b"\0" * (stride - len(line)))
    if not top_down:
        rows = rows[::-1]
    body = b"".join(rows)
    entry = 3 if header_size == 12 else 4
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r] + [0] * (entry - 3)) for r, g, b in palette)
    if header_size == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header_size, w, -h if top_down else h, 1, bits,
                           3 if masks else 0, len(body), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        extra = b""
        if masks:
            extra = struct.pack(f"<{len(masks)}I", *masks)
        info = info + extra
        if header_size > 40:
            info = info + b"\0" * (header_size - len(info))
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal
            + body)


def _pack(rgb: np.ndarray, fields) -> np.ndarray:
    """(h, w, 3) channel values -> pixel values by (shift, width) a channel."""
    out = np.zeros(rgb.shape[:2], np.uint64)
    for c, (shift, _) in enumerate(fields):
        out |= rgb[..., c].astype(np.uint64) << np.uint64(shift)
    return out


BMP_CASES = [
    # (name, bits, header_size, masks, fields of R, G, B in the pixel)
    ("24-bit", 24, 40, None, ((16, 8), (8, 8), (0, 8))),
    ("32-bit BGRX", 32, 40, None, ((16, 8), (8, 8), (0, 8))),
    ("16-bit 555", 16, 40, None, ((10, 5), (5, 5), (0, 5))),
    ("16-bit 565 bitfields", 16, 40, (0xF800, 0x7E0, 0x1F), ((11, 5), (5, 6), (0, 5))),
    ("16-bit 555 bitfields v4", 16, 108, (0x7C00, 0x3E0, 0x1F, 0), ((10, 5), (5, 5), (0, 5))),
    ("32-bit RGBA bitfields v5", 32, 124, (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
     ((0, 8), (8, 8), (16, 8))),
    ("32-bit XBGR bitfields v3", 32, 56, (0xFF000000, 0xFF0000, 0xFF00, 0),
     ((24, 8), (16, 8), (8, 8))),
    ("24-bit bitfields", 24, 40, (0xFF0000, 0xFF00, 0xFF), ((16, 8), (8, 8), (0, 8))),
]


class TestBmpDecode:
    """The port's BMP decoder against the JAX package's ``load_image``
    (PIL), exact, on files the test writes."""

    def check(self, tmp_path, data: bytes) -> np.ndarray:
        p = tmp_path / "x.bmp"
        p.write_bytes(data)
        got = load_image(p)
        np.testing.assert_array_equal(got, jax_load_image(p))
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
        return got

    @pytest.mark.parametrize("top_down", [False, True])
    @pytest.mark.parametrize("bits", [1, 4, 8])
    def test_palette(self, tmp_path, bits, top_down):
        rng = np.random.default_rng(bits)
        h, w = 13, 11  # rows that need padding at every depth
        palette = rng.integers(0, 256, (1 << bits, 3))
        idx = rng.integers(0, 1 << bits, (h, w))
        got = self.check(tmp_path, encode_test_bmp(idx, bits, palette, top_down))
        np.testing.assert_array_equal(got, palette[idx])

    def test_os2_header_palette(self, tmp_path):
        rng = np.random.default_rng(12)
        palette = rng.integers(0, 256, (256, 3))
        self.check(tmp_path, encode_test_bmp(rng.integers(0, 256, (6, 9)), 8, palette,
                                             header_size=12))

    def test_short_palette(self, tmp_path):
        """A palette with fewer entries than the depth allows (``biClrUsed``)."""
        rng = np.random.default_rng(3)
        palette = rng.integers(0, 256, (20, 3))
        self.check(tmp_path, encode_test_bmp(rng.integers(0, 20, (7, 10)), 8, palette))

    @pytest.mark.parametrize("top_down", [False, True])
    @pytest.mark.parametrize("name,bits,header_size,masks,fields", BMP_CASES,
                             ids=[c[0] for c in BMP_CASES])
    def test_true_colour(self, tmp_path, name, bits, header_size, masks, fields, top_down):
        rng = np.random.default_rng(bits + header_size)
        rgb = np.stack([rng.integers(0, 1 << size, (9, 7)) for _, size in fields], -1)
        pixels = _pack(rgb, fields)
        if bits == 32 and masks and masks[3]:
            pixels |= np.uint64(0x80) << np.uint64(24 if masks[3] == 0xFF000000 else 0)
        self.check(tmp_path, encode_test_bmp(pixels, bits, top_down=top_down,
                                             header_size=header_size, masks=masks))

    def test_save_gray_bmp_round_trips(self, tmp_path):
        """The 8-bit palette files ``save_gray_bmp`` writes."""
        values = np.random.default_rng(0).integers(0, 256, (5, 7))
        save_gray_bmp(tmp_path / "g.bmp", values)
        got = load_image(tmp_path / "g.bmp")
        np.testing.assert_array_equal(got, np.repeat(values[..., None], 3, -1))
        np.testing.assert_array_equal(got, jax_load_image(tmp_path / "g.bmp"))

    @pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
    def test_pil_written_files(self, tmp_path, mode):
        img = scene(15, 22, 4)
        im = Image.fromarray(img).convert(mode) if mode != "P" else \
            Image.fromarray(img[..., :3]).quantize(200)
        im.save(tmp_path / "x.bmp")
        np.testing.assert_array_equal(load_image(tmp_path / "x.bmp"),
                                      jax_load_image(tmp_path / "x.bmp"))

    @pytest.mark.parametrize("compression,name", [(1, "RLE8"), (2, "RLE4")])
    def test_rle_raises_by_name(self, compression, name):
        data = bytearray(encode_test_bmp(np.zeros((2, 2), int), 8, np.zeros((256, 3), int)))
        struct.pack_into("<I", data, 30, compression)
        with pytest.raises(ValueError, match=name):
            decode_bmp(bytes(data))

    def test_unknown_bitfields_raise(self):
        data = encode_test_bmp(np.zeros((2, 2), np.uint64), 32, masks=(0xFF, 0xFF00, 0xFF0000))
        with pytest.raises(ValueError, match="bitfields"):
            decode_bmp(data)


class TestResize:
    @pytest.mark.parametrize("src_hw,out_hw", [
        ((224, 224), (480, 640)),  # the reference fixture to the camera
        ((100, 130), (37, 53)),    # down, non-integer
        ((48, 64), (480, 640)),    # up x10
        ((480, 640), (120, 160)),  # down x4
        ((37, 53), (37, 90)),      # one axis only
        ((31, 17), (200, 3)),      # up one axis, down the other
        ((300, 400), (299, 401)),  # nearly unchanged
        ((5, 7), (5, 7)),          # unchanged: a copy
    ])
    def test_equals_pillow_byte_for_byte(self, src_hw, out_hw):
        rng = np.random.default_rng(src_hw[0])
        img = rng.integers(0, 256, (*src_hw, 3)).astype(np.uint8)
        img[: src_hw[0] // 3, : src_hw[1] // 3] = 255  # flat areas and hard edges: overshoot clips
        img[src_hw[0] // 2 :, src_hw[1] // 2 :] = 0
        want = np.asarray(Image.fromarray(img).resize((out_hw[1], out_hw[0])))
        got = resize_bicubic(img, (out_hw[1], out_hw[0]))
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        if src_hw == out_hw:
            assert got is not img and np.shares_memory(got, img) is False


class TestDebugBmp:
    @pytest.mark.parametrize("hw", [(3, 5), (4, 4), (7, 6), (1, 1)])
    def test_save_gray_bmp_equals_jax(self, tmp_path, hw):
        from tod_tpu.utils.image_io import save_gray_bmp as jax_save

        values = np.random.default_rng(hw[0]).uniform(-300, 600, hw)
        save_gray_bmp(tmp_path / "port.bmp", values)
        jax_save(tmp_path / "jax.bmp", values)
        assert (tmp_path / "port.bmp").read_bytes() == (tmp_path / "jax.bmp").read_bytes()

    def test_dump_scene_debug_equals_jax(self, tmp_path):
        from tod_tpu.utils.image_io import dump_scene_debug as jax_dump
        from tod_tpu_torch.core.config import CameraConfig, GeometryConfig
        from tod_tpu_torch.geometry.fusion import fuse_scene
        from tod_tpu_torch.runtime.frame_source import synth_frame_numpy
        from tod_tpu_torch.utils.image_io import dump_scene_debug

        f = synth_frame_numpy(0, 3, 48, 64)
        cls = np.zeros((48, 64), np.uint8)
        cls[(f.rgb == (240, 220, 40)).all(-1)] = 3
        cls[(f.rgb == (220, 40, 40)).all(-1)] = 1
        ids = np.where(cls == 3, 0, -1).astype(np.int32)
        s = fuse_scene(torch.from_numpy(f.depth.astype(np.int32)), torch.from_numpy(cls),
                       torch.from_numpy(ids), CameraConfig(width=64, height=48), GeometryConfig())
        (tmp_path / "port").mkdir()
        (tmp_path / "jax").mkdir()
        got = dump_scene_debug(s, tmp_path / "port", depth=f.depth)
        want = jax_dump(type("S", (), {"height": s.height.numpy(),
                                       "connections": s.connections.numpy()}),
                        tmp_path / "jax", depth=f.depth)
        assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want]
        for a, b in zip(got, want):
            assert open(a, "rb").read() == open(b, "rb").read(), a


class TestSources:
    def test_png_source_matches_jax(self, tmp_path):
        from tod_tpu.core.config import CameraConfig as JaxCam
        from tod_tpu.runtime.frame_source import PNGSource as JaxPNGSource
        from tod_tpu_torch.core.config import CameraConfig
        from tod_tpu_torch.runtime.frame_source import PNGSource

        path = tmp_path / "fixture.png"
        Image.fromarray(scene(224, 224, 1)[..., :3]).save(path)
        want = list(JaxPNGSource(path, JaxCam(width=160, height=120), n_frames=2).frames())
        got = list(PNGSource(path, CameraConfig(width=160, height=120), n_frames=2).frames())
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.rgb, w.rgb)
            np.testing.assert_array_equal(g.depth, w.depth)
            assert g.depth.dtype == np.uint16 and g.depth[0, 0] == 3500 and g.depth[-1, 0] == 600

    def test_png_source_takes_a_bmp_as_jax(self, tmp_path):
        """``--source png`` on a 24-bit BMP, as the JAX package's source
        reads it (through PIL)."""
        from tod_tpu.core.config import CameraConfig as JaxCam
        from tod_tpu.runtime.frame_source import PNGSource as JaxPNGSource
        from tod_tpu_torch.core.config import CameraConfig
        from tod_tpu_torch.runtime.frame_source import PNGSource

        path = tmp_path / "fixture.bmp"
        Image.fromarray(scene(120, 150, 2)[..., :3]).save(path)
        want = next(iter(JaxPNGSource(path, JaxCam(width=160, height=120), n_frames=1).frames()))
        got = next(iter(PNGSource(path, CameraConfig(width=160, height=120), n_frames=1).frames()))
        np.testing.assert_array_equal(got.rgb, want.rgb)
        np.testing.assert_array_equal(got.depth, want.depth)

    def test_ring_source_streams(self):
        from tod_tpu_torch.core.config import CameraConfig
        from tod_tpu_torch.runtime.frame_source import RingSource, synth_frame_numpy

        src = RingSource(CameraConfig(width=64, height=48), capacity=4, fps=200.0, seed=0,
                         n_frames=5)
        try:
            got = list(src.frames())
            assert len(got) == 5
            assert got[0].rgb.shape == (48, 64, 3)
            assert src.stats["pushed"] >= 5
            # the native scene is the numpy one, byte for byte
            synth = [synth_frame_numpy(0, t, 48, 64) for t in range(src.stats["pushed"])]
            for g in got:
                assert any(np.array_equal(g.rgb, s.rgb) and np.array_equal(g.depth, s.depth)
                           for s in synth)
        finally:
            src.close()
        src.close()  # idempotent
        assert list(src.frames()) == []

    def test_ring_trace_replay(self, tmp_path):
        from tod_tpu_torch.core.config import CameraConfig
        from tod_tpu_torch.runtime.frame_source import RingSource, SyntheticSource, write_trace

        cam = CameraConfig(width=64, height=48)
        frames = list(SyntheticSource(cam, seed=9, n_frames=2).frames())
        p = tmp_path / "r.todtrace"
        write_trace(p, frames)
        src = RingSource(cam, capacity=4, fps=500.0, trace_path=str(p), n_frames=4)
        try:
            got = list(src.frames())
            assert len(got) == 4
            # drop-oldest at 500 fps may skip frames: every frame is one of
            # the trace's, and in loop order when nothing was dropped
            trace = [f.rgb for f in frames]
            for g in got:
                assert any(np.array_equal(g.rgb, t) for t in trace)
            if src.stats["dropped"] == 0:
                np.testing.assert_array_equal(got[2].rgb, got[0].rgb)
        finally:
            src.close()

    def test_ring_drops_oldest_at_capacity(self):
        from tod_tpu_torch.native import ring

        lib = ring.get()
        handle = lib.tod_ring_create(2, 2, 3)
        try:
            for k in range(5):
                dropped = lib.tod_ring_push(handle, np.full(18, k, np.uint8),
                                            np.full(6, k, np.uint16))
                assert dropped == (k >= 2)
            rgb, depth = np.empty(18, np.uint8), np.empty(6, np.uint16)
            assert lib.tod_ring_pop(handle, rgb, depth, 10) == 1 and rgb[0] == 3
            assert lib.tod_ring_pop(handle, rgb, depth, 10) == 1 and depth[0] == 4
            assert lib.tod_ring_pop(handle, rgb, depth, 10) == 0
            assert (lib.tod_ring_stat_pushed(handle), lib.tod_ring_stat_dropped(handle)) == (5, 3)
        finally:
            lib.tod_ring_destroy(handle)


class TestCheckpoint:
    def test_npz_loads_as_the_pinned_weights(self, tmp_path):
        from tod_tpu_torch.core.weights import load_checkpoint, load_pinned, read_tree

        path = tmp_path / "ckpt.npz"
        np.savez(path, **read_tree())
        got, want = load_checkpoint(path), load_pinned()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)

    def test_directory_names_the_converter(self, tmp_path):
        from tod_tpu_torch.core.weights import load_checkpoint

        with pytest.raises(ValueError, match="test_torch_weights.py --write CKPT_DIR OUT.npz"):
            load_checkpoint(tmp_path)

    def test_wrong_model_raises(self, tmp_path):
        from tod_tpu_torch.core.config import ModelConfig
        from tod_tpu_torch.core.weights import load_checkpoint, read_tree

        path = tmp_path / "ckpt.npz"
        np.savez(path, **read_tree())
        with pytest.raises(ValueError, match="shape mismatch"):
            load_checkpoint(path, ModelConfig(fpn_channels=64))
