"""Domain-randomized FRC-scene generator, the sim-to-real training data
(the port's copy of the JAX package's ``train/domainrand.py``, numpy for
numpy: the same seed gives the same scenes bit for bit).

Everything that is not the class definition is randomized, so the stable
signal left to learn is the one that transfers to real photographs:

- **ball** (class 3): a circular object of a saturated game-piece color at
  any scale, with 3-D shading, seam arcs and mutual occlusion, or at times
  the legacy flat disc;
- **robot** (class 1 red / 2 blue): a dark cluttered body over a saturated
  bumper band with white number patches, or at times the legacy solid box;
- **background**: the legacy floor ramp, flat near-white, gradients,
  low-frequency texture, crowd clutter, or a spectator band over a floor;
- **hard negatives**: saturated clutter that is not a game piece
  (elongated textured ellipses, banners, small bumper-colored blobs,
  machinery with a non-bumper band), all labeled background;
- **photometrics**: gamma, brightness and white-balance jitter, optional
  blur, sensor noise.

Same contract as :class:`SyntheticDetectionData` (``next_batch()`` /
``_scene()``), so it drops into the trainer, the disk exporter and the
evaluator unchanged.  :class:`HardEvalData` is the hard held-out
distribution (small, occluded, crowded objects on busy backgrounds).
"""

from __future__ import annotations

import numpy as np

from tod_tpu_torch.train.synthetic_data import (
    BALL,
    BLUE_ROBOT,
    MAX_OBJECTS,
    RED_ROBOT,
    SyntheticDetectionData,
)

# Saturated game-piece palette (fixture balls are blue/red/yellow; orange is
# the adjacent FRC game era). Values are RGB float32.
BALL_PALETTE = np.array(
    [
        [235, 215, 40],  # yellow (legacy + the fixture's ~7in ball)
        [205, 45, 40],  # red
        [45, 90, 205],  # blue
        [235, 120, 35],  # orange
    ],
    np.float32,
)
BUMPER_RED = np.array([205, 40, 40], np.float32)
BUMPER_BLUE = np.array([40, 60, 205], np.float32)

# Saturated hard-negative palette (crowd shirts, banners, pit equipment).
# First 6 rows are NON-bumper hues — safe for shapes whose geometry would
# otherwise read as a bumper band; the red/blue tail rows are used only for
# shapes far smaller than the minimum robot footprint.
NEG_PALETTE = np.array(
    [
        [230, 210, 50],  # yellow
        [235, 130, 40],  # orange
        [60, 180, 75],  # green
        [70, 200, 200],  # teal
        [150, 60, 200],  # purple
        [230, 60, 180],  # magenta
        [205, 45, 40],  # red (crowd shirts)
        [45, 90, 205],  # blue (crowd shirts)
    ],
    np.float32,
)
NEG_PALETTE.setflags(write=False)

MIN_VISIBLE_PX = 30  # objects occluded below this vanish from the labels


def _rand_color(rng, lo=0, hi=255):
    return rng.uniform(lo, hi, 3).astype(np.float32)


BUMPER_RED.setflags(write=False)
BUMPER_BLUE.setflags(write=False)


def _muted(rng):
    """A desaturated random color (crowd/pit clutter — never ball-saturated)."""
    c = rng.uniform(0, 255, 3).astype(np.float32)
    g = c.mean()
    return g + (c - g) * rng.uniform(0.0, 0.45)


def _box_blur3(img: np.ndarray) -> np.ndarray:
    """3×3 box blur, edge-clamped (separable, pure numpy)."""
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    h = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    return (h[:-2] + h[1:-1] + h[2:]) / 9.0


class DomainRandomizedData(SyntheticDetectionData):
    """Drop-in domain-randomized variant of the procedural dataset.

    ``legacy_prob`` controls how often a scene is drawn in the plain
    procedural style (flat discs / solid boxes on the floor ramp) so the
    legacy held-out gates (tests/test_golden.py, seed-9999 scenes) stay
    in-distribution while the bulk of training covers the randomized domain.
    """

    # sampling ranges as class attributes so evaluation-only variants
    # (HardEvalData) can shift the distribution without copying draw code
    BALL_R_RANGE = (0.04, 0.32)       # fraction of min(h, w)
    ROBOT_HALF_RANGE = (0.12, 0.55)   # fraction of each axis
    N_BALLS_RANGE = (0, 5)            # np.integers bounds (high-exclusive)
    N_ROBOTS_RANGE = (0, 3)
    BG_MODES = ("ramp", "flat", "gradient", "texture", "clutter", "crowd")

    def __init__(self, *args, legacy_prob: float = 0.2, **kw):
        super().__init__(*args, **kw)
        self.legacy_prob = legacy_prob

    # ------------------------------------------------------------- scene --
    def _scene(self):
        if self.rng.random() < self.legacy_prob:
            return super()._scene()
        h, w = self.h, self.w
        rng = self.rng

        img = self._background(rng, h, w)

        inst_mask = np.zeros((MAX_OBJECTS, h, w), np.float32)
        boxes = np.zeros((MAX_OBJECTS, 4), np.float32)
        classes = np.zeros((MAX_OBJECTS,), np.int32)
        sem = np.zeros((h, w), np.int32)

        n_balls = int(rng.integers(*self.N_BALLS_RANGE))
        n_robots = int(rng.integers(*self.N_ROBOTS_RANGE))
        if n_balls + n_robots == 0:
            n_balls = 1
        kinds = [BALL] * n_balls + [
            int(rng.choice([RED_ROBOT, BLUE_ROBOT])) for _ in range(n_robots)
        ]
        rng.shuffle(kinds)
        kinds = kinds[:MAX_OBJECTS]

        # painter's order: each object may occlude everything drawn before it
        # (the fixture's yellow ball sits on the blue one); earlier objects'
        # visible masks lose the covered pixels.
        k = 0
        for kind in kinds:
            if kind == BALL:
                m = self._draw_ball(rng, img)
            else:
                m = self._draw_robot(rng, img, kind)
            if m is None:
                continue
            inst_mask[:k][:, m] = 0.0  # occlusion: newer object wins
            inst_mask[k] = m.astype(np.float32)
            classes[k] = kind
            k += 1

        # labels from the final VISIBLE masks (boxes are visible extents)
        valid = np.zeros((MAX_OBJECTS,), bool)
        for j in range(k):
            m = inst_mask[j] > 0
            if m.sum() < MIN_VISIBLE_PX:
                inst_mask[j] = 0.0
                continue
            ys, xs = np.nonzero(m)
            boxes[j] = [
                ys.min() / h,
                xs.min() / w,
                (ys.max() + 1) / h,
                (xs.max() + 1) / w,
            ]
            valid[j] = True
            sem[m] = classes[j]

        img = self._photometric(rng, img)
        return img, boxes, classes, valid, inst_mask, sem

    # -------------------------------------------------------- background --
    def _background(self, rng, h, w) -> np.ndarray:
        mode = rng.choice(list(self.BG_MODES))
        if mode == "ramp":  # legacy floor look, base colors jittered
            ramp = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
            base = _rand_color(rng, 10, 90)
            gain = _rand_color(rng, 20, 110)
            img = base + gain * ramp * np.ones((1, w, 1), np.float32)
        elif mode == "flat":
            # biased bright: the frc_balls fixture is near-white
            v = rng.uniform(120, 255) if rng.random() < 0.6 else rng.uniform(20, 255)
            img = np.full((h, w, 3), v, np.float32) + rng.uniform(-18, 18, 3).astype(
                np.float32
            )
        elif mode == "gradient":
            c0, c1 = _rand_color(rng), _rand_color(rng)
            ang = rng.uniform(0, 2 * np.pi)
            yy = np.linspace(-0.5, 0.5, h, dtype=np.float32)[:, None]
            xx = np.linspace(-0.5, 0.5, w, dtype=np.float32)[None, :]
            t = (yy * np.sin(ang) + xx * np.cos(ang) + 0.5)[..., None]
            img = c0 + (c1 - c0) * np.clip(t, 0, 1)
        elif mode == "texture":
            # low-frequency noise field: tiny random image, bilinear-ish upsample
            gh, gw = int(rng.integers(3, 9)), int(rng.integers(3, 12))
            grid = rng.uniform(0, 255, (gh, gw, 3)).astype(np.float32)
            img = _upsample_bilinear(grid, h, w)
        elif mode == "clutter":  # gradient base + rectangles/ellipses (crowd)
            img = self._background_simple(rng, h, w)
            for _ in range(int(rng.integers(3, 11))):
                self._draw_clutter(rng, img)
        else:  # crowd: dense spectator band over a floor (red_robot.png look)
            img = self._background_crowd(rng, h, w)
        # optional wall/floor split (red_robot.png: busy wall over a flat floor)
        if mode not in ("clutter", "crowd") and rng.random() < 0.3:
            split = int(rng.uniform(0.3, 0.75) * h)
            floor = np.full((h - split, w, 3), rng.uniform(40, 200), np.float32)
            floor += rng.uniform(-15, 15, 3).astype(np.float32)
            img[split:] = floor
        return img

    def _background_simple(self, rng, h, w) -> np.ndarray:
        c0, c1 = _rand_color(rng), _rand_color(rng)
        t = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
        return c0 + (c1 - c0) * t * np.ones((1, w, 1), np.float32)

    def _draw_clutter(self, rng, img) -> None:
        """Background clutter, always labeled background.

        v1 drew only muted shapes, which left saturation alone separating the
        classes from everything else — and the round-4 checkpoint then hit
        0.85-0.94-confidence ball/robot false positives on red_robot.png's
        saturated crowd.  v2 mixes in saturated hard negatives whose geometry
        still cannot be a class instance (see module docstring)."""
        h, w = img.shape[:2]
        roll = rng.random()
        if roll < 0.55:  # v1 muted shape (spectators, pit walls)
            self._clutter_shape(
                rng, img, _muted(rng),
                rng.uniform(0.03, 0.25) * h, rng.uniform(0.03, 0.25) * w,
            )
        elif roll < 0.78:
            # saturated banner/shirt: elongated (aspect ≥ 1.6 — never the
            # legacy flat disc) and heavily textured (never a clean shaded
            # sphere); any hue including game-piece colors
            color = NEG_PALETTE[rng.integers(0, len(NEG_PALETTE))] + rng.uniform(
                -20, 20, 3
            ).astype(np.float32)
            long_ = rng.uniform(0.08, 0.3)
            short = long_ / rng.uniform(1.6, 3.5)
            hh, hw2 = (long_ * h, short * w) if rng.random() < 0.5 else (
                short * h, long_ * w,
            )
            self._clutter_shape(rng, img, color, hh, hw2, noise=rng.uniform(12, 35))
        elif roll < 0.9:
            # small bumper-colored blob (a shirt in the crowd): well under
            # the minimum robot footprint (robots are ≥ 0.24·min(h,w) wide)
            color = (BUMPER_RED if rng.random() < 0.5 else BUMPER_BLUE) + rng.uniform(
                -25, 25, 3
            ).astype(np.float32)
            self._clutter_shape(
                rng, img, color,
                rng.uniform(0.015, 0.05) * h, rng.uniform(0.015, 0.05) * w,
                noise=rng.uniform(5, 20),
            )
        else:
            self._clutter_machinery(rng, img)

    def _clutter_shape(self, rng, img, color, hh, hw2, noise: float = 0.0) -> None:
        """One background rect/ellipse of half-size (hh, hw2) with optional
        per-pixel texture noise."""
        h, w = img.shape[:2]
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        y0, y1 = int(max(cy - hh, 0)), int(min(cy + hh, h))
        x0, x1 = int(max(cx - hw2, 0)), int(min(cx + hw2, w))
        if y1 <= y0 or x1 <= x0:
            return
        fill = np.broadcast_to(
            np.asarray(color, np.float32), (y1 - y0, x1 - x0, 3)
        ).astype(np.float32)
        if noise > 0.0:
            fill += rng.standard_normal(fill.shape, dtype=np.float32) * np.float32(
                noise
            )
        if rng.random() < 0.5:
            img[y0:y1, x0:x1] = fill
        else:
            yy = np.arange(y0, y1, dtype=np.float32)[:, None]
            xx = np.arange(x0, x1, dtype=np.float32)[None, :]
            m = ((yy - cy) / max(hh, 1)) ** 2 + ((xx - cx) / max(hw2, 1)) ** 2 <= 1.0
            img[y0:y1, x0:x1][m] = fill[m]

    def _clutter_machinery(self, rng, img) -> None:
        """Bumper-geometry hard negative: a dark machinery block with a
        NON-bumper-colored band at its bottom (pit carts, scoring table).
        Teaches that only a red/blue band under a dark body is a robot."""
        h, w = img.shape[:2]
        bw = rng.uniform(0.08, 0.35) * w
        bh = rng.uniform(0.08, 0.35) * h
        cy, cx = rng.uniform(0.15, 0.9) * h, rng.uniform(0.1, 0.9) * w
        y0, y1 = int(max(cy - bh, 0)), int(min(cy + bh, h))
        x0, x1 = int(max(cx - bw, 0)), int(min(cx + bw, w))
        if y1 <= y0 or x1 <= x0:
            return
        base = np.float32(rng.uniform(25, 110))
        img[y0:y1, x0:x1] = base + rng.standard_normal(
            (y1 - y0, x1 - x0, 3), dtype=np.float32
        ) * np.float32(12)
        band_h = max(int(rng.uniform(0.15, 0.4) * (y1 - y0)), 1)
        color = NEG_PALETTE[rng.integers(0, 6)] + rng.uniform(-20, 20, 3).astype(
            np.float32
        )  # non-bumper hues only: the geometry IS the robot signature
        img[y1 - band_h : y1, x0:x1] = color

    def _background_crowd(self, rng, h, w) -> np.ndarray:
        """Dense spectator band over a comparatively plain floor — the
        red_robot.png composition (busy crowd wall, flat gym floor)."""
        img = self._background_simple(rng, h, w)
        split = int(rng.uniform(0.35, 0.8) * h)
        floor = np.full((h - split, w, 3), rng.uniform(40, 210), np.float32)
        floor += rng.uniform(-15, 15, 3).astype(np.float32)
        img[split:] = floor
        for _ in range(int(rng.integers(15, 40))):
            if rng.random() < 0.7:  # muted heads/shoulders
                color = _muted(rng)
                noise = rng.uniform(0, 12)
            else:  # saturated shirts/banners, small and textured
                color = NEG_PALETTE[rng.integers(0, len(NEG_PALETTE))] + rng.uniform(
                    -20, 20, 3
                ).astype(np.float32)
                noise = rng.uniform(8, 25)
            cy = rng.uniform(0, split)
            cx = rng.uniform(0, w)
            hh = rng.uniform(0.02, 0.09) * h
            hw2 = rng.uniform(0.02, 0.09) * w
            y0, y1 = int(max(cy - hh, 0)), int(min(cy + hh, split))
            x0, x1 = int(max(cx - hw2, 0)), int(min(cx + hw2, w))
            if y1 <= y0 or x1 <= x0:
                continue
            fill = np.broadcast_to(
                np.asarray(color, np.float32), (y1 - y0, x1 - x0, 3)
            ).astype(np.float32)
            if noise > 0.0:
                fill += rng.standard_normal(
                    fill.shape, dtype=np.float32
                ) * np.float32(noise)
            yy = np.arange(y0, y1, dtype=np.float32)[:, None]
            xx = np.arange(x0, x1, dtype=np.float32)[None, :]
            m = ((yy - cy) / max(hh, 1)) ** 2 + ((xx - cx) / max(hw2, 1)) ** 2 <= 1.0
            img[y0:y1, x0:x1][m] = fill[m]
        return img

    # ------------------------------------------------------------- balls --
    def _draw_ball(self, rng, img) -> np.ndarray | None:
        """Shaded sphere with optional seams/specular; returns full-frame mask."""
        h, w = img.shape[:2]
        r = rng.uniform(*self.BALL_R_RANGE) * min(h, w)
        cy = rng.uniform(0.08, 0.92) * h
        cx = rng.uniform(0.08, 0.92) * w
        y0, y1 = int(max(cy - r, 0)), int(min(cy + r + 1, h))
        x0, x1 = int(max(cx - r, 0)), int(min(cx + r + 1, w))
        if y1 <= y0 or x1 <= x0:
            return None
        yy = np.arange(y0, y1, dtype=np.float32)[:, None] - cy
        xx = np.arange(x0, x1, dtype=np.float32)[None, :] - cx
        d2 = yy * yy + xx * xx
        m = d2 <= r * r
        if not m.any():
            return None
        base = BALL_PALETTE[rng.integers(0, len(BALL_PALETTE))] + rng.uniform(
            -25, 25, 3
        ).astype(np.float32)

        if rng.random() < 0.15:  # legacy flat disc
            shade = np.ones_like(d2)[..., None]
        else:
            # lambertian shading from a random light direction
            nz = np.sqrt(np.maximum(1.0 - d2 / (r * r), 0.0))
            lv = rng.normal(size=3)
            lv[2] = abs(lv[2]) + 0.5
            lv /= np.linalg.norm(lv)
            ndotl = np.maximum(
                (xx / r) * lv[0] + (yy / r) * lv[1] + nz * lv[2], 0.0
            )
            ambient = rng.uniform(0.35, 0.65)
            shade = (ambient + (1.05 - ambient) * ndotl)[..., None]

        patch = img[y0:y1, x0:x1]
        col = base[None, None, :] * shade
        # specular highlight
        if rng.random() < 0.6:
            hy, hx = rng.uniform(-0.5, 0.2) * r, rng.uniform(-0.5, 0.5) * r
            hd2 = (yy - hy) ** 2 + (xx - hx) ** 2
            col = col + rng.uniform(40, 120) * np.exp(-hd2 / (0.12 * r * r))[..., None]
        # seam arcs (tennis/FRC ball mold lines)
        for _ in range(int(rng.integers(0, 3))):
            sy, sx = rng.uniform(-0.7, 0.7, 2) * r
            r2 = rng.uniform(0.55, 1.15) * r
            ring = np.abs(np.sqrt((yy - sy) ** 2 + (xx - sx) ** 2) - r2) < max(
                0.04 * r, 1.0
            )
            col = np.where(ring[..., None], col * rng.uniform(0.65, 0.85), col)
        patch[m] = col[m]
        mask = np.zeros((h, w), bool)
        mask[y0:y1, x0:x1] = m
        return mask

    # ------------------------------------------------------------ robots --
    def _draw_robot(self, rng, img, kind: int) -> np.ndarray | None:
        """Dark mechanism body over a saturated bumper band (or legacy box)."""
        h, w = img.shape[:2]
        bw = rng.uniform(*self.ROBOT_HALF_RANGE) * w  # body half-width
        bh = rng.uniform(*self.ROBOT_HALF_RANGE) * h  # body half-height
        cy = rng.uniform(0.15, 0.9) * h
        cx = rng.uniform(0.1, 0.9) * w
        bumper = BUMPER_RED if kind == RED_ROBOT else BUMPER_BLUE
        bumper = bumper + rng.uniform(-20, 20, 3).astype(np.float32)

        mask = np.zeros((h, w), bool)
        if rng.random() < 0.2:  # legacy solid box
            y0, y1 = int(max(cy - bh, 0)), int(min(cy + bh, h))
            x0, x1 = int(max(cx - bw, 0)), int(min(cx + bw, w))
            if y1 <= y0 or x1 <= x0:
                return None
            img[y0:y1, x0:x1] = bumper
            mask[y0:y1, x0:x1] = True
            return mask

        # body: dark textured machinery
        y0, y1 = int(max(cy - bh, 0)), int(min(cy + bh, h))
        x0, x1 = int(max(cx - bw, 0)), int(min(cx + bw, w))
        if y1 <= y0 or x1 <= x0:
            return None
        body_h = y1 - y0
        # dark machinery 60 % / bright bare-metal frame 40 % — the real
        # red_robot.png body is mostly bright aluminium, and the v1 dark-only
        # body left the real robot's torso unexplained (sem IoU 0.33)
        base = np.float32(
            rng.uniform(25, 80) if rng.random() < 0.6 else rng.uniform(100, 190)
        )
        body = base + rng.standard_normal(
            (body_h, x1 - x0, 3), dtype=np.float32
        ) * np.float32(12)
        # mechanism clutter: small rects of metal grays / dark parts / a few
        # bright bits (wires, logos)
        for _ in range(int(rng.integers(2, 7))):
            ph = int(rng.uniform(0.08, 0.5) * body_h)
            pw = int(rng.uniform(0.08, 0.5) * (x1 - x0))
            py = int(rng.uniform(0, max(body_h - ph, 1)))
            px = int(rng.uniform(0, max(x1 - x0 - pw, 1)))
            if rng.random() < 0.7:
                c = np.full(3, rng.uniform(15, 210), np.float32) + rng.uniform(-12, 12, 3)
            else:
                c = _muted(rng)
            body[py : py + ph, px : px + pw] = c
        img[y0:y1, x0:x1] = body
        mask[y0:y1, x0:x1] = True

        # bumper band: bottom of the body, slightly wider, saturated team color
        band_h = rng.uniform(0.15, 0.38) * 2 * bh
        ext = rng.uniform(1.0, 1.15)
        by0 = int(max(cy + bh - band_h, 0))
        by1 = int(min(cy + bh, h))
        bx0 = int(max(cx - bw * ext, 0))
        bx1 = int(min(cx + bw * ext, w))
        if by1 > by0 and bx1 > bx0:
            band = np.broadcast_to(bumper, (by1 - by0, bx1 - bx0, 3)).astype(
                np.float32
            )
            band += rng.standard_normal(band.shape, dtype=np.float32) * np.float32(6)
            # white team-number patches
            for _ in range(int(rng.integers(1, 4))):
                ph = max(int((by1 - by0) * rng.uniform(0.3, 0.7)), 1)
                pw = max(int((bx1 - bx0) * rng.uniform(0.04, 0.12)), 1)
                py = int(rng.uniform(0, max(by1 - by0 - ph, 1)))
                px = int(rng.uniform(0, max(bx1 - bx0 - pw, 1)))
                band[py : py + ph, px : px + pw] = rng.uniform(215, 255)
            img[by0:by1, bx0:bx1] = band
            mask[by0:by1, bx0:bx1] = True
        return mask

    # -------------------------------------------------------- photometric --
    def _photometric(self, rng, img) -> np.ndarray:
        """Global white balance + brightness + gamma (as one per-channel u8
        LUT — the host is a single core, full-frame pow/float64 math was the
        generator's hot spot), then optional blur and sensor noise."""
        img = np.clip(img, 0, 255).astype(np.uint8)
        wb = rng.uniform(0.9, 1.1, 3) * rng.uniform(0.75, 1.25)
        gamma = rng.uniform(0.8, 1.25)
        v = np.arange(256, dtype=np.float32)[:, None] * wb[None, :]
        lut = (255.0 * np.clip(v / 255.0, 0, 1) ** gamma).astype(np.float32)
        out = lut[img, np.arange(3)]  # (H, W, 3) f32 via per-channel LUT
        if rng.random() < 0.4:
            out = _box_blur3(out)
            if rng.random() < 0.3:
                out = _box_blur3(out)
        sigma = np.float32(rng.uniform(2.0, 9.0))
        out += rng.standard_normal(out.shape, dtype=np.float32) * sigma
        return np.clip(out, 0, 255).astype(np.uint8)


class HardEvalData(DomainRandomizedData):
    """Harder held-out EVALUATION distribution (VERDICT r4 item 6).

    The standard held-out eval saturated: an 8k-step ResNet50 short-train and
    the 60k MobileNetV2 campaign both pin mAP@.5 = 1.0, so the backbone
    quality table could not discriminate capacity.  This variant shifts the
    same generator toward the failure modes that separate models — small
    objects (ball radius 0.018-0.07 vs 0.04-0.32), crowded scenes (3-6 balls
    + 1-3 robots, painter's-order occlusion), and busy backgrounds only
    (texture/clutter/crowd) — while keeping the class definitions identical.

    Evaluation-only by protocol (checkpoints/README.md "Real-fixture
    evaluation protocol"): training on this distribution would re-saturate
    the gate.  Used by bench config 15's quality axis and
    ``train.evaluate --hard``.
    """

    BALL_R_RANGE = (0.018, 0.07)  # floor keeps the smallest ball above MIN_VISIBLE_PX
    ROBOT_HALF_RANGE = (0.05, 0.16)
    N_BALLS_RANGE = (3, 7)
    N_ROBOTS_RANGE = (1, 4)
    BG_MODES = ("texture", "clutter", "crowd")

    def __init__(self, *args, **kw):
        kw["legacy_prob"] = 0.0
        super().__init__(*args, **kw)


def _upsample_bilinear(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """(gh, gw, 3) → (h, w, 3) bilinear, pure numpy."""
    gh, gw = grid.shape[:2]
    y = np.linspace(0, gh - 1, h, dtype=np.float32)
    x = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.floor(y).astype(np.int32)
    x0 = np.floor(x).astype(np.int32)
    y1 = np.minimum(y0 + 1, gh - 1)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = (y - y0)[:, None, None]
    fx = (x - x0)[None, :, None]
    a = grid[y0][:, x0]
    b = grid[y0][:, x1]
    c = grid[y1][:, x0]
    d = grid[y1][:, x1]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx
