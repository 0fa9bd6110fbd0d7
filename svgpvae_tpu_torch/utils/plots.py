"""The drivers' pictures, drawn with numpy alone (port of
svgpvae_tpu/utils/plots.py, which draws with matplotlib):

  * `plot_latents` -- video heatmaps, latent trajectories with their
    covariance ellipses, reconstruction heatmaps (the ball);
  * `plot_image_grid` -- ground-truth / reconstruction pairs (MNIST,
    SPRITES);
  * `plot_geometry_probe` -- the circles/squares latent-geometry probe;
  * `plot_kernel_matrices` -- view, object and product kernel heatmaps.

Each takes the JAX function's arguments and returns the picture as an
(H, W, 3) uint8 array, written as a PNG (utils.png) when `save_path` is
given.  The canvas is JAX's figure (figsize x dpi 100) and the panels sit
where matplotlib puts them: its default subplot grid (left 0.125, right
0.9, bottom 0.11, top 0.88, spacing 0.2), each image panel shrunk to its
image's aspect and centred, a colorbar taking 0.15 of its panel's width
with a pad of 0.05 (height : width 20).  Images are scaled nearest-
neighbour; single-channel images go through 256-entry colormap tables,
interpolated linearly between matplotlib's anchors, and are scaled to
their own min/max unless vmin/vmax are fixed.  Lines are 1.5 pt wide,
scatter dots 6 pt across (with their 1 pt edge: 7 pt), panel frames
0.8 pt; ellipses are filled at alpha 0.25 with no edge.  Artists are
painted in matplotlib's order: by zorder (dots and ellipses 1, lines 2,
frames 2.5), then in the order the JAX function adds them.

There are no fonts: the figure's title goes into the PNG's tEXt entry
"Title" and each panel's title or axis label into "Panel <k>", k the
panel's place in the subplot grid, row by row.  Tick marks and tick
labels are not drawn.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from svgpvae_tpu_torch.utils.png import write_png

DPI = 100
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2,
               hspace=0.2)
POINT = DPI / 72.0                      # pixels per typographic point
LINE_RADIUS = 0.75 * POINT              # lines: 1.5 pt wide
DOT_RADIUS = 3.5 * POINT                # scatter: s = 36 pt^2 and 1 pt edge
SPINE_RADIUS = max(0.4 * POINT, 0.5)    # frames: 0.8 pt, at least a pixel
COLORS = {"C0": (0x1F, 0x77, 0xB4), "C1": (0xFF, 0x7F, 0x0E),
          "blue": (0, 0, 255), "orange": (255, 165, 0), "black": (0, 0, 0)}
_RDBU = [(103, 0, 31), (178, 24, 43), (214, 96, 77), (244, 165, 130),
         (253, 219, 199), (247, 247, 247), (209, 229, 240), (146, 197, 222),
         (67, 147, 195), (33, 102, 172), (5, 48, 97)]
# matplotlib's anchors (0..255), evenly spaced over 0..1
CMAP_ANCHORS = {
    "Greys": [(g, g, g) for g in (255, 240, 217, 189, 150, 115, 82, 37, 0)],
    "gray": [(0, 0, 0), (255, 255, 255)],
    "RdBu_r": _RDBU[::-1],
}
CMAP_N = 256


def colormap(name: str, n: int = CMAP_N) -> np.ndarray:
    """The (n, 3) table of colormap `name` in 0..1: its anchors
    interpolated linearly at linspace(0, 1, n), as matplotlib builds its
    lookup table."""
    anchors = np.asarray(CMAP_ANCHORS[name], np.float64) / 255.0
    at = np.linspace(0.0, 1.0, len(anchors))
    x = np.linspace(0.0, 1.0, n)
    return np.stack([np.interp(x, at, anchors[:, c]) for c in range(3)], -1)


def apply_colormap(values: np.ndarray, name: str,
                   vmin: Optional[float] = None,
                   vmax: Optional[float] = None) -> np.ndarray:
    """values (...) -> colours (..., 3) in 0..1, as imshow maps them:
    normalised to vmin..vmax (default: the values' own min and max; a
    constant image maps to the table's first entry), then entry
    floor(x * 256), clipped to the table."""
    values = np.asarray(values, np.float64)
    lo = float(values.min()) if vmin is None else vmin
    hi = float(values.max()) if vmax is None else vmax
    x = (values - lo) / (hi - lo) if hi > lo else np.zeros_like(values)
    index = np.clip(np.floor(x * CMAP_N), 0, CMAP_N - 1).astype(np.int64)
    return colormap(name)[index]


def _video_heatmap(vid: np.ndarray) -> np.ndarray:
    """Overlay all frames shaded by time; (T, px, py) -> (px, py)."""
    t = len(vid)
    shaded = np.array([(i + 4) * v for i, v in enumerate(vid)])
    return np.max(shaded, axis=0) / (4 + t)


# --- layout ------------------------------------------------------------------


def grid_boxes(box: Tuple[float, float, float, float], nrows: int,
               ncols: int, wspace: float, hspace: float,
               width_ratios: Optional[Sequence[float]] = None) -> list:
    """matplotlib's GridSpec.get_grid_positions: the cells (x0, y0, w, h)
    of an nrows x ncols grid in `box` (left, bottom, right, top), row by
    row from the top."""
    left, bottom, right, top = box
    cell_h = (top - bottom) / (nrows + hspace * (nrows - 1))
    cell_w = (right - left) / (ncols + wspace * (ncols - 1))
    ratios = np.asarray(width_ratios if width_ratios is not None
                        else [1.0] * ncols, np.float64)
    widths = ratios * (cell_w * ncols / ratios.sum())
    lefts = left + np.concatenate([[0.0], np.cumsum(widths + wspace
                                                    * cell_w)[:-1]])
    boxes = []
    for r in range(nrows):
        y_top = top - r * cell_h * (1 + hspace)
        boxes += [(float(lefts[c]), y_top - cell_h, float(widths[c]), cell_h)
                  for c in range(ncols)]
    return boxes


def fit_box(box, aspect: float, anchor=(0.5, 0.5)) -> tuple:
    """`box` shrunk to height / width = `aspect` and placed at `anchor`
    inside it (imshow's aspect 'equal' with an adjustable box)."""
    x0, y0, w, h = box
    nw, nh = (w, w * aspect) if w * aspect <= h else (h / aspect, h)
    return (x0 + anchor[0] * (w - nw), y0 + anchor[1] * (h - nh), nw, nh)


class Canvas:
    """A white figure of figsize inches at `dpi` (the line widths are
    DPI's); boxes are (x0, y0, w, h) in pixels with y up from the bottom
    edge, as matplotlib's display coordinates."""

    def __init__(self, figsize: Tuple[float, float], dpi: int = DPI):
        self.w, self.h = (int(round(figsize[0] * dpi)),
                          int(round(figsize[1] * dpi)))
        self.rgb = np.ones((self.h, self.w, 3))
        self.text: Dict[str, str] = {}

    def subplots(self, nrows: int, ncols: int) -> list:
        """The subplot boxes, row by row from the top."""
        p = SUBPLOT
        return grid_boxes((p["left"] * self.w, p["bottom"] * self.h,
                           p["right"] * self.w, p["top"] * self.h),
                          nrows, ncols, p["wspace"], p["hspace"])

    def region(self, box, pad: float = 0.0):
        """(row slice, col slice, pixel-centre x (cols,), y (rows,)) of the
        pixels whose centres lie in `box` grown by `pad` pixels."""
        x0, y0, w, h = box
        c0 = max(int(np.ceil(x0 - pad - 0.5)), 0)
        c1 = min(int(np.ceil(x0 + w + pad - 0.5)), self.w)
        r0 = max(int(np.ceil(self.h - (y0 + h + pad) - 0.5)), 0)
        r1 = min(int(np.ceil(self.h - (y0 - pad) - 0.5)), self.h)
        xs = np.arange(c0, c1) + 0.5
        ys = self.h - (np.arange(r0, r1) + 0.5)
        return slice(r0, r1), slice(c0, c1), xs, ys

    def paint(self, rows, cols, mask, color: str) -> None:
        self.rgb[rows, cols][mask] = np.asarray(COLORS[color]) / 255.0

    def image(self, box, colors: np.ndarray, origin: str = "upper") -> None:
        """Fill `box` with the (nr, nc, 3) colours, nearest-neighbour."""
        rows, cols, xs, ys = self.region(box)
        x0, y0, w, h = box
        nr, nc = colors.shape[:2]
        ci = np.clip(np.floor((xs - x0) / w * nc), 0, nc - 1).astype(int)
        ri = np.clip(np.floor((y0 + h - ys) / h * nr), 0, nr - 1).astype(int)
        if origin == "lower":
            ri = nr - 1 - ri
        self.rgb[rows, cols] = colors[ri[:, None], ci[None, :]]

    def frame(self, box) -> None:
        """The four spines of `box`."""
        x0, y0, w, h = box
        corners = np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h],
                            [x0, y0 + h], [x0, y0]])
        rows, cols, xs, ys = self.region(box, pad=2.0)
        self.paint(rows, cols, _near_polyline(xs, ys, corners,
                                              SPINE_RADIUS), "black")

    def finish(self, save_path: Optional[str]) -> np.ndarray:
        """The canvas as uint8, written to save_path when given."""
        out = np.clip(np.rint(self.rgb * 255), 0, 255).astype(np.uint8)
        if save_path:
            write_png(save_path, out, self.text)
        return out


def _near_polyline(xs, ys, pts, radius) -> np.ndarray:
    """(len(ys), len(xs)) mask of the pixel centres within `radius` of the
    polyline through pts (K, 2), all in pixels."""
    px = np.broadcast_to(xs[None, :], (len(ys), len(xs))).reshape(-1)
    py = np.broadcast_to(ys[:, None], (len(ys), len(xs))).reshape(-1)
    pts = np.asarray(pts, np.float64)
    if len(pts) == 1:
        pts = np.vstack([pts, pts])
    a, b = pts[:-1], pts[1:]
    d = b - a
    dd = np.maximum((d ** 2).sum(-1), 1e-300)
    t = np.clip(((px[:, None] - a[None, :, 0]) * d[None, :, 0]
                 + (py[:, None] - a[None, :, 1]) * d[None, :, 1]) / dd,
                0.0, 1.0)
    qx = a[None, :, 0] + t * d[None, :, 0] - px[:, None]
    qy = a[None, :, 1] + t * d[None, :, 1] - py[:, None]
    near = (qx ** 2 + qy ** 2 <= radius ** 2).any(-1)
    return near.reshape(len(ys), len(xs))


class DataPanel:
    """A subplot with data limits: its artists are queued with their
    zorder and painted by `draw` in matplotlib's order, clipped to the
    box; the frame at zorder 2.5."""

    def __init__(self, canvas: Canvas, box, xlim, ylim):
        self.canvas, self.box = canvas, box
        self.xlim, self.ylim = xlim, ylim
        self.artists: List[tuple] = [(2.5, "frame", ())]

    def to_px(self, pts: np.ndarray) -> np.ndarray:
        x0, y0, w, h = self.box
        pts = np.asarray(pts, np.float64).reshape(-1, 2)
        (xa, xb), (ya, yb) = self.xlim, self.ylim
        return np.stack([x0 + (pts[:, 0] - xa) / (xb - xa) * w,
                         y0 + (pts[:, 1] - ya) / (yb - ya) * h], -1)

    def plot(self, pts, color, zorder: float = 2) -> None:
        self.artists.append((zorder, "line", (pts, color)))

    def scatter(self, pts, color, zorder: float = 1) -> None:
        self.artists.append((zorder, "dots", (pts, color)))

    def ellipses(self, centres, widths, heights, angles, color,
                 alpha: float, zorder: float = 1) -> None:
        self.artists.append((zorder, "ellipses", (centres, widths, heights,
                                                  angles, color, alpha)))

    def draw(self) -> None:
        cv = self.canvas
        rows, cols, xs, ys = cv.region(self.box)
        for _, kind, a in sorted(self.artists, key=lambda t: t[0]):
            if kind == "frame":
                cv.frame(self.box)
            elif kind == "ellipses":
                self._ellipses(rows, cols, xs, ys, *a)
            else:  # a line or dots: only the pixels near their points
                pts = self.to_px(a[0])
                radius = LINE_RADIUS if kind == "line" else DOT_RADIUS
                c = (xs >= pts[:, 0].min() - radius - 1) & \
                    (xs <= pts[:, 0].max() + radius + 1)
                r = (ys >= pts[:, 1].min() - radius - 1) & \
                    (ys <= pts[:, 1].max() + radius + 1)
                if not c.any() or not r.any():
                    continue
                ci, ri = np.flatnonzero(c), np.flatnonzero(r)
                sub_c = slice(cols.start + ci[0], cols.start + ci[-1] + 1)
                sub_r = slice(rows.start + ri[0], rows.start + ri[-1] + 1)
                sx, sy = xs[ci[0]:ci[-1] + 1], ys[ri[0]:ri[-1] + 1]
                if kind == "line":
                    mask = _near_polyline(sx, sy, pts, radius)
                else:
                    mask = ((sx[None, None, :] - pts[:, 0, None, None]) ** 2
                            + (sy[None, :, None] - pts[:, 1, None, None])
                            ** 2 <= radius ** 2).any(0)
                cv.paint(sub_r, sub_c, mask, a[1])

    def _ellipses(self, rows, cols, xs, ys, centres, widths, heights,
                  angles, color, alpha) -> None:
        """Filled ellipses in data coordinates (matplotlib's Ellipse: the
        unit circle scaled by (width/2, height/2), rotated by `angle`
        degrees, moved to the centre), all of one colour and alpha, so
        that painting k of them over a pixel leaves colour + (background -
        colour)(1 - alpha)^k whatever their order."""
        x0, y0, w, h = self.box
        (xa, xb), (ya, yb) = self.xlim, self.ylim
        dx = (xa + (xs - x0) / w * (xb - xa))[None, None, :] - \
            np.asarray(centres)[:, 0, None, None]
        dy = (ya + (ys - y0) / h * (yb - ya))[None, :, None] - \
            np.asarray(centres)[:, 1, None, None]
        th = np.radians(np.asarray(angles, np.float64))[:, None, None]
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        a = np.asarray(widths, np.float64)[:, None, None] / 2
        b = np.asarray(heights, np.float64)[:, None, None] / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            inside = (u / a) ** 2 + (v / b) ** 2 <= 1.0
        k = inside.sum(0)
        color = np.asarray(COLORS[color], np.float64) / 255.0
        sub = self.canvas.rgb[rows, cols]
        keep = (1 - alpha) ** k[..., None]
        self.canvas.rgb[rows, cols] = color + (sub - color) * keep


def image_panel(canvas: Canvas, box, colors: np.ndarray,
                 origin: str = "upper", axis: bool = True,
                 anchor=(0.5, 0.5)) -> None:
    """imshow in `box`: the box shrunk to the image's aspect, the image,
    and (unless the axis is off) its frame."""
    inner = fit_box(box, colors.shape[0] / colors.shape[1], anchor)
    canvas.image(inner, colors, origin)
    if axis:
        canvas.frame(inner)


def _autolim(pts: np.ndarray, margin: float = 0.05) -> tuple:
    """matplotlib's autoscaled limits of points: their range grown by
    `margin` of its width on each side."""
    lo, hi = float(np.min(pts)), float(np.max(pts))
    pad = margin * (hi - lo)
    return lo - pad, hi + pad


# --- the four pictures -------------------------------------------------------


def plot_latents(truevids, truepath, reconvids=None, reconpath=None,
                 reconvar=None, nplots: int = 4,
                 save_path=None) -> np.ndarray:
    """Video heatmaps + latent trajectories (+ covariance ellipses) +
    reconstruction heatmaps, one column per video (800 x 600 at
    nplots 4)."""
    cv = Canvas((2 * nplots, 6))
    boxes = cv.subplots(3, nplots)

    lim = 2.5
    for arr in (truepath[:nplots], reconpath[:nplots] if reconpath is not None
                else truepath[:1]):
        lim = max(lim, np.abs(arr).max() + 0.1)

    if reconvar is not None:
        evals, evecs = np.linalg.eig(reconvar[:nplots])
        heights = np.sqrt(np.abs(evals[:, :, 0]))
        widths = np.sqrt(np.abs(evals[:, :, 1]))
        angles = np.degrees(np.arctan2(evecs[:, :, 0, 1], evecs[:, :, 0, 0]))

    for i in range(nplots):
        image_panel(cv, boxes[i], apply_colormap(
            1 - _video_heatmap(truevids[i]), "Greys"), "lower", axis=False)

        panel = DataPanel(cv, boxes[nplots + i], (-lim, lim), (-lim, lim))
        panel.plot(truepath[i], "C0")
        panel.scatter(truepath[i, -1], "C0")
        if reconpath is not None:
            panel.plot(reconpath[i], "C1")
            panel.scatter(reconpath[i, -1], "C1")
        if reconvar is not None:
            t = truepath.shape[1]
            panel.ellipses(reconpath[i, :t], widths[i, :t], heights[i, :t],
                           angles[i, :t], "C1", 0.25)
        panel.draw()
        if reconvids is not None:
            image_panel(cv, boxes[2 * nplots + i], apply_colormap(
                1 - _video_heatmap(reconvids[i]), "Greys"), "lower",
                axis=False)
        else:  # an empty subplot keeps its frame
            cv.frame(boxes[2 * nplots + i])
    return cv.finish(save_path)


def plot_image_grid(images, recon_images, title: str, nr_images: int = 8,
                    seed: Optional[int] = 0, save_path=None) -> np.ndarray:
    """Ground-truth / reconstruction pair grid (1000 x 500 rows): pairs
    of random.Random(seed).sample(range(len(images)), nr_images) (the
    indices that random.seed(seed); random.sample(...) gives), or the
    first nr_images with seed None.  Single-channel images in 'gray' at
    their own min/max, RGB clipped to 0..1."""
    if seed is not None:
        indices = random.Random(seed).sample(range(len(images)), nr_images)
    else:
        indices = list(range(nr_images))
    rows = (nr_images + 3) // 4
    cv = Canvas((10, 5 * rows))
    boxes = cv.subplots(rows * 2, 4)
    cv.text["Title"] = title
    labels = {}
    for k, idx in enumerate(indices):
        r, c = divmod(k, 4)
        for offset, arr in ((0, images), (1, recon_images)):
            slot = (2 * r + offset) * 4 + c
            img = np.asarray(arr[idx], np.float64)
            if img.ndim != 3 or img.shape[-1] not in (1, 3):
                raise ValueError(f"plot_image_grid takes (H, W, 1) or "
                                 f"(H, W, 3) images, not {img.shape}")
            colors = (apply_colormap(img[..., 0], "gray")
                      if img.shape[-1] == 1 else np.clip(img, 0, 1))
            image_panel(cv, boxes[slot], colors)
            labels[slot] = f"{'gt' if offset == 0 else 'recon'} id {idx}"
    for slot, box in enumerate(boxes):
        if slot not in labels:  # an empty subplot keeps its frame
            cv.frame(box)
    cv.text.update({f"Panel {k}": labels[k] for k in sorted(labels)})
    return cv.finish(save_path)


def plot_geometry_probe(traj_true, traj_pred, vids, kind: str,
                        save_path=None) -> np.ndarray:
    """Circles/squares probe: rendered video heatmap + true (blue) vs
    predicted (orange, on top) latent geometry (800 x 400); the data
    panel's limits autoscaled as matplotlib's (5% margins)."""
    cv = Canvas((8, 4))
    box0, box1 = cv.subplots(1, 2)
    image_panel(cv, box0, apply_colormap(1 - _video_heatmap(vids[0]),
                                          "Greys"), "lower", axis=False)

    n = 19 if kind == "circles" else 25
    shown = [np.asarray(traj_true[:n])] + (
        [] if traj_pred is None else [np.asarray(traj_pred[:n])])
    pts = np.concatenate(shown)
    panel = DataPanel(cv, box1, _autolim(pts[:, 0]), _autolim(pts[:, 1]))
    panel.scatter(traj_true[:n], "blue")
    if traj_pred is not None:
        panel.scatter(traj_pred[:n], "orange", zorder=10)
    if kind == "circles":
        for lo, hi in ((1, 9), (9, 19)):
            panel.plot(np.vstack([traj_true[lo:hi], traj_true[lo:lo + 1]]),
                       "blue")
            if traj_pred is not None:
                panel.plot(np.vstack([traj_pred[lo:hi],
                                      traj_pred[lo:lo + 1]]), "orange",
                           zorder=10)
    else:
        for pts_k, color, z in ((traj_true, "blue", 1),
                                (traj_pred, "orange", 10)):
            if pts_k is None:
                continue
            for i in range(5):
                panel.plot(pts_k[5 * i:5 * i + 5], color, zorder=z)
                panel.plot(pts_k[i::5][:5], color, zorder=z)
    panel.draw()
    return cv.finish(save_path)


def plot_kernel_matrices(k_view, k_obj, k_prod, batch_idx: int = 0,
                         save_path=None) -> np.ndarray:
    """Heatmaps of the view/object/product kernel matrices in 'RdBu_r'
    over -1..1, each with its colorbar, titled with its determinant
    (1500 x 400)."""
    cv = Canvas((15, 4))
    fraction, pad, aspect = 0.15, 0.05, 20.0  # fig.colorbar's defaults
    ramp = colormap("RdBu_r")[:, None, :]
    for k, (box, (mat, name)) in enumerate(zip(cv.subplots(1, 3), (
            (k_view, "view"), (k_obj, "object"), (k_prod, "product")))):
        mat = np.asarray(mat)  # the title's det in the input's dtype
        x0, y0, w, h = box
        parent, bar = grid_boxes((x0, y0, x0 + w, y0 + h), 1, 2,
                                 2 * pad / (1 - pad), 0.0,
                                 [1 - fraction - pad, fraction])
        image_panel(cv, parent, apply_colormap(mat, "RdBu_r", -1.0, 1.0),
                     anchor=(1.0, 0.5))
        bar = fit_box(bar, aspect, anchor=(0.0, 0.5))
        cv.image(bar, ramp, origin="lower")
        cv.frame(bar)
        cv.text[f"Panel {k}"] = (f"{name} kernel. batch {batch_idx}. "
                                 f"det {np.linalg.det(mat):.3e}")
    return cv.finish(save_path)
