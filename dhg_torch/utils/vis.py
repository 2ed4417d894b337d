"""Stroke rendering (port of dhg/utils/vis.py) without matplotlib.

The rendering contract is dhg's (reference utils/vis.py:5-49):
  * absolute positions = cumsum of the (dx, dy) deltas;
  * the pen channel is rounded; a 1 at index i means the segment ARRIVING at
    point i was a pen-up move, so point i is excluded from the polyline it
    terminates and starts the next one;
  * anything after the LAST pen-up point is not drawn;
  * the figure is (scale * w/h, scale) inches (width capped at 100), axes
    off, black on white, saved to ./<name>.png.

drawn_segments, compose_lines and strokes_to_svg are dhg's own code (the SVG
string is the same). The PNG has no matplotlib on the card's machine, so
render_strokes rasterises the drawn segments in numpy inside the same figure
geometry: matplotlib's defaults of 100 dpi, subplot box (0.125, 0.11) to
(0.9, 0.88), 5% data margins, 1.5 pt lines, and savefig's tight box with a
0.1 inch pad. The pixels are not matplotlib's (no anti-aliasing); the ink
geometry is. images.write_png writes the file.
"""

from __future__ import annotations

import os

import numpy as np

from dhg_torch.data.images import write_png

DPI = 100  # matplotlib's figure.dpi
LINE_RADIUS = 1.5 * DPI / 72 / 2  # half of lines.linewidth (1.5 pt), in pixels
AXES_BOX = (0.125, 0.11, 0.9, 0.88)  # figure.subplot left, bottom, right, top
MARGIN = 0.05  # axes.xmargin / axes.ymargin
PAD = 0.1 * DPI  # savefig.pad_inches with bbox_inches="tight", in pixels


def drawn_segments(strokes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Absolute points and the drawn-segment mask for a [T, 3] sequence.

    Returns (xy [T, 2] float, draw [T-1] bool) where draw[i] is True iff
    the segment xy[i] -> xy[i+1] is part of the rendered polyline under
    show_strokes' contract (reference utils/vis.py:5-36): segments ending
    at a pen-up point are skipped, and nothing at-or-after the LAST pen-up
    point is drawn. A sequence with no pen-up point draws nothing
    (reference loop quirk). Shared by the PNG renderer, the SVG writer,
    and the metrics rasterizer (dhg.metrics.rasterize_strokes).
    """
    seq = np.asarray(strokes, dtype=float)
    xy = np.cumsum(seq[:, :2], axis=0)
    draw = np.zeros(max(len(seq) - 1, 0), dtype=bool)
    pen_up = np.flatnonzero(seq[:, 2].round() == 1)
    if pen_up.size:
        last = pen_up[-1]
        draw[: max(last - 1, 0)] = True  # segments ending at 1..last-1
        draw[pen_up[pen_up < last] - 1] = False  # ...except into a pen-up
    return xy, draw


def compose_lines(
    lines: list[np.ndarray | None],
    line_gap: float | None = None,
    align: str = "left",
) -> np.ndarray:
    """Merge per-line [T, 3] stroke sequences into ONE page-level sequence.

    Capability superset of the reference (whose renderer draws exactly one
    line, utils/vis.py:5-36): the composition happens in stroke space, so
    the result is itself a valid (dx, dy, pen) sequence and every existing
    renderer (show_strokes PNG, strokes_to_svg, the metrics rasterizer)
    draws the page unchanged.

    Exactness contract: each line is first trimmed to its solo-rendered ink
    (nothing at-or-after its last pen-up point is drawn when the line is
    rendered alone — see drawn_segments), then translated into its line
    slot; the move between lines arrives at a pen-up point, so it is never
    drawn. The composed page therefore draws exactly the union of the
    per-line solo renderings, translated — no more, no less (pinned by
    tests/test_wrap.py).

    lines: per-line sequences, top to bottom. None (or a line that draws
    nothing on its own) still occupies a line slot, i.e. renders as a blank
    line — so paragraph gaps compose naturally.
    line_gap: vertical pitch between consecutive line tops, in stroke
    units. None = 1.3 x the tallest line's ink height.
    align: "left" (default) or "center" per-line horizontal alignment.
    """
    if align not in ("left", "center"):
        raise ValueError(f"unknown align {align!r} (expected left or center)")
    slots: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None] = []
    for seq in lines:
        if seq is None or len(seq) == 0:
            slots.append(None)
            continue
        seq = np.asarray(seq, dtype=float)
        xy, draw = drawn_segments(seq)
        if not draw.any():
            slots.append(None)
            continue
        last = int(np.flatnonzero(seq[:, 2].round() == 1)[-1])
        pts = xy[: last + 1]
        pens = seq[: last + 1, 2].copy()
        # Ink bbox over points that participate in a drawn segment (the
        # trimmed tail keeps undrawn lead-in points; don't let them skew
        # alignment).
        dmask = np.zeros(last + 1, dtype=bool)
        idx = np.flatnonzero(draw[:last])
        dmask[idx] = True
        dmask[idx + 1] = True
        lo, hi = pts[dmask].min(axis=0), pts[dmask].max(axis=0)
        slots.append((pts, pens, lo, hi))

    inked = [s for s in slots if s is not None]
    if not inked:
        # No line draws anything: a single no-op row keeps the result a
        # renderable sequence (an empty figure, same as a solo no-ink line).
        return np.zeros((1, 3))
    heights = [hi[1] - lo[1] for _, _, lo, hi in inked]
    widths = [hi[0] - lo[0] for _, _, lo, hi in inked]
    pitch = float(line_gap) if line_gap is not None else 1.3 * max(max(heights), 1e-6)
    page_w = max(widths)

    out_pts: list[np.ndarray] = []
    out_pens: list[np.ndarray] = []
    for i, item in enumerate(slots):
        if item is None:
            continue
        pts, pens, lo, hi = item
        tx = -lo[0] + (0.5 * (page_w - (hi[0] - lo[0])) if align == "center" else 0.0)
        ty = -(i * pitch) - hi[1]  # ink top of line i sits at y = -i * pitch
        if out_pts:
            # The jump from the previous line ARRIVES at this line's first
            # point; flagging that point pen-up makes the renderer skip the
            # connecting segment and start this line's polyline at it. (The
            # point's original flag only governed a segment that was never
            # drawn solo: nothing arrives at a line's first point.)
            pens = pens.copy()
            pens[0] = 1.0
        out_pts.append(pts + np.array([tx, ty]))
        out_pens.append(pens)

    pts_all = np.concatenate(out_pts, axis=0)
    deltas = np.diff(pts_all, axis=0, prepend=np.zeros((1, 2)))
    return np.concatenate([deltas, np.concatenate(out_pens)[:, None]], axis=1)


def strokes_to_svg(
    strokes: np.ndarray,
    stroke_width: float = 1.5,
    color: str = "black",
    scale: float = 1.0,
    pad: float = 4.0,
) -> str:
    """Render a [T, 3] (dx, dy, pen) sequence to an SVG document string.

    Capability superset of the reference (whose only renderer is the
    matplotlib PNG, utils/vis.py:5-36): strokes are intrinsically vector
    data, so the natural lossless export is a vector format. Ink geometry
    matches show_strokes exactly (same drawn segments; y-up flipped to
    SVG's y-down); one <path> holds every polyline as M/L subpaths.
    """
    xy, draw = drawn_segments(strokes)
    if not draw.any():
        return (
            '<svg xmlns="http://www.w3.org/2000/svg" '
            f'width="{2 * pad:.0f}" height="{2 * pad:.0f}"/>'
        )
    pts = np.concatenate([xy[:-1][draw], xy[1:][draw]], axis=0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    w = (hi[0] - lo[0]) * scale + 2 * pad
    h = max((hi[1] - lo[1]) * scale, 1e-6) + 2 * pad
    to_x = lambda v: pad + (v - lo[0]) * scale
    to_y = lambda v: pad + (hi[1] - v) * scale  # y-up -> y-down

    # Consecutive drawn segments share points: emit one M per run.
    parts: list[str] = []
    pen_down = False
    for i, d in enumerate(draw):
        if not d:
            pen_down = False
            continue
        if not pen_down:
            parts.append(f"M{to_x(xy[i, 0]):.2f} {to_y(xy[i, 1]):.2f}")
            pen_down = True
        parts.append(f"L{to_x(xy[i + 1, 0]):.2f} {to_y(xy[i + 1, 1]):.2f}")
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.2f}" '
        f'height="{h:.2f}" viewBox="0 0 {w:.2f} {h:.2f}">'
        f'<path d="{" ".join(parts)}" fill="none" stroke="{color}" '
        f'stroke-width="{stroke_width}" stroke-linecap="round" '
        'stroke-linejoin="round"/></svg>'
    )


def _limits(lo: float, hi: float) -> tuple[float, float]:
    """Axis limits with the data margins (a flat range widens, as in
    matplotlib's nonsingular limits)."""
    if hi - lo < 1e-12:
        lo, hi = lo - 0.05 * max(abs(lo), 1.0), hi + 0.05 * max(abs(hi), 1.0)
    pad = MARGIN * (hi - lo)
    return lo - pad, hi + pad


def render_strokes(strokes: np.ndarray, scale: int = 1):
    """Rasterise a [T, 3] (dx, dy, pen) sequence as show_strokes draws it.

    Returns (image, to_pixel): a uint8 [H, W] image, ink 0 on white 255,
    cropped to the ink plus the tight-box pad; and a function mapping data
    points [N, 2] to (column, row) pixel coordinates of that image, for
    checking where the ink lies."""
    seq = np.asarray(strokes, dtype=float)
    xy, draw = drawn_segments(seq)
    extent = xy.max(axis=0) - xy.min(axis=0)
    w, h = float(extent[0]), max(float(extent[1]), 1e-6)
    fig_w = int(round(min(scale * w / h, 100.0) * DPI))
    fig_h = int(round(scale * DPI))
    pen_up = np.flatnonzero(seq[:, 2].round() == 1)
    # The plotted points (they set the data limits): everything before the
    # last pen-up point.
    plotted = xy[:pen_up[-1]] if pen_up.size and pen_up[-1] > 0 else xy[:0]
    if plotted.size:
        (xlo, xhi), (ylo, yhi) = (_limits(plotted[:, k].min(), plotted[:, k].max())
                                  for k in (0, 1))
    else:
        (xlo, xhi), (ylo, yhi) = (0.0, 1.0), (0.0, 1.0)
    left, bottom, right, top = AXES_BOX

    def to_figure(p):
        p = np.asarray(p, dtype=float).reshape(-1, 2)
        col = (left + (right - left) * (p[:, 0] - xlo) / (xhi - xlo)) * fig_w
        row = (1.0 - bottom - (top - bottom) * (p[:, 1] - ylo) / (yhi - ylo)) * fig_h
        return np.stack([col, row], axis=1)

    img = np.full((fig_h, fig_w), 255, np.uint8)
    ends = to_figure(np.concatenate([xy[:-1][draw], xy[1:][draw]], axis=0))
    n = int(draw.sum())
    for (c0, r0), (c1, r1) in zip(ends[:n], ends[n:]):
        _stamp_segment(img, c0, r0, c1, r1, LINE_RADIUS)
    ink_rows, ink_cols = np.nonzero(img == 0)
    if ink_rows.size == 0:
        return img, to_figure
    pad = int(np.ceil(PAD))
    r_lo, c_lo = max(ink_rows.min() - pad, 0), max(ink_cols.min() - pad, 0)
    r_hi, c_hi = min(ink_rows.max() + pad + 1, fig_h), min(ink_cols.max() + pad + 1, fig_w)

    def to_pixel(p):
        return to_figure(p) - np.array([c_lo, r_lo], dtype=float)

    return img[r_lo:r_hi, c_lo:c_hi].copy(), to_pixel


def _stamp_segment(img, c0, r0, c1, r1, radius):
    """Ink every pixel whose centre lies within `radius` of the segment."""
    height, width = img.shape
    cs = max(int(np.floor(min(c0, c1) - radius)), 0)
    ce = min(int(np.ceil(max(c0, c1) + radius)), width - 1)
    rs = max(int(np.floor(min(r0, r1) - radius)), 0)
    re = min(int(np.ceil(max(r0, r1) + radius)), height - 1)
    if cs > ce or rs > re:
        return
    pc, pr = np.meshgrid(np.arange(cs, ce + 1) + 0.5, np.arange(rs, re + 1) + 0.5)
    dc, dr = c1 - c0, r1 - r0
    length2 = dc * dc + dr * dr
    t = np.clip(((pc - c0) * dc + (pr - r0) * dr) / length2, 0.0, 1.0) if length2 > 0 else 0.0
    dist2 = (pc - c0 - t * dc) ** 2 + (pr - r0 - t * dr) ** 2
    img[rs:re + 1, cs:ce + 1][dist2 <= radius * radius] = 0


def stamp_segments(img: np.ndarray, a: np.ndarray, b: np.ndarray, radius: float,
                   value=0) -> None:
    """Ink `img` [H, W] in place along the segments a[i] -> b[i] ([N, 2],
    (column, row) in pixels): each sampled about once a pixel, a round pen
    of `radius` pixels stamped at every sample (no anti-aliasing). The
    metrics rasteriser's geometry, which dhg's rasterize_strokes fixes."""
    seg_len = np.hypot(*(b - a).T)
    n = np.ceil(seg_len).astype(int) + 1
    total = int(n.sum())
    seg_idx = np.repeat(np.arange(len(n)), n)
    within = np.arange(total) - np.repeat(np.cumsum(n) - n, n)
    frac = within / np.maximum(np.repeat(n - 1, n), 1)
    dense = a[seg_idx] + frac[:, None] * (b - a)[seg_idx]
    r = max(int(np.ceil(radius)), 1)
    ox, oy = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1))
    disk = (ox**2 + oy**2) <= radius**2 + 0.25
    cx = np.round(dense[:, 0]).astype(int)
    cy = np.round(dense[:, 1]).astype(int)
    height, width = img.shape
    for dx, dy in zip(ox[disk], oy[disk]):
        img[np.clip(cy + dy, 0, height - 1), np.clip(cx + dx, 0, width - 1)] = value


def segments_aa(img: np.ndarray, a: np.ndarray, b: np.ndarray, radius: float,
                value: float = 0.0, piece: float = 6.0) -> None:
    """Ink `img` [H, W] in place along the segments a[i] -> b[i] ([N, 2],
    (column, row), pixel centres at integer coordinates as in cv2) with a
    round pen of `radius` pixels, anti-aliased: a pixel's coverage is
    clip(radius + 0.5 - d, 0, 1), d its distance to the nearest segment (a
    one-pixel ramp across the edge), and it is blended once towards
    `value` (rounded where img is integer). Segments are cut into pieces of
    at most `piece` pixels, each scored over one fixed square window, all
    pieces at once."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n = np.maximum(np.ceil(np.hypot(*(b - a).T) / piece).astype(np.int64), 1)
    seg = np.repeat(np.arange(len(n)), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    d = (b - a)[seg]
    p0 = a[seg] + d * (k / n[seg])[:, None]
    step = (d / n[seg][:, None]).astype(np.float32)  # [P, 2] each piece's own vector
    reach = radius + 1.0
    size = int(np.ceil(piece + 2 * reach)) + 1
    lo = np.floor(np.minimum(p0, p0 + step) - reach).astype(np.int64)  # [P, 2] window corners
    off = np.arange(size, dtype=np.float32)
    start = (lo - p0).astype(np.float32)  # the window's corner relative to the piece's start
    ux = start[:, 0, None, None] + off[None, None, :]  # [P, 1, size]
    uy = start[:, 1, None, None] + off[None, :, None]  # [P, size, 1]
    dc, dr = step[:, 0, None, None], step[:, 1, None, None]
    length2 = dc * dc + dr * dr
    t = np.clip((ux * dc + uy * dr) / np.where(length2 > 0, length2, np.float32(1)), 0, 1)
    dx, dy = ux - t * dc, uy - t * dr
    cover = np.clip(np.float32(radius + 0.5) - np.sqrt(dx * dx + dy * dy), 0, 1)
    height, width = img.shape
    p, i, j = np.nonzero(cover > 0)
    row, col = lo[p, 1] + i, lo[p, 0] + j
    inside = (col >= 0) & (col < width) & (row >= 0) & (row < height)
    alpha = np.zeros(height * width, np.float32)
    np.maximum.at(alpha, (row * width + col)[inside], cover[p, i, j][inside])
    out = img + (value - img.astype(np.float32)) * alpha.reshape(height, width)
    img[...] = np.round(out) if img.dtype.kind in "iu" else out


def save_strokes(
    strokes: np.ndarray,
    name: str,
    fmt: str = "png",
    show_output: bool = False,
    scale: int = 1,
) -> str:
    """Save a stroke sequence as <name>.png (render_strokes) or <name>.svg
    (vector). Relative names save to ./<name>.<fmt>, absolute ones where they
    point. Returns the written path."""
    if show_output:
        raise ValueError("show=True needs a display library, and dhg_torch has none: "
                         "save the file and open it instead")
    if fmt not in ("png", "svg"):
        raise ValueError(f"unknown format {fmt!r} (expected png or svg)")
    target = f"{name}.{fmt}" if os.path.isabs(str(name)) else f"./{name}.{fmt}"
    if fmt == "svg":
        with open(target, "w") as f:
            f.write(strokes_to_svg(strokes, scale=float(scale)))
    else:
        write_png(target, render_strokes(strokes, scale=scale)[0])
    return target
