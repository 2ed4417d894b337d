"""The port's stroke rendering and text wrapping against dhg's, on the CPU.

(e) strokes_to_svg string-equal to dhg's; drawn_segments and compose_lines
equal to dhg's; wrap_text equal to dhg's; the PNG writer's output read back
exactly; and the ink of a rendered PNG lies on the drawn segments (every
ink pixel within the line's half-width of a drawn segment, every drawn
segment's midpoint inked), in matplotlib's figure geometry. Pixels are not
compared with matplotlib's: it anti-aliases, the port does not.
"""

import numpy as np
import pytest

from dhg.inference import wrap_text as jax_wrap_text
from dhg.utils import vis as jvis
from dhg_torch.data.images import read_png, write_png
from dhg_torch.inference import wrap_text
from dhg_torch.utils import vis


def _strokes(seed, n=120, pen_rate=0.15):
    rng = np.random.RandomState(seed)
    seq = np.concatenate([rng.randn(n, 2) * [1.0, 0.4], (rng.rand(n, 1) < pen_rate)], axis=1)
    seq[-1, 2] = 1.0
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_and_svg_match_dhg(seed):
    seq = _strokes(seed)
    xy, draw = vis.drawn_segments(seq)
    jxy, jdraw = jvis.drawn_segments(seq)
    np.testing.assert_array_equal(xy, jxy)
    np.testing.assert_array_equal(draw, jdraw)
    for kw in ({}, {"scale": 2.5, "stroke_width": 3.0, "color": "navy", "pad": 1.0}):
        assert vis.strokes_to_svg(seq, **kw) == jvis.strokes_to_svg(seq, **kw)
    no_ink = seq.copy()
    no_ink[:, 2] = 0
    assert vis.strokes_to_svg(no_ink) == jvis.strokes_to_svg(no_ink)


@pytest.mark.parametrize("align,gap", [("left", None), ("center", 7.5)])
def test_compose_lines_matches_dhg(align, gap):
    lines = [_strokes(3, 40), None, _strokes(4, 60), np.zeros((5, 3))]
    np.testing.assert_array_equal(vis.compose_lines(lines, line_gap=gap, align=align),
                                  jvis.compose_lines(lines, line_gap=gap, align=align))
    with pytest.raises(ValueError, match="align"):
        vis.compose_lines(lines, align="right")


@pytest.mark.parametrize("text,width", [("the quick brown fox jumps over", 10),
                                        ("para one\n\nsupercalifragilistic two", 7), ("", 3)])
def test_wrap_text_matches_dhg(text, width):
    assert wrap_text(text, width) == jax_wrap_text(text, width)


def test_png_writer_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    for shape in ((7, 9), (5, 11, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        write_png(tmp_path / "a.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / "a.png").reshape(shape), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "b.png", np.zeros((2, 2, 4), np.uint8))


def _seg_dist(p, a, b):
    """Distance from points p [N, 2] to the segment a-b."""
    d = b - a
    t = np.clip(((p - a) @ d) / max(d @ d, 1e-12), 0.0, 1.0)
    return np.linalg.norm(p - (a + t[:, None] * d), axis=1)


@pytest.mark.parametrize("seed,scale", [(5, 1), (6, 2)])
def test_rendered_ink_lies_on_drawn_segments(tmp_path, seed, scale):
    seq = _strokes(seed, n=60)
    path = vis.save_strokes(seq, str(tmp_path / "line"), fmt="png", scale=scale)
    img = read_png(path)[..., 0]
    ref, to_pixel = vis.render_strokes(seq, scale=scale)
    np.testing.assert_array_equal(img, ref)
    assert set(np.unique(img)) == {0, 255}
    xy, draw = vis.drawn_segments(seq)
    a, b = to_pixel(xy[:-1][draw]), to_pixel(xy[1:][draw])
    rows, cols = np.nonzero(img == 0)
    centres = np.stack([cols + 0.5, rows + 0.5], axis=1)
    nearest = np.min([_seg_dist(centres, p, q) for p, q in zip(a, b)], axis=0)
    assert nearest.max() <= vis.LINE_RADIUS + 1e-9
    mids = np.floor((a + b) / 2).astype(int)
    assert np.all(img[mids[:, 1], mids[:, 0]] == 0)
    # matplotlib's figure contract: (scale * w/h) by scale inches at 100 dpi
    # before the tight crop, which keeps the pad around the ink.
    assert img.shape[0] <= 100 * scale
    assert np.all(img[:10] == 255) and np.all(img[:, :10] == 255)


def test_save_strokes_svg_and_refusals(tmp_path):
    seq = _strokes(7)
    path = vis.save_strokes(seq, str(tmp_path / "page"), fmt="svg", scale=2)
    jpath = jvis.save_strokes(seq, str(tmp_path / "jpage"), fmt="svg", scale=2)
    assert open(path).read() == open(jpath).read()
    with pytest.raises(ValueError, match="display"):
        vis.save_strokes(seq, str(tmp_path / "x"), show_output=True)
    with pytest.raises(ValueError, match="unknown format"):
        vis.save_strokes(seq, str(tmp_path / "x"), fmt="gif")
