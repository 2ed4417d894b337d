"""IAM-OnDB stroke parsing, simplification and padding (port of
dhg/data/strokes.py; numpy and the standard library, plus the native scanner
of dhg_torch.native).

  * parse_strokes_xml: <StrokeSet><Stroke><Point x y> -> deltas (dx, -dy);
    the pen-lift marks the last point of each stroke, then the channel is
    rolled by +1 (a stroke that is not drawn has a 1); coordinates divided
    by the std of both delta channels; combine_strokes applied 3 times,
    each pass merging the 20% most collinear consecutive pairs;
  * combine_strokes: cost |a| + |b| - |a + b| over even/odd pairs; the n
    cheapest pairs summed (pen-lift OR'd), then renormalized by the std;
  * pad_stroke_seq: pad to a fixed length with (0, 0, 1) rows; None (the
    line is dropped) if too long or any |coordinate| > 15;
  * parse_lines_txt: the transcription lines after the CSR marker.

`parsed` counts how each file was parsed: "native" (the C++ scanner) or
"fallback" (ElementTree, for a file the scanner declines or without the
library).
"""

from __future__ import annotations

import collections
import threading
import xml.etree.ElementTree as ET
from os import PathLike

import numpy as np

parsed: collections.Counter = collections.Counter()
_parsed_lock = threading.Lock()


def _count(route: str) -> None:
    with _parsed_lock:
        parsed[route] += 1


def parse_strokes_xml(xml_path: PathLike | str) -> np.ndarray:
    """Parse an IAM stroke XML file -> [N, 3] array of (dx, dy, pen_lift).

    The native scanner (dhg_torch.native) parses and runs the 3 combine
    passes in one call when it is built. The ElementTree + numpy path below
    is the reference and the fallback for a file the scanner declines (it
    never guesses: an unexpected structure returns None and lands here).
    """
    from dhg_torch.native import parse_strokes_xml_native

    native = parse_strokes_xml_native(xml_path, passes=3, frac=0.2)
    if native is not None:
        _count("native")
        return native
    _count("fallback")

    root = ET.parse(xml_path).getroot()
    stroke_set = root.find("StrokeSet")
    if stroke_set is None:
        raise ValueError(f"no StrokeSet in {xml_path}")

    # Gather absolute points with per-stroke end markers, file order.
    xs, ys, ends = [], [], []
    for stroke in stroke_set.findall("Stroke"):
        points = stroke.findall("Point")
        for idx, p in enumerate(points):
            xs.append(int(p.attrib["x"]))
            ys.append(int(p.attrib["y"]))
            ends.append(1.0 if idx == len(points) - 1 else 0.0)

    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    ends = np.asarray(ends, dtype=np.float64)

    # Deltas between consecutive points (across stroke boundaries), y negated.
    strokes = np.stack(
        [xs[1:] - xs[:-1], -(ys[1:] - ys[:-1]), ends[1:]], axis=1
    )
    # Roll the pen channel by +1: the segment AFTER a pen-up is "not drawn".
    strokes[:, 2] = np.roll(strokes[:, 2], 1)
    # Normalize by the global std over both delta channels.
    strokes[:, :2] /= np.std(strokes[:, :2])

    return simplify_strokes(strokes, passes=3, frac=0.2)


def simplify_strokes(strokes: np.ndarray, passes: int = 3, frac: float = 0.2) -> np.ndarray:
    """combine_strokes applied `passes` times, each merging frac of pairs.

    Native (dhg_torch.native) when the library is built; the numpy path
    below is the reference (both use a stable cost ordering).
    """
    from dhg_torch.native import simplify_strokes_native

    out = simplify_strokes_native(strokes, passes=passes, frac=frac)
    if out is not None:
        return out
    for _ in range(passes):
        strokes = combine_strokes(strokes, int(len(strokes) * frac))
    return strokes


def combine_strokes(x: np.ndarray, n: int) -> np.ndarray:
    """Merge the n most-collinear consecutive (even, odd) delta pairs.

    Collinearity cost of a pair (a, b) is |a| + |b| - |a + b| (zero iff the
    deltas point the same way); the n cheapest pairs are summed, their
    pen-lift bits OR'd, the odd partner dropped, and the survivors
    re-normalized by the global delta std. Stable cost ordering so ties
    resolve identically in the numpy and native (C++) paths.
    """
    n_pairs = len(x) // 2
    even = x[0 : 2 * n_pairs : 2]
    odd = x[1 : 2 * n_pairs : 2]

    mag = np.sqrt((even[:, :2] ** 2).sum(1))
    mag_next = np.sqrt((odd[:, :2] ** 2).sum(1))
    mag_sum = np.sqrt(((even[:, :2] + odd[:, :2]) ** 2).sum(1))
    cost = mag + mag_next - mag_sum

    merge = np.zeros(n_pairs, dtype=bool)
    merge[np.argsort(cost, kind="stable")[:n]] = True

    merged = even.copy()
    merged[merge, :2] += odd[merge, :2]
    merged[merge, 2] = (even[merge, 2] + odd[merge, 2]) > 0

    # Survivors in original order: merged even rows, odd rows of unmerged
    # pairs, plus the trailing unpaired row when the length is odd.
    out_rows = []
    for p in range(n_pairs):
        out_rows.append(merged[p])
        if not merge[p]:
            out_rows.append(odd[p])
    if len(x) % 2:
        out_rows.append(x[-1])
    out = np.stack(out_rows)
    out[:, :2] /= np.std(out[:, :2])
    return out


def pad_stroke_seq(x: np.ndarray, maxlength: int) -> np.ndarray | None:
    """Pad to [maxlength, 3] with (0, 0, 1) rows; None if too long/out of range."""
    if len(x) > maxlength or np.amax(np.abs(x)) > 15:
        return None
    pad = np.concatenate(
        [np.zeros((maxlength - len(x), 2)), np.ones((maxlength - len(x), 1))], axis=-1
    )
    return np.concatenate([x, pad]).astype(np.float32)


def parse_lines_txt(ascii_path) -> dict[str, str]:
    """Parse an IAM ascii transcription: lines after the CSR marker.

    Returns {"<form>-<nn:02d>": text}. The line counter starts at -1 when
    CSR is seen (skipping CSR's own line and the blank after it), and the
    trailing newline is stripped via line[:-1], as dhg does.
    """
    texts: dict[str, str] = {}
    has_started = False
    lines_num = -1
    stem = str(ascii_path).rsplit("/", 1)[-1].rsplit(".", 1)[0]

    with open(ascii_path) as f:
        for line in f.readlines():
            if "CSR" in line:
                has_started = True
            if has_started:
                if lines_num > 0 and line.strip():
                    texts[f"{stem}-{lines_num:02d}"] = line[:-1]
                lines_num += 1
    return texts
