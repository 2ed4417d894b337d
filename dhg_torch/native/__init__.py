"""The stroke scanner in C++ (the port's copy of dhg/native), bound via ctypes.

stroke_ops.cpp is byte for byte dhg's: a targeted IAM stroke-XML scanner and
the three combine_strokes passes, one native call per line of the cache
build. It is built with g++ at first use into native/_build/ (listed in
.gitignore), named by a hash of the source and flags, under a lock, written
to a temporary name and renamed. DHG_NATIVE=0 disables it; without g++ the
callers in dhg_torch.data.strokes take their numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).parent / "stroke_ops.cpp"
BUILD_DIR = Path(__file__).parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lib: ctypes.CDLL | None = None
_tried = False
_load_lock = threading.Lock()  # the cache build's worker threads race here


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"_stroke_ops_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native build unavailable: %s", e)
        return False
    if res.returncode != 0:
        logger.warning("native build failed:\n%s", res.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> ctypes.CDLL | None:
    """The native library (built on first call), or None when DHG_NATIVE=0
    or it cannot be built. Thread-safe: the first callers serialize on a
    lock, so one g++ runs."""
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        return _get_lib_locked()


def _get_lib_locked() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("DHG_NATIVE", "1") != "1":
        return None
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        logger.warning("native load failed: %s", e)
        return None

    dbl_p = ctypes.POINTER(ctypes.c_double)
    lib.dhg_simplify_strokes.argtypes = [dbl_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_double, dbl_p]
    lib.dhg_simplify_strokes.restype = ctypes.c_int64
    lib.dhg_combine_strokes.argtypes = [dbl_p, ctypes.c_int64, ctypes.c_int64, dbl_p]
    lib.dhg_combine_strokes.restype = ctypes.c_int64
    lib.dhg_parse_strokes_xml.argtypes = [ctypes.c_char_p, ctypes.c_int64, dbl_p,
                                          ctypes.c_int64]
    lib.dhg_parse_strokes_xml.restype = ctypes.c_int64
    lib.dhg_parse_and_simplify.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_double, dbl_p, ctypes.c_int64]
    lib.dhg_parse_and_simplify.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def simplify_strokes_native(xyz: np.ndarray, passes: int = 3, frac: float = 0.2):
    """The combine passes natively; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    out = np.empty_like(xyz)
    n_out = lib.dhg_simplify_strokes(_as_c(xyz), xyz.shape[0], passes, frac, _as_c(out))
    return out[:n_out].copy()


def combine_strokes_native(xyz: np.ndarray, n_merge: int):
    """One native combine pass; None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    out = np.empty_like(xyz)
    n_out = lib.dhg_combine_strokes(_as_c(xyz), xyz.shape[0], n_merge, _as_c(out))
    return out[:n_out].copy()


def parse_strokes_xml_native(path, passes: int | None = None, frac: float = 0.2):
    """An IAM stroke XML -> [N, 3] normalized (dx, -dy, pen) deltas, natively.

    passes=None parses only; passes=k also runs k combine passes in the same
    call. Returns None when the library is unavailable or the scanner
    declines the file (no StrokeSet, a malformed tag or coordinate, fewer
    than 2 points): the caller then takes the ElementTree path, so the fast
    path never parses a file differently."""
    lib = get_lib()
    if lib is None:
        return None
    data = Path(path).read_bytes()
    max_rows = data.count(b"<Point") + 1  # an upper bound (comments may count)
    if max_rows < 2:
        return None
    out = np.empty((max_rows, 3), dtype=np.float64)
    if passes is None:
        n = lib.dhg_parse_strokes_xml(data, len(data), _as_c(out), max_rows)
    else:
        n = lib.dhg_parse_and_simplify(data, len(data), passes, frac, _as_c(out), max_rows)
    if n < 0:
        return None
    return out[:n].copy()
