"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

The sources under csrc/ have a plain C interface (no PyTorch headers), so a
build takes seconds: one nvcc per source, all started together, then one
link. The shared library goes to kernels/_build/ (listed in .gitignore),
named by a hash of the sources and flags: a checkout builds it at first use
and reuses it afterwards. No built library is committed.

    python -m dhg_torch.kernels.build     # build now, print the library path
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
MAX_SMEM = 232448  # bytes of shared memory one block may use on an H100
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdhg_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> list[str]:
    """Wait for every (Popen, what) pair; raise on the first failure."""
    errs = []
    for proc, what in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}):\n{err}")
        errs.append(err)
    return errs


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into one shared library unless it already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    # Write to temporary names, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / f"{s.stem}.o" for s in srcs]
        procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(o), str(s)],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                  s.name) for s, o in zip(srcs, objs)]
        logs = _run(procs)
        lib = tmp / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        logs += _run([(subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), "link")])
        if verbose:
            print("".join(logs), end="")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the library, with every C signature declared."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dhg_error_string.argtypes = [i]
    lib.dhg_error_string.restype = ctypes.c_char_p
    for name in ("dhg_encoder_layer_cluster", "dhg_encoder_layer_rows",
                 "dhg_encoder_layer_smem_bytes"):
        getattr(lib, name).argtypes = [i, i, i]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.dhg_encoder_layer_max_clusters.argtypes = [i, i, i, i]
    lib.dhg_encoder_layer_max_clusters.restype = i
    lib.dhg_fused_encoder_layer.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, p]
    lib.dhg_fused_encoder_layer.restype = i
    lib.dhg_fused_bottleneck.argtypes = [p, p, i, p, p, p, p, i, p, p, i, i, i, i, i, i, p]
    lib.dhg_fused_bottleneck.restype = i
    for name in ("dhg_bottleneck_smem_bytes", "dhg_bottleneck_workspace_elems"):
        getattr(lib, name).argtypes = [i, i, i, i, i]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.dhg_bottleneck_max_clusters.argtypes = [i, i, i, i, i]
    lib.dhg_bottleneck_max_clusters.restype = i
    lib.dhg_fused_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.dhg_fused_attention.restype = i
    lib.dhg_fused_conv_block.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.dhg_fused_conv_block.restype = i
    lib.dhg_conv_block_tile.argtypes = []
    lib.dhg_conv_block_threads.argtypes = [i]
    lib.dhg_conv_block_slots.argtypes = [i, i]
    lib.dhg_conv_block_smem_bytes.argtypes = [i, i]
    lib.dhg_conv_block_smem_bytes.restype = ctypes.c_longlong
    lib.dhg_conv_block_ctas_per_sm.argtypes = [i, i, i]
    for name in ("dhg_unet_t4_cluster", "dhg_unet_t4_rows", "dhg_unet_t4_keys",
                 "dhg_unet_t4_smem_bytes"):
        getattr(lib, name).argtypes = [i] * 6
        getattr(lib, name).restype = ctypes.c_longlong
    lib.dhg_unet_t4_tiles.argtypes = [i, i, i, i]
    lib.dhg_unet_t4_tiles.restype = ctypes.c_longlong
    lib.dhg_unet_t4_max_clusters.argtypes = [i] * 7
    lib.dhg_unet_t4_max_clusters.restype = i
    lib.dhg_fused_unet_t4.argtypes = [p, i, p, i, p] + [i] * 8 + [p]
    lib.dhg_fused_unet_t4.restype = i
    return lib


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: {lib.dhg_error_string(rc).decode()}")


if __name__ == "__main__":
    print(build(verbose=True))
