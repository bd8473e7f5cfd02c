"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` into
a shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/libsgmv-<hash>.so csrc/sgmv.cu

The library lands in ``build/repro_torch/`` under the repository root,
keyed by a hash of the sources and the flags, so an edit rebuilds. There
is no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if nvcc is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        nvcc = os.path.join(home, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from source at first use")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsgmv-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library if its hash-keyed file is missing; returns the
    path. When a build happens, ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report of registers, shared memory and spills."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC / "sgmv.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)                 # atomic: concurrent builders agree
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.sgmv_fused_blocks_launch.argtypes = [
                i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
            lib.sgmv_fused_blocks_launch.restype = i32
            lib.sgmv_multibank_blocks_launch.argtypes = [
                i32, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
                ctypes.POINTER(i32), i32, vp, vp, vp, i32, i32, i32, i32, vp]
            lib.sgmv_multibank_blocks_launch.restype = i32
            _LIB = lib
        return _LIB
