"""Build and load the port's CUDA kernels.

Every source under ``csrc/`` is compiled at first use with ``nvcc``, one
process per source, all started together (the headers ``csrc/*.cuh``
they include are hashed with them), and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <tmp>/<source>.o csrc/<source>.cu  # each
    nvcc -shared -o build/repro_torch/librepro_torch-<hash>.so <tmp>/*.o

The library lands in ``build/repro_torch/`` under the repository root,
keyed by a hash of the sources and the flags, so an edit rebuilds. There
is no fallback: without ``nvcc`` the build raises. ``launch`` calls one
of the library's launchers on a device's current stream and raises on
the CUDA error it returns. ``refuse_autograd`` is the wrappers' guard
against a call that autograd would record. The library's
``device_limits_query`` (``csrc/device.cu``) reads the card's limits
(``launch/mesh.py:device_limits``), and ``sgmv_kernel_resources`` and
``flash_kernel_resources`` each kernel instantiation's registers, shared
memory and spills (``analysis/smem.py``).
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

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
    return BUILD_DIR / f"librepro_torch-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library if its hash-keyed file is missing; returns the
    path. When a build happens, ``verbose`` adds ``-Xptxas -v`` and prints
    the compiler's report of registers, shared memory and spills."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, proc in procs:             # wait for every compiler
            report = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{report}")
            elif verbose:
                # analysis: ignore[raw-log] the ptxas report asked for
                print(f"nvcc {name}:\n{report}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(lib, out)             # atomic: concurrent builders agree
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.sgmv_fused_blocks_launch.argtypes = [
                i32, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
            lib.sgmv_fused_blocks_launch.restype = i32
            lib.sgmv_multibank_blocks_launch.argtypes = [
                i32, i32, vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
                ctypes.POINTER(i32), i32, vp, vp, vp, vp, i32, i32, i32, i32,
                vp]
            lib.sgmv_multibank_blocks_launch.restype = i32
            lib.sgmv_shrink_launch.argtypes = [
                i32, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
            lib.sgmv_shrink_launch.restype = i32
            lib.sgmv_expand_launch.argtypes = [
                i32, vp, vp, vp, vp, i32, i32, i32, i32, vp]
            lib.sgmv_expand_launch.restype = i32
            lib.sgmv_multibank_shrink_launch.argtypes = [
                i32, i32, vp, ctypes.POINTER(vp), ctypes.POINTER(i32), i32,
                vp, vp, vp, vp, i32, i32, i32, i32, vp]
            lib.sgmv_multibank_shrink_launch.restype = i32
            lib.sgmv_multibank_expand_launch.argtypes = [
                i32, vp, ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp,
                vp, vp, i32, i32, i32, i32, vp]
            lib.sgmv_multibank_expand_launch.restype = i32
            lib.flash_mha_launch.argtypes = [
                i32, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
                i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, vp]
            lib.flash_mha_launch.restype = i32
            lib.sgmv_cluster_occupancy.argtypes = [
                i32, i32, i32, i32, ctypes.POINTER(i32)]
            lib.sgmv_cluster_occupancy.restype = i32
            i64p = ctypes.POINTER(ctypes.c_longlong)
            lib.sgmv_kernel_resources.argtypes = [i32, i32, i32, i32, i64p]
            lib.sgmv_kernel_resources.restype = i32
            lib.flash_kernel_resources.argtypes = [i32, i32, i32, i32, i64p]
            lib.flash_kernel_resources.restype = i32
            lib.device_limits_query.argtypes = [i32, i64p]
            lib.device_limits_query.restype = i32
            _LIB = lib
        return _LIB


def launch(fn_name: str, device, *args) -> None:
    """Calls the library's launcher ``fn_name`` with ``args`` and the
    current stream of ``device`` (a CUDA device); raises if it returns a
    CUDA error (a launch the card refused never runs)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(load_library(), fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")


def refuse_autograd(kernel: str, *args) -> None:
    """Raise ``RuntimeError`` when autograd would record a call of
    ``kernel``: grad mode is on and a tensor among ``args`` (or in a
    list or tuple of them) requires grad. A kernel writes its output by
    raw pointer into a tensor without a ``grad_fn``, and none has a
    backward (nor has a Pallas kernel of the JAX package a vjp), so the
    gradient would stop there without a word. Every wrapper calls this
    first, whatever the device, so a CPU run refuses what a card run
    would."""
    if not torch.is_grad_enabled():
        return
    stack = list(args)
    while stack:
        a = stack.pop()
        if isinstance(a, (list, tuple)):
            stack.extend(a)
        elif isinstance(a, torch.Tensor) and a.requires_grad:
            raise RuntimeError(
                f"{kernel}: an input requires grad and the kernel has no "
                "backward; train through the plain path (models.model."
                "forward: einsum LoRA, common.flash_attention) or call "
                "it under torch.no_grad()")

