"""Build and load the port's CUDA library (route: nvcc -> shared library with
a plain C interface -> ctypes).

The library is compiled from `svgpvae_tpu_torch/csrc/*.cu` at first use,
into `svgpvae_tpu_torch/_build/` (listed in .gitignore), under a name keyed
by the sources' hash, so an edited source is never served by a stale build.
Each source is compiled by its own nvcc process, all started together, and
the objects are then linked into one shared library.
Nothing here runs at import time: the CPU tests import every module, and
the CPU has no nvcc.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "svgp_error_string": ([_I], ctypes.c_char_p),
    "svgp_stats_plan": ([_I, _I, _I, _PI], _I),
    "svgp_stats_info": ([_I, _I, _I, _I, _I, _PI], _I),
    "svgp_gp_stats": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _PI, _P], _I),
    "svgp_fused_kernel_stats": ([_P, _P, _P, _P, _I, _I, _F, _F, _I, _I,
                                 _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _PI, _P], _I),
    "svgp_chol_inverse_plan": ([_I, _PI], _I),
    "svgp_chol_inverse_info": ([_I, _I, _PI, _PI], _I),
    "svgp_chol_inverse": ([_P, _P, _P, _P, _I, _I, _PI, _P], _I),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of svgpvae_tpu_torch are built with it at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails, after every one has ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def _compile(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(work, s.stem + ".o") for s in srcs]
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(s)]
                  for s, o in zip(srcs, objs)])
        tmp = os.path.join(work, target.name)
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, target)  # atomic: never a half-written library


def load() -> ctypes.CDLL:
    """The compiled library, building it first if this source has no build."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libsvgp_kernels_{_digest()}.so"
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = load().svgp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
