"""Build and load the package's CUDA kernels (nvcc + ctypes).

Every ``spatialcore_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``), one process per source started together, and linked
into one shared library with a plain C interface, at first use, under
``kernels/_build/``. The library's name carries a hash of
the sources and flags, so an edited ``.cu`` builds anew. ``nvcc``'s output
(with ``-Xptxas -v``: registers, shared memory and spills per kernel) is
kept beside the library as ``<name>.log``.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points and their argument types; each returns cudaGetLastError()
_SIGNATURES = {
    # local_idx, wq, sw, zp, far_ptr, far_q, zf, partial, nb, B, k, gcols,
    # packed, tile, run, chunk, far_cap, stream
    "sct_band_cross_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P],
    # local_idx, w, zp, partial, nb, B, k, G, is_bf16, gt, run, chunk, stream
    "sct_band_cross_float": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    # A, zp, partial, nb, B, G, is_bf16, mt, stages, skip, stream (A4 for
    # rot4)
    "sct_band_cross_dense": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sct_band_cross_rot4": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # local_idx, wq, zp, far_ptr, far_q, zf, far_dense, obs, cnt, nb, B, k,
    # G, far_form, cnt_bytes, stream
    "sct_lisa_count": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _P],
    # local_idx, wq, zp, far_ptr, far_q, zf, far_dense, out, nb, B, k, G,
    # far_form, stream
    "sct_lisa_observed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P],
    # stat, alt, local_idx, wq, zp, far_ptr, far_q, zf, obs, cnt, row_i,
    # row_f, col_a, col_b, lag_o, me_o, inv_m, nb, B, k, G, cnt_bytes, stream
    "sct_local_count": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, ctypes.c_float, _I, _I, _I, _I, _I, _P],
    # stat, local_idx, wq, zp, far_ptr, far_q, zf, row_i, out, nb, B, k, G,
    # stream
    "sct_local_observed": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P],
    # mode, local_idx, wq, zp, far_ptr, far_q, zf, zx, sw, obs, cnt, out,
    # part, nb, B, k, G, cnt_bytes, stream
    "sct_lee": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                _I, _I, _P],
    # coords, n, k, include_self, out_d, out_i, stream
    "sct_knn": [_P, _I, _I, _I, _P, _P, _P],
}

_library: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspatialcore_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The build writes to a temporary name and renames it into place, so
    concurrent processes never load a half-written library. Raises with
    nvcc's output if the compile fails.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    nvcc = _nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objs = [f"{tmp}.{i}.o" for i in range(len(cu))]
    try:
        # one nvcc per source, all started together, then one link
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", o, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *objs],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed.append(link.returncode)
        out.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log[-4000:]}")
        os.replace(tmp, out)
    finally:
        for path in [tmp, *objs]:
            if os.path.exists(path):
                os.unlink(path)
    return out


def build_log() -> str:
    """nvcc's output for the current library (empty if not built here)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library
