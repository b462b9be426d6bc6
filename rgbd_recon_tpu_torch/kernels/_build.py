"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

The sources under ``rgbd_recon_tpu_torch/csrc/`` have a plain C interface
(pointers, ints and a stream; each entry point returns ``cudaGetLastError()``)
and compile, one nvcc process per source, all started together, into objects
linked as one shared library under ``build/kernels/`` at the root of the
checkout. Each source's ``ptxas -v`` report (registers, shared memory, spills
per kernel) is kept beside it as ``<source>.ptxas.txt``. The build runs at
the first kernel launch of a process, never at import: the CPU tests import
every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / f for f in ("stencil13.cu", "bake.cu",
                                              "gather.cu", "march.cu",
                                              "holefill.cu", "hits.cu",
                                              "preprocess.cu", "compact.cu",
                                              "render_stages.cu",
                                              "fuse.cu"))
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIBRARY = BUILD_DIR / "librgbd_kernels.so"

# No fast math (IEEE division and square roots) and no FMA contraction:
# the kernels then round every operation like the plain PyTorch versions.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
_PI = ctypes.POINTER(_I)
# entry point -> argtypes (all return int, the CUDA error code)
_SIGNATURES = {
    "rgbd_bilateral13": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "rgbd_quality13": (_P, _P, _P, _I, _I, _I, _P),
    "rgbd_surface_occ": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "rgbd_sentinel_bake": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P),
    "rgbd_brick_clearance": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rgbd_oct_table": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rgbd_gather_flat": (_P, _P, _P, _I, _I, _P),
    "rgbd_gather_flat_smem": (_P, _P, _P, _I, _I, _P),
    "rgbd_gather_flat_smem_plan": (_I, _I, ctypes.POINTER(_I)),
    "rgbd_gather_smem_entries": (ctypes.POINTER(_I),),
    "rgbd_gather_rows": (_P, _P, _P, _I, _I, _I, _P),
    "rgbd_gather_rows_cluster": (_P, _P, _P, _I, _I, _I, _P),
    "rgbd_gather_rows_cluster_plan": (_I, _I, _I, ctypes.POINTER(_I)),
    "rgbd_gather_cols": (_P, _P, _P, _I, _I, _I, _P),
    "rgbd_march": (_P, _I, _I, _I, _I, _LL, _LL, _I, _LL, _I, _I, _I, _I,
                   _F, _F, _F, _P),
    "rgbd_march_rows": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _I, _F, _F, _F, _P),
    "rgbd_compact": (_P, _I, _I, _I, _P, _P, _P, _P, _P),
    "rgbd_compact_scratch_words": (),
    # a pointer to the parameter block (kernels/render_stages.py) and the
    # stream
    "rgbd_render_scan": (_P, _P),
    "rgbd_render_scan_plan": (_P, _PI),
    "rgbd_render_block_setup": (_P, _P),
    "rgbd_render_block_setup_plan": (_P, _PI),
    "rgbd_render_bracket": (_P, _P),
    "rgbd_render_bracket_plan": (_P, _PI),
    "rgbd_render_hit_gather": (_P, _P),
    "rgbd_render_hit_gather_plan": (_P, _PI),
    "rgbd_render_compose": (_P, _P),
    "rgbd_render_params_size": (ctypes.POINTER(_I),),
    "rgbd_holefill_pull": (_LL, _LL, _LL, _P, _LL, _PI, _I, _I, _I, _PI,
                           _P),
    "rgbd_holefill_push": (_LL, _LL, _LL, _LL, _PI, _PI, _I, _I, _I, _P, _P,
                           _P, _I, _I, _P),
    "rgbd_holefill_fill": (_LL, _LL, _LL, _P, _LL, _PI, _PI, _I, _I, _I, _P,
                           _P, _I, _I, _PI, _P),
    # a pointer to the parameter block (kernels/hits.py) and the stream
    "rgbd_hit_refine": (_P, _P),
    "rgbd_hit_refine_plan": (_I, _PI),
    "rgbd_hit_shade": (_P, _P),
    "rgbd_hit_shade_plan": (_I, _PI),
    "rgbd_hit_params_sizes": (ctypes.POINTER(_I),),
    "rgbd_pre_morph": (_P, _P, _I, _I, _I, _P),
    "rgbd_pre_morph_plan": (_P, _P, _I, _I, _I, _PI),
    "rgbd_pre_lab": (_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P),
    "rgbd_pre_depth2": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _P),
    "rgbd_pre_boundary": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "rgbd_pre_normals": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rgbd_pre_quality": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # a pointer to the parameter block (kernels/fuse.py) and the stream
    "rgbd_brick_mark": (_P, _P),
    "rgbd_brick_mark_plan": (_P, _PI),
    "rgbd_brick_integrate": (_P, _P),
    "rgbd_brick_integrate_plan": (_P, _PI),
    "rgbd_fuse_params_sizes": (_PI,),
    "rgbd_fuse_attrs": (_I, _PI),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's nvcc run, if it ran


def find_nvcc() -> str:
    """nvcc from CUDA_HOME (as PyTorch resolves it) or from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(s.stat().st_mtime > built for s in SOURCES)


def _run(cmd, what: str) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stderr}")
    return res


def build() -> Path:
    """Compile the library if it is missing or older than its sources."""
    global build_seconds
    if not _stale():
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        jobs = [pool.submit(_run, [nvcc, *COMPILE_FLAGS, "-c", "-o", str(o),
                                   str(s)], s.name)
                for s, o in zip(SOURCES, objs)]
    for s, job in zip(SOURCES, jobs):
        (BUILD_DIR / f"{s.stem}.ptxas.txt").write_text(job.result().stderr)
    tmp = LIBRARY.with_suffix(f".{tag}.tmp")
    _run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
         "the link")
    for o in objs:
        o.unlink()
    os.replace(tmp, LIBRARY)
    build_seconds = time.perf_counter() - t0
    return LIBRARY


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero CUDA error code returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
