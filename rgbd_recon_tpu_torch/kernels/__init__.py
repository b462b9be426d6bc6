"""ctypes wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
on a nonzero CUDA error code, and adds one to a kernel's entry of
:data:`LAUNCHES` for each launch of it (``holefill.fill_cuda`` launches
both fill kernels from one call).
The plain PyTorch twins and the CPU/CUDA dispatch live in ``ops/`` beside
their callers (``ops/stencil13.py``, ``ops/bake.py``, ``ops/gather.py``,
``ops/raymarch.py``, ``ops/holefill.py``, ``ops/hits.py``,
``ops/preprocess.py``, ``ops/compact.py``, ``ops/render_stages.py``,
``ops/bricks.py``, ``ops/tsdf.py``).
"""

from __future__ import annotations

# kernel name -> number of launches in this process (reset_launch_counts()
# zeroes them; a run reads them to show which kernels its path went through)
LAUNCHES = {
    "bilateral13": 0,
    "quality13": 0,
    "surface_occ": 0,
    "sentinel_bake": 0,
    # the render bake's brick clearance and oct hit table (csrc/bake.cu)
    "brick_clearance": 0,
    "oct_table": 0,
    "march": 0,
    # the render's block stages (csrc/compact.cu, csrc/render_stages.cu)
    "compact": 0,
    "scan": 0,
    "block_setup": 0,
    "bracket": 0,
    "hit_gather": 0,
    "compose": 0,
    "holefill_pull": 0,
    "holefill_push": 0,
    "hit_refine": 0,
    "hit_shade": 0,
    # the preprocess chain's passes (csrc/preprocess.cu)
    "morph": 0,
    "lab": 0,
    "depth2": 0,
    "boundary": 0,
    "normals": 0,
    "quality": 0,
    # the fuse's marking and brick-compact integration (csrc/fuse.cu)
    "brick_mark": 0,
    "brick_integrate": 0,
    # the gather-rate probe's kernels (bench/gather_probe.py; on no path)
    "gather_flat": 0,
    "gather_flat_smem": 0,
    "gather_rows": 0,
    "gather_cols": 0,
    # the probe's measure of distributed shared memory (on no path, and
    # behind no ops function)
    "gather_rows_cluster": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
