"""One process of a sharded step over a mesh that spans several processes
(counterpart of scripts/multihost_worker.py).

Each process gives ``--devices-per-process`` shards to one global mesh.
Every process builds the same scene (that of scripts/multihost_worker.py:
2 sensors at 48x40 depth, 6.25 cm voxels in 25 cm bricks, a 48x32 camera),
runs one ``shard_pipeline_step`` over the global mesh, and gathers the
volume; process 0 writes ``volume.npy``, ``color.npy``, ``hit.npy``,
``meta.json`` (processes, global devices, the processes the mesh spans,
the step's bytes by collective and process 0's kernel launches in it) and
``done`` into ``--outdir``.

Two processes of 4 CPU shards, gloo:

  python -m rgbd_recon_tpu_torch.dist.worker --process-id 0 \\
      --num-processes 2 --coordinator 127.0.0.1:12655 --outdir mp \\
      --backend gloo --device cpu &
  python -m rgbd_recon_tpu_torch.dist.worker --process-id 1 \\
      --num-processes 2 --coordinator 127.0.0.1:12655 --outdir mp \\
      --backend gloo --device cpu

With ``--device cuda`` process p places its shards on card p modulo the
cards visible: on one card both processes share it (gloo only; NCCL
refuses two ranks on one GPU), on two or more each has its own.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def scene(device, voxel_size: float = 0.0625):
    """(pipeline, frames, camera) of scripts/multihost_worker.py:73-89,
    built by the port on ``device``; another ``voxel_size`` than a whole
    fraction of the 25 cm bricks makes the grid dense (the dense z-sharded
    step)."""
    from ..calib.sensors import build_synthetic_calibration
    from ..core import BoundingBox, PipelineConfig
    from ..ops.raymarch import ViewCamera
    from ..recon.tsdf_pipeline import TsdfPipeline
    from ..sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(num_sensors=2, depth_size=(48, 40),
                           color_size=(64, 48), bbox=bbox)
    calib = build_synthetic_calibration(rig, bbox, cv_res=(16, 24, 16),
                                        inv_res=(32, 36, 32), device=device)
    frames = render_rig_frames(
        SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig, device=device)
    cfg = PipelineConfig(voxel_size=voxel_size, brick_size=0.25,
                         tsdf_limit=0.02, integrate_taps="bilinear",
                         skip_fine_rounds=3, num_lods=4)
    camera = ViewCamera(width=48, height=32, eye=(0.0, 1.3, 2.6),
                        target=(0.0, 1.1, 0.0))
    return TsdfPipeline(calib, cfg, bbox), frames, camera


def main(argv=None, voxel_size: float = 0.0625) -> None:
    """The worker on ``argv``; ``voxel_size`` is the scene's (see
    :func:`scene`: 0.07 runs the dense z-sharded step)."""
    from .. import kernels
    from . import collectives, process
    from .mesh import make_mesh, shard_pipeline_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default="127.0.0.1:12655",
                    help="host:port where process 0 listens")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=process.BACKENDS, required=True)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device available; pass "
                             "--device cpu")
        device = torch.device(
            "cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    process.initialize(args.coordinator, args.num_processes, args.process_id,
                       args.backend)
    try:
        pipe, frames, camera = scene(device, voxel_size)
        mesh = make_mesh(devices_per_process=args.devices_per_process,
                         device=device)
        step = shard_pipeline_step(pipe, camera, mesh)
        step(frames)                                  # warm-up
        collectives.reset_bytes()
        kernels.reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        volume, out = step(frames)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s = time.perf_counter() - t0
        moved = collectives.bytes_moved()
        launched = kernels.launch_counts()
        whole = volume.gather()
        if mesh.process == 0:
            outdir = Path(args.outdir)
            outdir.mkdir(parents=True, exist_ok=True)
            for name, t in (("volume", whole), ("color", out.color),
                            ("hit", out.hit)):
                np.save(outdir / f"{name}.npy", t.cpu().numpy())
            meta = {
                "processes": args.num_processes,
                "devices_per_process": args.devices_per_process,
                "global_devices": mesh.size,
                "process_spans": sorted(set(mesh.processes)),
                "devices": [str(d) for d in mesh.devices],
                "backend": args.backend,
                "compact": pipe.compact,
                "step_seconds": step_s,
                "bytes_per_step": moved,
                "launches_per_step": launched,
            }
            (outdir / "meta.json").write_text(json.dumps(meta, indent=1))
            (outdir / "done").write_text("ok")
        # every process stays until the others are done with the group
        import torch.distributed as tdist

        tdist.barrier()
    finally:
        process.shutdown()


if __name__ == "__main__":
    main()
