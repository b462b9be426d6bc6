"""The port's mesh over several processes (rgbd_recon_tpu_torch/dist/
process.py, the worker ``python -m rgbd_recon_tpu_torch.dist.worker``):
two gloo processes of 4 CPU shards each run the sharded step over one
8-shard mesh, as tests/test_multihost.py runs the JAX package's over
jax.distributed.

- against the port's single process (8 shards, and one device): volume,
  colour and hit mask bit-equal (the collectives only move bytes; the psum
  adds in shard order on the receiver);
- against the JAX package's single device on the same scene:
  tests/test_multihost.py's tolerances (volume rtol 1e-5 / atol 1e-6,
  colour rtol 1e-4 / atol 1e-5, hit masks equal);
- the dense z-sharded step (7 cm voxels) across the two processes:
  bit-equal to the port's single device;
- the collectives across processes, each against the single process's;
- the backend check: NCCL with two ranks on one GPU raises.

Each worker runs with one thread and a free port; the test kills them past
180 s.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rgbd_recon_tpu.calib.sensors import (
    build_synthetic_calibration as jax_calibration,
)
from rgbd_recon_tpu.core.config import PipelineConfig as JaxConfig
from rgbd_recon_tpu.core.grid import BoundingBox as JaxBox
from rgbd_recon_tpu.ops.raymarch import ViewCamera as JaxCamera
from rgbd_recon_tpu.recon import TsdfPipeline as JaxPipeline
from rgbd_recon_tpu.sensors import synthetic as jax_synthetic

from rgbd_recon_tpu_torch import dist
from rgbd_recon_tpu_torch.dist import collectives, process
from rgbd_recon_tpu_torch.dist.worker import scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _launch(argvs):
    """Run one process per argv (a list of arguments after the python
    executable) to the end; kill them all past TIMEOUT_S. Returns their
    outputs."""
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for argv in argvs]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


# the worker's entry point at another voxel size than its scene's
WORKER_AT = ("import sys; from rgbd_recon_tpu_torch.dist import worker; "
             "worker.main(sys.argv[2:], voxel_size=float(sys.argv[1]))")


def _workers(outdir, voxel_size=None):
    """Two gloo worker processes of 4 CPU shards each, through the worker's
    module or, at another ``voxel_size``, its ``main``; (meta, arrays)."""
    port = _free_port()
    entry = (["-m", "rgbd_recon_tpu_torch.dist.worker"] if voxel_size is None
             else ["-c", WORKER_AT, str(voxel_size)])
    _launch([[*entry, "--process-id", str(i), "--num-processes", "2",
              "--coordinator", f"127.0.0.1:{port}", "--outdir", str(outdir),
              "--backend", "gloo", "--device", "cpu"] for i in range(2)])
    assert (outdir / "done").exists()
    meta = json.loads((outdir / "meta.json").read_text())
    return meta, {k: np.load(outdir / f"{k}.npy")
                  for k in ("volume", "color", "hit")}


@pytest.fixture(scope="module")
def compact(tmp_path_factory):
    return _workers(tmp_path_factory.mktemp("mp"))


def _single(voxel_size=0.0625):
    """The port's single device and single-process 8-shard step on the
    worker's scene: ((volume, color, hit), the same of the 8 shards)."""
    pipe, frames, camera = scene("cpu", voxel_size)
    vol, maps, counts = pipe.fuse(frames)
    out = pipe.make_renderer(camera)(vol, maps, counts)
    vol8, out8 = dist.shard_pipeline_step(
        pipe, camera, dist.make_mesh(8, device="cpu"))(frames)
    return ((vol, out.color, out.hit), (vol8.gather(), out8.color, out8.hit))


def test_mesh_spans_both_processes(compact):
    meta, _ = compact
    assert meta["processes"] == 2 and meta["global_devices"] == 8
    assert meta["process_spans"] == [0, 1], "the mesh must span both"
    assert meta["backend"] == "gloo" and meta["compact"]
    moved = meta["bytes_per_step"]
    # the gathers and the halo cross processes; CPU tensors need no host
    # staging
    assert moved["between_processes"]["all_gather"] > 0
    assert moved["between_processes"]["halo"] > 0
    assert not any(moved["through_host"].values())
    assert not any(moved["between_devices"].values())


def test_two_processes_bit_equal_to_one(compact):
    _, got = compact
    for ref in _single():
        for name, want in zip(("volume", "color", "hit"), ref):
            np.testing.assert_array_equal(got[name], want.numpy(),
                                          err_msg=name)


def test_two_processes_match_the_jax_single_device(compact):
    """tests/test_multihost.py's reference and tolerances."""
    _, got = compact
    bbox = JaxBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = jax_synthetic.default_test_rig(
        num_sensors=2, depth_size=(48, 40), color_size=(64, 48), bbox=bbox)
    calib = jax_calibration(rig, bbox, cv_res=(16, 24, 16),
                            inv_res=(32, 36, 32))
    frames = jax_synthetic.render_rig_frames(
        jax_synthetic.SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]), rig)
    cfg = JaxConfig(voxel_size=0.0625, brick_size=0.25, tsdf_limit=0.02,
                    integrate_taps="bilinear", skip_fine_rounds=3,
                    num_lods=4)
    pipe = JaxPipeline(calib, cfg, bbox)
    camera = JaxCamera(width=48, height=32, eye=(0.0, 1.3, 2.6),
                       target=(0.0, 1.1, 0.0))
    volume, maps, counts = pipe.fuse(frames)
    out = pipe.make_renderer(camera)(volume, maps, counts)
    np.testing.assert_allclose(got["volume"], np.asarray(volume),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["color"], np.asarray(out.color),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["hit"], np.asarray(out.hit))


def test_dense_step_over_two_processes(tmp_path):
    """7 cm voxels in 25 cm bricks: the dense z-sharded step (Z = 29
    padded to 32 over the 8 shards), bit-equal to the single device."""
    meta, got = _workers(tmp_path, 0.07)
    assert not meta["compact"] and meta["process_spans"] == [0, 1]
    (vol, color, hit), _ = _single(0.07)
    assert vol.shape[0] == 29
    for name, want in (("volume", vol), ("color", color), ("hit", hit)):
        np.testing.assert_array_equal(got[name], want.numpy(), err_msg=name)


# one process of the collectives check: 3 shards each, gloo, CPU; process
# 0 saves what every collective gave it
COLLECTIVES = r"""
import sys
import numpy as np
import torch
from rgbd_recon_tpu_torch import dist
from rgbd_recon_tpu_torch.dist import collectives, halo_exchange_z
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.initialize(f"127.0.0.1:{port}", 2, rank, "gloo")
try:
    mesh = dist.make_mesh(devices_per_process=3, device="cpu")
    assert mesh.local == tuple(range(3 * rank, 3 * rank + 3)), mesh
    rng = np.random.default_rng(0)
    parts = torch.from_numpy((rng.standard_normal((6, 5))
                              * 10.0 ** rng.integers(-6, 6, (6, 5))
                              ).astype(np.float32))
    slabs = torch.arange(6 * 4 * 2, dtype=torch.float32).reshape(6, 4, 2)
    mine = list(mesh.local)
    cpu = torch.device("cpu")
    res = {
        "psum": collectives.psum([parts[s] for s in mine], cpu, mesh=mesh),
        "gather": collectives.all_gather(
            [parts[s].reshape(1, 5) > 0 for s in mine], cpu, mesh=mesh),
        "gather_bf16": collectives.all_gather(
            [parts[s].to(torch.bfloat16) for s in mine], cpu, mesh=mesh),
    }
    for h in (1, 3):
        for fill in (None, -1.0):
            ext = halo_exchange_z([slabs[s] for s in mine], h, fill=fill,
                                  mesh=mesh)
            res[f"halo{h}_{fill}"] = torch.stack(ext)
    if rank == 0:
        np.savez(out, **{k: v.float().numpy() for k, v in res.items()},
                 moved=np.array(repr(collectives.bytes_moved())))
finally:
    dist.shutdown()
"""


def test_collectives_across_processes(tmp_path):
    """psum (shard order, on the receiver: float sums of values 12 decades
    apart reassociate visibly), all_gather of bool and bf16 parts, and the
    halo exchange at halo 1 and 3, edge-repeated and filled, each equal to
    the single process's on the same six shards."""
    port = _free_port()
    out = tmp_path / "collectives.npz"
    _launch([["-c", COLLECTIVES, str(i), str(port), str(out)]
             for i in range(2)])
    got = np.load(out)
    rng = np.random.default_rng(0)
    parts = torch.from_numpy((rng.standard_normal((6, 5))
                              * 10.0 ** rng.integers(-6, 6, (6, 5))
                              ).astype(np.float32))
    slabs = torch.arange(6 * 4 * 2, dtype=torch.float32).reshape(6, 4, 2)
    cpu = torch.device("cpu")
    want = {
        "psum": collectives.psum(list(parts), cpu),
        "gather": collectives.all_gather(
            [p.reshape(1, 5) > 0 for p in parts], cpu),
        "gather_bf16": collectives.all_gather(
            [p.to(torch.bfloat16) for p in parts], cpu),
    }
    for h in (1, 3):
        for fill in (None, -1.0):
            want[f"halo{h}_{fill}"] = torch.stack(
                dist.halo_exchange_z(list(slabs), h, fill=fill))[:3]
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.float().numpy(), err_msg=k)
    moved = eval(str(got["moved"]))
    # process 0 received shards 3-5's parts: 3 x 20 bytes in the sum
    assert moved["between_processes"]["psum"] == 60
    assert moved["between_shards"]["psum"] == 100


def test_nccl_refuses_two_ranks_on_one_gpu():
    gpu = [("host", "cuda", "GPU-a")] * 4
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU"):
        process.check_backend("nccl", [gpu, gpu])
    process.check_backend("nccl", [gpu, [("host", "cuda", "GPU-b")] * 4])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        process.check_backend("nccl", [[("host", "cpu", "cpu")]] * 2)
    process.check_backend("gloo", [gpu, gpu])
    process.check_backend("gloo", [[("host", "cpu", "cpu")]] * 2)


def test_process_entry_points_reject():
    """A backend the caller did not pick from the two, a rank outside the
    group, NCCL without a card, a spanning mesh before the group exists or
    without this process's devices."""
    with pytest.raises(ValueError, match="backend"):
        process.initialize("127.0.0.1:1", 2, 0, "mpi")
    with pytest.raises(ValueError, match="process_id"):
        process.initialize("127.0.0.1:1", 2, 2, "gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            process.initialize("127.0.0.1:1", 2, 0, "nccl")
    with pytest.raises(RuntimeError, match="dist.initialize"):
        dist.make_mesh(devices_per_process=4, device="cpu")
    with pytest.raises(ValueError, match="device= or devices="):
        dist.make_mesh(devices_per_process=4)


def test_single_process_forms_refuse_a_spanning_mesh():
    """shard_preprocess and refine_poses(mesh=...) run over a mesh of one
    process; over several they raise, naming their ROADMAP item."""
    from rgbd_recon_tpu_torch.refine import pose_ba

    pipe, frames, _ = scene("cpu")
    mesh = dist.Mesh((torch.device("cpu"),) * 4, processes=(0, 0, 1, 1))
    assert mesh.multiprocess and mesh.local == (0, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dist.shard_preprocess(pipe, mesh)
    volume, maps, _ = pipe.fuse(frames)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pose_ba.refine_poses(pipe.calib, maps, volume, 0.02, iters=1,
                             mesh=mesh)
