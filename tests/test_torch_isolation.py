"""The port stands alone: no module of rgbd_recon_tpu_torch (nor
chip_smoke.py) imports the JAX package, jax or flax; its own copies of the
host modules (core/, io/, bench/, calib/scattered.py) agree with the JAX
package's; and the entry points that move data to a device default to the
card and raise without one unless the caller asks for the CPU.

Each package builds its own objects from one set of arguments; files
(.stream recordings, checkpoints) cross between them on disk."""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from rgbd_recon_tpu import core as jax_core
from rgbd_recon_tpu.calib import scattered as jax_scattered
from rgbd_recon_tpu.io import checkpoint as jax_checkpoint
from rgbd_recon_tpu.io import stream as jax_stream
from rgbd_recon_tpu.viz import navigation as jax_navigation

from rgbd_recon_tpu_torch import convert
from rgbd_recon_tpu_torch import core as port_core
from rgbd_recon_tpu_torch import dist
from rgbd_recon_tpu_torch.bench import TimerDatabase
from rgbd_recon_tpu_torch.calib import scattered as port_scattered
from rgbd_recon_tpu_torch.calib.inverter import invert_calibration_bruteforce
from rgbd_recon_tpu_torch.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu_torch.core import camera as port_camera
from rgbd_recon_tpu_torch.io import checkpoint as port_checkpoint
from rgbd_recon_tpu_torch.io import stream as port_stream
from rgbd_recon_tpu_torch.io.feed import FrameFeed
from rgbd_recon_tpu_torch.ops.raymarch import ViewCamera
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import CamParams
from rgbd_recon_tpu_torch.sensors import synthetic as port_synthetic
from rgbd_recon_tpu_torch.viz import OrbitNavigator
from rgbd_recon_tpu_torch.viz import navigation as port_navigation

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(REPO))
    for p in (REPO / "rgbd_recon_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = ("rgbd_recon_tpu", "jax", "flax")

BOX = dict(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
# the verify scene's config and bench.py's reference-exact parity config
CONFIGS = {
    "default": {},
    "verify": dict(voxel_size=0.05, brick_size=0.2, tsdf_limit=0.02,
                   num_lods=5),
    "parity": dict(march_mode="trilinear", march_empty_skip=False,
                   integrate_taps="bilinear", mark_stride=1,
                   projection_model=False, march_dtype="float32"),
}


# ---- 1. no import of the JAX package, jax or flax --------------------------

def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES)
def test_module_imports_nothing_of_jax(path):
    """Every import statement of the module, at any depth (functions
    included), names neither rgbd_recon_tpu (the JAX package), jax nor
    flax; relative imports stay inside the port."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_module_list_is_whole():
    """The walk covers the package's new host copies."""
    for name in ("core/grid.py", "core/camera.py", "core/config.py",
                 "io/stream.py", "io/dxt.py", "io/network.py",
                 "io/checkpoint.py", "io/native.py", "io/feed.py",
                 "bench/timing.py", "refine/pose_ba.py",
                 "calib/scattered.py", "dist/__init__.py",
                 "dist/collectives.py", "dist/halo.py", "dist/mesh.py",
                 "dist/preprocess.py", "dist/process.py", "dist/worker.py",
                 "viz/navigation.py", "viz/preview.py", "viz/jpeg.py",
                 "kernels/gather.py", "ops/gather.py", "kernels/raymarch.py",
                 "kernels/holefill.py", "ops/holefill.py",
                 "kernels/hits.py", "ops/hits.py",
                 "kernels/preprocess.py", "ops/preprocess.py",
                 "kernels/compact.py", "ops/compact.py",
                 "kernels/render_stages.py", "ops/render_stages.py",
                 "ops/stage_calls.py",
                 "bench/gather_probe.py", "bench/headline.py",
                 "bench/oracle.py", "bench/trace.py", "bench/ablation.py",
                 "bench/render_sweep.py", "bench/stages.py",
                 "kernels/fuse.py", "bench/fuse_split.py",
                 "bench/kernel_inputs.py", "profile_slice.py"):
        assert f"rgbd_recon_tpu_torch/{name}" in PORT_FILES, name


# ---- 2. the copies against the JAX package ----------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pipeline_config_matches(name):
    kw = CONFIGS[name]
    want = dataclasses.asdict(jax_core.PipelineConfig(**kw))
    got = dataclasses.asdict(port_core.PipelineConfig(**kw))
    assert got == want


CONF_TEXT = """# reference settings file
voxel_size: 0.01
brick_size : 0.1
tsdf_limit: 0.01
num_lods: 7
bilateral: true
skip_space: false
mark_stride: 3
sensor_ids: 1,2,3
"""
KS_TEXT = "kinect 23.yml\nkinect 24.yml\n\nbbx -1 0 -1 1 2.2 1\n"


def test_parse_conf_matches():
    want = jax_core.parse_conf(CONF_TEXT)
    got = port_core.parse_conf(CONF_TEXT)
    assert got == want and got["sensor_ids"] == [1, 2, 3]
    assert (dataclasses.asdict(port_core.PipelineConfig.from_conf(got))
            == dataclasses.asdict(jax_core.PipelineConfig.from_conf(want)))


@pytest.mark.parametrize("source", ["text", "file"])
def test_parse_ks_matches(tmp_path, source):
    arg = KS_TEXT
    if source == "file":
        arg = tmp_path / "scene.ks"
        arg.write_text(KS_TEXT)
    want = jax_core.parse_ks(arg)
    got = port_core.parse_ks(arg)
    assert type(got.bbox) is port_core.BoundingBox
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("voxel,brick", [(0.01, 0.1), (0.05, 0.2),
                                         (0.0625, 0.25), (0.03, 0.07)])
def test_grids_match(voxel, brick):
    jb, pb = jax_core.BoundingBox(**BOX), port_core.BoundingBox(**BOX)
    jv = jax_core.VolumeGrid(bbox=jb, voxel_size=voxel)
    pv = port_core.VolumeGrid(bbox=pb, voxel_size=voxel)
    jg = jax_core.BrickGrid(bbox=jb, brick_size=brick)
    pg = port_core.BrickGrid(bbox=pb, brick_size=brick)
    assert pv.shape == jv.shape and pv.res == jv.res
    assert pg.shape == jg.shape and pg.num_bricks == jg.num_bricks
    if pv.num_voxels <= 200_000:
        np.testing.assert_array_equal(pg.voxel_to_brick_map(pv),
                                      jg.voxel_to_brick_map(jv))
    p = np.random.default_rng(0).uniform(-1.5, 2.5, (64, 3))
    np.testing.assert_array_equal(pb.normalize(p), jb.normalize(p))
    np.testing.assert_array_equal(pb.denormalize(p), jb.denormalize(p))


@pytest.mark.parametrize("distortion", [(0.0,) * 5,
                                        (0.09, -0.27, 0.001, -0.002, 0.1)])
def test_camera_projection_matches(distortion):
    kw = dict(width=512, height=424, fx=365.0, fy=364.0, cx=255.5, cy=211.2,
              r_cw=tuple(map(tuple, jax_core.camera.look_at_rotation(
                  (1.5, 1.4, 2.0), (0.0, 1.1, 0.0)).tolist())),
              t_cw=(1.5, 1.4, 2.0), distortion=distortion)
    jc = jax_core.PinholeCamera(**kw)
    pc = port_core.PinholeCamera(**kw)
    rng = np.random.default_rng(1)
    world = rng.uniform([-0.8, 0.3, -0.8], [0.8, 1.9, 0.8], (200, 3))
    (juv, jz), (puv, pz) = jc.project(world), pc.project(world)
    np.testing.assert_array_equal(puv, juv)
    np.testing.assert_array_equal(pz, jz)
    np.testing.assert_array_equal(pc.unproject(puv, pz),
                                  jc.unproject(juv, jz))
    np.testing.assert_array_equal(
        port_camera.look_at_rotation((0.3, 1.0, 2.0), (0.0, 1.1, 0.0)),
        jax_core.camera.look_at_rotation((0.3, 1.0, 2.0), (0.0, 1.1, 0.0)))


def _frames(rng, n, dsize, csize):
    (dw, dh), (cw, ch) = dsize, csize
    colors = rng.random((n, ch, cw, 3)).astype(np.float32)
    depths = rng.uniform(0.5, 4.5, (n, dh, dw)).astype(np.float32)
    depths[:, :3, :5] = 0.0
    return colors, depths


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("comp", [dict(), dict(rgb=1), dict(rgb=5),
                                  dict(depth_u8=True)])
def test_stream_files_cross(tmp_path, writer, comp):
    """A .stream file written by one package reads back the same in both
    (raw, DXT1, DXT5 colour; f32 and uint8 depth)."""
    dsize, csize = (40, 32), (48, 40)
    colors, depths = _frames(np.random.default_rng(2), 3, dsize, csize)
    mods = {"jax": jax_stream, "port": port_stream}
    path = tmp_path / "s.stream"
    w = mods[writer]
    with w.StreamWriter(path, compression=w.FrameCompression(**comp)) as f:
        for c, d in zip(colors, depths):
            f.write_frame(c, d)
    reads = {}
    for name, m in mods.items():
        r = m.StreamReader(path, depth_size=dsize, color_size=csize,
                           compression=m.FrameCompression(**comp))
        assert r.num_frames == 3
        reads[name] = [r.read_frame() for _ in range(3)]
    for (pc, pd), (jc, jd) in zip(reads["port"], reads["jax"]):
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pd, jd)
    assert (port_stream.frame_wire_size(
        dsize, csize, port_stream.FrameCompression(**comp))
        == jax_stream.frame_wire_size(
            dsize, csize, jax_stream.FrameCompression(**comp)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross(tmp_path, writer):
    """A checkpoint directory written by one package's CheckpointManager
    is read by the other's, field for field."""
    rng = np.random.default_rng(3)
    mods = {"jax": jax_checkpoint, "port": port_checkpoint}
    cfgs = {"jax": jax_core.PipelineConfig, "port": port_core.PipelineConfig}
    w = mods[writer]
    mgr = w.CheckpointManager(tmp_path, keep=2)
    for i in (1, 2, 3):
        mgr.save(w.ReconCheckpoint(
            volume=rng.normal(size=(4, 5, 6)).astype(np.float32),
            brick_counts=rng.integers(0, 40, (2, 2, 3)).astype(np.int32),
            poses=np.eye(4, dtype=np.float32)[None].repeat(2, 0),
            frame_index=i, timestamp=i / 30.0,
            config_json=w.config_to_json(cfgs[writer](voxel_size=0.05))))
    latest = {n: m.CheckpointManager(tmp_path).latest()
              for n, m in mods.items()}
    assert latest["port"].frame_index == latest["jax"].frame_index == 3
    for f in ("volume", "brick_counts", "poses"):
        np.testing.assert_array_equal(getattr(latest["port"], f),
                                      getattr(latest["jax"], f))
    assert latest["port"].timestamp == latest["jax"].timestamp
    assert latest["port"].config_json == latest["jax"].config_json
    assert len(list(Path(tmp_path).glob("*.npz"))) == 2


def test_native_reader_matches(tmp_path):
    """The port's native replay reader, which it builds with g++ into
    build/native/ (never over the tracked native/libframering.so), decodes
    a file the JAX package wrote like the JAX package's Python reader."""
    from rgbd_recon_tpu_torch.io import native

    tracked = REPO / "native" / "libframering.so"
    before = tracked.stat().st_mtime if tracked.exists() else None
    if not native.available():
        pytest.skip("g++ could not build native/framering.cpp")
    assert native._LIB_PATH == REPO / "build" / "native" / "libframering.so"
    after = tracked.stat().st_mtime if tracked.exists() else None
    assert after == before
    dsize, csize = (10, 8), (16, 12)
    colors, depths = _frames(np.random.default_rng(6), 3, dsize, csize)
    path = tmp_path / "s.stream"
    with jax_stream.StreamWriter(path) as f:
        for c, d in zip(colors, depths):
            f.write_frame(c, d)
    py = jax_stream.StreamReader(path, depth_size=dsize, color_size=csize)
    nat = native.NativeStreamReader(path, depth_size=dsize, color_size=csize)
    try:
        assert nat.num_frames == 3
        for _ in range(4):       # past the end it loops, in order
            (cn, dn), (cp, dp) = nat.read_frame(), py.read_frame()
            np.testing.assert_array_equal(cn, cp)
            np.testing.assert_array_equal(dn, dp)
    finally:
        nat.close()


def _navigate(module):
    """The cameras of an orbit navigator through orbits (one past the
    elevation limit), pans, zooms (one below the minimum distance) and a
    reset, as (eye, target, width, height, fov_y, rotation)."""
    nav = module.OrbitNavigator(poi=(0.1, 1.0, -0.2), distance=2.5,
                                width=96, height=80)
    steps = [lambda n: n, lambda n: n.orbit(0.7, 0.3),
             lambda n: n.pan(0.2, -0.1), lambda n: n.zoom(0.8),
             lambda n: n.orbit(7.0, 2.0), lambda n: n.zoom(0.01),
             lambda n: n.pan(-0.4, 0.3), lambda n: n.reset()]
    out = []
    for step in steps:
        cam = step(nav).camera()
        out.append((cam.eye, cam.target, cam.width, cam.height, cam.fov_y,
                    cam.rotation()))
    return out


def test_orbit_navigator_matches():
    """viz/navigation.py's copy drives the port's ViewCamera through the
    JAX package's navigator's cameras, value for value."""
    assert port_navigation.ViewCamera is ViewCamera
    for got, want in zip(_navigate(port_navigation),
                         _navigate(jax_navigation)):
        assert got[:5] == want[:5]
        np.testing.assert_array_equal(got[5], np.asarray(want[5]))


def test_orbit_navigator_distance_and_target():
    """tests/test_new_components.py:225 on the port's navigator."""
    nav = OrbitNavigator(poi=(0.0, 1.0, 0.0), distance=3.0)
    cam = nav.camera()
    assert np.isclose(np.linalg.norm(np.asarray(cam.eye)
                                     - np.asarray(nav.poi)), 3.0)
    nav.orbit(np.pi / 2, 0.0)
    cam2 = nav.camera()
    assert not np.allclose(cam.eye, cam2.eye)
    assert np.isclose(
        np.linalg.norm(np.asarray(cam2.eye) - np.asarray(nav.poi)), 3.0)


def test_orbit_navigator_zoom_reset():
    """tests/test_new_components.py:239 on the port's navigator."""
    nav = OrbitNavigator(distance=2.0)
    nav.zoom(0.5)
    assert np.isclose(nav.distance, 1.0)
    nav.pan(0.3, -0.1)
    nav.reset()
    assert np.isclose(nav.distance, 2.0)
    assert np.allclose(nav.poi, (0.0, 1.1, 0.0))


@pytest.mark.parametrize("fn", ["idw", "mls", "mls_degenerate", "lookup"])
def test_scattered_matches(fn):
    """calib/scattered.py's copy gives the JAX package's values bit for
    bit: IDW, MLS (and its IDW fallback on coplanar neighbourhoods) and the
    lookup-volume builder."""
    rng = np.random.default_rng(8)
    pos = rng.uniform(0, 1, (120, 3))
    val = rng.uniform(-1, 1, (120, 2))
    q = rng.uniform(0, 1, (40, 3))
    if fn == "mls_degenerate":
        pos[:, 2] = 0.5       # every neighbourhood coplanar
    calls = {
        "idw": lambda m: m.idw_interpolate(pos, val, q, k=6),
        "mls": lambda m: m.mls_interpolate(pos, val, q, k=12),
        "mls_degenerate": lambda m: m.mls_interpolate(pos, val, q, k=12),
        "lookup": lambda m: m.build_lookup_volume(
            pos, val, (5, 4, 3), np.zeros(3), np.ones(3)),
    }
    np.testing.assert_array_equal(calls[fn](port_scattered),
                                  calls[fn](jax_scattered))


def test_volume_binary_matches(tmp_path):
    vol = np.random.default_rng(4).normal(size=(3, 4, 5)).astype(np.float32)
    port_checkpoint.save_volume_binary(tmp_path / "p.vol", vol, (0.5, 4.5))
    jax_checkpoint.save_volume_binary(tmp_path / "j.vol", vol, (0.5, 4.5))
    assert ((tmp_path / "p.vol").read_bytes()
            == (tmp_path / "j.vol").read_bytes())


def test_timer_database_writes_csv(tmp_path):
    db = TimerDatabase()
    for _ in range(3):
        with db.time("1preprocess+2integrate"):
            pass
    text = db.write_csv(tmp_path / "t.csv")
    assert (tmp_path / "t.csv").read_text().split() == text.split()
    assert text.splitlines()[1].startswith("1preprocess+2integrate,")


# ---- 3. entry points run on the card unless the caller asks for the CPU ---

def _rig():
    return port_synthetic.default_test_rig(
        num_sensors=1, depth_size=(16, 12), color_size=(16, 12),
        bbox=port_core.BoundingBox(**BOX))


def _container_arrays():
    rig = _rig()
    calib = build_synthetic_calibration(
        rig, port_core.BoundingBox(**BOX), cv_res=(4, 4, 4),
        inv_res=(4, 4, 4), device="cpu")
    return convert.field_arrays(calib)


ENTRY_POINTS = {
    "build_synthetic_calibration": lambda: build_synthetic_calibration(
        _rig(), port_core.BoundingBox(**BOX), cv_res=(4, 4, 4),
        inv_res=(4, 4, 4)),
    "render_rig_frames": lambda: port_synthetic.render_rig_frames(
        port_synthetic.SyntheticScene(spheres=[((0.0, 1.1, 0.0), 0.55)]),
        _rig()),
    "CamParams.from_camera": lambda: CamParams.from_camera(
        ViewCamera(width=8, height=6), port_core.BoundingBox(**BOX)),
    "CamParams.from_matrix": lambda: CamParams.from_matrix(
        np.eye(4, dtype=np.float32), port_core.BoundingBox(**BOX)),
    "FrameFeed": lambda: FrameFeed(lambda: None),
    "make_mesh": lambda: dist.make_mesh(),
    "invert_calibration_bruteforce": lambda: invert_calibration_bruteforce(
        np.zeros((2, 2, 2, 3), np.float32), port_core.BoundingBox(**BOX),
        (2, 2, 2)),
    "calibration_from_numpy": lambda: convert.calibration_from_numpy(
        _container_arrays()),
    "frames_from_numpy": lambda: convert.frames_from_numpy(dict(
        colors=np.zeros((1, 2, 2, 3), np.float32),
        depths=np.zeros((1, 2, 2), np.float32),
        timestamp=np.zeros((), np.float32))),
    "pixel_models_from_numpy": lambda: convert.pixel_models_from_numpy(
        {f.name: np.zeros(1, np.float32)
         for f in dataclasses.fields(convert.PixelModels)}),
    "projection_models_from_numpy":
        lambda: convert.projection_models_from_numpy(
            {f.name: np.zeros(1, np.float32)
             for f in dataclasses.fields(convert.ProjectionModels)}),
    "sensor_maps_from_numpy": lambda: convert.sensor_maps_from_numpy(
        {f.name: np.zeros(1, np.float32)
         for f in dataclasses.fields(convert.SensorMaps)}),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_a_card_by_default(name):
    """Called without ``device`` the entry point targets the card; with no
    card it raises (and never quietly runs on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_entry_points_default_to_cuda():
    import inspect

    from rgbd_recon_tpu_torch import device

    assert device.DEFAULT == torch.device("cuda")
    fns = [build_synthetic_calibration, port_synthetic.render_rig_frames,
           CamParams.from_camera, CamParams.from_matrix, FrameFeed.__init__,
           convert.calibration_from_numpy, convert.frames_from_numpy,
           convert.pixel_models_from_numpy,
           convert.projection_models_from_numpy,
           convert.sensor_maps_from_numpy, invert_calibration_bruteforce]
    for fn in fns:
        default = inspect.signature(fn).parameters["device"].default
        assert default == torch.device("cuda"), fn.__qualname__


def test_cpu_when_asked():
    feed = FrameFeed(lambda: (0.0, np.zeros((1, 2, 2, 3)), np.ones((1, 2, 2))),
                     device="cpu", mode="ordered")
    try:
        frames = feed.get(timeout=10.0)
    finally:
        feed.close()
    assert frames.depths.device.type == "cpu"
    assert float(frames.depths.sum()) == 4.0
    cam = CamParams.from_matrix(np.eye(4, dtype=np.float32),
                                port_core.BoundingBox(**BOX), device="cpu")
    assert cam.eye_w.device.type == "cpu"
