"""Application shell of the port (counterpart of rgbd_recon_tpu/app.py):
the kinect_client / calib_inverter equivalents, headless.

  python -m rgbd_recon_tpu_torch.app run scene.ks --conf settings.conf \
      [--streams recordings/] [--frames N] [--out out/] [--mode M] \
      [--device cuda|cpu]
        -> reconstruction loop: stream/synthetic frames -> TSDF fusion ->
           the mode's renderer -> PNGs + stage-timing CSV

  python -m rgbd_recon_tpu_torch.app invert scene.ks --voxel-size 0.01 --out dir/
        -> offline inverse-calibration baking (calib_inverter.cpp:12-75)

  python -m rgbd_recon_tpu_torch.app record --out dir/ --frames N
        -> synthesize a test scene into reference-format .stream files

  python -m rgbd_recon_tpu_torch.app warm
        -> build the CUDA kernels (nvcc) into build/kernels/

``run`` computes on ``--device`` (default ``cuda``); without a CUDA device
it exits non-zero unless ``--device cpu`` is given. The flags are the JAX
app's (CMDParser style, kinect_client.cpp:870-885).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

def _device(name: str) -> torch.device:
    from .device import resolve

    try:
        return resolve(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}") from None


def _load_scene(ks_path, conf_path=None):
    from .core.config import PipelineConfig, parse_conf, parse_ks

    scene = parse_ks(ks_path)
    config = PipelineConfig()
    if conf_path:
        config = PipelineConfig.from_conf(parse_conf(Path(conf_path).read_text()))
    return scene, config


def _build_calibration(scene, device, cv_res=(128, 256, 128), inv_res=None,
                       voxel_size=0.01, depth_size=(128, 106),
                       color_size=(160, 128)):
    """The scene's CalibrationSet on ``device``: pre-baked .cv_xyz / .cv_uv
    / .cv_xyz_inv volumes when present, else an analytic bake of the .yml
    files, else (no calibration on disk) a synthetic rig of the scene's
    sensor count."""
    from .core.camera import SensorRig

    from .calib.frustum import frustum_from_cv_xyz
    from .calib.kinect_yml import parse_kinect_yml
    from .calib.sensors import CalibrationSet, build_synthetic_calibration
    from .calib.volume_io import read_calibration_volume

    base = Path(scene.base_dir)
    baked, sensors, missing = [], [], []
    for name in scene.calib_files:
        yml = base / name
        stem = str(yml.with_suffix(""))
        cvx, cvu, cvi = (Path(stem + ".cv_xyz"), Path(stem + ".cv_uv"),
                         Path(stem + ".cv_xyz_inv"))
        if cvx.exists() and cvu.exists() and cvi.exists():
            baked.append((cvx, cvu, cvi))
        elif yml.exists():
            sensors.append(parse_kinect_yml(yml).to_rgbd_sensor())
        else:
            missing.append(name)

    if missing and not (baked or sensors):
        from .sensors.synthetic import default_test_rig

        print(f"warning: no calibration files found for {missing}; using a "
              "synthetic rig", file=sys.stderr)
        rig = default_test_rig(num_sensors=len(missing), bbox=scene.bbox,
                               depth_size=tuple(depth_size),
                               color_size=tuple(color_size))
        sensors = list(rig.sensors)
    elif missing:
        raise FileNotFoundError(f"no calibration for {missing}")

    if baked and not sensors:
        xs, us, invs, lims, cams = [], [], [], [], []
        for cvx, cvu, cvi in baked:
            vx, lim = read_calibration_volume(cvx, channels=3)
            xs.append(vx)
            us.append(read_calibration_volume(cvu, channels=2)[0])
            invs.append(read_calibration_volume(cvi, channels=4)[0])
            lims.append(lim)
            cams.append(frustum_from_cv_xyz(vx).camera_position())

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return CalibrationSet(
            cv_xyz=t(np.stack(xs)), cv_uv=t(np.stack(us)),
            cv_xyz_inv=t(np.stack(invs)),
            depth_limits=t(np.array(lims, np.float32)),
            camera_positions=t(np.stack(cams)),
            bbox_min=t(np.array(scene.bbox.min, np.float32)),
            bbox_max=t(np.array(scene.bbox.max, np.float32)),
        )
    if sensors:
        rig = SensorRig(sensors=tuple(sensors))
        if inv_res is None:
            inv_res = tuple(int(np.ceil(s / voxel_size))
                            for s in scene.bbox.size)
        return build_synthetic_calibration(rig, scene.bbox, cv_res, inv_res,
                                           device=device)
    raise ValueError("scene has no usable calibrations")


def _wire_compressions(args, scene, num_sensors):
    """Per-sensor wire encodings, from each sensor's calibration flags
    (NetKinectArray.cpp:120-144); --stream-compression / --stream-depth-u8
    override all."""
    from .io.stream import RAW, FrameCompression

    from .calib.kinect_yml import parse_kinect_yml

    if args.stream_compression != "raw" or args.stream_depth_u8:
        override = FrameCompression(
            rgb={"raw": 0, "dxt1": 1, "dxt5": 5}[args.stream_compression],
            depth_u8=args.stream_depth_u8,
        )
        return [override] * num_sensors
    base = Path(scene.base_dir)
    out = []
    for name in scene.calib_files:
        yml = base / name
        comp = RAW
        if yml.exists():
            cal = parse_kinect_yml(yml)
            if cal.compressed_rgb or cal.compressed_depth:
                comp = FrameCompression.from_calibration(cal)
                print(f"wire compression from {name}: {comp}",
                      file=sys.stderr)
        out.append(comp)
    return out + [RAW] * (num_sensors - len(out))


def _stream_source(args, num_sensors, compressions):
    """.stream replay: every frame in order, through the native GIL-free
    reader when it builds (native/framering.cpp), else the Python one."""
    from .io import native as native_io
    from .io.stream import StreamReader

    use_native = not args.no_native_ingest and native_io.available()
    paths = sorted(Path(args.streams).glob("*.stream"))
    if len(paths) < num_sensors:
        raise FileNotFoundError(
            f"need {num_sensors} .stream files in {args.streams}")
    reader = native_io.NativeStreamReader if use_native else StreamReader
    readers = [reader(p, depth_size=tuple(args.depth_size),
                      color_size=tuple(args.color_size),
                      compression=compressions[i])
               for i, p in enumerate(paths[:num_sensors])]
    if use_native:
        print("replay through native framering", file=sys.stderr)
    clock = [0.0]

    def source():
        colors, depths = zip(*(r.read_frame() for r in readers))
        ts = clock[0]
        clock[0] += 1.0 / 30.0
        return ts, np.stack(colors), np.stack(depths)

    return source


def _synthetic_source(args, scene, num_sensors):
    """A sphere circling the box center, rendered for a synthetic rig."""
    from .sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    rig = default_test_rig(num_sensors=num_sensors,
                           depth_size=tuple(args.depth_size),
                           color_size=tuple(args.color_size), bbox=scene.bbox)
    clock = [0.0]

    def source():
        t = clock[0]
        clock[0] += 1.0 / 30.0
        sc = SyntheticScene(
            spheres=[((0.25 * np.sin(t), 1.1, 0.25 * np.cos(t)), 0.55)])
        # host frames: the feed copies them to the device
        fr = render_rig_frames(sc, rig, t, device="cpu")
        return t, fr.colors.numpy(), fr.depths.numpy()

    return source


def _warn_overflow(diag: dict) -> None:
    """Capacity-overflow warnings: a fixed capacity dropped geometry or
    pixels this frame."""
    if diag.get("bricks_dropped", 0):
        print(f"WARNING: {diag['bricks_dropped']} occupied bricks beyond "
              f"brick_capacity={diag['brick_capacity']} were dropped — raise "
              "PipelineConfig.brick_capacity", file=sys.stderr)
    for key, knob in (
        ("blocks_dropped", "ray_compaction"),
        ("phase2_rays_dropped", "march tail capacity"),
        ("hits_dropped", "hit_compaction"),
        ("oct_bricks_dropped", "brick_capacity (oct table)"),
    ):
        if diag.get(key, 0):
            print(f"WARNING: {diag[key]} {key} this frame — raise "
                  f"PipelineConfig.{knob}", file=sys.stderr)


def cmd_run(args):
    from .bench import TimerDatabase
    from .io.checkpoint import (
        CheckpointManager,
        ReconCheckpoint,
        config_to_json,
    )

    from .io.feed import FrameFeed
    from .ops.raymarch import ViewCamera
    from .recon import (
        CalibVisPipeline,
        MvtPipeline,
        PointsPipeline,
        TrigridPipeline,
        TsdfPipeline,
    )
    from .recon.tsdf_pipeline import CamParams
    from .viz import save_image
    from .viz.stereo import StereoCamera, make_stereo_renderer

    device = _device(args.device)
    scene, config = _load_scene(args.scene, args.conf)
    if args.mode is not None:
        config.recon_mode = args.mode
    calib = _build_calibration(
        scene, device, inv_res=args.inv_res, voxel_size=config.voxel_size,
        depth_size=tuple(args.depth_size), color_size=tuple(args.color_size),
    )
    num_sensors = calib.num_sensors
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    pipe = TsdfPipeline(calib, config, scene.bbox)
    center = scene.bbox.center
    camera = ViewCamera(
        width=args.width, height=args.height,
        eye=(center[0], center[1] + 0.2, center[2] + 2.6),
        target=tuple(center.tolist()),
    )
    if args.stereo != "mono":
        # anaglyph / side-by-side output (kinect_client.cpp:612-673)
        stereo = make_stereo_renderer(
            pipe.make_renderer, StereoCamera(cyclops=camera), mode=args.stereo)

        def tsdf_render(volume, maps, counts, cam_pose=None):
            return stereo(volume, maps, counts), None
    else:
        mono = pipe.make_renderer(camera)

        def tsdf_render(volume, maps, counts, cam_pose=None):
            out = mono(volume, maps, counts, camera_pose=cam_pose)
            return out.color, out
    points_renderer = PointsPipeline(calib, config).make_renderer(camera)
    trigrid_renderer = TrigridPipeline(calib, config).make_renderer(camera)
    mvt_renderer = MvtPipeline(calib, config).make_renderer(camera)
    calibvis_renderer = CalibVisPipeline(
        pipe.volume_grid, config.tsdf_limit).make_renderer(camera)

    ckpt_mgr = (CheckpointManager(args.checkpoint_dir)
                if args.checkpoint_dir else None)

    # frame source: ZMQ stream, .stream replay, or synthetic, pumped
    # through FrameFeed so host decode overlaps the device step. Live
    # network sources drop to the latest frame; replay and synthetic
    # sources deliver every frame in order.
    compressions = _wire_compressions(args, scene, num_sensors)
    zmq_source = None
    feed_mode = "ordered"
    if args.zmq:
        from .io.network import ZmqFrameSource

        feed_mode = "latest"
        zmq_source = ZmqFrameSource(
            args.zmq, num_sensors, depth_size=tuple(args.depth_size),
            color_size=tuple(args.color_size), endpoint_slave=args.zmq_slave,
            compression=compressions,
        )
        source = zmq_source.latest
    elif args.streams:
        source = _stream_source(args, num_sensors, compressions)
    else:
        source = _synthetic_source(args, scene, num_sensors)

    # control plane: the remote feedback channel drives recon_mode, the
    # stream slot and the render-camera pose live (FeedbackReceiver +
    # kinect_client.cpp:637-673)
    fbr = None
    if args.feedback:
        from .io.network import FeedbackReceiver

        fbr = FeedbackReceiver(args.feedback)
        print(f"feedback channel on {args.feedback}", file=sys.stderr)

    sync = torch.cuda.synchronize if device.type == "cuda" else None
    db = TimerDatabase()
    n_done = 0
    start_frame = 0
    if ckpt_mgr is not None and args.resume:
        resumed = ckpt_mgr.latest()
        if resumed is not None:
            start_frame = resumed.frame_index
            print(f"resuming at frame {start_frame}", file=sys.stderr)

    preview = None
    if args.preview_port:
        from .viz.preview import PreviewServer

        preview = PreviewServer(port=args.preview_port)
        print(f"live preview: http://localhost:{preview.port}/",
              file=sys.stderr)

    feed = FrameFeed(source, device=device, mode=feed_mode)
    start = time.time()
    try:
        while True:
            if args.frames and n_done >= args.frames:
                break
            if config.time_limit and time.time() - start > config.time_limit:
                break
            # the first frame may wait on the source's warm-up
            frames = feed.get(timeout=120.0 if n_done == 0 else 10.0)
            if frames is None:
                print("frame source idle; stopping", file=sys.stderr)
                break
            ts = float(frames.timestamp)

            # live control from the feedback channel (kinect_client.cpp:
            # 637-673; NetKinectArray.cpp:766-771)
            cam_pose = None
            if fbr is not None and fbr.seq > 0:
                fb = fbr.get()
                if int(fb.recon_mode) != config.recon_mode:
                    print(f"feedback: recon_mode -> {int(fb.recon_mode)}",
                          file=sys.stderr)
                config.recon_mode = int(fb.recon_mode)
                if zmq_source is not None:
                    zmq_source.stream_slot = int(fb.stream_slot) % 2
                cam_pose = CamParams.from_matrix(fb.cyclops_mat, scene.bbox,
                                                 device)

            render_out = None
            with db.time("1preprocess+2integrate", sync=sync):
                volume, maps, counts = pipe.fuse(frames)
            with db.time("3recon", sync=sync):
                if config.recon_mode == 0:
                    img = points_renderer(maps)[0]
                elif config.recon_mode == 2:
                    img = trigrid_renderer(maps)[0]
                elif config.recon_mode == 3:
                    img = mvt_renderer(maps)[0]
                elif config.recon_mode == 4:
                    img = calibvis_renderer(volume)[0]
                else:
                    img, render_out = tsdf_render(volume, maps, counts,
                                                  cam_pose)
            if args.save_renders:
                save_image(out_dir / f"frame_{n_done:04d}.png", img)
            if preview is not None:
                # live MJPEG preview (the reference's viewer window,
                # kinect_client.cpp:583-716, as a browser stream)
                preview.update(img)
            n_done += 1
            if ckpt_mgr is not None and n_done % args.checkpoint_every == 0:
                ckpt_mgr.save(ReconCheckpoint(
                    volume=volume.cpu().numpy(),
                    brick_counts=counts.cpu().numpy(),
                    frame_index=start_frame + n_done,
                    timestamp=ts,
                    config_json=config_to_json(config),
                ))
            if (args.refine_every and config.recon_mode == 1
                    and n_done % args.refine_every == args.refine_every - 1):
                # sensor-pose drift correction against the leave-one-out
                # consensus, folded into the calibration for later frames
                poses, _ = pipe.refine_sensor_poses(maps, counts)
                norms = torch.linalg.norm(poses[:, 3:], dim=1).cpu().numpy()
                print(f"refined sensor poses; translation corrections (mm): "
                      f"{np.round(norms * 1000, 2)}", file=sys.stderr)
            if n_done % 10 == 1 and config.recon_mode == 1:
                _warn_overflow(pipe.diagnostics(counts, render_out))
            print(f"frame {n_done} t={ts:.2f}", file=sys.stderr)
    finally:
        produced = feed.frames_produced
        feed.close()
        if zmq_source is not None:
            zmq_source.close()
        if fbr is not None:
            fbr.close()
        if preview is not None:
            preview.close()
    print(db.write_csv(out_dir / "timings.csv"), file=sys.stderr)
    if feed_mode == "latest":
        dropped = max(0, produced - n_done)
        print(f"processed {n_done} frames ({dropped} dropped to keep latest) "
              f"-> {out_dir}")
    else:
        print(f"processed {n_done} frames (in order) -> {out_dir}")


def cmd_invert(args):
    """Offline inverse-calibration baking (source/calib_inverter.cpp)."""
    from .core.config import parse_ks

    from .calib.inverter import invert_calibration_knn
    from .calib.volume_io import (
        read_calibration_volume,
        write_calibration_volume,
    )

    scene = parse_ks(args.scene)
    base = Path(scene.base_dir)
    res = tuple(int(np.ceil(s / args.voxel_size)) for s in scene.bbox.size)
    out_dir = Path(args.out or base)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in scene.calib_files:
        cv_path = Path(str((base / name).with_suffix("")) + ".cv_xyz")
        vol, limits = read_calibration_volume(cv_path, channels=3)
        print(f"inverting {cv_path} at res {res}", file=sys.stderr)
        inv = invert_calibration_knn(vol, scene.bbox, res)
        out_path = out_dir / (cv_path.name + "_inv")
        write_calibration_volume(out_path, inv, limits)
        print(f"wrote {out_path}")


def cmd_warm(args):
    """Build the CUDA kernels (there is no compile cache to warm beyond
    the kernel library)."""
    from .kernels import _build

    print(f"kernels: {_build.build()}")


def cmd_record(args):
    """Synthesize a moving-sphere sequence into .stream files."""
    from .core.grid import BoundingBox
    from .io.stream import FrameCompression, StreamWriter

    from .sensors.synthetic import (
        SyntheticScene,
        default_test_rig,
        render_rig_frames,
    )

    bbox = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
    rig = default_test_rig(
        num_sensors=args.sensors, depth_size=tuple(args.depth_size),
        color_size=tuple(args.color_size), bbox=bbox)
    compression = FrameCompression(
        rgb={"raw": 0, "dxt1": 1, "dxt5": 5}[args.compress],
        depth_u8=args.compress_depth_u8,
        near=rig.sensors[0].depth.near, far=rig.sensors[0].depth.far,
    )
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    writers = [
        StreamWriter(out / f"{s.serial or f'sensor{i}'}.stream",
                     compression=compression)
        for i, s in enumerate(rig.sensors)
    ]
    try:
        for f in range(args.frames):
            t = f / 30.0
            scene = SyntheticScene(
                spheres=[((0.25 * np.sin(t), 1.1, 0.25 * np.cos(t)), 0.55)])
            fr = render_rig_frames(scene, rig, t, device="cpu")
            for i, w in enumerate(writers):
                w.write_frame(fr.colors[i].numpy(), fr.depths[i].numpy())
            print(f"recorded frame {f}", file=sys.stderr)
    finally:
        for w in writers:
            w.close()
    print(f"wrote {len(writers)} stream files x {args.frames} frames -> {out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="rgbd_recon_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="reconstruction loop")
    pr.add_argument("scene", help=".ks scene file")
    pr.add_argument("--conf", help=".conf settings file")
    pr.add_argument("--device", default="cuda",
                    help="torch device to compute on (default cuda; the "
                         "app exits if it has no CUDA device and cpu was "
                         "not asked for)")
    pr.add_argument("--streams", help="directory of .stream recordings")
    pr.add_argument("--zmq", default=None,
                    help="ZMQ SUB endpoint for live frames, e.g. "
                         "tcp://127.0.0.1:7000 (master)")
    pr.add_argument("--zmq-slave", default=None,
                    help="secondary ZMQ endpoint (stream-slot switch)")
    pr.add_argument("--feedback", default=None,
                    help="ZMQ SUB endpoint of the feedback control channel "
                         "(drives recon_mode / stream slot / camera pose "
                         "live, like the reference's FeedbackReceiver)")
    pr.add_argument("--no-native-ingest", action="store_true",
                    help="force the pure-Python .stream reader even when "
                         "the native framering library builds")
    pr.add_argument("--stream-compression", default="raw",
                    choices=["raw", "dxt1", "dxt5"],
                    help="wire color encoding of --streams/--zmq frames")
    pr.add_argument("--stream-depth-u8", action="store_true",
                    help="wire depth is uint8 sqrt-compressed")
    pr.add_argument("--refine-every", type=int, default=0,
                    help="sensor-pose refinement every N frames in mode 1 "
                         "(0: never)")
    pr.add_argument("--frames", type=int, default=10)
    pr.add_argument("--mode", type=int, default=None,
                    help="recon mode override (0 points, 1 tsdf, 2 trigrid, "
                         "3 mvt, 4 calib vis)")
    pr.add_argument("--stereo", default="mono",
                    choices=["mono", "anaglyph", "side-by-side"],
                    help="stereo output mode (tsdf mode only)")
    pr.add_argument("--checkpoint-dir", default=None,
                    help="enable rotating checkpoints in this directory")
    pr.add_argument("--checkpoint-every", type=int, default=10)
    pr.add_argument("--resume", action="store_true",
                    help="resume frame cursor from the latest checkpoint")
    pr.add_argument("--preview-port", type=int, default=0,
                    help="serve a live MJPEG preview of the render on "
                         "http://<host>:PORT/ (0 = off)")
    pr.add_argument("--out", default="out")
    pr.add_argument("--width", type=int, default=640)
    pr.add_argument("--height", type=int, default=360)
    pr.add_argument("--depth-size", type=int, nargs=2, default=(128, 106))
    pr.add_argument("--color-size", type=int, nargs=2, default=(160, 128))
    pr.add_argument("--inv-res", type=int, nargs=3, default=None)
    pr.add_argument("--save-renders", action="store_true", default=True)
    pr.set_defaults(fn=cmd_run)

    pi = sub.add_parser("invert", help="bake inverse calibration volumes")
    pi.add_argument("scene", help=".ks scene file")
    pi.add_argument("--voxel-size", type=float, default=0.01)
    pi.add_argument("--out")
    pi.set_defaults(fn=cmd_invert)

    pw = sub.add_parser("warm", help="build the CUDA kernels (nvcc)")
    pw.set_defaults(fn=cmd_warm)

    pc = sub.add_parser("record", help="synthesize .stream recordings")
    pc.add_argument("--out", default="recordings")
    pc.add_argument("--frames", type=int, default=30)
    pc.add_argument("--sensors", type=int, default=4)
    pc.add_argument("--depth-size", type=int, nargs=2, default=(128, 106))
    pc.add_argument("--color-size", type=int, nargs=2, default=(160, 128))
    pc.add_argument("--compress", default="raw",
                    choices=["raw", "dxt1", "dxt5"],
                    help="color wire encoding of the recorded streams")
    pc.add_argument("--compress-depth-u8", action="store_true",
                    help="record uint8 sqrt-compressed depth")
    pc.set_defaults(fn=cmd_record)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
