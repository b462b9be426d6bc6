"""The port's application shell (``python -m rgbd_recon_tpu_torch.app``) on
the CPU: ``record`` then ``run`` in all five modes, stereo output with
checkpoints, resuming from a checkpoint the JAX app wrote, ``invert``, the
options that are not ported, the CUDA requirement, and one run of both apps
on the same recordings and calibration volumes, image for image.

Scene: 2 synthetic sensors at 40x32 depth / 48x40 color recorded into
.stream files (2 frames), a 48x40 camera, 10 cm voxels in 50 cm bricks
(tests/test_app.py's sizes).

Tolerance of the app-against-app run: decoded PNG bytes within 1 level of
255 (a float within f32 rounding of a level boundary truncates to either
side) except at most APP_KNIFE_EDGE_PIXELS pixels (the knife-edge pixels of
tests/test_torch_recon_modes.py and tests/test_torch_render.py: a fragment
or hit that the JAX CPU compiler's FMA contraction moves across a pixel).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from rgbd_recon_tpu.app import main as jax_main
from rgbd_recon_tpu.calib.sensors import build_synthetic_calibration
from rgbd_recon_tpu.core import BoundingBox
from rgbd_recon_tpu.io import CheckpointManager
from rgbd_recon_tpu.sensors.synthetic import default_test_rig

from rgbd_recon_tpu_torch import app
from rgbd_recon_tpu_torch.calib.volume_io import write_calibration_volume

APP_KNIFE_EDGE_PIXELS = 16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BBOX = BoundingBox(min=(-1.0, 0.0, -1.0), max=(1.0, 2.2, 1.0))
SIZES = ["--depth-size", "40", "32", "--color-size", "48", "40"]
CONF = "voxel_size: 0.1\nbrick_size: 0.5\ntsdf_limit: 0.02\nrecon_mode: 1\n"


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Recordings made by the port's ``record``, a .ks whose sensors have
    no calibration on disk (a synthetic rig is baked), and a .ks whose
    calibration volumes were baked by the JAX package (both apps load
    them)."""
    root = tmp_path_factory.mktemp("app")
    rec = root / "rec"
    app.main(["record", "--out", str(rec), "--frames", "2", "--sensors", "2",
              *SIZES])
    (root / "s.conf").write_text(CONF)
    (root / "synth.ks").write_text(
        "kinect a.yml\nkinect b.yml\nbbx -1 0 -1 1 2.2 1\n")
    rig = default_test_rig(num_sensors=2, depth_size=(40, 32),
                           color_size=(48, 40), bbox=BBOX)
    calib = build_synthetic_calibration(rig, BBOX, cv_res=(16, 24, 16),
                                        inv_res=(24, 26, 24))
    lines = []
    for i, name in enumerate(("a", "b")):
        lim = tuple(np.asarray(calib.depth_limits[i]).tolist())
        for ext, field in (("cv_xyz", "cv_xyz"), ("cv_uv", "cv_uv"),
                           ("cv_xyz_inv", "cv_xyz_inv")):
            write_calibration_volume(root / f"{name}.{ext}",
                                     np.asarray(getattr(calib, field)[i]),
                                     lim)
        lines.append(f"kinect {name}.yml")
    (root / "baked.ks").write_text("\n".join(lines)
                                   + "\nbbx -1 0 -1 1 2.2 1\n")
    return root


def _run_args(scene, ks, out, *extra):
    return ["run", str(scene / ks), "--conf", str(scene / "s.conf"),
            "--streams", str(scene / "rec"), "--no-native-ingest",
            "--frames", "2", "--out", str(out), "--width", "48",
            "--height", "40", *SIZES, "--inv-res", "24", "26", "24", *extra]


def test_record_writes_streams(scene):
    streams = sorted((scene / "rec").glob("*.stream"))
    assert [p.name for p in streams] == ["synth0.stream", "synth1.stream"]


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_run_every_mode(scene, tmp_path, mode):
    out = tmp_path / "out"
    app.main(_run_args(scene, "synth.ks", out, "--device", "cpu",
                       "--mode", str(mode)))
    csv = (out / "timings.csv").read_text()
    assert "1preprocess+2integrate" in csv and "3recon" in csv
    renders = sorted(out.glob("frame_*.png"))
    assert len(renders) == 2
    img = _png(renders[1])
    assert img.shape == (40, 48, 3)
    if mode in (0, 1, 4):
        # (trigrid and MVT keep no triangle at this grid size with the
        # reference's min_length, in either package)
        assert (img.sum(-1) > 0).sum() > 10


@pytest.mark.parametrize("stereo,width", [("anaglyph", 48),
                                          ("side-by-side", 96)])
def test_run_stereo_with_checkpoints(scene, tmp_path, stereo, width):
    out, ck = tmp_path / "out", tmp_path / "ck"
    app.main(_run_args(scene, "synth.ks", out, "--device", "cpu",
                       "--stereo", stereo, "--checkpoint-dir", str(ck),
                       "--checkpoint-every", "1"))
    renders = sorted(out.glob("frame_*.png"))
    assert len(renders) == 2
    assert _png(renders[0]).shape == (40, width, 3)
    latest = CheckpointManager(ck).latest()
    assert latest is not None and latest.frame_index == 2
    assert latest.volume.shape == (20, 22, 20)


@pytest.fixture(scope="module")
def jax_runs(scene, tmp_path_factory):
    """The JAX app on the baked scene in modes 0 and 1 (mode 1 with
    checkpoints)."""
    root = tmp_path_factory.mktemp("jax_app")
    outs = {}
    for mode in (0, 1):
        out = root / f"out{mode}"
        extra = (["--checkpoint-dir", str(root / "ck"),
                  "--checkpoint-every", "1"] if mode == 1 else [])
        jax_main(_run_args(scene, "baked.ks", out, "--mode", str(mode),
                           *extra))
        outs[mode] = out
    return outs, root / "ck"


@pytest.mark.parametrize("mode", [0, 1])
def test_run_matches_jax_app(scene, jax_runs, tmp_path, mode):
    outs, _ = jax_runs
    out = tmp_path / "out"
    app.main(_run_args(scene, "baked.ks", out, "--device", "cpu", "--mode",
                       str(mode)))
    for name in ("frame_0000.png", "frame_0001.png"):
        want = _png(outs[mode] / name).astype(np.int16)
        got = _png(out / name).astype(np.int16)
        assert got.shape == want.shape == (40, 48, 3)
        assert (want.sum(-1) > 0).sum() > 10
        off = (np.abs(got - want) > 1).any(-1)
        assert off.sum() <= APP_KNIFE_EDGE_PIXELS, off.sum()


def test_resumes_from_jax_checkpoint(scene, jax_runs, tmp_path):
    """A checkpoint directory the JAX app wrote: the port's app resumes
    its frame cursor and goes on writing checkpoints in the same format."""
    _, ck = jax_runs
    assert CheckpointManager(ck).latest().frame_index == 2
    app.main(_run_args(scene, "baked.ks", tmp_path / "out", "--device",
                       "cpu", "--checkpoint-dir", str(ck),
                       "--checkpoint-every", "1", "--resume"))
    latest = CheckpointManager(ck).latest()
    assert latest.frame_index == 4
    assert latest.brick_counts.dtype == np.int32


def test_invert_matches_jax_app(tmp_path):
    from rgbd_recon_tpu.calib.bake import bake_cv_xyz

    from rgbd_recon_tpu_torch.calib.volume_io import read_calibration_volume

    rig = default_test_rig(num_sensors=1, bbox=BBOX)
    cv = np.asarray(bake_cv_xyz(rig.sensors[0], res=(16, 20, 16)))
    write_calibration_volume(tmp_path / "23.cv_xyz", cv, (0.5, 4.5))
    (tmp_path / "scene.ks").write_text("kinect 23.yml\nbbx -1 0 -1 1 2.2 1\n")
    for main, sub in ((jax_main, "jax"), (app.main, "port")):
        main(["invert", str(tmp_path / "scene.ks"), "--voxel-size", "0.25",
              "--out", str(tmp_path / sub)])
    got = (tmp_path / "port" / "23.cv_xyz_inv").read_bytes()
    assert got == (tmp_path / "jax" / "23.cv_xyz_inv").read_bytes()
    inv, _ = read_calibration_volume(tmp_path / "port" / "23.cv_xyz_inv",
                                     channels=4)
    assert inv.shape == (8, 9, 8, 4) and (inv[..., 3] > 0).any()


@pytest.mark.parametrize("flag,item", [("--refine-every", "pose refinement"),
                                       ("--preview-port", "viz/preview")])
def test_unported_options_raise(scene, tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        app.main(_run_args(scene, "synth.ks", tmp_path, "--device", "cpu",
                           flag, "5"))


def test_run_needs_cuda_unless_cpu_is_asked(scene, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        app.main(_run_args(scene, "synth.ks", tmp_path / "out"))
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out").exists()


def test_port_imports_no_jax():
    """The app, recon, viz, calib and io modules load neither jax nor
    flax (the card's machine has neither)."""
    code = (
        "import sys\n"
        "import rgbd_recon_tpu_torch.app, rgbd_recon_tpu_torch.recon\n"
        "import rgbd_recon_tpu_torch.viz, rgbd_recon_tpu_torch.io\n"
        "import rgbd_recon_tpu_torch.calib.inverter\n"
        "import rgbd_recon_tpu_torch.calib.kinect_yml\n"
        "import rgbd_recon_tpu_torch.calib.volume_io\n"
        "import rgbd_recon_tpu_torch.ops.splat\n"
        "bad = [m for m in ('jax', 'flax') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
