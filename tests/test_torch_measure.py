"""The port's measurement scripts (rgbd_recon_tpu_torch/bench/ablation.py,
render_sweep.py, stages.py) on the CPU at the verify scene (4 sensors at
64x56, 5 cm voxels in 20 cm bricks, calibration volumes 24x32x24, a 96x80
camera), one timed call a row: their variant lists against the JAX
scripts' (read with ast: bench_render_sweep.py runs when imported), the
form of each result, the ablation's Markdown table, each row reached by
``reconfigure`` against a fresh pipeline of that config (bit-equal on the
CPU), and the entry points' refusals without a card. No time of these CPU
runs is a measurement: the tests check the form only."""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from rgbd_recon_tpu_torch.bench import ablation, render_sweep, stages
from rgbd_recon_tpu_torch.bench.headline import Scene, reference_setup
from rgbd_recon_tpu_torch.bench.oracle import surface_rmse_mm
from rgbd_recon_tpu_torch.recon.tsdf_pipeline import TsdfPipeline

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
VERIFY = Scene(depth_size=(64, 56), color_size=(80, 64), cv_res=(24, 32, 24),
               inv_res=(40, 44, 40), voxel_size=0.05, brick_size=0.2,
               tsdf_limit=0.02, num_lods=5, camera_size=(96, 80))
STAGE_ROWS = {
    "preprocess": ["preprocess", "morph_dilate", "bilateral13", "quality13",
                   "lab_colors", "bilateral_lab", "boundary", "normals",
                   "quality", "mark_bricks", "color_fetch"],
    "fuse": ["preprocess+mark", "mark_bricks", "integrate",
             "integrate_compact", "occupied_brick_ids_plain",
             "integrate_bricks_plain"],
    "render": ["fuse", "render", "bake", "surface_occ", "brick_clearance",
               "sentinel_bake", "render_from_baked", "fill_colors_planar"],
}
MODULES = {"ablation": ablation, "render_sweep": render_sweep,
           "stages": stages}


def _literal(node):
    """The value of a variant list's node: literals and dict(k=v) calls."""
    if isinstance(node, ast.Call) and node.func.id == "dict":
        return {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_literal(e) for e in node.elts]
    return ast.literal_eval(node)


def script_variants(name):
    """``variants = [...]`` of scripts/<name>, as [(name, kwargs)]."""
    tree = ast.parse((REPO / "scripts" / name).read_text())
    found = [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and [getattr(t, "id", None) for t in n.targets] == ["variants"]]
    assert len(found) == 1
    return [tuple(v) for v in _literal(found[0])]


def _finite_positive(x):
    return isinstance(x, float) and math.isfinite(x) and x > 0.0


def _fresh_render(pipe, frames, camera, changes):
    """Fuse + render of a new pipeline of the scene's config with
    ``changes`` on ``pipe``'s calibration."""
    fresh = TsdfPipeline(pipe.calib, VERIFY.config(**changes), pipe.bbox)
    volume, maps, counts = fresh.fuse(frames)
    return fresh.make_renderer(camera)(volume, maps, counts)


@pytest.fixture(scope="module")
def abl_run(tmp_path_factory):
    setup = reference_setup("cpu", VERIFY)
    out = tmp_path_factory.mktemp("ablation") / "ablation_torch.md"
    return setup, ablation.run(iters=1, device="cpu", setup=setup, out=out)


@pytest.fixture(scope="module")
def two_spheres():
    pipe, _, camera = reference_setup("cpu", VERIFY)
    return pipe, render_sweep.two_sphere_frames("cpu", VERIFY, pipe.bbox), \
        camera


@pytest.fixture(scope="module")
def sweep_run(two_spheres):
    """The sweep, with every output of its renderer handle recorded."""
    pipe = two_spheres[0]
    outs = []
    make = pipe.make_renderer

    def recording(*args, **kwargs):
        renderer = make(*args, **kwargs)

        def rec(*a, **k):
            outs.append(renderer(*a, **k))
            return outs[-1]
        return rec

    pipe.make_renderer = recording
    try:
        result = render_sweep.run(iters=1, device="cpu", setup=two_spheres)
    finally:
        del pipe.make_renderer
    return result, outs


def test_variant_lists_match_scripts():
    """The variants, names and config changes in order, are the JAX
    scripts' own."""
    assert ablation.VARIANTS == script_variants("ablate_fast_modes.py")
    assert render_sweep.VARIANTS == script_variants("bench_render_sweep.py")
    assert len(ablation.VARIANTS) == 8 and len(render_sweep.VARIANTS) == 6


def test_ablation_form(abl_run):
    _, result = abl_run
    json.dumps(result)
    assert [r["variant"] for r in result["rows"]] == [
        n for n, _ in ablation.VARIANTS]
    for row in result["rows"]:
        assert math.isfinite(row["surface_rmse_mm"])
        assert row["surface_hits"] > 0 and len(row["overflow"]) == 4
        for key in ("fuse_ms", "render_ms"):
            assert _finite_positive(row[key]), (row["variant"], key)
        assert row["fuse_event_ms"] is None and row["render_event_ms"] is None
    assert result["iters"] == 1 and result["launches"] == {}
    assert result["device"] == {"platform": "cpu"}


def test_ablation_table_has_ablation_md_header(abl_run):
    """The table's title, column header and separator are ABLATION.md's;
    one line a variant, in order."""
    _, result = abl_run
    ours = Path(result["table"]).read_text().splitlines()
    theirs = (REPO / "ABLATION.md").read_text().splitlines()
    assert ours[0] == theirs[0]
    start = theirs.index(ablation.TABLE_HEADER[0])
    assert theirs[start:start + 2] == ablation.TABLE_HEADER
    i = ours.index(ablation.TABLE_HEADER[0])
    assert ours[i:i + 2] == ablation.TABLE_HEADER
    body = ours[i + 2:i + 2 + len(ablation.VARIANTS)]
    for line, (name, _) in zip(body, ablation.VARIANTS):
        assert line.startswith(f"| {name} | ") and line.count("|") == 5
    assert ours[-1] == "Device: cpu."


@pytest.mark.parametrize("index", range(len(ablation.VARIANTS)),
                         ids=[n for n, _ in ablation.VARIANTS])
def test_ablation_row_equals_fresh_pipeline(abl_run, index):
    """Each row, reached by reconfigure on one pipeline, reads the RMSE and
    hits of a new pipeline of that config; the last is the parity cell's
    config."""
    (pipe, frames, camera), result = abl_run
    name, changes = ablation.VARIANTS[index]
    row = result["rows"][index]
    out = _fresh_render(pipe, frames, camera, changes)
    assert (row["surface_rmse_mm"], row["surface_hits"]) == \
        surface_rmse_mm(out, camera)
    assert row["overflow"] == out.overflow.tolist()
    if name == "reference-exact (all)":
        from rgbd_recon_tpu_torch.bench.headline import load_cell

        assert changes == load_cell("tsdf_parity_4kinect2_1cm")["pipeline"]
    # the pipeline came back to the fast defaults
    assert pipe.config == VERIFY.config()


def test_sweep_form(sweep_run):
    result, _ = sweep_run
    json.dumps(result)
    assert [r["variant"] for r in result["rows"]] == [
        n for n, _ in render_sweep.VARIANTS]
    for row in result["rows"]:
        assert _finite_positive(row["render_ms"])
        assert row["render_event_ms"] is None
        assert row["hits"] > 0 and len(row["overflow"]) == 4
        assert row["diagnostics"]["occupied_bricks"] > 0
        assert row["diagnostics"]["blocks_dropped"] == row["overflow"][0]
    assert result["iters"] == 1 and result["launches"] == {}


@pytest.mark.parametrize("index", range(len(render_sweep.VARIANTS)),
                         ids=[n for n, _ in render_sweep.VARIANTS])
def test_sweep_row_equals_fresh_pipeline(two_spheres, sweep_run, index):
    """Each variant's render under the one handle is bit-equal to a new
    pipeline's of that config (hit mask, depth, overflow)."""
    pipe, frames, camera = two_spheres
    result, outs = sweep_run
    calls = len(outs) // len(render_sweep.VARIANTS)
    assert len(outs) == calls * len(render_sweep.VARIANTS)
    got = outs[index * calls]
    _, changes = render_sweep.VARIANTS[index]
    want = _fresh_render(pipe, frames, camera, changes)
    row = result["rows"][index]
    assert row["hits"] == int(want.hit.sum())
    assert row["overflow"] == want.overflow.tolist()
    assert torch.equal(got.hit, want.hit)
    assert torch.equal(got.depth, want.depth)
    assert pipe.config == VERIFY.config()


def test_stages_form(two_spheres):
    result = stages.run("all", iters=1, device="cpu", setup=two_spheres)
    json.dumps(result)
    parts = result["parts"]
    assert list(parts) == list(stages.PARTS)
    for part, names in STAGE_ROWS.items():
        assert list(parts[part]["rows"]) == names, part
        assert parts[part]["iters"] == 1
        for name, row in parts[part]["rows"].items():
            assert _finite_positive(row["ms"]), (part, name)
            assert row["event_ms"] is None
    assert parts["fuse"]["occupied_bricks"] > 0
    render = parts["render"]
    assert render["hits"] > 0 and len(render["overflow"]) == 4
    assert render["diagnostics"]["occupied_bricks"] > 0
    assert _finite_positive(render["moved_camera"]["ms"])
    assert render["moved_camera"]["rebuilt"] is False
    assert result["launches"] == {}


def test_stages_part_and_small_scene():
    """One part alone, at bench_render.py's small scene, at its default
    iteration count."""
    result = stages.run("fuse", small=True, device="cpu")
    assert list(result["parts"]) == ["fuse"]
    fuse = result["parts"]["fuse"]
    assert fuse["iters"] == stages.ITERS["fuse"] == 5
    assert list(fuse["rows"]) == STAGE_ROWS["fuse"]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_run_needs_a_card_by_default(name, monkeypatch):
    """Called without ``device`` each run targets the card and raises here,
    before any work."""
    def never(*a, **k):
        raise AssertionError("the run started without a card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(MODULES[name], "reference_setup", never)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MODULES[name].run()


ARGV = {"ablation": ["--iters", "2", "--out", "x.md"],
        "render_sweep": ["--iters", "2"],
        "stages": ["--part", "render", "--small", "--iters", "2"]}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main(name, monkeypatch, capsys, tmp_path):
    """Without a card the entry point exits non-zero before any work; with
    one it prints the card line, then the run's JSON line last."""
    module = MODULES[name]
    seen = {}

    def fake_run(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        return {"rows": [], "device": {"card": "a card, 700.00 W"}}

    monkeypatch.setattr(module, "run", fake_run)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main(ARGV[name])
    assert exc.value.code not in (0, None) and not seen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    module.main(ARGV[name])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "a card, 700.00 W"
    assert json.loads(lines[-1])["rows"] == []
    assert seen["kwargs"]["iters"] == 2
    if name == "ablation":
        assert seen["kwargs"]["out"] == Path("x.md")
    if name == "stages":
        assert seen["args"] == ("render",) and seen["kwargs"]["small"]
