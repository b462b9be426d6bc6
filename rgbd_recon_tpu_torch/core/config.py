"""Configuration system: pipeline settings, .conf files, and .ks scene files.

Replicates the reference's 3-layer config (SURVEY.md §5):
  - ``.conf`` key:value files (reference: framework/io/configurator.cpp:8-55
    — whitespace stripped, '#' comments, typed buckets for uint / bool /
    float / uint-list inferred from the value's spelling),
  - ``.ks`` scene files ("kinect <file.yml>" lines + "bbx <6 floats>",
    reference: source/kinect_client.cpp:206-235),
  - programmatic defaults matching kinect_client.cpp:60-95.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Tuple, Union

from .grid import BoundingBox

ConfValue = Union[bool, int, float, List[int]]


def parse_conf(path_or_text: Union[str, Path]) -> Dict[str, ConfValue]:
    """Parse a .conf file into a typed dict.

    Type inference matches configurator.cpp:25-54: all-digit values are
    uints, all-alpha values are bools ("true" -> True, anything else ->
    False), values containing ',' are uint lists, everything else is float.
    """
    p = Path(path_or_text)
    text = p.read_text() if p.suffix == ".conf" and p.exists() else str(path_or_text)
    out: Dict[str, ConfValue] = {}
    for raw_line in text.splitlines():
        line = "".join(raw_line.split())  # strip ALL whitespace, like the ref
        if ":" not in line:
            continue
        name, _, val = line.partition(":")
        if len(name) < 2 or name.startswith("#"):
            continue
        if "," in val:
            out[name] = [int(e) if e.isdigit() else 0 for e in val.split(",") if e]
        elif val.isdigit():
            out[name] = int(val)
        elif val.isalpha() and val != "":
            out[name] = val == "true"
        else:
            try:
                out[name] = float(val)
            except ValueError:
                out[name] = 0.0
    return out


@dataclasses.dataclass
class SceneDescription:
    """Parsed .ks scene file: calibration file names + working bounding box."""

    calib_files: List[str]
    bbox: BoundingBox
    base_dir: str = ""


def parse_ks(path_or_text: Union[str, Path]) -> SceneDescription:
    """Parse a .ks file (kinect_client.cpp:206-235):
    lines starting with 'kinect' name a sensor .yml; a 'bbx' line carries
    6 floats (min xyz, max xyz)."""
    p = Path(str(path_or_text))
    if p.exists():
        text = p.read_text()
        base = str(p.parent)
    else:
        text = str(path_or_text)
        base = ""
    calib_files: List[str] = []
    bbox = BoundingBox(min=(-1.2, 0.0, -1.2), max=(1.2, 2.4, 1.2))
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "kinect" and len(parts) >= 2:
            calib_files.append(parts[1])
        elif parts[0] == "bbx" and len(parts) >= 7:
            vals = [float(v) for v in parts[1:7]]
            bbox = BoundingBox(min=tuple(vals[0:3]), max=tuple(vals[3:6]))
    return SceneDescription(calib_files=calib_files, bbox=bbox, base_dir=base)


@dataclasses.dataclass
class PipelineConfig:
    """All tunables of the reconstruction pipeline, defaults matching the
    reference's globals (kinect_client.cpp:60-95)."""

    recon_mode: int = 1            # 0 points, 1 TSDF, 2 trigrid, 3 mvt
    screen_width: int = 1280
    screen_height: int = 720
    bilateral: bool = True         # 13x13 bilateral depth filter
    processed: bool = True         # use processed (vs raw) depth
    refine: bool = True            # boundary color refinement
    colorfill: bool = True         # pull-push hole fill
    bricking: bool = True          # occupancy-gated integration
    skip_space: bool = True        # brick-interval raymarch start
    morph: bool = True             # morphological dilate pass
    voxel_size: float = 0.01       # meters
    brick_size: float = 0.1        # meters
    tsdf_limit: float = 0.01       # truncation, in normalized depth units
    min_voxels_per_brick: int = 10
    # Max occupied bricks the compact integration path processes per frame
    # (fixed shape for jit). Reference scenes mark 3-5.5% of bricks
    # (inc_bricks.glsl:52-56) = ~260-480 of 8800 at default scale; 640 is
    # ~1.3-2.4x headroom, and integration cost scales linearly with it.
    # Extra occupied bricks beyond capacity are dropped — watch
    # TsdfPipeline.diagnostics()['bricks_dropped'] and raise if nonzero.
    brick_capacity: int = 640
    time_limit: int = 0            # benchmark seconds; 0 = unlimited
    num_lods: int = 7              # pull-push pyramid depth
    shade_mode: int = 0            # 0 textured,1 shaded,2 normals,3 cam blend
    precompute_projections: bool = True  # hoist cv_xyz_inv gathers (perf)
    # Replace per-frame cv_xyz/cv_uv trilinear lookups in the preprocess
    # chain with per-pixel closed forms fitted at setup (exact for pinhole
    # calibrations; see calib.sensors.PixelModels). Falls back to volume
    # lookups automatically when the fit residual exceeds ~a pixel.
    pixel_ray_model: bool = True
    # Visual-hull carve threshold on the bilinearly sampled silhouette.
    # 1.0 reproduces the reference exactly (tsdf_integration.vs:32: carve
    # when silhouette < 1.0) — which over-carves by up to a sensor pixel at
    # the object limb. At reference sensor resolution (512x424) that is
    # sub-centimeter; low-resolution rigs (tests) can set a small value
    # (carve only where the silhouette is nearly fully background) to keep
    # the hull erosion below a voxel.
    carve_sil_threshold: float = 1.0
    # Raymarch sampling: "nearest" (TPU fast path — nearest-voxel stepping,
    # one gather row per ray-step, with a trilinear secant re-refinement at
    # the crossing) or "trilinear" (the reference's exact per-step sampling,
    # 8 gather rows per ray-step). See ops/raymarch.py march().
    march_mode: str = "nearest"
    # Fraction of screen BLOCKS (interval_downsample^2-pixel tiles) the
    # compacted march processes; blocks whose brick interval is empty never
    # march or shade. 0 disables compaction (dense full-screen march).
    # Active blocks beyond capacity render as background and are counted in
    # RenderOutput.overflow[0]; typical scenes activate 15-22% of blocks.
    ray_compaction: float = 0.20
    # Edge of the screen-tile blocks the interval pass scans (one coarse ray
    # per block; intervals are conservatively 3x3-min/max-pooled across
    # neighboring blocks). Also the block-compaction granularity.
    interval_downsample: int = 4
    # Staged march: all compacted rays march `march_phase1_steps`; rays
    # still unfinished are re-compacted to narrower widths and continue
    # (two tail stages: 1/4 capacity for a medium budget, then 1/16
    # capacity to exhaustion — the long tail is grazing silhouette rays).
    # 0 disables the split (single full-length march).
    march_phase1_steps: int = 10
    # Sample budget of the LAST tail stage (the 1/16-capacity
    # run-to-exhaustion stage for grazing silhouette rays). 0 = auto
    # (10 * phase1 + 32, capped at the exhaustive max_steps). Grazing
    # rays that exhaust the budget render as background (compare hit
    # counts when tuning; RenderOutput.overflow[1] counts tail
    # COMPACTION overflow, not budget exhaustion); the auto budget
    # reaches every surface the interval scan admits.
    march_tail_budget: int = 0
    # Chunked parallel marching: each march iteration fetches this many
    # affinely-spaced samples per ray in ONE wide gather; skip sentinels
    # then jump only at chunk boundaries. Measured on TPU v5e the serial
    # in-loop march already streams at ~237 M gather rows/s
    # (scripts/profile_march_stages.py), so chunking LOSES there (fewer
    # sentinel jumps per sample + selection overhead) — kept at 0; the
    # knob remains for architectures where dependent in-loop gathers are
    # slow. Applies to the nearest fast path only.
    march_chunk: int = 0
    # Coarse interval-scan step as a fraction of the brick edge. The scan
    # targets the 1-brick-DILATED surface-brick set (a >=3-brick-wide slab
    # around any surface), so 0.5-brick steps cannot miss it; smaller =
    # more coarse samples but slightly tighter intervals. 0.75 measures an
    # identical hit set to 0.5 at reference scale with ~35% fewer scan
    # gathers (the march start pad scales with the step, so the
    # conservative margin is unchanged).
    interval_step_frac: float = 0.75
    # Sphere-trace through certified-empty space: a per-frame Chebyshev
    # distance-to-surface field is baked into the marched volume as skip
    # sentinels, and the march advances by the certified-safe distance in
    # one iteration (exactly safe for nearest sampling). Mean iterations
    # per ray drop ~4x at reference scale. Applies to the nearest fast path
    # only; trilinear parity mode always steps uniformly like the reference.
    march_empty_skip: bool = True
    # Rounds of voxel-level dilation for the near-surface skip field (skip
    # sentinels 1..N voxels), and rounds of BRICK-level dilation for the
    # far-field skip (sentinels N bricks of voxels — the far field costs
    # a (Bz,By,Bx)-sized pass instead of dense volume dilations).
    skip_fine_rounds: int = 6
    skip_brick_rounds: int = 6
    # Per-block fine-march bracketing from the coarse density march (one
    # ray per block marches the volume first; fine rays then march only
    # [min9(hit)-margin, max9(hit)+margin] when all 3x3 neighboring block
    # rays hit coherently). Margin and max bracket width in units of the
    # march step (tsdf_limit/2). Rays that miss inside the bracket continue
    # to the full interval in the tail stages, so bracketing never drops
    # geometry that the coarse-hit test approved.
    bracket_margin_steps: float = 3.0
    bracket_max_steps: float = 16.0
    # Bracket the fine march with each block's OWN coarse-ray crossing
    # bracket (widened by the 3x3 depth spread) instead of the pooled 3x3
    # union — ~2x narrower windows on sloped surfaces; the same 3x3 trust
    # guards gate it, and bracket misses still fall through to the
    # full-interval tail stages.
    bracket_per_block: bool = False
    # Widened trilinear re-bracketing of the per-hit secant refine, in
    # march steps (tsdf_limit/2) each side of the nearest-march crossing
    # bracket. The nearest-tap march brackets the CELL-CENTER-sampled
    # field whose zero crossing sits up to ~half a voxel from the true
    # trilinear crossing the reference marches — the dominant fast-mode
    # accuracy penalty (ABLATION.md). The widened refine re-samples the
    # trilinear field across the widened window (refine_widen_samples
    # points, one batched oct-row gather) and runs two secant iterations,
    # paying trilinear cost only on the hit set. 0 disables (round-4
    # endpoint-confirm refine). Applies to the oct-table hit path.
    refine_widen_steps: float = 1.5
    refine_widen_samples: int = 8
    # Fraction of compacted rays given hit-shading capacity (normals +
    # color blending run on the compacted hit set only). Hits beyond
    # capacity render as background and are counted in
    # RenderOutput.overflow[2]. 0 disables hit compaction. Typical scenes
    # hit on ~40-45% of compacted rays.
    hit_compaction: float = 0.55
    # Color blending at raymarch hits: "quality" is the reference's default
    # blendColors (quality/(dist+0.01) weights + inverse-distance fallback,
    # tsdf_raymarch.fs:303-338); "normal_deviation" and "best_two" are its
    # alternative blendColors2 paths (:266-301) weighting by surface-vs-
    # sensor normal agreement.
    blend_mode: str = "quality"
    # Map sampling of the TSDF integration: "bilinear" is the reference's
    # exact texture() filtering (one 16-wide packed row per sample);
    # "nearest" fetches the nearest texel (4-wide row, ~2x gather rate,
    # deviates by at most the inter-pixel map variation — sub-voxel at
    # reference sensor resolution).
    integrate_taps: str = "nearest"
    # Storage dtype of the packed march volume on the nearest fast path:
    # "bfloat16" halves the gather table (and gathers ~1.3x faster) at an
    # absolute TSDF rounding error of ~limit * 2^-8 (~0.2 mm of surface
    # position at reference scale); "float32" for exact parity. The
    # trilinear parity mode always packs float32.
    march_dtype: str = "bfloat16"
    # Hit-path sampling through a compact per-occupied-brick cell-corner
    # table (ops/raymarch.py OctVolume): exact trilinear secant refinement
    # and the analytic trilinear-cell gradient cost ONE 8-wide row gather
    # each (vs 4 pair rows per trilinear sample + 6 nearest taps), and the
    # march volume drops to the non-overlapping half-pair layout (17.6 MB —
    # the fast gather size class). Applies to the nearest fast path only;
    # capacity is 2x brick_capacity (overflow observable via
    # RenderOutput.overflow[3]). Requires brick-aligned volume dims.
    oct_hit_table: bool = True
    # Space-skip by bricks that can actually produce ray-surface crossings
    # (any positive TSDF voxel in the 1-voxel-dilated brick) instead of the
    # marked-occupancy mask, which includes silhouette-carve-only bricks
    # that rays march end to end without hitting anything. Identical hit
    # results, much tighter intervals.
    surface_skip: bool = True
    # Perf-diagnostic switches (comma list): "blend" replaces the color
    # blend with a constant, "refine" skips the secant re-refinement,
    # "grad" uses a fixed normal. For profiling stage costs only — never
    # set in production configs.
    debug_skip: str = ""
    # Brick-marking pixel stride: every stride-th pixel scatters stride^2
    # counts (see TsdfPipeline._mark_bricks). 1 = reference-exact; at 3,
    # a brick passes the >10 threshold with >=2 lattice samples (a 10 cm
    # brick's footprint is hundreds of pixels, so marking is unchanged
    # except at extreme grazing fringes).
    mark_stride: int = 3
    # Replace the per-hit cv_xyz_inv/cv_uv lookups of the color blend with
    # analytic per-sensor projection models fitted at setup (exact for
    # pinhole calibrations — more accurate than the k-NN/IDW-baked inverse
    # volumes; automatic fallback to volume lookups when the fit residual
    # exceeds ~a pixel). See calib.sensors.ProjectionModels.
    projection_model: bool = True
    # True reproduces the reference's phantom hull surfaces: voxels of
    # occupied bricks observed by no sensor keep the +limit init
    # (tsdf_integration.vs:28), so carved->unobserved boundaries raymarch as
    # walls. False (default) resets unobserved voxels to -limit so only
    # measured TSDF bands produce surface hits.
    phantom_hull: bool = False

    @classmethod
    def from_conf(cls, conf: Dict[str, ConfValue]) -> "PipelineConfig":
        """Build from a parsed .conf dict, using reference key names
        (kinect_client.cpp load_config :294-317)."""
        c = cls()
        keymap = {
            "recon_mode": "recon_mode",
            "screenWidth": "screen_width",
            "screenHeight": "screen_height",
            "bilateral": "bilateral",
            "processed": "processed",
            "refine": "refine",
            "colorfill": "colorfill",
            "bricking": "bricking",
            "skip_space": "skip_space",
            "voxel_size": "voxel_size",
            "brick_size": "brick_size",
            "tsdf_limit": "tsdf_limit",
            "time_limit": "time_limit",
        }
        for conf_key, attr in keymap.items():
            if conf_key in conf:
                setattr(c, attr, conf[conf_key])
        return c


def format_conf(config: PipelineConfig) -> str:
    """Serialize a PipelineConfig back to .conf text (round-trip support)."""
    lines = [
        f"recon_mode: {config.recon_mode}",
        f"screenWidth: {config.screen_width}",
        f"screenHeight: {config.screen_height}",
        f"bilateral: {str(config.bilateral).lower()}",
        f"processed: {str(config.processed).lower()}",
        f"refine: {str(config.refine).lower()}",
        f"colorfill: {str(config.colorfill).lower()}",
        f"bricking: {str(config.bricking).lower()}",
        f"skip_space: {str(config.skip_space).lower()}",
        f"voxel_size: {config.voxel_size}",
        f"brick_size: {config.brick_size}",
        f"tsdf_limit: {config.tsdf_limit}",
        f"time_limit: {config.time_limit}",
    ]
    return "\n".join(lines) + "\n"
