"""Whole-slice parity of the PyTorch port against the JAX package, fuse +
render on the verify scene (4 sensors at 64x56, 5 cm voxels,
brick_size=0.2, a 96x80 camera), for the render levers of the render-lever
sweep (scripts/bench_render_sweep.py, the port's bench/render_sweep.py):
``ray_compaction`` 0.25, ``march_phase1_steps`` 16, ``interval_step_frac``
0.125 and ``hit_compaction`` 0.35. The configurations and checks are in
tests/test_torch_parity.py."""

import pytest

from test_torch_parity import (
    check_depth,
    check_hits,
    check_overflow_and_samples,
    check_prefill_color,
    check_volume,
    run_slice,
    slice_setup,
)


@pytest.fixture(scope="module")
def setup():
    return slice_setup()


@pytest.fixture(scope="module",
                params=["ray_compaction_025", "phase1_16", "step_frac_0125",
                        "hit_compaction_035"])
def run(request, setup):
    return run_slice(setup, request.param)


def test_volume_matches(run):
    check_volume(run)


def test_hit_masks_match(run):
    check_hits(run)


def test_depth_matches(run):
    check_depth(run)


def test_color_matches_before_fill(run):
    check_prefill_color(run)


def test_overflow_and_samples_match(run):
    check_overflow_and_samples(run)
