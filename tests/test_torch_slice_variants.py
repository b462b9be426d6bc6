"""Whole-slice parity of the PyTorch port against the JAX package, fuse +
render on the verify scene (4 sensors at 64x56, 5 cm voxels,
brick_size=0.2, a 96x80 camera), for the fast path's color variants:
shade_mode=3 (the camera-influence view), blend_mode="best_two" and
"normal_deviation" (the normal-weighted blends), and the profiling switches
debug_skip="blend,grad,refine". The march variants are in
tests/test_torch_slice_variants_march.py; the configurations and checks in
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
                params=["shade_mode_3", "best_two", "normal_deviation",
                        "debug_skip"])
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
