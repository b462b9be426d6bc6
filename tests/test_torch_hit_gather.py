"""The render's hit gather on the CPU: a numpy model of csrc/render_stages.cu
``hit_gather_kernel`` and edge cases of its twin,
``ops/render_stages.py hit_gather_plain``.

- The kernel as it runs: a thread a hit slot, GATHER_THREADS slots a thread
  block, ceil(capH / GATHER_THREADS) blocks; each thread's loads as the
  16-byte words it reads (ray8's two float4, st8's float4 at 0 and float2 at
  4 of the row min(id, R - 1)), its row (pos0, dir, lo_t, hi_t) taken from
  those words' components, its position from them (pos0 + dir * hit_t in
  f32, a product then a sum), its stores: the row as two float4 words, the
  position as three elements, the live byte. The model lists every store
  (block, thread, first element, elements) and applies them: each output
  element written exactly once, each word on 16 bytes, and the outputs
  assembled from the threads' words bit-equal to ``hit_gather_plain``, at
  capH = 1, 3, 4, 7, 8, GATHER_THREADS - 1, GATHER_THREADS, GATHER_THREADS
  + 1, 1,023 and the cells' 101,376, and at the block sizes the variants
  script measures.
- The twin on ``tests/hit_gather_cases.py``'s seeded rows (NaN, +-0.0,
  +-inf, and the NaNs inf * 0 and inf - inf make), R = 1, lists that are
  all padding and without padding: rows and live copied bit for bit,
  ``hpos`` bit for bit against numpy's f32 product then sum (no FMA), and
  the whole against the JAX package's gather as written at
  rgbd_recon_tpu/recon/tsdf_pipeline.py:1466-1475 (rows and live bit for
  bit; positions within 1e-6, NaN and infinity where JAX has them: XLA's
  CPU backend may contract the product and sum).
- ``bench/hit_gather_variants.py``'s variant regions, found once in the
  source.

The constants the model uses are read from the CUDA source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu_torch.bench import hit_gather_variants
from rgbd_recon_tpu_torch.ops import render_stages

import hit_gather_cases as cases

torch.set_num_threads(2)

SOURCE = (Path(render_stages.__file__).resolve().parent.parent / "csrc"
          / "render_stages.cu")
POS_ATOL = 1e-6


def _constant(name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text())
    return m[1]


THREADS = int(_constant("GATHER_THREADS"))
CAPS = (1, 3, 4, 7, 8, THREADS - 1, THREADS, THREADS + 1, 1_023, 101_376)


def test_model_uses_the_sources_constants():
    """The block size of the source: whole warps."""
    assert THREADS % 32 == 0 and 32 <= THREADS <= 1024


# ---- the kernel ---------------------------------------------------------------

# output -> (elements a slot, elements a store of a thread)
LAYOUT = {"hrows": (8, 4), "hpos": (3, 1), "live": (1, 1)}


def kernel_stores(capH: int, threads: int) -> dict:
    """{output: (block, thread, first element, elements)} int arrays of
    every store the kernel makes: ceil(capH / threads) blocks, the thread
    of slot h < capH storing its slot's elements of each output in
    stores of LAYOUT's size, in order; the threads past capH none."""
    blocks = -(-capH // threads)
    h = np.arange(blocks * threads)
    h = h[h < capH]
    out = {}
    for name, (per, size) in LAYOUT.items():
        k = np.arange(per // size)
        first = (per * h[:, None] + size * k[None, :]).reshape(-1)
        slot = np.repeat(h, k.size)
        out[name] = np.stack([slot // threads, slot % threads, first,
                              np.full(first.size, size)], axis=1)
    return out


def thread_words(ray8, st8, hit_idx):
    """What each slot's thread computes, from the words it loads: ray8's
    float4 a, b and st8's float4 s and float2 t of the row min(id, R - 1);
    its row (a.x, a.y, a.z, a.w, b.x, b.y, s.w, t.x), its position (a.xyz +
    (a.w, b.x, b.y) * t.y, f32 products, then sums) and its live byte."""
    R = ray8.shape[0]
    live = hit_idx < R
    r = np.where(live, hit_idx, R - 1)
    words4 = ray8.reshape(R, 2, 4)
    a, b = words4[r, 0], words4[r, 1]
    s = st8.reshape(R, 2, 4)[r, 0]
    t = st8.reshape(R, 4, 2)[r, 2]
    row = np.concatenate([a, b[:, :2], s[:, 3:4], t[:, 0:1]], axis=1)
    d = np.stack([a[:, 3], b[:, 0], b[:, 1]], axis=1)
    with np.errstate(invalid="ignore", over="ignore"):
        pos = a[:, :3] + d * t[:, 1:2]
    return {"hrows": row, "hpos": pos, "live": live.astype(np.uint8)}


def assemble(stores, computed, capH: int, threads: int):
    """The outputs the stores write from the threads' values, each
    element's write count, and whether every float4 starts on 16 bytes (the
    outputs' bases do)."""
    outs, counts, aligned = {}, {}, True
    for name, (per, size) in LAYOUT.items():
        flat = computed[name].reshape(-1)
        got = np.zeros_like(flat)
        count = np.zeros(flat.size, np.int64)
        b, tid, first, n = stores[name].T
        assert (tid < threads).all() and (b * threads + tid < capH).all()
        # a thread stores its own slot's elements only
        assert ((first // per) == b * threads + tid).all()
        if size == 4:
            aligned &= bool(((first * flat.itemsize) % 16 == 0).all())
        for k in range(size):
            got[first + k] = flat[first + k]
            np.add.at(count, first + k, 1)
        outs[name] = got.reshape(computed[name].shape)
        counts[name] = count
    return outs, counts, aligned


def _zeros(capH):
    return {"hrows": np.zeros((capH, 8), np.float32),
            "hpos": np.zeros((capH, 3), np.float32),
            "live": np.zeros(capH, np.uint8)}


@pytest.mark.parametrize("capH", CAPS)
def test_stores_write_each_element_once(capH):
    """Every element of hrows, hpos and live written exactly once, the
    rows' float4 words on 16 bytes, at the source's block size."""
    _, counts, aligned = assemble(kernel_stores(capH, THREADS),
                                  _zeros(capH), capH, THREADS)
    assert aligned
    for name, c in counts.items():
        assert (c == 1).all(), name


@pytest.mark.parametrize("threads", [128, 256, 512])
@pytest.mark.parametrize("capH", [1, 5, 127, 129, 1_023, 4_097])
def test_stores_at_the_measured_block_sizes(capH, threads):
    """The store plan holds at the variants' block sizes too."""
    _, counts, aligned = assemble(kernel_stores(capH, threads),
                                  _zeros(capH), capH, threads)
    assert aligned and all((c == 1).all() for c in counts.values())


@pytest.mark.parametrize("kind", cases.KINDS)
@pytest.mark.parametrize("capH", CAPS)
def test_model_assembles_the_twin(capH, kind):
    """The outputs assembled from the threads' words by the kernel's
    stores bit-equal to hit_gather_plain's (R = 184,320, the cells' rays,
    for the cells' 101,376 slots; else 2 capH + 3)."""
    R = 184_320 if capH == 101_376 else 2 * capH + 3
    ray8, st8, idx = cases.gather_case(capH + len(kind), capH, R, kind,
                                       "cpu")
    computed = thread_words(ray8.numpy(), st8.numpy(), idx.numpy())
    got, _, _ = assemble(kernel_stores(capH, THREADS), computed, capH,
                         THREADS)
    want = render_stages.hit_gather_plain(ray8, st8, idx)
    assert np.array_equal(got["hrows"].view(np.int32),
                          want[0].numpy().view(np.int32))
    assert np.array_equal(got["hpos"].view(np.int32),
                          want[1].numpy().view(np.int32))
    assert np.array_equal(got["live"].astype(bool), want[2].numpy())


# ---- the twin's edge cases ------------------------------------------------

def _jax_gather(ray8, st8, hit_idx):
    """rgbd_recon_tpu/recon/tsdf_pipeline.py:1466-1475 as written."""
    ray8, st8, hit_idx = (jnp.asarray(x) for x in (ray8, st8, hit_idx))
    R = ray8.shape[0]
    safeH = jnp.minimum(hit_idx, R - 1)
    live_h = hit_idx < R
    rh = ray8[safeH]
    sh = st8[safeH]
    rows = jnp.concatenate([rh[:, :6], sh[:, 3:5]], axis=1)
    hit_pos_h = jnp.stack([rh[:, i] + rh[:, 3 + i] * sh[:, 5]
                           for i in range(3)], axis=-1)
    return (np.asarray(rows), np.asarray(hit_pos_h), np.asarray(live_h))


EDGE_CASES = {
    "mixed": (37, 101, "mixed"),
    "no_padding": (37, 101, "live"),
    "all_padding": (37, 101, "dead"),
    "one_ray": (9, 1, "mixed"),
    "one_ray_live": (9, 1, "live"),
    "one_ray_dead": (9, 1, "dead"),
    "one_slot": (1, 5, "live"),
    "more_slots_than_rays": (300, 7, "mixed"),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_twin_edge_cases(name):
    """hit_gather_plain on seeded rows with NaN, +-0.0, +-inf: rows and
    live copied from min(id, R - 1) bit for bit, positions bit for bit
    against numpy's f32 pos0 + dir * hit_t (a rounded product, then a
    rounded sum); and against the JAX package's gather."""
    capH, R, kind = EDGE_CASES[name]
    ray8, st8, idx = cases.gather_case(len(name), capH, R, kind, "cpu")
    rows, pos, live = render_stages.hit_gather_plain(ray8, st8, idx)
    assert rows.shape == (capH, 8) and pos.shape == (capH, 3)
    assert live.dtype == torch.bool and live.shape == (capH,)
    r8, s8, ids = ray8.numpy(), st8.numpy(), idx.numpy()
    want_live = ids < R
    assert np.array_equal(live.numpy(), want_live)
    assert int(want_live.sum()) == {"live": capH, "dead": 0}.get(
        kind, int(want_live.sum()))
    r = np.minimum(ids, R - 1)
    want_rows = np.concatenate([r8[r, :6], s8[r, 3:5]], axis=1)
    assert np.array_equal(rows.numpy().view(np.int32),
                          want_rows.view(np.int32))
    with np.errstate(invalid="ignore", over="ignore"):
        prod = r8[r, 3:6] * s8[r, 5:6]
        want_pos = r8[r, :3] + prod
    assert prod.dtype == np.float32 and want_pos.dtype == np.float32
    assert np.array_equal(pos.numpy().view(np.int32),
                          want_pos.view(np.int32))
    jrows, jpos, jlive = _jax_gather(r8, s8, ids)
    assert np.array_equal(rows.numpy().view(np.int32), jrows.view(np.int32))
    assert np.array_equal(live.numpy(), jlive)
    np.testing.assert_allclose(pos.numpy(), jpos, rtol=0, atol=POS_ATOL,
                               equal_nan=True)


def test_cases_hold_the_specials():
    """The seeded rows reach what the edge cases claim: NaN, +-0.0 and
    +-inf in the positions' inputs, NaNs made by inf * 0 and inf - inf, and
    positions where the product then the sum differs from a fused
    multiply-add (so the test above tells the two apart)."""
    rng = np.random.default_rng(3)
    ray8, st8 = cases.rows(rng, 4_000)
    ins = np.concatenate([ray8[:, :6], st8[:, 5:6]], axis=1)
    assert np.isnan(ins).any() and np.isposinf(ins).any()
    assert np.isneginf(ins).any()
    zeros = ins[ins == 0.0]
    assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()
    with np.errstate(invalid="ignore", over="ignore"):
        pos = ray8[:, :3] + ray8[:, 3:6] * st8[:, 5:6]
        fused = (ray8[:, :3].astype(np.float64) + ray8[:, 3:6].astype(
            np.float64) * st8[:, 5:6].astype(np.float64)).astype(np.float32)
    finite_in = np.isfinite(ins).all(axis=1)
    assert (np.isnan(pos).any(axis=1) & finite_in).sum() == 0
    assert np.isnan(pos[~finite_in]).any()
    made = np.isnan(pos) & ~np.isnan(ray8[:, :3]) & ~np.isnan(
        ray8[:, 3:6]) & ~np.isnan(st8[:, 5:6])
    assert made.sum() >= 2
    both = np.isfinite(pos) & np.isfinite(fused)
    assert (pos[both] != fused[both]).sum() > 100


def test_rows_of_one_special_source():
    """At most one NaN source an operation in the seeded rows: one special
    among a row's pos0, dir and hit_t, or the inf * 0 / inf - inf rows."""
    rng = np.random.default_rng(5)
    ray8, st8 = cases.rows(rng, 2_000)
    ins = np.concatenate([ray8[:, :6], st8[:, 5:6]], axis=1)
    special = ~np.isfinite(ins) | (ins == 0.0)
    assert (special.sum(axis=1) <= 2).all()
    two = np.flatnonzero(special.sum(axis=1) == 2)
    assert two.size == 2
    for r in two:
        assert (ray8[r, 3] == np.inf and st8[r, 5] == 0.0) or (
            ray8[r, 0] == np.inf and ray8[r, 3] == -np.inf)


def test_hit_list_kinds():
    """The lists: ascending, their padding R one tail; "live" none,
    "dead" all, "mixed" some of each (more slots than rays: ids repeat)."""
    rng = np.random.default_rng(0)
    for capH, R in ((50, 101), (300, 7), (1, 1)):
        for kind in cases.KINDS:
            ids = cases.hit_list(rng, capH, R, kind)
            assert ids.shape == (capH,) and (np.diff(ids) >= 0).all()
            live = ids < R
            assert (ids[~live] == R).all()
            assert live.sum() == {"live": capH, "dead": 0}.get(
                kind, live.sum())
            if kind == "mixed" and capH > 1:
                assert 0 < live.sum() < capH


# ---- the variants script ----------------------------------------------------

@pytest.mark.parametrize("name", list(hit_gather_variants.VARIANTS))
def test_variant_regions_found_once(name):
    """Each variant's changes apply to the source as it is (each region's
    start found once, its end after it), and change it (but "kept" and the
    kept kernel's own block size)."""
    text = SOURCE.read_text()
    out = hit_gather_variants.variant_source(text, name)
    assert (out == text) == (name in ("kept", f"threads_{THREADS}"))
    assert "hit_gather_kernel(" in out


def test_variants_cover_the_measured_forms():
    """The kept kernel, its stores staged a thread block and a warp at a
    time, 128 / 256 / 512 threads, four slots a thread, the two stripped
    forms; only those two are exempt from the bit check."""
    v = hit_gather_variants.VARIANTS
    assert {"kept", "staged_lines", "staged_lines_256", "threads_128",
            "threads_256", "threads_512", "warp_lines",
            "warp_lines_rows_direct", "four_slots_64", "four_slots_128",
            "writes_only", "loads_only"} == set(v)
    assert set(hit_gather_variants.STRIPPED) == {"writes_only", "loads_only"}
    text = SOURCE.read_text()
    for t in (128, 256, 512):
        src = hit_gather_variants.variant_source(text, f"threads_{t}")
        assert f"constexpr int GATHER_THREADS = {t};" in src

    def kernel(name):
        return hit_gather_variants.variant_source(text, name).split(
            "hit_gather_kernel(")[1].split("// ----")[0]

    assert "__ldg" not in kernel("writes_only")
    loads = kernel("loads_only")
    assert "p.hrows" not in loads and "p.live" not in loads
