"""The block set-up and hit refine kernels' algorithms on the CPU, as numpy /
torch models of csrc/render_stages.cu ``block_setup_kernel`` and
csrc/hits.cu ``refine_kernel``:

- the set-up as the kernel runs it: a tile of SETUP_TX x SETUP_TY blocks,
  its scan cells with a halo of one staged from the five scan planes
  (clamped to the scan grid), each (cell, plane) pooled once in _pool3's
  order, each block reading its cell's five pools. Held bit for bit
  against the sequential per-block fold of the same order (NaN payloads
  and signed zeros included) and against ``block_setup_plain`` on planes
  without NaNs or negative zeros; on planes with NaNs, signed zeros and
  infinities at their edges and corners, by value (NaN where the twin has
  NaN, equal elsewhere), since CPU torch's vectorized minimum / maximum
  choose a NaN's payload and a zero's sign by the element's place in the
  vector (the card's twin has one rule, and the card tests hold the kernel
  to it bit for bit). Geometries with ragged tiles, Hs * sc > Hb and scan
  strides 1 to 5 (``tests/setup_refine_cases.py``);
- the refine's widened bracket as the kernel runs it: every sample of a
  chunk of REFINE_CHUNK first, then the first rising pair, chunk after
  chunk. Held bit for bit against the loop with a break (the kernel
  before) and the twin's selection (``ops/raymarch.py
  oct_refine_crossing``: rising pairs, any, argmax), on crafted sequences
  (none, at k = 1 and K - 1, across a chunk's end, NaN before and after the
  rise, exact +-0.0) at K = 3, 8, 9 and 17; the whole refine with the
  chunked selection bit for bit against ``refine_hits_plain`` on those
  sequences and on a render's hits, and within ``POS_ATOL`` (1e-6,
  tests/test_torch_hits.py's) of the JAX package's ``oct_refine_crossing``
  on the finite sequences;
- the two kernels' index arithmetic: the divisions by the scan stride and
  the brick edge as a multiply and a shift, and the refine's choice of its
  row path.

The constants the models use are read from the CUDA sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rgbd_recon_tpu.ops import raymarch as jax_raymarch

from rgbd_recon_tpu_torch.kernels.hits import input_rows
from rgbd_recon_tpu_torch.ops import hits, raymarch, render_stages
from rgbd_recon_tpu_torch.ops.stage_calls import all_bits_equal, bits_equal

import setup_refine_cases as cases

torch.set_num_threads(2)

CSRC = Path(render_stages.__file__).resolve().parent.parent / "csrc"
POS_ATOL = 1e-6
# the set-up's tile (csrc/render_stages.cu) and the refine's chunk
# (csrc/hits.cu)
SETUP_TX, SETUP_TY = 32, 8
SETUP_ROWS, SETUP_COLS = SETUP_TY + 2, SETUP_TX + 2
REFINE_CHUNK = 4
KS = (3, 8, 9, 17)


def _constant(source: str, name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);",
                  (CSRC / source).read_text())
    return m[1]


def test_models_use_the_sources_constants():
    rs = "render_stages.cu"
    assert _constant(rs, "SETUP_TX") == str(SETUP_TX)
    assert _constant(rs, "SETUP_TY") == str(SETUP_TY)
    assert _constant(rs, "SETUP_ROWS") == "SETUP_TY + 2"
    assert _constant(rs, "SETUP_COLS") == "SETUP_TX + 2"
    assert _constant("hits.cu", "REFINE_CHUNK") == str(REFINE_CHUNK)


# ---- the set-up ---------------------------------------------------------------

def _t_min(a, b):
    """csrc/render_stages.cu t_min: a NaN a, else a NaN b, else the
    smaller; a on a tie (the model's rule for +-0.0: the fold's order then
    shows in the bits)."""
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.where(b < a, b, a)))


def _t_max(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b,
                                             np.where(b > a, b, a)))


# scan5's planes: first, last, first-surface, s0, s1; min pools for 0, 2, 3
OPS = (_t_min, _t_max, _t_min, _t_min, _t_max)


def setup_pools_as_kernel(g, scan5):
    """(5, Hb, Wb) pools of the (5, Hs, Ws) numpy ``scan5`` as the kernel
    computes them: for each tile, its cells i0 .. i0 + rows - 1 (rows and
    columns from the tile's first and last blocks) and a halo of one
    staged with clamped indices, each (cell, plane) folded once from the
    centre over the 9 taps row-major, each block reading its cell; every
    block written once, every tile's staging within SETUP_ROWS x
    SETUP_COLS."""
    Hb, Wb, Hs, Ws, sc = g.Hb, g.Wb, g.Hs, g.Ws, g.sc
    out = np.full((5, Hb, Wb), np.nan, np.float32)
    written = np.zeros((Hb, Wb), int)
    for by0 in range(0, Hb, SETUP_TY):
        for bx0 in range(0, Wb, SETUP_TX):
            i0, j0 = by0 // sc, bx0 // sc
            by = np.arange(by0, min(by0 + SETUP_TY, Hb))
            bx = np.arange(bx0, min(bx0 + SETUP_TX, Wb))
            rows = by[-1] // sc - i0 + 1
            cols = bx[-1] // sc - j0 + 1
            assert rows + 2 <= SETUP_ROWS and cols + 2 <= SETUP_COLS
            assert rows * cols <= SETUP_TX * SETUP_TY
            ys = np.clip(i0 - 1 + np.arange(rows + 2), 0, Hs - 1)
            xs = np.clip(j0 - 1 + np.arange(cols + 2), 0, Ws - 1)
            staged = scan5[:, ys[:, None], xs[None, :]]
            pool = np.empty((5, rows, cols), np.float32)
            for k in range(5):
                acc = staged[k, 1:rows + 1, 1:cols + 1]
                for dy in range(3):
                    for dx in range(3):
                        acc = OPS[k](acc, staged[k, dy:dy + rows,
                                                 dx:dx + cols])
                pool[k] = acc
            r = (by // sc - i0)[:, None]
            c = (bx // sc - j0)[None, :]
            out[:, by[:, None], bx[None, :]] = pool[:, r, c]
            written[by[:, None], bx[None, :]] += 1
    assert (written == 1).all()
    return out


def sequential_pools(g, scan5):
    """The same pools a block at a time (the kernel before: each block
    folds its cell's pools itself, pool3's clamped taps in the same
    order)."""
    Hs, Ws, sc = g.Hs, g.Ws, g.sc
    i = np.arange(g.Hb) // sc
    j = np.arange(g.Wb) // sc
    out = []
    for k in range(5):
        plane = scan5[k]
        acc = plane[i[:, None], j[None, :]]
        for dy in range(3):
            y = np.clip(i + dy - 1, 0, Hs - 1)
            for dx in range(3):
                x = np.clip(j + dx - 1, 0, Ws - 1)
                acc = OPS[k](acc, plane[y[:, None], x[None, :]])
        out.append(acc)
    return np.stack(out)


def setup_from_pools(g, pools, cam):
    """block_setup_plain's outputs from the blocks' pools (the twin's
    arithmetic after its upc, element for element)."""
    NB = g.NB
    first, last, fsurf, s0p, s1p = torch.from_numpy(pools)
    pad = g.pad
    found = torch.isfinite(first) & torch.isfinite(last)
    s_start = torch.maximum(
        torch.maximum(first - pad, fsurf - g.brick_norm - pad), s0p)
    s_end = torch.minimum(last + g.step_len + pad, s1p)
    length = torch.where(found, torch.clamp_min(s_end - s_start, 0.0), 0.0)
    s_start = torch.where(found, s_start, 0.0).reshape(NB)
    dirs = tuple(d.reshape(NB) for d in render_stages._block_centres(g, cam))
    pos0 = tuple(cam.eye_vol[a] + dirs[a] * s_start for a in range(3))
    blk = torch.stack([*pos0, *dirs, length.reshape(NB), s_start], dim=-1)
    flags = ((length > 0.0).reshape(NB).to(torch.uint8)
             | (found.reshape(NB).to(torch.uint8) << 1))
    inf = float("inf")
    grid = torch.stack([torch.zeros(NB), torch.full((NB,), inf),
                        torch.full((NB,), -inf)])
    return blk, s_end.reshape(NB), flags, grid


def twin_pools(g, scan5):
    """The twin's pools at block resolution (its upc: _pool3, repeated sc
    times each way, cut to Hb x Wb)."""
    out = []
    for k, op in enumerate((torch.minimum, torch.maximum, torch.minimum,
                            torch.minimum, torch.maximum)):
        p = render_stages._pool3(scan5[k], op)
        r = p.repeat_interleave(g.sc, 0).repeat_interleave(g.sc, 1)
        out.append(r[:g.Hb, :g.Wb])
    return torch.stack(out)


def _same_values(a, b) -> bool:
    """NaN where the other has NaN, equal elsewhere (+0.0 == -0.0)."""
    return (a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, 7.0), torch.nan_to_num(b, 7.0)))


def _bits(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.int32),
        np.ascontiguousarray(b).view(np.int32))


@pytest.mark.parametrize("Hb,Wb,sc,ds", cases.SETUP_GEOMETRIES)
def test_setup_model_matches_sequential_fold(Hb, Wb, sc, ds):
    """The tile model's pools bit for bit (NaN payloads and signed zeros
    included) against each block folding its own cell's pools, on planes
    with NaNs, signed zeros and infinities at the edges and corners."""
    for seed in (1, 2, 3):
        g, scan5, _ = cases.setup_case(seed, Hb, Wb, sc, ds, "cpu")
        planes = scan5.numpy()
        got = setup_pools_as_kernel(g, planes)
        assert _bits(got, sequential_pools(g, planes)), seed
        assert np.isnan(planes).any() and np.isinf(planes).any()
        assert (np.signbit(planes) & (planes == 0)).any()


@pytest.mark.parametrize("Hb,Wb,sc,ds", cases.SETUP_GEOMETRIES)
def test_setup_model_matches_twin(Hb, Wb, sc, ds):
    """The tile model's outputs (blk, s_end, flags, grid) against
    block_setup_plain: bit for bit on planes without NaNs or negative
    zeros, by value on planes with them (the module's note); its pools
    against the twin's upc the same way."""
    for seed, specials in ((4, False), (5, False), (6, True), (7, True)):
        g, scan5, cam = cases.setup_case(seed, Hb, Wb, sc, ds, "cpu",
                                         specials=specials)
        pools = setup_pools_as_kernel(g, scan5.numpy())
        got = setup_from_pools(g, pools, cam)
        want = render_stages.block_setup_plain(g, scan5, cam)
        want_pools = twin_pools(g, scan5)
        if not specials:
            assert all_bits_equal(got, want), seed
            assert bits_equal(torch.from_numpy(pools), want_pools), seed
            continue
        for k, (a, b) in enumerate(zip(got, want)):
            if a.is_floating_point():
                assert _same_values(a, b), (seed, k)
            else:
                assert torch.equal(a, b), (seed, k)
        assert _same_values(torch.from_numpy(pools), want_pools), seed


@pytest.mark.parametrize("sc", [1, 2, 3, 4, 5, 7, 8, 9, 16, 33])
def test_setup_staging_holds_every_scan_stride(sc):
    """A tile's cells and halo fit the staging at every scan stride (the
    model asserts it tile by tile), at the cells' camera and a ragged one."""
    for Hb, Wb in ((180, 320), (37, 101)):
        g = cases.geometry(Hb, Wb, sc, 4)
        planes = cases.scan_planes(sc, g.Hs, g.Ws, True)
        assert _bits(setup_pools_as_kernel(g, planes),
                     sequential_pools(g, planes))


@pytest.mark.parametrize("sc", [0, -1])
def test_setup_wrapper_refuses_a_stride_it_cannot_stage(sc):
    """A scan stride below 1 is refused with ValueError before the wrapper
    looks at the tensors (the planes' shape would divide by it)."""
    from rgbd_recon_tpu_torch.kernels.render_stages import block_setup_cuda

    g = cases.geometry(9, 13, sc, 4)
    cam = cases.camera(1, "cpu")
    with pytest.raises(ValueError, match="scan stride"):
        block_setup_cuda(g, torch.zeros(5, 5, 7), cam)


def _divisor(d: int):
    """csrc/render_stages.cu and csrc/hits.cu divisor(d): (magic, shift)."""
    shift = 31 + max(d - 1, 0).bit_length()
    return ((1 << shift) + d - 1) // d, shift


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 10, 20, 31, 32, 33, 100,
                               1000, 65_535, 2 ** 20 + 1])
def test_divisor_is_exact(d):
    """v // d as (v * magic) >> shift for v in [0, 2^31): every v below
    20,000 and 20,000 seeded ones up to 2^31 - 1, and the top; the product
    below 2^64."""
    magic, shift = _divisor(d)
    assert magic <= 2 ** 32
    rng = np.random.default_rng(d)
    vs = np.concatenate([np.arange(20_000), rng.integers(0, 2 ** 31, 20_000),
                         [2 ** 31 - 1, 2 ** 31 - 2]]).astype(object)
    for v in vs:
        assert v * magic < 2 ** 64
        assert (v * magic) >> shift == v // d, v


# ---- the refine ---------------------------------------------------------------

def first_rising_loop(d):
    """(k*, d_lo, d_hi) one sample after the other with a break at the
    first k with d_k > 0 and d_k-1 <= 0 (the kernel before); -1 without."""
    prev = np.float32(0.0)
    for k, x in enumerate(d):
        if k > 0 and x > 0.0 and prev <= 0.0:
            return k - 1, prev, x
        prev = x
    return -1, np.float32(0.0), np.float32(0.0)


def first_rising_chunked(d, chunk=REFINE_CHUNK):
    """The same as the kernel runs it: each chunk's samples all first,
    then the test over the chunk, the pair across a chunk's end from the
    previous chunk's last sample; no chunk after the one that holds the
    rise."""
    K = len(d)
    kstar, prev = -1, np.float32(0.0)
    d_lo = d_hi = np.float32(0.0)
    k0 = 0
    while k0 < K and kstar < 0:
        samples = [d[k] for k in range(k0, min(k0 + chunk, K))]
        for c, x in enumerate(samples):
            k = k0 + c
            if kstar < 0:
                if k > 0 and x > 0.0 and prev <= 0.0:
                    kstar, d_lo, d_hi = k - 1, prev, x
                prev = x
        k0 += chunk
    return kstar, d_lo, d_hi


def first_rising_twin(d):
    """oct_refine_crossing's selection: the rising pairs, any, argmax."""
    t = torch.from_numpy(np.asarray(d, np.float32))
    rising = (t[1:] > 0.0) & (t[:-1] <= 0.0)
    if not bool(rising.any()):
        return -1
    return int(rising.to(torch.float32).argmax())


def _f32_bits(x):
    return int(np.float32(x).view(np.int32))


@pytest.mark.parametrize("K", KS)
def test_chunked_bracket_matches_loop_and_twin(K):
    """On every crafted sequence: the chunked selection's k*, d_lo and
    d_hi bit for bit the loop's, its k* the twin's; chunks of 1, 3,
    REFINE_CHUNK and 8."""
    seqs = cases.crafted_d(K)
    assert {"rise_at_1", "rise_at_last", "nan_before_rise",
            "nan_after_rise", "pos_zero_before",
            "neg_zero_before"} <= set(seqs)
    for name, d in seqs.items():
        want = first_rising_loop(d)
        assert first_rising_twin(d) == want[0], name
        for chunk in (1, 3, REFINE_CHUNK, 8):
            got = first_rising_chunked(d, chunk)
            assert got[0] == want[0], (name, chunk)
            assert _f32_bits(got[1]) == _f32_bits(want[1]), (name, chunk)
            assert _f32_bits(got[2]) == _f32_bits(want[2]), (name, chunk)
    # the sequences reach the rises they are named for
    assert first_rising_loop(seqs["rise_at_1"])[0] == 0
    assert first_rising_loop(seqs["rise_at_last"])[0] == K - 2
    assert first_rising_loop(seqs["all_nan"])[0] == -1
    assert first_rising_loop(seqs["zero_is_not_a_rise"])[0] == 1
    if K > 8:
        assert first_rising_loop(seqs["rise_across_chunk"])[0] == 7


class CraftedOct:
    """An oct table whose samples are given: ``d`` (n, K) for the widened
    bracket's K samples a hit, ``dm`` (n,) for the secant's sample."""

    def __init__(self, d, dm, lib=torch):
        self.d, self.dm, self.lib = d, dm, lib

    def sample_p(self, px, py, pz, fill):
        return self.d if px.ndim == 2 else self.dm


def refine_chunked(pos0, dn, lo_t, hi_t, hit, hit_pos, limit, d, sample,
                   widen_steps, K):
    """The widened refine as the kernel runs it: the K samples ``d`` (n, K)
    of each hit, the first rising pair chunk by chunk, the two secant
    iterations (``sample(ts)`` the secant's sample) in the twin's
    arithmetic; a hit not live or without a rise keeps ``hit_pos``."""
    sd = float(np.float32(limit) * np.float32(0.5))
    span_lo = lo_t - widen_steps * sd
    span = (hi_t - lo_t) + 2.0 * widen_steps * sd
    sel = [first_rising_chunked(row) for row in d.numpy()]
    kstar = torch.tensor([max(k, 0) for k, _, _ in sel], dtype=torch.int64)
    found = hit & torch.tensor([k >= 0 for k, _, _ in sel])
    d_lo = torch.gather(d[:, :-1], 1, kstar[:, None])[:, 0]
    d_hi = torch.gather(d[:, 1:], 1, kstar[:, None])[:, 0]
    for i, (k, lo, hi) in enumerate(sel):
        if k >= 0:
            assert _f32_bits(d_lo[i]) == _f32_bits(lo)
            assert _f32_bits(d_hi[i]) == _f32_bits(hi)
    step = span / (K - 1)
    t_lo = span_lo + kstar.to(torch.float32) * step
    t_hi = t_lo + step
    ts = t_hi - (t_hi - t_lo) * (d_hi / raymarch._secant_den(d_hi - d_lo))
    dm = sample(ts)
    up = dm > 0.0
    t_lo2 = torch.where(up, t_lo, ts)
    d_lo2 = torch.where(up, d_lo, dm)
    t_hi2 = torch.where(up, ts, t_hi)
    d_hi2 = torch.where(up, dm, d_hi)
    tstar = t_hi2 - (t_hi2 - t_lo2) * (d_hi2 / raymarch._secant_den(
        d_hi2 - d_lo2))
    refined = torch.stack([p + v * tstar for p, v in zip(pos0, dn)], dim=-1)
    return torch.where(found[:, None], refined, hit_pos)


def _crafted_hits(K, seed):
    """(args of refine_hits_plain, d (n, K), dm (n,)): a hit a crafted
    sequence (each sequence twice: live, then dead), seeded rays."""
    seqs = cases.crafted_d(K)
    rng = np.random.default_rng(seed)
    d = np.stack([*seqs.values(), *seqs.values()])
    n = len(d)
    f32 = np.float32

    def t(x):
        return torch.from_numpy(np.asarray(x, f32))

    pos0 = tuple(t(rng.uniform(0.2, 0.8, n)) for _ in range(3))
    dn = tuple(t(rng.normal(0.0, 1.0, n)) for _ in range(3))
    lo = rng.uniform(0.1, 0.5, n).astype(f32)
    hi = (lo + rng.uniform(0.001, 0.01, n)).astype(f32)
    dm = t(rng.choice([-0.02, 0.0, 0.03, np.nan], n))
    hit = torch.from_numpy(np.arange(n) < n // 2)
    hit_pos = t(rng.uniform(0.0, 1.0, (n, 3)))
    return (pos0, dn, t(lo), t(hi), hit, hit_pos, 0.01), t(d), dm


@pytest.mark.parametrize("K", KS)
def test_chunked_refine_matches_twin_on_crafted_samples(K):
    """The refine with the chunked selection bit for bit against
    refine_hits_plain fed the same samples (an oct table that answers the
    crafted sequences), live and dead hits."""
    args, d, dm = _crafted_hits(K, K)
    oct = CraftedOct(d, dm)
    want = hits.refine_hits_plain(*args, oct=oct, widen_steps=1.5,
                                  widen_samples=K)
    got = refine_chunked(*args, d, lambda ts: dm, 1.5, K)
    assert bits_equal(got, want)
    # live rises moved, dead hits and live ones without a rise kept
    assert bool((got != args[5]).any(dim=-1)[: len(d) // 2].any())
    assert torch.equal(got[len(d) // 2:], args[5][len(d) // 2:])


@pytest.mark.parametrize("K", KS)
def test_chunked_refine_matches_jax_on_finite_samples(K):
    """The same within POS_ATOL of the JAX package's oct_refine_crossing on
    the sequences without NaN or infinity (its selection multiplies the
    samples by a one-hot, so a NaN or an infinity anywhere in a row reaches
    its d_lo)."""
    args, d, dm = _crafted_hits(K, 100 + K)
    dm = torch.nan_to_num(dm, 0.01)
    keep = torch.isfinite(d).all(dim=1)
    d = d[keep]
    args = (tuple(x[keep] for x in args[0]), tuple(x[keep] for x in args[1]),
            args[2][keep], args[3][keep], args[4][keep], args[5][keep],
            args[6])
    dm = dm[keep]
    got = refine_chunked(*args, d, lambda ts: dm, 1.5, K)

    def j(x):
        return jnp.asarray(x.numpy())

    want = jax_raymarch.oct_refine_crossing(
        CraftedOct(j(d), j(dm)), tuple(j(x) for x in args[0]),
        tuple(j(x) for x in args[1]), j(args[2]), j(args[3]), j(args[4]),
        j(args[5]), args[6], widen_steps=1.5, widen_samples=K)
    assert len(d) >= 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=POS_ATOL)


@pytest.fixture(scope="module")
def render_hits():
    """The refine call one CPU render of the small scene (20 cm bricks,
    the fast config: the oct table, widened) hands to ops.hits."""
    from hit_cases import record_hits
    from test_torch_kernels import _hit_scene

    pipe, volume, maps, counts, cam = _hit_scene("cpu")
    render = pipe.make_renderer(cam)
    calls = record_hits(lambda: render(volume, maps, counts))
    return calls["refine"]


@pytest.mark.parametrize("K", KS)
def test_chunked_refine_matches_twin_on_render_hits(render_hits, K):
    """On a render's hits and its oct table, K samples a hit: the refine
    with the chunked selection (the samples the twin's sample_p gives)
    bit for bit against refine_hits_plain; the hits reach rises in the
    first chunk and, at K = 9 and 17, past it."""
    args, kwargs = render_hits
    oct = kwargs["oct"]
    pos0, dn, lo_t, hi_t, hit, hit_pos, limit = args
    ws = kwargs["widen_steps"]
    assert ws > 0.0
    sd = float(np.float32(limit) * np.float32(0.5))
    span_lo = lo_t - ws * sd
    span = (hi_t - lo_t) + 2.0 * ws * sd
    ks = torch.arange(K, dtype=torch.float32) / (K - 1)
    tk = span_lo[..., None] + ks * span[..., None]
    d = oct.sample_p(*[p[..., None] + v[..., None] * tk
                       for p, v in zip(pos0, dn)], -limit)

    def sample(ts):
        return oct.sample_p(*[p + v * ts for p, v in zip(pos0, dn)], -limit)

    want = hits.refine_hits_plain(*args, oct=oct, widen_steps=ws,
                                  widen_samples=K)
    got = refine_chunked(*args, d, sample, ws, K)
    assert bits_equal(got, want)
    ks_found = [first_rising_chunked(row)[0] for row in d[hit].numpy()]
    assert sum(k >= 0 for k in ks_found) > 100
    if K > REFINE_CHUNK:
        assert any(k >= REFINE_CHUNK - 1 for k in ks_found)


def test_refine_row_path_choice():
    """input_rows: the 8 column views of a row-major (n, 8) f32 tensor on
    16 bytes (the render's hit rows) take the row path; separate tensors,
    an (n, 8) view 4 bytes off 16, an (n, 9) tensor's first 8 columns and
    a broadcast input take the strided scalar path."""
    n = 37
    rows = torch.empty((n, 8))
    assert rows.data_ptr() % 16 == 0

    def cols(t):
        return [t[:, k] for k in range(8)]

    assert input_rows(cols(rows)) == rows.data_ptr()
    assert input_rows(cols(rows) + [torch.zeros(n)] * 3) == rows.data_ptr()
    assert input_rows([c.clone() for c in cols(rows)]) == 0
    flat = torch.empty(n * 8 + 4)
    off = flat[1:1 + n * 8].view(n, 8)
    assert off.data_ptr() % 16 == 4
    assert input_rows(cols(off)) == 0
    assert input_rows(cols(torch.empty((n, 9)))[:8]) == 0
    wide = cols(rows)
    wide[6] = torch.broadcast_to(torch.zeros(1), (n,))
    assert input_rows(wide) == 0
    # a row of 16-byte aligned rows further on: still the row path
    assert input_rows(cols(rows[2:])) == rows[2:].data_ptr()


def test_variant_sources_replace_their_regions():
    """bench/setup_refine_variants.py's variants: each region's start found
    once in the CUDA sources and the region replaced, the rest of both
    files unchanged; the kept variant the sources themselves."""
    from rgbd_recon_tpu_torch.bench import setup_refine_variants as srv

    texts = tuple(s.read_text() for s in srv.SOURCES)
    assert srv.variant_sources(texts, srv.VARIANTS["kept"]) == texts
    for name, changes in srv.VARIANTS.items():
        got = srv.variant_sources(texts, changes)
        for change in changes:
            k, start, end, other = change
            a = texts[k].index(start)
            b = texts[k].index(end, a)
            assert not other or got[k].count(other) == 1, name
            one = srv.variant_sources(texts, (change,))[k]
            assert one == texts[k][:a] + other + texts[k][b:], name
        changed = {k for k, *_ in changes}
        for k in set(range(2)) - changed:
            assert got[k] == texts[k], name
        assert (got != texts) == bool(changes), name
    assert set(srv.STRIPPED) < set(srv.VARIANTS)
    with pytest.raises(ValueError, match="not found once"):
        srv.variant_sources(texts, ((0, "no such text", "", ""),))


def test_variant_ptxas_usage():
    """The ptxas -v lines of a kernel's template instances read into
    (registers, shared bytes, spill bytes)."""
    from rgbd_recon_tpu_torch.bench.setup_refine_variants import ptxas_usage

    report = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113refine_kernelIfEEvNS_12RefineParamsENS_7DivisorE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113refine_kernelIfEEvNS_12RefineParamsENS_7DivisorE
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113refine_kernelItEEvNS_12RefineParamsENS_7DivisorE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113refine_kernelItEEvNS_12RefineParamsENS_7DivisorE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118block_setup_kernelENS_12RenderParamsENS_7DivisorE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118block_setup_kernelENS_12RenderParamsENS_7DivisorE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 20112 bytes smem
"""
    assert ptxas_usage(report, "refine_kernel") == {"f32": (96, 0, 8),
                                                    "bf16": (80, 0, 0)}
    assert ptxas_usage(report, "block_setup_kernel") == {
        "kernel": (38, 20112, 0)}
