"""The stepwise march of the port: its per-ray form against its vectorized
twin, and the CPU dispatch and argument checks of its CUDA wrapper.

``_march_per_ray`` is the algorithm of csrc/march.cu written as a numpy
float32 loop, one ray at a time and without the twin's global exit check:
each ray steps until it hits, passes its length or spends the budget. It
must equal ``ops.raymarch.march_plain`` bit for bit on every case below,
which shows that one thread a ray computes what the vectorized loop does
before the kernel itself is held to the twin on the card
(tests/test_torch_kernels.py, ``cuda``-marked).
"""

import numpy as np
import pytest
import torch

from rgbd_recon_tpu_torch import kernels
from rgbd_recon_tpu_torch.ops import bake, raymarch

torch.set_num_threads(2)

LIMIT = 0.04
SHAPE = (20, 24, 22)
BRICK_VOX = 4
F = np.float32


def _volume():
    """TSDF-like (Z, Y, X) volume of a sphere, clamped to +-LIMIT, with
    seeded values in [-LIMIT, LIMIT / 2] on the two outer layers of each
    face (the edge taps and clamps see differing texels there)."""
    z, y, x = np.meshgrid(*(np.arange(s) + 0.5 for s in SHAPE),
                          indexing="ij")
    Z, Y, X = SHAPE
    r = np.sqrt((x - X / 2) ** 2 + (y - Y / 2) ** 2 + (z - Z / 2) ** 2)
    vol = np.clip((min(SHAPE) * 0.3 - r) * LIMIT * 0.4, -LIMIT, LIMIT)
    face = np.ones(SHAPE, bool)
    face[2:-2, 2:-2, 2:-2] = False
    noise = np.random.default_rng(5).uniform(-LIMIT, LIMIT / 2, SHAPE)
    return np.where(face, noise, vol).astype(np.float32)


def _table(kind):
    """(torch table, sentinel_skip) of a case: the raw f32 volume, or its
    sentinel-coded table (the render's bake rule) in bf16 or f32."""
    vol = torch.from_numpy(_volume())
    if kind == "raw_f32":
        return vol, False
    occ = bake.surface_occ_plain(vol, BRICK_VOX)
    bs = (bake.fine_safe_field(occ, 2) * float(BRICK_VOX)).contiguous()
    dtype = torch.bfloat16 if kind == "sentinel_bf16" else torch.float32
    return bake.sentinel_bake_plain(vol, bs, BRICK_VOX, 3, dtype), True


def _rays(rng, n):
    """((pos0 x, y, z), length) and (dir x, y, z) as float32 numpy: half
    the rays aimed at the sphere from a shell around the cube, half from
    anywhere in any direction; lengths in [0, 1.4], a few of them 0 or
    negative."""
    start = rng.uniform(-0.2, 1.2, (3, n))
    aim = 0.5 + rng.normal(0.0, 0.12, (3, n)) - start
    d = np.where(np.arange(n) < n // 2, aim, rng.normal(size=(3, n)))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    length = rng.uniform(0.0, 1.4, n)
    length[rng.random(n) < 0.06] = 0.0
    length[rng.random(n) < 0.03] = -0.1
    return (start.astype(F), length.astype(F)), d.astype(F)


def _sample(tab, px, py, pz, mode):
    """One sample of the f32 values ``tab`` as the kernel takes it."""
    D, H, W = tab.shape

    def idx(v, n):
        return min(max(int(v), 0), n - 1)

    if mode == "nearest":
        return tab[idx(pz * F(D), D), idx(py * F(H), H), idx(px * F(W), W)]
    cx = px * F(W) - F(0.5)
    cy = py * F(H) - F(0.5)
    cz = pz * F(D) - F(0.5)
    x0f, y0f, z0f = np.floor(cx), np.floor(cy), np.floor(cz)
    fx = F(0.0) if x0f < 0 else cx - x0f
    fy, fz = cy - y0f, cz - z0f
    x0 = idx(x0f, W)
    x1 = min(x0 + 1, W - 1)
    y0, y1 = idx(y0f, H), idx(y0f + F(1.0), H)
    z0, z1 = idx(z0f, D), idx(z0f + F(1.0), D)

    def pair(z, y):
        return tab[z, y, x0] * (F(1.0) - fx) + tab[z, y, x1] * fx

    c0 = pair(z0, y0) * (F(1.0) - fy) + pair(z0, y1) * fy
    c1 = pair(z1, y0) * (F(1.0) - fy) + pair(z1, y1) * fy
    return c0 * (F(1.0) - fz) + c1 * fz


def _march_per_ray(tab, limit, max_steps, start_end, dirs, mode,
                   sentinel_skip, sentinel_scale, resume=None):
    """csrc/march.cu's algorithm in numpy float32 scalars, one ray at a
    time: -> (hit, num, (t, prev_t, prev, lo_t, hi_t, hit_t)) as arrays."""
    (p0, length) = start_end
    n = length.shape[0]
    neg_limit, sd = F(-limit), F(limit) * F(0.5)
    scale = F(sentinel_scale)
    hit = np.zeros(n, bool)
    num = np.zeros(n, np.int32)
    state = np.zeros((6, n), F)
    for i in range(n):
        if resume is None:
            t, prev_t, prev = F(0.0), F(0.0), neg_limit
        else:
            t, prev_t, prev = (F(r[i]) for r in resume)
        lo_t = hi_t = hit_t = F(0.0)
        steps = max_steps if length[i] > 0 else 0
        k = 0
        while k < steps and t <= length[i]:
            px, py, pz = (p0[a][i] + dirs[a][i] * t for a in range(3))
            raw = F(_sample(tab, px, py, pz, mode))
            density = neg_limit if raw < neg_limit else raw
            found = density > 0
            if found:
                den = density - prev
                den = F(1e-20) if abs(den) < F(1e-20) else den
                hit_t = t - (t - prev_t) * (density / den)
                lo_t, hi_t = prev_t, t
            advance = sd
            if sentinel_skip and raw < F(-1.5):
                clr = (-raw - F(2.0)) * scale
                advance = sd if clr < sd else clr
            num[i] += 1
            prev_t, prev = t, density
            t = t + advance
            k += 1
            if found:
                hit[i] = True
                break
        state[:, i] = (t, prev_t, prev, lo_t, hi_t, hit_t)
    return hit, num, tuple(state)


def _assert_bit_equal(got, want):
    """hit, num and the six state values bit for bit (numpy arrays or CPU
    tensors)."""
    hit, num, st = got
    hw, nw, sw = want
    np.testing.assert_array_equal(np.asarray(hit), np.asarray(hw))
    np.testing.assert_array_equal(np.asarray(num), np.asarray(nw))
    for name, a, b in zip(("t", "prev_t", "prev", "lo_t", "hi_t", "hit_t"),
                          st, sw):
        a, b = np.asarray(a, F), np.asarray(b, F)
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), name


def _plain(table, max_steps, start_end, dirs, mode, skip, resume=None):
    (p0, length), d = start_end, dirs
    return raymarch.march_plain(
        table, LIMIT, max_steps,
        (tuple(torch.from_numpy(x) for x in p0), torch.from_numpy(length)),
        tuple(torch.from_numpy(x) for x in d), mode=mode,
        sentinel_skip=skip, sentinel_scale=1.0 / max(SHAPE),
        resume=None if resume is None else tuple(
            torch.from_numpy(np.ascontiguousarray(x)) for x in resume))


CASES = [("nearest", "sentinel_bf16"), ("nearest", "raw_f32"),
         ("nearest", "sentinel_f32"), ("trilinear", "raw_f32"),
         ("trilinear", "sentinel_bf16")]


@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("max_steps", [0, 1, 7, 8, 9, 64])
@pytest.mark.parametrize("mode,kind", CASES)
def test_per_ray_march_equals_plain(mode, kind, max_steps, resume):
    """One ray at a time, each stopping on its own, equals the vectorized
    twin bit for bit: hits, step counts and the six state values. With
    ``resume`` the rays restart from the twin's state after 5 steps, some
    of them with t pushed past their length (never active again)."""
    table, skip = _table(kind)
    tab = table.to(torch.float32).numpy()
    rng = np.random.default_rng(max_steps + 100 * resume)
    start_end, dirs = _rays(rng, 96)
    res = None
    if resume:
        _, _, st = _plain(table, 5, start_end, dirs, mode, skip)
        res = [x.numpy().copy() for x in st[:3]]
        past = rng.random(96) < 0.1
        res[0][past] = start_end[1][past] + F(0.05)
    want = _plain(table, max_steps, start_end, dirs, mode, skip, res)
    got = _march_per_ray(tab, LIMIT, max_steps, start_end, dirs, mode, skip,
                         1.0 / max(SHAPE), res)
    _assert_bit_equal(got, want)
    if max_steps == 64 and not resume:
        assert int(got[0].sum()) > 10          # the cases reach the surface
    if max_steps == 0:
        assert not got[0].any() and not got[1].any()


def test_unmarchable_rays_keep_their_initial_state():
    """Rays of length <= 0 and resumed rays past their length take no step:
    hit False, num 0, (t, prev_t, prev) as given (or 0, 0, -limit), the
    bracket and hit_t 0."""
    table, skip = _table("sentinel_bf16")
    start_end, dirs = _rays(np.random.default_rng(3), 16)
    (p0, length) = start_end
    length[:8] = np.array([0, -1, 0, -0.5, 0, 0, -2, 0], F)
    hit, num, st = _plain(table, 64, (p0, length), dirs, "nearest", skip)
    assert not hit[:8].any() and not num[:8].any()
    for v, want in zip(st, (0.0, 0.0, -LIMIT, 0.0, 0.0, 0.0)):
        assert (v.numpy()[:8] == F(want)).all()
    res = [np.full(16, 0.3, F), np.full(16, 0.2, F), np.full(16, -0.01, F)]
    length[:] = 0.25
    got = _march_per_ray(table.float().numpy(), LIMIT, 64, (p0, length),
                         dirs, "nearest", skip, 1.0 / max(SHAPE), res)
    assert not got[0].any() and not got[1].any()
    _assert_bit_equal(got, (np.zeros(16, bool), np.zeros(16, np.int32),
                            (*res, *np.zeros((3, 16), F))))
    _assert_bit_equal(got, _plain(table, 64, (p0, length), dirs, "nearest",
                                  skip, res))


@pytest.mark.parametrize("mode,kind", CASES)
def test_march_on_cpu_is_the_plain_march(mode, kind):
    """``march`` on a CPU table returns march_plain's result exactly and
    launches nothing."""
    table, skip = _table(kind)
    start_end, dirs = _rays(np.random.default_rng(7), 200)
    (p0, length) = start_end
    args = (table, LIMIT, 40,
            (tuple(torch.from_numpy(x) for x in p0), torch.from_numpy(length)),
            tuple(torch.from_numpy(x) for x in dirs))
    kw = dict(mode=mode, sentinel_skip=skip, sentinel_scale=1.0 / 24)
    kernels.reset_launch_counts()
    got = raymarch.march(*args, **kw)
    want = raymarch.march_plain(*args, **kw)
    assert kernels.launch_counts()["march"] == 0
    _assert_bit_equal(got, want)


def test_march_cuda_rejects_what_it_does_not_take():
    """march_cuda's checks, none of which needs the card or nvcc: a table
    of another type, shape or layout, one of 2^31 entries (a meta tensor),
    a mode it lacks, a negative budget, per-ray inputs of another type or
    device, and CPU tensors."""
    from rgbd_recon_tpu_torch.kernels.raymarch import march_cuda

    def rays(n=4, dtype=torch.float32, device="cpu"):
        z = torch.zeros(n, dtype=dtype, device=device)
        return ((z, z, z), z), (z, z, z)

    def call(table, *a, **kw):
        start_end, dirs = rays(*a)
        return march_cuda(table, LIMIT, 8, start_end, dirs, **kw)

    kernels.reset_launch_counts()
    vol = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="table must be one of"):
        call(vol.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        call(vol.permute(2, 1, 0))
    with pytest.raises(ValueError, match="contiguous"):
        call(vol[0])
    big = torch.empty((2 ** 11, 2 ** 10, 2 ** 10), dtype=torch.bfloat16,
                      device="meta")
    with pytest.raises(ValueError, match="2\\^31 entries"):
        call(big, 4, torch.float32, "meta")
    with pytest.raises(ValueError, match="mode"):
        call(vol, mode="cubic")
    with pytest.raises(ValueError, match="max_steps"):
        march_cuda(vol, LIMIT, -1, *rays())
    with pytest.raises(ValueError, match="float32 tensors"):
        call(vol, 4, torch.float64)
    with pytest.raises(ValueError, match="float32 tensors"):
        call(vol, 4, torch.float32, "meta")
    with pytest.raises(ValueError, match="at most 2\\^31 - 1 rays"):
        call(torch.zeros(SHAPE, device="meta"), 2 ** 31, torch.float32,
             "meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(vol)
    assert kernels.launch_counts()["march"] == 0
