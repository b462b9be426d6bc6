"""Inputs, work counts and the one-call library counterpart for the card's
checks of the render's compaction and the preprocess boundary pass
(``chip_smoke.py`` phase 3 and the ``cuda`` tests; the CPU tests hold the
same inputs against the JAX package):

- ``library_compact``: ``torch.nonzero_static`` on the compaction's flags;
- ``synthetic_flags`` and ``compact_scaling``: the kernel and the library
  call on synthetic flags at 184,320, 1,658,880 and 8,294,400 (a share
  0.35 set, capacity 0.55 n, the slot map off and on), each time's growth
  from size to size beside the growth of n;
- ``BOUNDARY_SHAPES``, ``boundary_maps`` and ``boundary_work``: maps with
  invalid edges at shapes that are no multiple of the boundary kernel's
  tile, and the bytes and operations the pass needs on given maps;
- ``morph_exits``: how many pixels of a depth map take each of the morph
  kernel's exits.
"""

from __future__ import annotations

SCALING_SIZES = (184_320, 1_658_880, 8_294_400)
SCALING_SHARE = 0.35
SCALING_CAPACITY = 0.55   # of n: the render's hit list's share


def library_compact(torch, flags, bit, capacity, ids=None):
    """(name, fn) of the one PyTorch call that computes the compaction's
    list on ``flags``' bit ``bit`` (the mask made before, outside the
    call): ``torch.nonzero_static(mask, size=capacity, fill_value=n)``,
    or ``torch.nonzero`` (a list of another length, the count's) where
    this PyTorch has no ``nonzero_static`` on the flags' device. Given
    ``ids`` (the compaction's list), ``nonzero_static``'s list is first
    held to it."""
    n = flags.shape[0]
    mask = (flags & (1 << bit)) != 0
    try:
        torch.nonzero_static(mask[:1], size=1, fill_value=n)
    except (AttributeError, NotImplementedError, RuntimeError):
        return "torch.nonzero", lambda: torch.nonzero(mask)

    def fn():
        return torch.nonzero_static(mask, size=capacity, fill_value=n)

    if ids is not None and not torch.equal(fn()[:, 0], ids):
        raise AssertionError("nonzero_static's list differs from the "
                             "compaction's")
    return "torch.nonzero_static", fn


def synthetic_flags(torch, n, share, bit, seed, device):
    """(n,) uint8 flags on ``device`` with bit ``bit`` set at a share
    ``share`` of them and the other bits random (a seeded generator)."""
    g = torch.Generator(device).manual_seed(seed)
    flags = torch.randint(0, 256, (n,), dtype=torch.uint8, device=device,
                          generator=g)
    on = torch.rand(n, device=device, generator=g) < share
    return torch.where(on, flags | (1 << bit), flags & (255 - (1 << bit)))


def compact_scaling(torch, timer, device, sizes=SCALING_SIZES):
    """The compaction kernel and its library call on synthetic flags at
    each of ``sizes``, with and without the slot map (the library call
    makes none): the kernel bit-equal to compact_plain and the library's
    list to the kernel's, each timed by ``timer`` (fn -> (cold ms, warm
    ms) between CUDA events: chip_smoke.py ``_events_ms``), each cold
    time's growth from the size before beside n's. One row a size and
    slot map."""
    from rgbd_recon_tpu_torch.kernels.compact import compact_cuda
    from rgbd_recon_tpu_torch.ops.compact import compact_plain
    from rgbd_recon_tpu_torch.ops.stage_calls import all_bits_equal

    rows = []
    for i, n in enumerate(sizes):
        flags = synthetic_flags(torch, n, SCALING_SHARE, 0, 11 + i, device)
        capacity = int(SCALING_CAPACITY * n)
        for want_slot in (False, True):
            counts = torch.zeros(1, dtype=torch.int32, device=device)
            want_counts = counts.clone()

            def kern():
                return compact_cuda(flags, 0, capacity, counts, 0, want_slot)

            got = kern()
            want = compact_plain(flags, 0, capacity, want_counts, 0,
                                 want_slot)
            if not (all_bits_equal(got, want)
                    and torch.equal(counts, want_counts)):
                raise AssertionError(f"compact differs from compact_plain "
                                     f"at {n} flags")
            lib_name, lib = library_compact(torch, flags, 0, capacity,
                                            ids=got[0])
            cold, warm = timer(kern)
            lib_cold, lib_warm = timer(lib)
            row = dict(n=n, capacity=capacity, slot=want_slot,
                       count=int(want_counts[0]), bit_equal=True,
                       events_cold_ms=cold, events_warm_ms=warm,
                       library=lib_name, library_events_cold_ms=lib_cold,
                       library_events_warm_ms=lib_warm)
            prev = [r for r in rows if r["slot"] == want_slot]
            if prev:
                row.update(
                    n_growth=n / prev[-1]["n"],
                    growth=cold / prev[-1]["events_cold_ms"],
                    library_growth=(lib_cold
                                    / prev[-1]["library_events_cold_ms"]))
            rows.append(row)
        del flags
    return rows


# shapes that are no multiple of the boundary kernel's 32 x 16 tile, and the
# reference's 4 x 424 x 512
BOUNDARY_SHAPES = ((1, 3, 4), (2, 5, 7), (1, 37, 70), (4, 424, 512))


def boundary_maps(torch, shape, seed, device):
    """(depth2 (n, h, w, 2), lab (n, h, w, 3)) for the boundary pass, from a
    seeded generator on ``device``: normalized depths with culled 0s and
    invalidated -1s, confidences around 0.65 (exactly 0.65 at some
    pixels), invalid pixels along every edge (outside, unreliable,
    invalidated in turn), a reliable left half (tiles that read no colour),
    LAB of the chain's scale with a patch of one colour (kept pixels)."""
    n, h, w = shape
    g = torch.Generator(device).manual_seed(seed)

    def uniform(lo, hi, size=shape):
        return lo + (hi - lo) * torch.rand(size, device=device, generator=g)

    d = uniform(0.1, 0.9)
    u = uniform(0.0, 1.0)
    d = torch.where(u < 0.08, 0.0, torch.where(u < 0.12, -1.0, d))
    q = uniform(0.3, 1.0)
    q = torch.where(uniform(0.0, 1.0) < 0.05, 0.65, q)
    q = torch.where(d <= 0.0, 0.0, q)
    left = torch.arange(w, device=device) < w // 2
    q = torch.where(left & (d > 0.0), 0.9, q)
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None]
    edge = (yy < 2) | (yy >= h - 2) | (xx < 2) | (xx >= w - 2)
    kind = (yy + xx) % 3
    d = torch.where(edge & (kind == 0), 0.0, torch.where(
        edge & (kind == 2), -1.0, d))
    q = torch.where(edge & (kind == 0), 0.0, torch.where(
        edge & (kind == 1), 0.5, torch.where(edge & (kind == 2), 0.1, q)))
    lab = torch.stack([uniform(0.0, 0.3), uniform(-0.1, 0.1),
                       uniform(-0.1, 0.1)], -1)
    lab[:, : h // 2, : w // 2] = lab[:, :1, :1]
    return torch.stack([d, q], -1).contiguous(), lab.contiguous()


def boundary_work(torch, depth2, lab, refine):
    """(bytes, operations) the boundary pass needs on these maps: depth2
    once, the LAB of the pixels inside the 5x5 windows of the pixels whose
    flags read their colour difference (unreliable, refine on), the two
    outputs once; 10 operations a pixel and 375 more (25 taps of 15: the
    distance, its square root, the sums) at each such pixel."""
    d, q = depth2[..., 0], depth2[..., 1]
    need = ((d > 0.0) & (q <= 0.65) & bool(refine)).to(torch.float32)
    window = torch.nn.functional.max_pool2d(need[:, None], 5, 1, 2)
    pixels = d.numel()
    nbytes = (depth2.numel() * 4 + int(window.sum()) * 3 * 4
              + pixels * (2 + 1) * 4)
    return nbytes, 10 * pixels + 375 * int(need.sum())


def morph_exits(torch, depth):
    """{exit: pixels} of the morph kernel on the (N, H, W) metric
    ``depth``: ``valid`` (a valid centre writes itself), ``no_valid_tap``
    (an invalid centre with no valid tap in its edge-clamped 3x3 window
    writes +0.0), ``two_pass`` (the rest run both passes), and ``pixels``,
    their sum."""
    import torch.nn.functional as F

    valid = (depth > 0.5) & (depth < 4.5)
    padded = F.pad(valid.to(torch.float32)[:, None], (1, 1, 1, 1),
                   mode="replicate")
    near = F.max_pool2d(padded, 3, stride=1)[:, 0] > 0.0
    return dict(valid=int(valid.sum()),
                no_valid_tap=int((~valid & ~near).sum()),
                two_pass=int((~valid & near).sum()), pixels=depth.numel())
