"""The gather-rate probe's four gathers (rgbd_recon_tpu_torch/ops/gather.py)
against the XLA forms of scripts/probe_pallas_gather.py, which its Pallas
kernels compute: ``table[idx]`` (``pallas_take``), ``jnp.take(table, idx,
axis=0)`` (``pallas_take2``) and ``jnp.take_along_axis`` along axis 1
(``pallas_taa``) and axis 0 (``pallas_taas``). The script runs its probe
when imported, so its functions are restated here. Inputs are made with
numpy from a seed, indices in range; a gather copies values, so every
comparison is bit for bit, also at odd lengths and column counts and on
index views at storage offsets 1-3 (``idx[k:]``, not 16-byte aligned).
Then the probe's own formulations and edge cases on the CPU (each twin and
library call equal), and the dispatch: CPU tensors take the plain twin and
launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_recon_tpu_torch import kernels
from rgbd_recon_tpu_torch.bench import gather_probe
from rgbd_recon_tpu_torch.ops import gather

# an H100's limits: the longest rows gather_rows_cluster holds in clusters
# of 4 and 8 blocks, the largest table of gather_flat_smem
H100_LIMITS = (232_416, 464_832, 58_112)


def _inputs(seed, table_shape, idx_shape, axis_len):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal(table_shape).astype(np.float32)
    i = rng.integers(0, axis_len, idx_shape, dtype=np.int32)
    return t, i


def _offset_view(i, axis_len, offset):
    """``i``, its first index set to 0 and its last to ``axis_len - 1``, as
    a contiguous view at storage ``offset`` of a larger buffer, as
    ``idx[k:]`` gives one."""
    i.reshape(-1)[[0, -1]] = 0, axis_len - 1
    buf = torch.zeros(offset + i.size, dtype=torch.int32)
    buf[offset:] = torch.from_numpy(i.reshape(-1))
    view = buf[offset:].view(i.shape)
    assert view.storage_offset() == offset and view.is_contiguous()
    return view


# (n, m, storage offset of idx): the first three with their earlier ids;
# then odd lengths, each on a view at one offset
@pytest.mark.parametrize("n,m,offset", [
    pytest.param(1 << 16, 1 << 16, 0, id="65536-65536"),
    pytest.param(1000, 777, 0, id="1000-777"),
    pytest.param(1, 5, 0, id="1-5"),
    *[pytest.param(4099, m, off, id=f"4099-{m}-offset{off}")
      for m, off in [(1, 1), (3, 2), (4, 3), (5, 1), (129, 2),
                     ((1 << 20) + 3, 3)]]])
def test_flat_matches_take(n, m, offset):
    t, i = _inputs(n + m, (n,), (m,), n)
    idx = _offset_view(i, n, offset) if offset else torch.from_numpy(i)
    want = np.asarray(jnp.asarray(t)[jnp.asarray(i)])
    want_take = np.asarray(jnp.take(jnp.asarray(t), jnp.asarray(i), axis=0))
    np.testing.assert_array_equal(want, want_take)
    for fn in (gather.gather_flat, gather.gather_flat_smem,
               gather.gather_flat_plain):
        got = fn(torch.from_numpy(t), idx).numpy()
        assert got.dtype == np.float32 and got.shape == (m,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,m", [((8, 1 << 13), 1 << 13), ((3, 1001), 517),
                                     ((1, 4), 9)])
def test_rows_match_take_along_axis_1(shape, m):
    t, i = _inputs(m, shape, (shape[0], m), shape[1])
    want = np.asarray(jnp.take_along_axis(jnp.asarray(t), jnp.asarray(i),
                                          axis=1))
    for fn in (gather.gather_rows, gather.gather_rows_plain):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(t), torch.from_numpy(i)).numpy(), want)


# (table shape, m, storage offset of idx): the first three with their
# earlier ids; then C = 37, 4 and 128, each on a view at one offset
@pytest.mark.parametrize("shape,m,offset", [
    pytest.param((1 << 9, 128), 1 << 9, 0, id="shape0-512"),
    pytest.param((999, 37), 45, 0, id="shape1-45"),
    pytest.param((4, 1), 6, 0, id="shape2-6"),
    pytest.param((999, 37), 1001, 1, id="999x37-1001-offset1"),
    pytest.param((1000, 4), 129, 2, id="1000x4-129-offset2"),
    pytest.param((1 << 9, 128), 513, 3, id="512x128-513-offset3")])
def test_cols_match_take_along_axis_0(shape, m, offset):
    t, i = _inputs(m, shape, (m, shape[1]), shape[0])
    idx = (_offset_view(i, shape[0], offset) if offset
           else torch.from_numpy(i))
    want = np.asarray(jnp.take_along_axis(jnp.asarray(t), jnp.asarray(i),
                                          axis=0))
    for fn in (gather.gather_cols, gather.gather_cols_plain):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(t), idx).numpy(), want)


def test_probe_edge_cases_on_the_cpu():
    """The edge cases ``chip_smoke.py`` holds the four gathers to on the
    card (at an H100's shared memory): their shapes, storage offsets of
    table and indices and end indices, each through the dispatching
    function against the XLA form, bit for bit; on CPU tensors no kernel
    launches."""
    kernels.reset_launch_counts()
    cases = gather_probe.edge_cases("cpu", limits=H100_LIMITS)
    n = 1 << 20
    assert [(name, tuple(t.shape), t.storage_offset(), tuple(i.shape),
             i.storage_offset()) for _, name, t, i in cases] == [
        ("gather_flat", (n,), 0, (n + 3,), 0),
        ("gather_flat", (n,), 0, (n + 2,), 1),
        ("gather_cols", (999, 37), 0, (1001, 37), 0),
        ("gather_cols", (1 << 13, 128), 0, (1 << 13, 128), 3),
        ("gather_rows_cluster", (3, 1001), 0, (3, 517), 0),
        ("gather_rows_cluster", (5, 1 << 16), 0, (5, (1 << 15) + 4), 0),
        ("gather_rows_cluster", (2, 232_416), 0, (2, 5000), 0),
        ("gather_rows_cluster", (2, 232_417), 0, (2, 5000), 0),
        ("gather_rows_cluster", (1, 464_832), 0, (1, 5000), 0),
        ("gather_rows_cluster", (8, 1 << 17), 1, (8, 1 << 17), 0),
        ("gather_rows", (1, 464_833), 0, (1, 5000), 0),
        *[("gather_flat_smem", (1 << 15,), k, (n,), 0) for k in (1, 2, 3)],
        ("gather_flat_smem", (58_112,), 0, (n,), 0),
        *[("gather_flat_smem", (4099,), 0, (m,), 0) for m in (1, 3, 5)]]
    for label, name, t, i in cases:
        axis_len = t.shape[1] if name.startswith("gather_rows") else \
            t.shape[0]
        flat = i.reshape(-1)
        # (one lookup: the last index only)
        assert int(flat[0]) == (0 if flat.numel() > 1 else axis_len - 1)
        assert int(flat[-1]) == axis_len - 1, label
        assert int(i.min()) >= 0 and int(i.max()) < axis_len, label
        tj, ij = jnp.asarray(t.numpy()), jnp.asarray(i.numpy())
        if name in ("gather_flat", "gather_flat_smem"):
            got = getattr(gather, name)(t, i)
            want = jnp.take(tj, ij, axis=0)
        elif name.startswith("gather_rows"):
            # gather_rows_cluster's plain version: gather_rows' on the CPU
            got = gather.gather_rows(t, i)
            want = jnp.take_along_axis(tj, ij, axis=1)
        else:
            got = gather.gather_cols(t, i)
            want = jnp.take_along_axis(tj, ij, axis=0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_probe_row_rate_cases_on_the_cpu():
    """The rate sweep's rows: one row of 2^15-2^18 entries a case, 2^24
    indices in range (here 2^12), every row within what a cluster holds on
    an H100; the twin equals the library call."""
    cases = gather_probe.row_rate_cases("cpu", lookups=1 << 12)
    assert [tuple(t.shape) for _, t, _ in cases] == [
        (1, 1 << k) for k in (15, 16, 17, 18)]
    assert all(t.shape[1] <= H100_LIMITS[1] for _, t, _ in cases)
    for _, t, i in cases:
        assert i.shape == (1, 1 << 12) and i.dtype == torch.int32
        assert int(i.min()) >= 0 and int(i.max()) < t.shape[1]
        assert torch.equal(gather.gather_rows(t, i),
                           torch.take_along_dim(t, i.long(), dim=1))


def test_probe_formulations_on_the_cpu():
    """The probe's four formulations at 2^14 lookups into 2^14 entries
    (a 2^10-entry shared-memory table): twin, library call and the
    dispatching function agree, at the shapes the probe reshapes to; on
    CPU tensors no kernel launches."""
    kernels.reset_launch_counts()
    table, idx = gather_probe.make_inputs("cpu", 0, 1 << 14, 1 << 14)
    assert table.dtype == torch.float32 and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 1 << 14
    forms = gather_probe.formulations(table, idx, 1 << 10)
    assert [f.name for f in forms] == ["gather_flat", "gather_flat_smem",
                                       "gather_rows", "gather_cols"]
    shapes = [(1 << 14,), (1 << 14,), (8, 1 << 11), (1 << 7, 128)]
    for f, shape in zip(forms, shapes):
        got = f.kernel()
        assert got.shape == shape, f.name
        assert torch.equal(got, f.plain()) and torch.equal(got, f.library())
        assert f.moved[-1].shape == shape
        assert "scripts/probe_pallas_gather.py:" in f.replaces
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="cuda"):
        gather_probe.main([])


def test_probe_cluster_formulation_on_the_cpu():
    """gather_rows_cluster's probe formulation takes gather_rows' inputs,
    plain version and library call; its kernel needs the card (no plain
    fallback on CPU tensors)."""
    table, idx = gather_probe.make_inputs("cpu", 0, 1 << 14, 1 << 14)
    rows = gather_probe.formulations(table, idx)[2]
    f = gather_probe.cluster_formulation(table, idx)
    assert f.name == "gather_rows_cluster" and f.replaces == rows.replaces
    assert all(torch.equal(a, b) for a, b in zip(f.moved[:2], rows.moved))
    assert f.moved[2].shape == rows.moved[2].shape   # the output
    assert torch.equal(f.plain(), f.library())
    with pytest.raises(ValueError, match="CUDA"):
        f.kernel()
