"""Gather-rate probe on the card (counterpart of
scripts/probe_pallas_gather.py).

    python -m rgbd_recon_tpu_torch.bench.gather_probe [--seed 0] [--iters 20]

Runs the four gathers of csrc/gather.cu at the TPU probe's shapes (2^20
f32 lookups by i32 indices: from a 4 MiB table, from a 2^15-entry table in
shared memory, along axis 1 of (8, 2^17) and along axis 0 of (2^13, 128)),
checks each against its plain twin (bit for bit), and prints one line per
formulation: name, ms and M lookups/s by CUDA events over back-to-back
calls (the table warm in L2), then the same for the one PyTorch call that
computes the same function. The data comes from a seeded
``torch.Generator`` on the card. Without a CUDA device it exits non-zero.

Then the same for ``gather_rows_cluster`` at the (8, 2^17) shape of
``gather_rows`` (each row held in a thread-block cluster's shared memory),
and the launch configurations of it and of ``gather_flat_smem``
(:func:`configuration`). Then the rate sweep (:func:`rate_cases`):
``gather_flat`` and ``torch.take`` at 2^24 uniform lookups into tables of
2^15 to 2^24 entries, and (:func:`row_rate_cases`) ``gather_rows`` (from
L2), ``gather_rows_cluster`` (from the cluster's shared memory) and
``torch.take_along_dim`` at 2^24 lookups into one row of 2^15 to 2^18
entries, G lookups/s by CUDA events over back-to-back calls; at 2^24
lookups a call takes about 0.1 ms or more on an H100, so the wrapper's
host time hides behind the device's. :func:`edge_cases` are odd shapes,
the clusters' capacity and views at a storage offset for the gathers
(``chip_smoke.py`` phase 13 holds the kernels to them).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Callable, List, Tuple

import torch

from ..ops import gather

LOOKUPS = 1 << 20
TABLE = 1 << 20         # f32 entries: 4 MiB
SMEM_TABLE = 1 << 15    # f32 entries: 128 KiB, in shared memory
PROBE = "scripts/probe_pallas_gather.py"


@dataclasses.dataclass
class Formulation:
    """One gather of the probe: the kernel, its plain twin and the library
    call on the same inputs, the Pallas functions it stands for, and the
    tensors the function must move (its inputs and output, for the
    bound)."""

    name: str
    replaces: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Callable[[], torch.Tensor]
    library_name: str
    moved: List[torch.Tensor]


def make_inputs(device, seed: int = 0, lookups: int = LOOKUPS,
                table: int = TABLE):
    """A normal f32 table and uniform i32 indices into it, from a seeded
    generator on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tab = torch.randn(table, generator=g, device=device)
    idx = torch.randint(0, table, (lookups,), generator=g, device=device,
                        dtype=torch.int32)
    return tab, idx


def formulations(table: torch.Tensor, idx: torch.Tensor,
                 smem_table: int = SMEM_TABLE) -> List[Formulation]:
    """The probe's four gathers on ``table`` (n,) and ``idx`` (m,), m and n
    multiples of 128, reshaped and reduced as the TPU probe does."""
    n, m = table.numel(), idx.numel()
    tab_s = table[:smem_table].contiguous()
    idx_s = idx % smem_table
    rows_t = table.reshape(8, n // 8)
    rows_i = (idx % (n // 8)).reshape(8, m // 8)
    cols_t = table.reshape(n // 128, 128)
    cols_i = (idx % (n // 128)).reshape(m // 128, 128)
    # the library calls take int64 indices
    idx_l, idx_sl = idx.long(), idx_s.long()
    rows_l, cols_l = rows_i.long(), cols_i.long()

    def out_like(i):
        return torch.empty(i.shape, dtype=torch.float32, device=i.device)

    return [
        Formulation(
            "gather_flat", f"{PROBE}:78 pallas_take, :95 pallas_take2",
            lambda: gather.gather_flat(table, idx),
            lambda: gather.gather_flat_plain(table, idx),
            lambda: torch.take(table, idx_l), "torch.take",
            [table, idx, out_like(idx)]),
        Formulation(
            "gather_flat_smem", f"{PROBE}:95 pallas_take2 (a "
            f"{smem_table}-entry table)",
            lambda: gather.gather_flat_smem(tab_s, idx_s),
            lambda: gather.gather_flat_plain(tab_s, idx_s),
            lambda: torch.take(tab_s, idx_sl), "torch.take",
            [tab_s, idx_s, out_like(idx_s)]),
        Formulation(
            "gather_rows", f"{PROBE}:116 pallas_taa",
            lambda: gather.gather_rows(rows_t, rows_i),
            lambda: gather.gather_rows_plain(rows_t, rows_i),
            lambda: torch.take_along_dim(rows_t, rows_l, dim=1),
            "torch.take_along_dim",
            [rows_t, rows_i, out_like(rows_i)]),
        Formulation(
            "gather_cols", f"{PROBE}:135 pallas_taas",
            lambda: gather.gather_cols(cols_t, cols_i),
            lambda: gather.gather_cols_plain(cols_t, cols_i),
            lambda: torch.take_along_dim(cols_t, cols_l, dim=0),
            "torch.take_along_dim",
            [cols_t, cols_i, out_like(cols_i)]),
    ]


def edge_cases(device, seed: int = 1, limits: Tuple[int, int, int] = None
               ) -> List[Tuple[str, str, torch.Tensor, torch.Tensor]]:
    """(label, kernel, table, idx) at odd shapes and offsets, idx holding 0
    and the last index along the gathered axis: ``gather_flat`` at an odd
    length and on a view at storage offset 1 (indices not 16-byte aligned),
    ``gather_cols`` with 37 columns and at the probe's 128 columns on a
    view at storage offset 3; ``gather_rows_cluster`` at odd C (rows off
    16-byte boundaries), at 5 rows (not a multiple of the clusters a row),
    at the longest row a cluster of 4 holds and one entry longer (a
    cluster of 8), at the longest row a cluster of 8 holds, and on a table
    view at storage offset 1; ``gather_rows`` one entry past that (no
    cluster holds it); ``gather_flat_smem`` on table views at storage
    offsets 1-3, at its largest table and at 1, 3 and 5 lookups.
    ``limits`` are the longest rows clusters of 4 and 8 blocks hold and
    the largest table of ``gather_flat_smem`` (the card's, when None)."""
    if limits is None:
        from ..kernels import gather as kg

        limits = (*kg.rows_capacities(device), kg.smem_table_entries(device))
    cap4, cap8, most = limits
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def case(table_shape, m, offset, axis_len, table_offset=0):
        size = math.prod(table_shape)
        t = torch.randn(table_offset + size, generator=g,
                        device=device)[table_offset:].view(table_shape)
        buf = torch.randint(0, axis_len, (offset + m,), generator=g,
                            device=device, dtype=torch.int32)
        buf[offset], buf[-1] = 0, axis_len - 1
        return t, buf[offset:]

    n = 1 << 20
    flat_t, flat_i = case((n,), n + 3, 0, n)
    view_t, view_i = case((n,), n + 2, 1, n)
    odd_t, odd_i = case((999, 37), 1001 * 37, 0, 999)
    cols_t, cols_i = case((n // 128, 128), n, 3, n // 128)
    cases = [("odd length 2^20 + 3", "gather_flat", flat_t, flat_i),
             ("idx at storage offset 1", "gather_flat", view_t, view_i),
             ("(999, 37), 1001 rows", "gather_cols", odd_t,
              odd_i.view(1001, 37)),
             ("(2^13, 128), idx at storage offset 3", "gather_cols", cols_t,
              cols_i.view(n // 128, 128))]
    for label, name, R, C, M, t_off in [
            ("(3, 1001) x 517, odd C", "gather_rows_cluster", 3, 1001, 517,
             0),
            ("(5, 2^16) x (2^15 + 4), 5 rows", "gather_rows_cluster", 5,
             1 << 16, (1 << 15) + 4, 0),
            (f"(2, {cap4}), the longest row 4 blocks hold",
             "gather_rows_cluster", 2, cap4, 5000, 0),
            (f"(2, {cap4 + 1}), in 8 blocks", "gather_rows_cluster", 2,
             cap4 + 1, 5000, 0),
            (f"(1, {cap8}), the longest row 8 blocks hold",
             "gather_rows_cluster", 1, cap8, 5000, 0),
            ("(8, 2^17), table at storage offset 1", "gather_rows_cluster",
             8, 1 << 17, 1 << 17, 1),
            (f"(1, {cap8 + 1}), past every cluster", "gather_rows", 1,
             cap8 + 1, 5000, 0)]:
        t, i = case((R, C), R * M, 0, C, t_off)
        cases.append((label, name, t, i.view(R, M)))
    for label, size, m, t_off in [
            *[(f"table 2^15 at storage offset {k}", 1 << 15, n, k)
              for k in (1, 2, 3)],
            (f"largest table, {most} entries", most, n, 0),
            *[(f"n = {m}", 4099, m, 0) for m in (1, 3, 5)]]:
        t, i = case((size,), m, 0, size, t_off)
        cases.append((label, "gather_flat_smem", t, i))
    return cases


def configuration(name: str, table: torch.Tensor, idx: torch.Tensor
                  ) -> dict:
    """The launch of ``gather_rows_cluster`` or ``gather_flat_smem`` at these
    inputs (``kernels.gather.rows_plan`` / ``smem_plan``) and the table
    bytes it reads from L2 a call (reckoned: one read of the row a
    cluster, one of the table a block)."""
    from ..kernels import gather as kg

    if name == "gather_rows_cluster":
        R, C = table.shape
        plan = kg.rows_plan(R, C, idx.shape[1], table.device)
        return dict(plan, table_bytes_from_l2=R * plan["clusters_per_row"]
                    * C * 4)
    if name == "gather_flat_smem":
        plan = kg.smem_plan(idx.numel(), table.numel(), table.device)
        return dict(plan, table_bytes_from_l2=plan["blocks"] * table.numel()
                    * 4)
    raise ValueError(f"{name}: no launch configuration to report")


def cluster_formulation(table: torch.Tensor, idx: torch.Tensor
                        ) -> Formulation:
    """``gather_rows_cluster`` on the inputs of the probe's ``gather_rows``
    (see :func:`formulations`): not a gather of the TPU probe's, the
    probe's measure of lookups from a cluster's shared memory."""
    from ..kernels.gather import gather_rows_cluster_cuda

    rows = formulations(table, idx)[2]
    t, i = rows.moved[:2]
    return dataclasses.replace(
        rows, name="gather_rows_cluster",
        kernel=lambda: gather_rows_cluster_cuda(t, i))


RATE_LOOKUPS = 1 << 24
RATE_TABLES = (15, 18, 20, 22, 24)   # log2 of the f32 entries


def rate_cases(device, seed: int = 2, lookups: int = RATE_LOOKUPS
               ) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
    """(label, table, idx): ``lookups`` uniform i32 indices into tables of
    2^15 entries (128 KiB: an SM's L1 holds it), 2^18, the probe's 2^20
    (4 MiB), 2^22 (16 MiB) and 2^24 (64 MiB: past the 50 MB L2)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cases = []
    for k in RATE_TABLES:
        t = torch.randn(1 << k, generator=g, device=device)
        cases.append((f"table 2^{k}", t,
                      torch.randint(0, 1 << k, (lookups,), generator=g,
                                    device=device, dtype=torch.int32)))
    return cases


ROW_RATE_ROWS = (15, 16, 17, 18)   # log2 of the one row's f32 entries


def row_rate_cases(device, seed: int = 3, lookups: int = RATE_LOOKUPS
                   ) -> List[Tuple[str, torch.Tensor, torch.Tensor]]:
    """(label, t, idx): ``lookups`` uniform i32 indices into one row of
    2^15 to 2^18 entries, t (1, C) and idx (1, lookups): from 128 KiB to 1
    MiB, each held in one cluster's shared memory by
    ``gather_rows_cluster`` (4 blocks up to 2^17, 8 for 2^18)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    cases = []
    for k in ROW_RATE_ROWS:
        t = torch.randn(1, 1 << k, generator=g, device=device)
        cases.append((f"row 2^{k}", t,
                      torch.randint(0, 1 << k, (1, lookups), generator=g,
                                    device=device, dtype=torch.int32)))
    return cases


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe: torch.cuda.is_available() is false")
    from ..profile_slice import card_line, event_ms

    print(card_line(), flush=True)
    table, idx = make_inputs(torch.device("cuda"), args.seed)
    for f in [*formulations(table, idx), cluster_formulation(table, idx)]:
        if not torch.equal(f.kernel(), f.plain()):
            raise SystemExit(f"{f.name}: the kernel differs from its plain "
                             "version")
        if f.name in ("gather_rows_cluster", "gather_flat_smem"):
            print(f"{f.name}: {configuration(f.name, *f.moved[:2])}",
                  flush=True)
        for label, fn in ((f.name, f.kernel),
                          (f"  {f.library_name}", f.library)):
            ms = event_ms(fn, iters=args.iters)
            print(f"{label:40s} {ms:8.4f} ms   "
                  f"{LOOKUPS / ms / 1e3:10.1f} M lookups/s", flush=True)
    for label, t, i in rate_cases(torch.device("cuda"), args.seed + 2):
        i_l = i.long()
        if not torch.equal(gather.gather_flat(t, i), t[i_l]):
            raise SystemExit(f"gather_flat ({label}) differs from its plain "
                             "version")
        for who, fn in (("gather_flat", lambda: gather.gather_flat(t, i)),
                        ("torch.take", lambda: torch.take(t, i_l))):
            ms = event_ms(fn, iters=args.iters)
            print(f"rate {who}, {label} ({t.numel()} entries, "
                  f"{i.numel()} lookups): {ms:8.4f} ms "
                  f"{i.numel() / ms / 1e6:7.1f} G lookups/s", flush=True)
    from ..kernels.gather import gather_rows_cluster_cuda

    for label, t, i in row_rate_cases(torch.device("cuda"), args.seed + 3):
        i_l = i.long()
        want = torch.take_along_dim(t, i_l, dim=1)
        for who, fn in (("gather_rows", gather.gather_rows),
                        ("gather_rows_cluster", gather_rows_cluster_cuda)):
            if not torch.equal(fn(t, i), want):
                raise SystemExit(f"{who} ({label}) differs from its plain "
                                 "version")
        cluster = configuration("gather_rows_cluster", t, i)["cluster"]
        for who, fn in (
                ("gather_rows", lambda: gather.gather_rows(t, i)),
                (f"gather_rows_cluster ({cluster} blocks)",
                 lambda: gather_rows_cluster_cuda(t, i)),
                ("torch.take_along_dim",
                 lambda: torch.take_along_dim(t, i_l, dim=1))):
            ms = event_ms(fn, iters=args.iters)
            print(f"rate {who}, {label} ({t.numel()} entries, "
                  f"{i.numel()} lookups): {ms:8.4f} ms "
                  f"{i.numel() / ms / 1e6:7.1f} G lookups/s", flush=True)


if __name__ == "__main__":
    main()
