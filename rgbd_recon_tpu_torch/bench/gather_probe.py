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

Then the rate sweep (:func:`rate_cases`): ``gather_flat`` and
``torch.take`` at 2^24 uniform lookups into tables of 2^15 to 2^24 entries,
G lookups/s by CUDA events over back-to-back calls; at 2^24 lookups a call
takes about 0.1 ms or more on an H100, so the wrapper's host time hides
behind the device's. :func:`edge_cases` are odd shapes and index views at a
storage offset for ``gather_flat`` and ``gather_cols`` (``chip_smoke.py``
phase 13 holds the kernels to them).
"""

from __future__ import annotations

import argparse
import dataclasses
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


def edge_cases(device, seed: int = 1) -> List[Tuple[str, str, torch.Tensor,
                                                     torch.Tensor]]:
    """(label, kernel, table, idx) at odd shapes and offsets, idx holding 0
    and the last index along the gathered axis: ``gather_flat`` at an odd
    length and on a view at storage offset 1 (indices not 16-byte aligned),
    ``gather_cols`` with 37 columns and at the probe's 128 columns on a
    view at storage offset 3."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def case(table_shape, m, offset, axis_len):
        t = torch.randn(table_shape, generator=g, device=device)
        buf = torch.randint(0, axis_len, (offset + m,), generator=g,
                            device=device, dtype=torch.int32)
        buf[offset], buf[-1] = 0, axis_len - 1
        return t, buf[offset:]

    n = 1 << 20
    flat_t, flat_i = case((n,), n + 3, 0, n)
    view_t, view_i = case((n,), n + 2, 1, n)
    odd_t, odd_i = case((999, 37), 1001 * 37, 0, 999)
    cols_t, cols_i = case((n // 128, 128), n, 3, n // 128)
    return [("odd length 2^20 + 3", "gather_flat", flat_t, flat_i),
            ("idx at storage offset 1", "gather_flat", view_t, view_i),
            ("(999, 37), 1001 rows", "gather_cols", odd_t,
             odd_i.view(1001, 37)),
            ("(2^13, 128), idx at storage offset 3", "gather_cols", cols_t,
             cols_i.view(n // 128, 128))]


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
    for f in formulations(table, idx):
        if not torch.equal(f.kernel(), f.plain()):
            raise SystemExit(f"{f.name}: the kernel differs from its plain "
                             "version")
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


if __name__ == "__main__":
    main()
