"""Row gather and scatter-add probes P1-P4 (``kernels/csrc/gather_scatter.cu``).

The counterparts of the four Pallas TPU probes, the only functions of the
repository that reach ``pl.pallas_call``:

- P1 :func:`row_gather_loop` (``perf/pallas_experiments.py:60``) and P2
  :func:`row_gather_take` (``:94``): ``out[i] = table[idx[i]]``;
- P3 :func:`scatter_add_rmw` (``:124``): ``out[idx[i]] += upd[i]`` into a
  zeroed fp32 table, whole tiles of 2048 rows only, as the TPU grid
  (:func:`p3_plan` picks its vector width on the card);
- P4 :func:`scatter_add_onehot` (``perf/bench_scatter_alts.py:196``): the
  function of a one-hot product with bf16 operands and fp32 accumulation,
  i.e. the scatter-add of the bf16-rounded updates, computed on the card
  as that scatter-add (:func:`p4_plan` picks its route).

Each wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (no fallback); each counts its launches.  The
probe entry points are ``emernerf_torch/perf/pallas_experiments.py`` and
``emernerf_torch/perf/bench_scatter_alts.py``.
"""

from __future__ import annotations

import torch

from emernerf_torch import kernels

TILE = 2048  # rows per grid step of the TPU probes


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P1 and P2."""
    return table.index_select(0, idx)


def scatter_add_plain(idx: torch.Tensor, upd: torch.Tensor, t: int) -> torch.Tensor:
    """Plain version of P3: a (t, w) table of the updates' dtype."""
    return torch.zeros((t, upd.shape[1]), dtype=upd.dtype, device=upd.device).index_add_(
        0, idx, upd)


def scatter_add_onehot_plain(rows: torch.Tensor, upd: torch.Tensor, t: int) -> torch.Tensor:
    """Plain version of P4: the scatter-add of the bf16-rounded updates,
    summed in fp32 (the one-hot product's function)."""
    return scatter_add_plain(rows, upd.bfloat16().float(), t)


def _check_rows(name: str, idx: torch.Tensor, n: int = None):
    if idx.dtype != torch.int32 or idx.dim() != 1 or n not in (None, idx.shape[0]):
        raise ValueError(f"{name}: indices must be one int32 per row")


def _check_range(name: str, idx: torch.Tensor, t: int):
    """On the card, where an index out of range would fault the kernel."""
    if idx.numel():
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()  # one host sync
        if lo < 0 or hi >= t:
            raise ValueError(f"{name}: indices must lie in [0, {t})")


def _check_gather(name: str, table: torch.Tensor, idx: torch.Tensor):
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: table must be (t, w) float32 or bfloat16")
    _check_rows(name, idx)


def _check_scatter(name: str, idx: torch.Tensor, upd: torch.Tensor, tile: int):
    if upd.dim() != 2 or upd.dtype != torch.float32:
        raise ValueError(f"{name}: updates must be (n, w) float32")
    n = upd.shape[0]
    _check_rows(name, idx, n)
    if n % tile:
        raise ValueError(f"{name}: takes whole tiles: n = {n} is not a multiple of {tile}")


def _launch_gather(name, table, idx):
    kernels.require_cuda_inputs(name, table, idx)
    _check_range(name, idx, table.shape[0])
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    return kernels.load(), out


def p1_plan(row_bytes: int, table_ptr: int, out_ptr: int) -> int:
    """P1's vector width on the card in bytes: the widest of 16, 8, 4 and 2
    that divides the row and the alignment of both pointers."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and table_ptr % v == 0 and out_ptr % v == 0:
            return v
    raise ValueError("row_gather_loop: rows and pointers must be 2-byte aligned")


def row_gather_loop(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1: ``table[idx]`` (n, w) in the table's dtype; on the card a warp
    per 32 rows with the vector width :func:`p1_plan` picks."""
    name = "row_gather_loop"
    _check_gather(name, table, idx)
    if kernels.dispatch_device(name, table) == "cpu":
        return row_gather_plain(table, idx)
    lib, out = _launch_gather(name, table, idx)
    if out.numel() == 0:
        return out
    row_bytes = table.shape[1] * table.element_size()
    err = lib.emt_gather_loop(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
                              row_bytes, p1_plan(row_bytes, table.data_ptr(), out.data_ptr()),
                              kernels.stream_ptr(table.device))
    kernels.check(err, name)
    row_gather_loop.launches += 1
    return out


row_gather_loop.launches = 0


def row_gather_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2: ``table[idx]`` (n, w), one block per 2048 indices staged in
    shared memory and one warp per row on the card (rows of a multiple of
    16 bytes)."""
    name = "row_gather_take"
    _check_gather(name, table, idx)
    if kernels.dispatch_device(name, table) == "cpu":
        return row_gather_plain(table, idx)
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte multiples, 16-byte aligned")
    lib, out = _launch_gather(name, table, idx)
    err = lib.emt_gather_take(table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
                              row_bytes, kernels.stream_ptr(table.device))
    kernels.check(err, name)
    row_gather_take.launches += 1
    return out


row_gather_take.launches = 0


def p3_plan(w: int, upd_ptr: int, out_ptr: int) -> int:
    """P3's vector width on the card in bytes for fp32 rows of ``w``: the
    widest of 16, 8 and 4 that divides the row and the alignment of both
    pointers."""
    row_bytes = 4 * w
    for v in (16, 8, 4):
        if row_bytes % v == 0 and upd_ptr % v == 0 and out_ptr % v == 0:
            return v
    raise ValueError("scatter_add_rmw: rows and pointers must be 4-byte aligned")


def scatter_add_rmw(idx: torch.Tensor, upd: torch.Tensor, t: int) -> torch.Tensor:
    """P3: the (t, w) fp32 sum of the update rows at their indices, on the
    card a warp per 32 update rows with the vector reductions
    :func:`p3_plan` picks.  Takes whole tiles of 2048 rows, as the TPU
    grid."""
    name = "scatter_add_rmw"
    _check_scatter(name, idx, upd, TILE)
    if kernels.dispatch_device(name, upd) == "cpu":
        return scatter_add_plain(idx, upd, t)
    kernels.require_cuda_inputs(name, idx, upd)
    _check_range(name, idx, t)
    n, w = upd.shape
    out = torch.zeros((t, w), dtype=torch.float32, device=upd.device)
    if out.numel() == 0:
        return out
    err = kernels.load().emt_scatter_rmw(idx.data_ptr(), upd.data_ptr(), out.data_ptr(), n, w,
                                         p3_plan(w, upd.data_ptr(), out.data_ptr()),
                                         kernels.stream_ptr(upd.device))
    kernels.check(err, name)
    scatter_add_rmw.launches += 1
    return out


scatter_add_rmw.launches = 0


# P4 on the card (kernels/csrc/gather_scatter.cu): the whole fp32 (t, w)
# table in one block's shared memory where it fits, else vector global
# reductions into the L2-resident table ("red")
SMEM_BYTES = 232_448  # shared memory one H100 block may opt into


def _check_onehot(name, rows, upd, tile_n):
    if tile_n <= 0 or tile_n % 64:
        raise ValueError(f"{name}: tile_n must be a positive multiple of 64")
    _check_scatter(name, rows, upd, tile_n)


def p4_plan(t: int, w: int) -> str:
    """P4's route on the card for a (t, w) fp32 table: "shared_table" where
    it fits one block's shared memory, else "red"."""
    return "shared_table" if 4 * t * w <= SMEM_BYTES else "red"


def scatter_add_onehot(rows: torch.Tensor, upd: torch.Tensor, t: int,
                       tile_n: int = TILE) -> torch.Tensor:
    """P4: ``onehot(rows)^T . bf16(upd)`` (t, w) in fp32, i.e. the
    scatter-add of the bf16-rounded update rows, on the card by the route
    :func:`p4_plan` picks (no one-hot product).  Takes whole tiles of
    ``tile_n`` rows (a multiple of 64), as the TPU grid."""
    name = "scatter_add_onehot"
    _check_onehot(name, rows, upd, tile_n)
    if kernels.dispatch_device(name, upd) == "cpu":
        return scatter_add_onehot_plain(rows, upd, t)
    kernels.require_cuda_inputs(name, rows, upd)
    n, w = upd.shape
    if upd.data_ptr() % 16:  # both routes read 16-byte vectors
        upd = upd.clone()
    out = torch.zeros((t, w), dtype=torch.float32, device=upd.device)
    lib = kernels.load()
    _check_range(name, rows, t)  # last: only the launch waits on its host sync
    err = lib.emt_scatter_onehot(rows.data_ptr(), upd.data_ptr(), out.data_ptr(), n, t, w,
                                 tile_n, int(p4_plan(t, w) == "shared_table"),
                                 kernels.stream_ptr(upd.device))
    kernels.check(err, name)
    scatter_add_onehot.launches += 1
    return out


scatter_add_onehot.launches = 0
