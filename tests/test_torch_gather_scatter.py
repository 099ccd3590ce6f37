"""The gather/scatter probes P1-P4 on the CPU: the port's plain versions
against the JAX package's Pallas TPU kernel bodies run in interpret mode,
the wrappers' checks, and both probe entry points at tiny sizes.

- P1, P2: ``perf/pallas_experiments.py``'s ``gather_loop_kernel`` and
  ``gather_take_kernel`` through ``pl.pallas_call(..., interpret=True)``
  with plain ``BlockSpec``s; the plain gather equals them bit for bit.
- P3: ``bench_pallas_scatter_rmw``'s body is a closure, so it is written
  again here (the same per-row read-modify-write into a table-sized
  scratch); the plain ``index_add_`` sums the same fp32 terms, in index
  order as the body does: atol 1e-6 x the largest |value| (measured 0).
- P4: ``case_pallas_onehot``'s body written again (a bf16 one-hot times
  the bf16 updates, ``dot_general`` with fp32 accumulation, summed over
  the tiles); the plain ``index_add_`` of the bf16-rounded updates sums the
  same fp32 terms in another order: atol 1e-5 x the largest |value|, the
  bound chip_smoke holds the card kernel to.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from emernerf_torch.ops import gather_scatter as gs
from emernerf_torch.perf import bench_scatter_alts as bsa
from emernerf_torch.perf import bench_scatter_rmw
from emernerf_torch.perf import pallas_experiments as pe
from perf.pallas_experiments import gather_loop_kernel, gather_take_kernel

TILE = 128  # rows per grid step here (2048 in the probes)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(n, t, seed):
    return np.random.default_rng(seed).integers(0, t, n).astype(np.int32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_gather(body, table, idx):
    n, (t, w) = idx.shape[0], table.shape
    return pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((n, w), table.dtype), grid=(n // TILE,),
        in_specs=[pl.BlockSpec((TILE,), lambda i: (i,)), pl.BlockSpec((t, w), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((TILE, w), lambda i: (i, 0)), interpret=True)(idx, table)


@pytest.mark.parametrize("body", [gather_loop_kernel, gather_take_kernel],
                         ids=["P1_loop", "P2_take"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gather_equals_jax_kernel_body(body, dtype):
    table = _normal((96, 128), 0)
    idx = _rows(4 * TILE, 96, 1)
    ref = np.asarray(_jax_gather(body, jnp.asarray(table, dtype), jnp.asarray(idx)))
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    for fn in (gs.row_gather_loop, gs.row_gather_take):
        ours = fn(t, torch.from_numpy(idx))
        assert ours.dtype == t.dtype
        np.testing.assert_array_equal(ours.float().numpy(), ref.astype(np.float32))


def test_plain_scatter_rmw_matches_jax_kernel_body():
    n, t, w = 4 * TILE, 64, 128
    idx, upd = _rows(n, t, 2), _normal((n, w), 3)

    def kernel(idx_ref, upd_ref, out_ref, acc_ref):  # the body of :128
        @pl.when(pl.program_id(0) == 0)
        def _():
            acc_ref[:] = jnp.zeros_like(acc_ref)

        def body(i, _):
            r = idx_ref[i]
            acc_ref[r, :] += upd_ref[i, :]
            return 0

        jax.lax.fori_loop(0, TILE, body, 0)

        @pl.when(pl.program_id(0) == pl.num_programs(0) - 1)
        def _():
            out_ref[:] = acc_ref[:]

    ref = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((t, w), jnp.float32), grid=(n // TILE,),
        in_specs=[pl.BlockSpec((TILE,), lambda i: (i,)), pl.BlockSpec((TILE, w), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((t, w), lambda i: (0, 0)),
        scratch_shapes=[pltpu.VMEM((t, w), jnp.float32)], interpret=True)(
            jnp.asarray(idx), jnp.asarray(upd)))
    # whole tiles of 2048 rows, as the TPU grid: the plain version itself
    idx2, upd2 = _rows(2 * gs.TILE, t, 4), _normal((2 * gs.TILE, w), 5)
    ours = gs.scatter_add_rmw(torch.from_numpy(idx2), torch.from_numpy(upd2), t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jnp.zeros((t, w)).at[idx2].add(upd2)),
                               rtol=0, atol=1e-6 * np.abs(ours.numpy()).max())
    plain = gs.scatter_add_plain(torch.from_numpy(idx), torch.from_numpy(upd), t).numpy()
    np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("t,w", [(64, 108), (256, 40)])
def test_plain_scatter_onehot_matches_jax_kernel_body(t, w):
    tile_n, n = 256, 1024
    rows, upd = _rows(n, t, 6), _normal((n, w), 7)

    def kernel(rows_ref, upd_ref, out_ref):  # the body of :203
        i = pl.program_id(0)

        @pl.when(i == 0)
        def _():
            out_ref[...] = jnp.zeros_like(out_ref)

        r, u = rows_ref[...], upd_ref[...]
        iota_t = jax.lax.broadcasted_iota(jnp.int32, (tile_n, t), 1)
        oh = (r[:, None] == iota_t).astype(jnp.bfloat16)
        out_ref[...] += jax.lax.dot_general(oh, u.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
                                            preferred_element_type=jnp.float32)

    ref = np.asarray(pl.pallas_call(
        kernel, grid=(n // tile_n,),
        in_specs=[pl.BlockSpec((tile_n,), lambda i: (i,)),
                  pl.BlockSpec((tile_n, w), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((t, w), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((t, w), jnp.float32), interpret=True)(
            jnp.asarray(rows), jnp.asarray(upd)))
    ours = gs.scatter_add_onehot(torch.from_numpy(rows), torch.from_numpy(upd), t, tile_n)
    assert ours.dtype == torch.float32 and ours.shape == (t, w)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # the bf16 rounding of the updates is part of the function
    exact = gs.scatter_add_plain(torch.from_numpy(rows), torch.from_numpy(upd), t).numpy()
    assert np.abs(exact - ref).max() > 1e-3 * np.abs(ref).max()


def test_wrapper_checks_and_cpu_dispatch():
    idx, upd = torch.zeros(gs.TILE, dtype=torch.int32), torch.ones(gs.TILE, 8)
    with pytest.raises(ValueError, match="whole tiles"):
        gs.scatter_add_rmw(idx[:-1], upd[:-1], 4)
    with pytest.raises(ValueError, match="float32"):
        gs.scatter_add_rmw(idx, upd.bfloat16(), 4)
    with pytest.raises(ValueError, match="int32"):
        gs.scatter_add_rmw(idx.long(), upd, 4)
    with pytest.raises(ValueError, match="tile_n"):
        gs.scatter_add_onehot(idx, upd, 4, tile_n=100)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gs.row_gather_loop(upd.double(), idx)
    with pytest.raises(ValueError, match="int32"):
        gs.row_gather_take(upd, idx[:, None])
    fns = (gs.row_gather_loop, gs.row_gather_take, gs.scatter_add_rmw, gs.scatter_add_onehot)
    before = [fn.launches for fn in fns]
    gs.row_gather_loop(upd, idx)
    gs.row_gather_take(upd, idx)
    assert torch.equal(gs.scatter_add_rmw(idx, upd, 4)[0], torch.full((8,), float(gs.TILE)))
    gs.scatter_add_onehot(idx, upd, 4)
    assert [fn.launches for fn in fns] == before  # the plain versions launch nothing


# a 256-byte-aligned device address, as the caching allocator returns
_BASE_PTR = 0x7F00_0000_0000


@pytest.mark.parametrize("out_offset", [0, 2, 4, 8])
@pytest.mark.parametrize("table_offset", [0, 2, 4, 8])
@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["fp32", "bf16"])
def test_p1_plan_picks_the_widest_aligned_vector(elem_bytes, table_offset, out_offset):
    """P1's vector width over row widths 1-257 and pointers offset by 0, 2,
    4 or 8 bytes (table views at an element offset): it divides the row
    and both alignments, and no wider width of 16, 8, 4, 2 does."""
    table_ptr, out_ptr = _BASE_PTR + table_offset, _BASE_PTR + out_offset
    for w in range(1, 258):
        row_bytes = w * elem_bytes
        v = gs.p1_plan(row_bytes, table_ptr, out_ptr)
        assert v in (16, 8, 4, 2)
        assert row_bytes % v == 0 and table_ptr % v == 0 and out_ptr % v == 0, (w, v)
        wider = [u for u in (16, 8, 4) if u > v]
        assert not any(row_bytes % u == 0 and table_ptr % u == 0 and out_ptr % u == 0
                       for u in wider), (w, v)
    if (elem_bytes, table_offset, out_offset) == (4, 0, 0):
        assert gs.p1_plan(128 * 4, table_ptr, out_ptr) == 16  # the probe's fp32 rows
    with pytest.raises(ValueError, match="2-byte aligned"):
        gs.p1_plan(3, table_ptr, out_ptr)


@pytest.mark.parametrize("upd_offset", [0, 4, 8])
@pytest.mark.parametrize("out_offset", [0, 4, 8])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 6, 128, 130])
def test_p3_plan_picks_the_widest_aligned_vector(w, upd_offset, out_offset):
    """P3's vector width for fp32 rows of w with the update and table
    pointers offset by 0, 4 or 8 bytes: it divides the row and both
    alignments, and no wider width of 16, 8, 4 does."""
    upd_ptr, out_ptr = _BASE_PTR + upd_offset, _BASE_PTR + out_offset
    v = gs.p3_plan(w, upd_ptr, out_ptr)
    ok = [u for u in (16, 8, 4) if (4 * w) % u == 0 and upd_ptr % u == 0 and out_ptr % u == 0]
    assert v == max(ok)
    if (w, upd_offset, out_offset) == (128, 0, 0):
        assert v == 16  # the probe's rows: float4 reductions
    with pytest.raises(ValueError, match="4-byte aligned"):
        gs.p3_plan(w, upd_ptr + 2, out_ptr)


@pytest.mark.parametrize("w", [1, 3, 6, 128, 130])
def test_scatter_add_rmw_matches_numpy_add_at(w):
    """P3 on the CPU (its plain version) and the plain version itself
    against numpy's unbuffered ``np.add.at`` on numpy-seeded inputs (two
    tiles of 2048 rows, repeated indices), in float64 as the reference:
    within 1e-6 of the largest |value|."""
    rng = np.random.default_rng(60 + w)
    t, n = 97, 2 * gs.TILE
    idx = rng.integers(0, t, n).astype(np.int32)
    upd = rng.normal(size=(n, w)).astype(np.float32)
    ref = np.zeros((t, w))
    np.add.at(ref, idx, upd.astype(np.float64))
    ti, tu = torch.from_numpy(idx), torch.from_numpy(upd)
    ours, plain = gs.scatter_add_rmw(ti, tu, t), gs.scatter_add_plain(ti, tu, t)
    assert ours.dtype == torch.float32 and ours.shape == (t, w)
    for got in (ours, plain):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("t,w,route", [
    (512, 108, "shared_table"),  # 221,184 bytes: fits one block's shared memory
    (4096, 108, "red"),
    (2048, 432, "red"),
    (4096, 432, "red"),
    (538, 108, "shared_table"),  # 232,416 bytes: the largest T that fits
    (539, 108, "red"),
    (1, 58_112, "shared_table"),  # exactly SMEM_BYTES
    (1, 58_113, "red"),
])
def test_p4_plan_picks_the_route_by_table_size(t, w, route):
    """The wrapper's route: the shared-memory table up to SMEM_BYTES, else
    vector reductions into the L2-resident table."""
    assert gs.p4_plan(t, w) == route
    assert (4 * t * w <= gs.SMEM_BYTES) == (route == "shared_table")


_PE_LINE = re.compile(r"^(.{45}) +\d+\.\d Mrows/s +\d+\.\d\d ms$")
_BSA_LINE = re.compile(r"^\S.*? +\d+\.\d\d ms +\d+\.\d Mrows/s +\d+\.\d GB/s\(upd\)$")


@pytest.mark.parametrize("only", ["g1 loop-gather t=2^14", "g1 loop-gather t=2^15", "g2", "s1"])
def test_pallas_experiments_entry_point_on_cpu(only, monkeypatch, capsys):
    monkeypatch.setattr(pe, "N_QUICK", 2 * gs.TILE)
    monkeypatch.setattr(pe, "ITERS", 1)
    pe.main(["--device", "cpu", "--quick", "--only", only])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and _PE_LINE.match(lines[0]), lines
    assert lines[0].startswith(only)


# lines each --case prints, as perf/bench_scatter_alts.py's main
_BSA_CASES = {"base": 3, "width": 4, "sorted": 4, "merged": 1, "onehot": 3, "onehot2": 5,
              "pallas": 4, "sub": 3}


@pytest.mark.parametrize("case", sorted(_BSA_CASES))
def test_bench_scatter_alts_entry_point_on_cpu(case, monkeypatch, capsys):
    monkeypatch.setattr(bsa, "N", gs.TILE)
    monkeypatch.setattr(bsa, "NW", gs.TILE)
    bsa.main(["--device", "cpu", "--case", case, "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == _BSA_CASES[case] and all(_BSA_LINE.match(x) for x in lines), lines
    if case == "pallas":
        assert all(x.startswith("pallas_onehot N=2048 ") for x in lines)


def test_onehot_matmul_is_the_scatter_add_of_bf16_updates():
    rows, upd = bsa.make_inputs(1024, 96, 40, torch.device("cpu"))
    torch.testing.assert_close(bsa.onehot_matmul(rows, upd, 96, chunk=300),
                               gs.scatter_add_onehot_plain(rows, upd, 96), rtol=0, atol=1e-5)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.main(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bsa.main(["--case", "pallas"])


def test_p3_shapes_start_at_the_probe_entry_shape_and_make_their_views():
    """The P3 shapes that the bench times and chip_smoke.py phase 7 checks:
    the first is the probe entry point's (n = 2^22 rows of 128 into 2^13
    table rows); each case's inputs have its width, its update offset and,
    where asked, every index 0."""
    assert bench_scatter_rmw.SHAPES[0] == (pe.N, 128, 0, False) and bench_scatter_rmw.T == 1 << 13
    for n, w, offset, equal in [(64, 3, 1, False), (64, 128, 0, True)]:
        idx, upd = bench_scatter_rmw.make_inputs("cpu", n, w, offset, equal)
        assert idx.dtype == torch.int32 and upd.shape == (n, w) and upd.is_contiguous()
        assert upd.storage_offset() == offset
        assert bool((idx == 0).all()) == equal and int(idx.max()) < bench_scatter_rmw.T
