"""Launch plans of kernels K3-K7 (repro_torch): the pure functions that
decide how a CUDA launch spreads its work, checked on the CPU.

* K7 (``kernels/r2f2_matmul.py``): ``split_plan`` gives every K block its
  own CTA where the output grid leaves SMs idle and the partials' scratch
  fits its cap; ``k_ranges`` is the K-block range each CTA along K takes;
  ``ring_plan`` sizes the shared-memory ring; ``launch_plan`` puts them
  together.
* K3 (``kernels/swe_flux.py``): ``cluster_plan`` cuts one split tile into
  the row bands of a thread-block cluster.
* K5a and K5d (``kernels/pde_steps.py``): ``heat2d_cluster_plan`` cuts a
  heat2d field's interior rows into the bands of a thread-block cluster;
  ``heat2d_plan`` gives a field beyond it the rod's grid.
* The rod kernels, K2 and K4 heat1d and the 1-D K5 bodies
  (``kernels/rod.py``): ``rod_plan`` gives a ``(br, nx)`` row block or a
  periodic rod the warps of one CTA or a cooperative grid, and
  ``grid_scratch`` sizes the grid's scratch.
* K4 swe2d (``kernels/mega.py``): ``swe2d_plan`` cuts a state's rows into
  the bands of a cooperative grid, and ``swe2d_grid_scratch`` sizes the
  grid's scratch.
* K6 (``kernels/r2f2_quantize.py``): ``quantize_plan`` puts a tile on a
  thread-block cluster or on the two-pass shape.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from repro_torch.core.flexformat import FlexFormat
from repro_torch.kernels import _cuda
from repro_torch.kernels.r2f2_matmul import (
    MAX_BLOCK, R2F2_MATMUL, SCRATCH_CAP, k_ranges, launch_plan, r2f2_matmul, r2f2_matmul_plain, ring_plan, split_plan,
)
from repro_torch.kernels.mega import (
    SWE2D_MIN_MEMBER_CTAS, SWE2D_SMEM_LIMIT, member_waves, swe2d_band_floats, swe2d_bands, swe2d_grid_scratch, swe2d_plan,
)
from repro_torch.kernels.pde_steps import (
    HEAT2D_CLUSTERS, HEAT2D_CTA_CELLS, HEAT2D_MAX_CTA_CELLS, ClusterPlan, heat2d_cluster_plan, heat2d_plan,
)
from repro_torch.kernels.rod import (
    CELLS, GRID_CELLS, GRID_THREADS, WARP_LIMIT, WARP_MAX, RodPlan, grid_scratch, rod_plan,
)
from repro_torch.kernels.r2f2_quantize import (
    CTA_TILE_BYTES, MIN_CLUSTER_TILE_BYTES, R2F2_QUANTIZE, quantize_plan, r2f2_quantize, r2f2_quantize_plain,
)
from repro_torch.kernels.r2f2_quantize import MAX_CLUSTER as K6_MAX_CLUSTER
from repro_torch.kernels.swe_flux import MAX_CLUSTER, cluster_plan

H100_SMS = 132
D, FF, E = 5120, 8192, 16  # llama4-scout: d_model, (shared-)expert hidden width, experts

# (label, m, kdim, n, splits): the LM's K7 shapes at prefill (4 x 64 tokens)
# and decode (4 rows)
LM_SHAPES = [
    ("gate/up decode", 4, D, FF, 40),
    ("down decode", 4, FF, D, 64),
    ("router decode", 4, D, E, 40),
    ("router prefill", 256, D, E, 40),
    ("gate/up prefill", 256, D, FF, 1),  # 128 output blocks, and 335 MB of scratch
    ("down prefill", 256, FF, D, 1),  # 80 output blocks, but 335 MB of scratch
]


@pytest.mark.parametrize("label,m,kdim,n,splits", LM_SHAPES, ids=[s[0] for s in LM_SHAPES])
def test_split_plan_at_the_lm_shapes(label, m, kdim, n, splits):
    assert split_plan(m, n, kdim, n_sms=H100_SMS) == splits
    plan = launch_plan(m, n, kdim, n_sms=H100_SMS)
    assert plan.splits == splits and plan.ctas == plan.gm * plan.gn * splits
    if splits > 1:
        assert plan.gm * plan.gn < H100_SMS and plan.gk * m * n * 4 <= SCRATCH_CAP
    else:
        assert plan.gm * plan.gn >= H100_SMS or plan.gk * m * n * 4 > SCRATCH_CAP
    assert launch_plan(m, n, kdim, n_sms=H100_SMS, split=False).splits == 1


def test_launch_plan_fills_the_card_at_decode():
    """Decode's gate/up/down run at least one CTA per SM, the router more
    than the two output blocks it has."""
    for label, m, kdim, n, _ in LM_SHAPES:
        ctas = launch_plan(m, n, kdim, n_sms=H100_SMS).ctas
        if "decode" in label and "router" not in label:
            assert ctas >= H100_SMS, label
        if "router" in label:
            assert ctas > 2, label


@pytest.mark.parametrize(
    "m,kdim,n,n_sms,cap,want",
    [
        (4, 5120, 8192, 64, SCRATCH_CAP, 1),  # the grid already fills 64 SMs
        (4, 5120, 8192, 65, SCRATCH_CAP, 40),
        (4, 5120, 8192, 132, 40 * 4 * 8192 * 4 - 1, 1),  # scratch one byte over the cap
        (4, 5120, 8192, 132, 40 * 4 * 8192 * 4, 40),
        (4, 100, 8192, 132, SCRATCH_CAP, 1),  # one K block: nothing to split
        (5, 1000, 24, 132, SCRATCH_CAP, 8),  # ragged: the last K block is partial
        (1, 129, 1, 132, SCRATCH_CAP, 2),
        (2048, 5120, 2048, 132, SCRATCH_CAP, 1),  # 256 output blocks
    ],
)
def test_split_plan_edges(m, kdim, n, n_sms, cap, want):
    assert split_plan(m, n, kdim, n_sms=n_sms, scratch_cap=cap) == want


def test_split_plan_follows_the_blocks():
    """Smaller blocks make more output blocks and more K blocks."""
    assert split_plan(64, 64, 640, blocks=(64, 64, 64), n_sms=H100_SMS) == 10
    assert split_plan(64, 64, 640, blocks=(32, 32, 64), n_sms=4) == 1


@pytest.mark.parametrize("gk", [1, 2, 3, 7, 40, 64, 65])
def test_k_ranges_cover_each_k_block_once(gk):
    for splits in sorted(s for s in {1, 2, 3, gk // 2, gk - 1, gk} if 1 <= s <= gk):
        ranges = k_ranges(gk, splits)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == gk
        assert all(j0 < j1 for j0, j1 in ranges)  # every CTA has a K block
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # contiguous, in K order
        covered = [j for j0, j1 in ranges for j in range(j0, j1)]
        assert covered == list(range(gk))
        lengths = [j1 - j0 for j0, j1 in ranges]
        assert max(lengths) - min(lengths) <= 1


@pytest.mark.parametrize(
    "bm,bn,bk,tiles,slots",
    [
        (128, 128, 128, 40, 6),  # prefill: two K blocks of 32 KB slots exceed the limit, six slots fit
        (4, 128, 128, 1, 4),  # a split decode CTA: one K block
        (4, 128, 128, 40, 8),  # unsplit decode: two K blocks in flight
        (128, 16, 128, 40, 8),
        (5, 24, 128, 1, 4),
        (64, 64, 64, 3, 4),
        (128, 128, 100, 2, 6),  # a partial last chunk
    ],
)
def test_ring_plan(bm, bn, bk, tiles, slots):
    got, smem = ring_plan(bm, bn, bk, tiles)
    chunks = -(-bk // 32)
    assert got == slots and got >= chunks
    assert smem == slots * 4 * 32 * (bm + -(-bn // 4) * 4) <= _cuda.SMEM_LIMIT


def test_ring_plan_raises_when_one_k_block_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        ring_plan(128, 128, 1024, 2)


def test_launch_plan_rejects_blocks_over_the_kernel_limit():
    with pytest.raises(ValueError, match="output blocks up to"):
        launch_plan(256, 256, 256, blocks=(MAX_BLOCK * 2, 128, 128))


def test_wrapper_on_cpu_runs_the_plain_version_split_or_not():
    """On CPU tensors the private split switch changes nothing: both calls
    run the plain version and count as plain calls."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(5, 300, generator=g), torch.randn(300, 24, generator=g)
    fmt = FlexFormat(3, 9, 3)
    before = (R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls)
    x, y = r2f2_matmul(a, b, fmt=fmt), r2f2_matmul(a, b, fmt=fmt, _split=False)
    assert (R2F2_MATMUL.launches - before[0], R2F2_MATMUL.plain_calls - before[1]) == (0, 2)
    assert torch.equal(x, y) and torch.equal(x, r2f2_matmul_plain(a, b, fmt=fmt))


@pytest.mark.parametrize(
    "shape,want",
    [
        ((127, 128), (16, 8)),  # the paper's field in one tile: 15 bands of 8 rows and one of 7
        ((64, 128), (16, 4)),
        ((128, 128), (16, 8)),
        ((61, 30), (7, 9)),  # an unaligned tile (scalar loads): 6 bands of 9 rows and one of 7
        ((50, 64), (13, 4)),
        ((5, 64), (2, 4)),
        ((1, 128), (1, 2)),
        ((3, 8), (1, 32)),
    ],
)
def test_cluster_plan(shape, want):
    br, bw = shape
    c, band = cluster_plan(br, bw)
    assert (c, band) == want
    bands = [(r * band, min(br, (r + 1) * band)) for r in range(c)]
    assert all(lo < hi for lo, hi in bands)  # no CTA without a row
    assert [row for lo, hi in bands for row in range(lo, hi)] == list(range(br))


def test_cluster_plan_bands_cover_every_tile():
    """Every tile up to 300 rows: at most MAX_CLUSTER CTAs, each with at
    least one row and at least one element per thread, the bands covering
    the rows once (the kernel's own check: C * band >= br > (C - 1) * band)."""
    for bw in (1, 30, 64, 128, 512):
        for br in range(1, 301):
            c, band = cluster_plan(br, bw)
            assert 1 <= c <= MAX_CLUSTER, (br, bw)
            assert c * band >= br > (c - 1) * band, (br, bw)
            assert band * bw >= 256 and band == max(-(-br // MAX_CLUSTER), -(-256 // bw)), (br, bw)


@pytest.mark.parametrize(
    "shape,want",
    [
        ((64, 64), (16, 4)),  # the main path: 62 interior rows, 15 bands of 4 and one of 2
        ((3, 3), (1, 1)),  # the smallest field: one interior cell
        ((4, 64), (1, 2)),
        ((10, 10), (1, 8)),
        ((20, 20), (2, 9)),
        ((24, 24), (2, 11)),
        ((61, 45), (15, 4)),  # unaligned: 59 rows in 14 bands of 4 and one of 3
        ((200, 200), (16, 13)),  # over one CTA's shared memory before the cluster
        ((358, 358), (16, 23)),  # the largest square field
    ],
)
def test_heat2d_cluster_plan(shape, want):
    nx, ny = shape
    c, band = heat2d_cluster_plan(nx, ny)
    assert (c, band) == want
    bands = [(1 + r * band, 1 + min(nx - 2, (r + 1) * band)) for r in range(c)]
    assert all(lo < hi for lo, hi in bands)  # every CTA owns an interior row
    assert [row for lo, hi in bands for row in range(lo, hi)] == list(range(1, nx - 1))


def test_heat2d_cluster_plan_covers_every_field():
    """Every field up to 120 x 120: at most 16 CTAs, the bands covering the
    interior rows once (the kernel's own check: C * band >= nx - 2 > (C - 1)
    * band), one CTA for tiny fields, the default within HEAT2D_CTA_CELLS a
    CTA where 16 CTAs allow it, and each asked-for size honoured where the
    rows allow it."""
    for nx in range(3, 121):
        for ny in (3, 4, 17, 64, 120):
            ni, mi = nx - 2, ny - 2
            c, band = heat2d_cluster_plan(nx, ny)
            assert 1 <= c <= 16 and c * band >= ni > (c - 1) * band, (nx, ny)
            assert band * mi <= HEAT2D_CTA_CELLS or c == -(-ni // -(-ni // 16)), (nx, ny)
            if ni * mi <= HEAT2D_CTA_CELLS:
                assert c == 1, (nx, ny)
            for ask in HEAT2D_CLUSTERS:
                if -(-ni // min(ask, ni)) * mi > HEAT2D_MAX_CTA_CELLS:
                    with pytest.raises(ValueError, match="cannot hold"):
                        heat2d_cluster_plan(nx, ny, ask)
                    continue
                c, band = heat2d_cluster_plan(nx, ny, ask)
                assert c <= ask and c * band >= ni > (c - 1) * band
                assert c == ask or ni < ask or -(-ni // band) < ask  # fewer only where the rows run out


def test_heat2d_cluster_plan_at_the_main_path_sizes():
    """64 x 64 at every size the chip measures: (C, band) with C CTAs."""
    assert [heat2d_cluster_plan(64, 64, c) for c in HEAT2D_CLUSTERS] == [(1, 62), (2, 31), (4, 16), (8, 8), (16, 4)]


@pytest.mark.parametrize("shape", [(359, 359), (258, 515), (3, 8195), (131_075, 3)])
def test_heat2d_cluster_plan_refuses_beyond_capacity(shape):
    """16 CTAs hold at most HEAT2D_MAX_CTA_CELLS interior cells each; the
    cluster refuses a field beyond that, and heat2d_plan gives it the rod's
    cooperative grid instead (one row or column fewer fits the cluster)."""
    with pytest.raises(ValueError, match="cannot hold"):
        heat2d_cluster_plan(*shape)
    nx, ny = shape
    assert heat2d_plan(nx, ny) == rod_plan(nx, ny) and heat2d_plan(nx, ny).shape == "grid"
    assert _in_cluster(nx - 1, ny) or _in_cluster(nx, ny - 1)


def _in_cluster(nx, ny):
    return min(nx, ny) >= 3 and isinstance(heat2d_plan(nx, ny), ClusterPlan)


def test_heat2d_cluster_plan_refuses_bad_asks():
    with pytest.raises(ValueError, match="nx, ny >= 3"):
        heat2d_cluster_plan(2, 64)
    with pytest.raises(ValueError, match="1 to 16"):
        heat2d_cluster_plan(64, 64, 17)
    with pytest.raises(ValueError, match="cannot hold"):
        heat2d_cluster_plan(200, 200, 1)  # 39,204 cells in one CTA
    assert HEAT2D_MAX_CTA_CELLS == 512 * 16


# ---------------------------------------------------------------------------
# K2 and K4 heat1d: rod_plan


@pytest.mark.parametrize("br,nx,plan", [(1, 128, ("warp", 128, 1, 1)), (8, 128, ("warp", 256, 4, 1)), (2, 64, ("warp", 128, 1, 1)),
                                         (1, 3, ("warp", 32, 1, 1))],
                         ids=["main-path", "block-rows-8", "block-rows-2", "three-cells"])
def test_heat1d_plan_at_the_path_shapes(br, nx, plan):
    """The main path's (1, 128) rod (four warps, one cell a lane), the
    kernel API's eight rows of 128, phase 2's (5, 64) at block_rows=2 and
    the 3-cell rod (one warp)."""
    assert rod_plan(br, nx) == plan


@pytest.mark.parametrize("br,nx", [(1, 2048), (2, 1024), (8, 256), (1, 2049), (3, 683), (5, 410)])
def test_heat1d_plan_warp_grid_boundary(br, nx):
    """WARP_MAX warps of 8 cells a lane hold WARP_LIMIT = 2048 cells: one
    cell more takes the grid, on two CTAs (GRID_THREADS * GRID_CELLS cells a
    CTA)."""
    plan = rod_plan(br, nx)
    if br * nx <= WARP_LIMIT:
        assert plan == ("warp", 32 * WARP_MAX, 8, 1)
    else:
        assert plan == ("grid", 2 * GRID_THREADS, 8, 2)


def _owners(plan, n):
    """How often each cell of an n-cell block is taken: lane l of the warp
    shape's threads holds [l * cells, (l + 1) * cells); a grid thread holds
    first + i * threads for i < cells, batch after batch while below n."""
    seen = torch.zeros(n, dtype=torch.int64)
    if plan.shape == "warp":
        for lane in range(plan.threads):
            seen[lane * plan.cells:min((lane + 1) * plan.cells, n)] += 1
        return seen
    batches = -(-n // (plan.threads * plan.cells))
    for first in range(plan.threads):
        walk = first + plan.threads * torch.arange(batches * plan.cells)
        seen[walk[walk < n]] += 1
    return seen


@pytest.mark.parametrize("br", [1, 2, 3, 8])
def test_heat1d_plan_covers_every_cell_once(br):
    """Every cell of blocks from 3 cells to well past the warp shape, and
    at 30,000, 10**6 and 2 * 10**6 (batches), is taken by exactly one lane
    or thread; the warp shape takes a warp for each 32 cells up to
    WARP_MAX; the grid never has more CTAs than the card's SMs, nor fewer
    than its cells ask for, and holds a block in one batch up to 32 cells a
    thread."""
    for nx in [*range(3, 700, 7), WARP_LIMIT // br, WARP_LIMIT // br + 1, 4096, 30_000, 10**6, 2 * 10**6]:
        plan = rod_plan(br, nx)
        n = br * nx
        assert bool((_owners(plan, n) == 1).all()), (br, nx)
        assert plan.cells in CELLS
        if plan.shape == "warp":
            assert plan.threads == 32 * min(WARP_MAX, -(-n // 32)) and plan.cells <= 8 and plan.ctas == 1
        else:
            assert plan.threads == plan.ctas * GRID_THREADS
            assert plan.ctas == min(-(-n // (GRID_THREADS * GRID_CELLS)), H100_SMS)
            assert plan.threads * plan.cells >= n or plan.cells == 32


def test_heat1d_plan_refuses_nothing_from_three_cells():
    """Any rod of at least 3 cells has a launch shape (there is no field
    limit: the card runs heat1d where repro does); fewer cells, or no rows,
    are refused."""
    for nx in [*range(3, 3000), 25_600, 25_601, 10**6, 10**8]:
        assert rod_plan(1, nx).shape in ("warp", "grid")
    assert rod_plan(1, 10**8, n_sms=16).ctas == 16
    for br, nx in ((1, 2), (0, 128), (4, 1)):
        with pytest.raises(ValueError, match="nx >= 3"):
            rod_plan(br, nx)


@pytest.mark.parametrize("rows,nx,br", [(1, 30_000, 1), (1, 10**6, 1), (12, 4096, 3)])
def test_heat1d_grid_scratch_does_not_grow_with_the_horizon(rows, nx, br):
    """The grid shape's scratch is the same for any number of substeps: two
    field buffers of the field's size (a third one to decode a packed input
    into), a ring of two substeps' lap and flux maxima a block and the two
    storage maxima' slots, and one barrier counter a block, both zeroed.
    The counter is 64-bit: three barriers a substep over 132 CTAs would wrap
    32 bits after about 11 million substeps, and a wrapped target lets CTAs
    past the barrier early."""
    blocks = rows // br
    for staged in (False, True):
        work, maxes, count = grid_scratch(rows, nx, br, "cpu", staged=staged)
        assert work.dtype == torch.float32 and work.numel() == (3 if staged else 2) * rows * nx
        assert maxes.dtype == torch.int32 and maxes.numel() == 4 * blocks + 2 and not maxes.any()
        assert count.dtype == torch.int64 and count.numel() == blocks and not count.any()


# ---------------------------------------------------------------------------
# the 1-D K5 bodies on the rod: rod_plan(periodic=True)


def _wrap_neighbours(plan, n):
    """The cells a periodic rod's kernel reads as each cell's left and right
    neighbour (-1: a value no cell holds), as csrc/rod_warp.cu and rod_grid.cu take them. Warp
    shape: lane l holds cells [l*G, l*G + G); a lane's first cell takes the
    last cell of the lane before (by shuffle, or the warp before's edge) and
    cell 0 the wrap, u[n - 1]; a lane's last cell takes the first of the
    lane after (lane 31 of the last warp: its own first cell), and the lane
    holding cell n - 1 picks the wrap, u[0], for that cell alone. Grid shape:
    indices mod n."""
    if plan.shape == "grid":
        return [n - 1 if j == 0 else j - 1 for j in range(n)], [0 if j + 1 == n else j + 1 for j in range(n)]
    g_cells, warps = plan.cells, plan.threads // 32
    cell = lambda lane, g: lane * g_cells + g if lane * g_cells + g < n else -1  # noqa: E731
    left, right = [], []
    for j in range(n):
        lane, g = divmod(j, g_cells)
        if g > 0:
            left.append(cell(lane, g - 1))
        else:
            left.append(n - 1 if lane == 0 else cell(lane - 1, g_cells - 1))
        if j == n - 1:
            right.append(0)  # the lane's `last` bit picks the wrap
        elif g < g_cells - 1:
            right.append(cell(lane, g + 1))
        else:
            last_lane = lane % 32 == 31 and lane // 32 + 1 == warps
            right.append(cell(lane, 0) if last_lane else cell(lane + 1, 0))
    return left, right


@pytest.mark.parametrize("nx", [1, 2, 3, 5, 255, 256, 257, 1000, WARP_LIMIT - 1, WARP_LIMIT, WARP_LIMIT + 1,
                                WARP_LIMIT + 2, 30_000])
def test_rod_plan_periodic_rods(nx):
    """A periodic rod (advection1d, burgers1d) takes the warp shape up to
    WARP_LIMIT cells and the grid one cell past it (heat1d's plan from 3
    cells on), every cell taken by one lane or thread, and the kernel's
    neighbours are the periodic ones, (j - 1) mod n and (j + 1) mod n: cell
    0 takes cell n - 1 and cell n - 1 takes cell 0 in both shapes."""
    plan = rod_plan(1, nx, periodic=True)
    assert plan.shape == ("warp" if nx <= WARP_LIMIT else "grid")
    if nx >= 3:
        assert plan == rod_plan(1, nx)
    assert bool((_owners(plan, nx) == 1).all())
    for p in (plan, RodPlan("grid", GRID_THREADS, next(g for g in CELLS if g * GRID_THREADS >= nx or g == 32), 1)):
        left, right = _wrap_neighbours(p, nx)
        assert left == [(j - 1) % nx for j in range(nx)], p
        assert right == [(j + 1) % nx for j in range(nx)], p
        assert (left[0], right[nx - 1]) == (nx - 1, 0)


def test_rod_plan_periodic_grid_walks_batches():
    """A periodic rod's grid thread holds at most GRID_CELLS cells (the
    kernel's kPeriodicGridCells); a longer rod walks batches, every cell
    taken once, where heat1d's thread holds up to 32."""
    n = 10**6
    plan = rod_plan(1, n, periodic=True)
    assert plan == ("grid", H100_SMS * GRID_THREADS, GRID_CELLS, H100_SMS)
    assert rod_plan(1, n).cells == 32
    assert -(-n // (plan.threads * plan.cells)) == 4
    assert bool((_owners(plan, n) == 1).all())


def test_rod_plan_periodic_refuses_no_rod():
    """Any periodic rod of one cell or more has a shape; no rod, or no row, is refused."""
    assert rod_plan(1, 1, periodic=True) == ("warp", 32, 1, 1)
    for br, nx in ((1, 0), (0, 256)):
        with pytest.raises(ValueError, match="nx >= 1"):
            rod_plan(br, nx, periodic=True)


# ---------------------------------------------------------------------------
# heat2d beyond its cluster: heat2d_plan


@pytest.mark.parametrize("shape,shape_kind", [((358, 358), "cluster"), ((258, 514), "cluster"), ((359, 359), "grid"),
                                              ((258, 515), "grid"), ((64, 64), "cluster"), ((400, 400), "grid")])
def test_heat2d_plan_cluster_or_grid(shape, shape_kind):
    """heat2d's plan is the cluster up to its capacity (358x358, and 16 CTAs
    of 16 x 512 interior cells at (258, 514)) and the rod's cooperative grid
    one row or column past it; an asked-for cluster size stays a cluster."""
    nx, ny = shape
    plan = heat2d_plan(nx, ny)
    if shape_kind == "cluster":
        assert plan == heat2d_cluster_plan(nx, ny) and isinstance(plan, ClusterPlan)
    else:
        assert plan == rod_plan(nx, ny) and plan.shape == "grid"
        assert plan.ctas == min(-(-nx * ny // (GRID_THREADS * GRID_CELLS)), H100_SMS)
        with pytest.raises(ValueError, match="cannot hold"):
            heat2d_plan(nx, ny, cluster=16)
    assert heat2d_plan(64, 64, cluster=4) == (4, 16)


# ---------------------------------------------------------------------------
# K4 swe2d: swe2d_plan


@pytest.mark.parametrize("shape,want", [
    ((64, 64), (63, 256, 2)),  # the card link's field: one-row bands, the last two rows
    ((128, 128), (127, 256, 2)),  # the main path
    ((129, 128), (128, 256, 2)),  # the largest field of the default kernel_blocks
    ((127, 128), (126, 256, 2)),
    ((200, 200), (132, 512, 2)),  # more rows than SMs: taller bands, more threads
    ((400, 400), (132, 512, 4)),
    ((3, 3), (2, 256, 2)),  # the last band holds both wall rows
    ((32, 3), (31, 256, 2)),
    ((64, 5000), (63, 512, 2)),  # a wide field: its band arrays in device memory
])
def test_swe2d_plan(shape, want):
    plan = swe2d_plan(*shape)
    assert (plan.ctas, plan.threads, plan.rows) == want
    nbytes = 4 * swe2d_band_floats(plan.rows, shape[1])
    assert plan.smem == (nbytes if nbytes <= SWE2D_SMEM_LIMIT else 0) and (plan.smem == 0) == (shape == (64, 5000))


def test_swe2d_plan_covers_every_field():
    """Every row is owned by exactly one band; each band's halo row (the row
    below it) lies inside the field; the last band holds both wall rows
    nx - 2 and nx - 1 (and the first band holds row 1 or has it as its
    halo); the plan's grid fits one CTA per SM, and rows beyond that take
    taller bands; an asked-for grid (bands of two and four rows) keeps its
    CTAs up to nx - 1; a CTA has a thread per point of its tallest band,
    256 to 512; the band arrays fit shared memory or go to device memory."""
    sms = H100_SMS
    for nx in list(range(3, 140)) + [255, 256, 257, 263, 264, 265, 400, 1000, 4097]:
        for ny in (3, 4, 64, 128, 5000):
            for ctas in (None, -(-nx // 2), -(-nx // 4)):
                plan = swe2d_plan(nx, ny, sms=sms, ctas=ctas)
                bands = swe2d_bands(nx, plan.ctas)
                assert 1 <= plan.ctas <= nx - 1, (nx, ny, plan)
                assert bands[0][0] == 0 and bands[-1][1] == nx
                assert all(a[1] == b[0] for a, b in zip(bands, bands[1:])), (nx, bands)
                heights = [r1 - r0 for r0, r1 in bands]
                assert min(heights) >= 1 and max(heights) == plan.rows == -(-nx // plan.ctas)
                assert all(r1 < nx for _, r1 in bands[:-1])  # every halo row is in the field
                assert heights[-1] >= 2  # the wall pair nx-2, nx-1 in one band
                assert bands[0][1] >= 1  # row 0 mirrors row 1: CTA 0 holds it (own or halo)
                if ctas is None:
                    assert plan.ctas == min(sms, nx - 1)
                    assert plan.rows == (2 if nx <= sms + 1 else -(-nx // sms))  # taller bands past the SMs
                else:
                    assert plan.ctas == max(1, min(ctas, nx - 1))
                assert plan.threads % 128 == 0 and 256 <= plan.threads <= 512
                assert plan.threads == 512 or plan.threads >= plan.rows * ny
                nbytes = 4 * swe2d_band_floats(plan.rows, ny)
                assert plan.smem == (nbytes if nbytes <= SWE2D_SMEM_LIMIT else 0)
    with pytest.raises(ValueError, match="nx, ny >= 3"):
        swe2d_plan(2, 64)


@pytest.mark.parametrize("nx,ny,kw,want", [
    (128, 128, dict(ctas=1), (1, 512, 128)),  # one CTA owns every row
    (128, 128, dict(ctas=8), (8, 512, 16)),
    (128, 128, dict(ctas=500), (127, 256, 2)),
    (128, 128, dict(ctas=64), (64, 256, 2)),  # two-row bands
    (9, 7, dict(ctas=3), (3, 256, 3)),
])
def test_swe2d_plan_forced_grids(nx, ny, kw, want):
    """An asked-for grid keeps its CTA count up to nx - 1 bands; a CTA that
    owns every row takes the whole field, its band arrays in device memory
    when they do not fit shared memory."""
    plan = swe2d_plan(nx, ny, **kw)
    assert (plan.ctas, plan.threads, plan.rows) == want
    assert (plan.smem == 0) == (4 * swe2d_band_floats(want[2], ny) > SWE2D_SMEM_LIMIT)


@pytest.mark.parametrize("nx,ny", [(128, 128), (200, 200), (512, 512), (64, 5000)])
def test_swe2d_grid_scratch_does_not_grow_with_the_horizon(nx, ny):
    """The grid's scratch is the same for any number of substeps: Ux in a
    ring of two substeps, the band arrays in device memory only where they
    do not fit shared memory, each CTA's maxima at a substep's two grid
    barriers and at the storage rounding's, and one 64-bit barrier counter
    (zeroed): two grid barriers a substep would wrap 32 bits after about 16
    million substeps on 132 CTAs."""
    plan = swe2d_plan(nx, ny)
    ux, bands, words, count = swe2d_grid_scratch(nx, ny, plan, "cpu")
    assert ux.dtype == torch.float32 and ux.numel() == 2 * 3 * (nx - 1) * ny
    if plan.smem:
        assert bands is None
    else:
        assert bands.dtype == torch.float32 and bands.numel() == plan.ctas * swe2d_band_floats(plan.rows, ny)
    assert words.dtype == torch.int32 and words.numel() == 3 * plan.ctas
    assert count.dtype == torch.int64 and count.numel() == 1 and not count.any()


@pytest.mark.parametrize("members,capacity,want", [
    (8, 264, (33, 512, 4, 8)),  # service's max_bucket, two CTAs an SM: 33 CTAs of up to 4 rows, one wave
    (8, 396, (49, 384, 3, 8)),  # three CTAs an SM
    (1, 264, (127, 256, 2, 1)),  # one member keeps the one-row bands
    (2, 264, (127, 256, 2, 2)),  # two members of 127 CTAs fit side by side
    (3, 264, (88, 256, 2, 3)),
    (8, 64, (16, 512, 8, 4)),  # beyond the fewest CTAs a member: two waves of four members
    (8, 16, (16, 512, 8, 1)),  # one member a wave
])
def test_swe2d_member_plan(members, capacity, want):
    """Ensemble members at 128x128: each member takes its own bands, planned
    so that every member's CTAs are resident at once (members * ctas <=
    capacity), with taller bands down to SWE2D_MIN_MEMBER_CTAS CTAs a
    member; beyond that the members run in waves."""
    plan = swe2d_plan(128, 128, members=members, capacity=capacity)
    assert (plan.ctas, plan.threads, plan.rows, plan.wave) == want
    assert plan.wave * plan.ctas <= capacity or plan.ctas > capacity


def test_swe2d_member_plan_covers_every_field_and_member():
    """For any field, member count and capacity: the bands cover every row
    once with the walls in the last band and every halo row in the field;
    a member's grid fits the capacity beside the others' where it can
    (else it keeps SWE2D_MIN_MEMBER_CTAS CTAs, or the field's rows); the
    waves hand out every member exactly once, in order, each wave within
    the capacity; a forced grid keeps its CTAs."""
    for nx in (3, 5, 17, 64, 127, 128, 129, 200, 400):
        for ny in (3, 64, 128):
            for members in (1, 2, 3, 5, 8, 9, 33):
                for capacity in (16, 33, 64, 132, 264, 528, 10**4):
                    plan = swe2d_plan(nx, ny, members=members, capacity=capacity)
                    bands = swe2d_bands(nx, plan.ctas)
                    assert bands[0][0] == 0 and bands[-1][1] == nx
                    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
                    assert all(r1 < nx for _, r1 in bands[:-1]) and bands[-1][1] - bands[-1][0] >= 2
                    assert max(r1 - r0 for r0, r1 in bands) == plan.rows
                    one = swe2d_plan(nx, ny)
                    if members * one.ctas <= capacity:
                        assert plan.ctas == one.ctas and plan.wave == members
                    else:
                        assert plan.ctas == max(1, min(max(capacity // members, min(SWE2D_MIN_MEMBER_CTAS, one.ctas)),
                                                       nx - 1))
                    waves = member_waves(members, plan.wave)
                    assert [m for m0, n in waves for m in range(m0, m0 + n)] == list(range(members))
                    assert all(n * plan.ctas <= capacity for _, n in waves) or plan.ctas > capacity
    forced = swe2d_plan(128, 128, ctas=16, members=3, capacity=32)
    assert (forced.ctas, forced.wave) == (16, 2) and member_waves(3, forced.wave) == [(0, 2), (2, 1)]
    with pytest.raises(ValueError, match="at least one member"):
        swe2d_plan(128, 128, members=0)


def test_member_scratch_is_a_members_worth_each():
    """An ensemble's grid scratch is one member's scratch a member: the rod
    grid's buffers, maxima and barrier counters, and K4 swe2d's Ux ring,
    band arrays, maxima words and one 64-bit barrier counter a member (each
    member's grid barriers wait only on its own CTAs)."""
    work, maxes, count = grid_scratch(1, 3000, 1, "cpu", members=5)
    assert work.numel() == 5 * 2 * 3000 and maxes.numel() == 5 * (4 + 2) and count.numel() == 5 and not count.any()
    work, _, _ = grid_scratch(1, 3000, 1, "cpu", staged=True, members=5)
    assert work.numel() == 5 * 3 * 3000
    for nx, ny in ((128, 128), (64, 5000)):
        plan = swe2d_plan(nx, ny, members=8, capacity=264)
        ux, bands, words, count = swe2d_grid_scratch(nx, ny, plan, "cpu", members=8)
        assert ux.numel() == 8 * 2 * 3 * (nx - 1) * ny and words.numel() == 8 * 3 * plan.ctas
        assert count.dtype == torch.int64 and count.numel() == 8 and not count.any()
        assert (bands is None) == bool(plan.smem)
        if bands is not None:
            assert bands.numel() == 8 * plan.ctas * swe2d_band_floats(plan.rows, ny)


# ---------------------------------------------------------------------------
# K6: quantize_plan


@pytest.mark.parametrize("m,n,block,want", [
    (5120, 8192, (256, 256), ("cluster", 4, 64, 65536, 2560)),  # the shared-expert gate's weight
    (1024, 1024, (256, 256), ("cluster", 4, 64, 65536, 64)),  # bench_kernels: 16 tiles, 64 CTAs
    (1024, 1024, (128, 256), ("cluster", 2, 64, 65536, 64)),
    (1024, 1024, (256, 128), ("cluster", 2, 128, 65536, 64)),
    (1024, 1024, (128, 128), ("cluster", 1, 128, 65536, 64)),
    (1024, 1024, (512, 256), ("cluster", 8, 64, 65536, 64)),  # 512 KB: the largest cluster
    (96, 512, (96, 256), ("cluster", 2, 48, 49152, 4)),  # a block as tall as the matrix
    (1024, 1024, (512, 512), ("two_pass", 0, 512, 0, 4)),  # 1 MB: more than 8 CTAs of 64 KB
    (1024, 1024, (8, 128), ("two_pass", 0, 8, 0, 1024)),  # 4 KB: its second read hits L1
    (1024, 1026, (1024, 6), ("two_pass", 0, 1024, 0, 171)),  # no 16-byte vectors
    (1024, 1028, (256, 514), ("two_pass", 0, 256, 0, 8)),
])
def test_quantize_plan(m, n, block, want):
    assert tuple(quantize_plan(m, n, *block)) == want


def test_quantize_plan_cluster_shapes():
    """Over blocks of every power-of-two side from 8 to 1024 and some that
    are not: the cluster divides the tile's rows, a CTA's rows fit its 64 KB
    of shared memory (several CTAs an SM, under the 227 KB a CTA may take),
    the cluster is at most 8 CTAs, the rows allow 16-byte vectors, and the
    tile is at least 16 KB; every other block takes the two-pass shape, one
    CTA per tile. An unaligned matrix always takes the two-pass shape."""
    sides = [8, 16, 32, 64, 96, 128, 200, 256, 512, 1024, 6, 12, 250, 514]
    for bm in sides:
        for bn in sides:
            m, n = 4 * bm, 2 * bn
            plan = quantize_plan(m, n, bm, bn)
            tile = 4 * bm * bn
            if plan.shape == "cluster":
                assert bm % plan.cluster == 0 and plan.rows * plan.cluster == bm
                assert 1 <= plan.cluster <= K6_MAX_CLUSTER and plan.cluster & (plan.cluster - 1) == 0
                assert plan.smem == 4 * plan.rows * bn <= CTA_TILE_BYTES < 227 * 1024
                assert plan.cluster == 1 or plan.smem * 2 > CTA_TILE_BYTES  # the fewest CTAs that hold it
                assert bn % 4 == 0 and tile >= MIN_CLUSTER_TILE_BYTES
                assert plan.ctas == 8 * plan.cluster
            else:
                assert (bn % 4 or tile < MIN_CLUSTER_TILE_BYTES or tile > K6_MAX_CLUSTER * CTA_TILE_BYTES
                        or bm % -(-tile // CTA_TILE_BYTES)), (bm, bn, plan)
                assert plan == ("two_pass", 0, bm, 0, 8)
            assert quantize_plan(m, n, bm, bn, aligned=False) == ("two_pass", 0, bm, 0, 8)


def test_r2f2_quantize_cpu_runs_the_plain_version():
    """On the CPU the wrapper runs the plain version whatever the plan (and
    counts it); the plan is a function of the shapes alone."""
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    fmt = FlexFormat(3, 9, 3)
    plain = R2F2_QUANTIZE.plain_calls
    y, k = r2f2_quantize(x, fmt=fmt, block=(64, 128))
    want = r2f2_quantize_plain(x, fmt=fmt, block=(64, 128))
    assert torch.equal(y, want[0]) and torch.equal(k, want[1]) and R2F2_QUANTIZE.plain_calls == plain + 1
