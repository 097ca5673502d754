"""Kernel B, the DFA backward, on the CPU: its planner and a plain mirror
of its deterministic design.

Kernel B runs on the card only (`csrc/sampling.cu`): B0 ranks each
camera row's live slots, B1 (a block per anchor) writes each live
entry's record at its rank, and B2 (a block per camera row and pixel
tile of a level) owns those feature-gradient rows and sums every entry
whose 2x2 footprint reaches its tile, in rank order. The mirror here
repeats that bookkeeping in PyTorch: the ranks must be the order in
which `dfa_slots` keeps the slots, every live corner of nonzero weight
must be summed by exactly one tile, and the tiles' sums must give the
plain backward's feature gradient. The kernel against its plain version
is chip_smoke's `train_grad` phase; the plain version against JAX is
`tests/test_torch_port_train.py::test_dfa_gradients_match_jax`.
"""
import numpy as np
import pytest
import torch

from simpb_tpu_torch.configs.base import simpb_r50_704x256_fast, simpb_tiny
from simpb_tpu_torch.models.det3d_blocks import SparseBox3DKeyPointsGenerator
from simpb_tpu_torch.ops import _kernels
from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.ops.format import SpatialShapes

torch.set_num_threads(1)
FAST, TINY = simpb_r50_704x256_fast(), simpb_tiny()


def _train_shapes(cfg, bs):
    """DFA's call in a training step: (bs, cams, anchors with the DN rows,
    points, groups, C, capacity, levels)."""
    h = cfg.head
    anchors = h.num_anchor + h.num_dn_groups * 2 * h.max_dn_gt
    pts = len(SparseBox3DKeyPointsGenerator.FIX_SCALE) + h.num_learnable_pts
    return (bs, h.num_cams, anchors, pts, h.num_groups, h.embed_dims,
            h.dfa_gather_capacity, cfg.feature_shapes)


TS = tsmp.B2_TILE


def _tile_index(plan, shapes):
    """B2's tile numbering, from the plan's dims: [(level, ty0, tx0)] in
    block order (the C entry reads the first tile of each level)."""
    num_levels = len(shapes)
    first = list(plan.dims)[-num_levels:]
    out = {}
    for lvl, (h, w) in enumerate(shapes):
        ntx = -(-w // TS)
        for t in range(-(-h // TS) * ntx):
            out[first[lvl] + t] = (lvl, t // ntx * TS, t % ntx * TS)
    return [out[i] for i in range(len(out))]


@pytest.mark.parametrize("cfg,bs", [(FAST, 4), (TINY, 1)],
                         ids=["fast_bs4", "tiny_bs1"])
def test_plan_dfa_backward_at_training_shapes(cfg, bs):
    """B1 a block per (anchor, batch), B2 a block per (camera row, tile)
    with every pixel of every level in one tile, the smallest level's
    tiles first; shared memory and scratch as the kernels lay them out."""
    args = _train_shapes(cfg, bs)
    bs, cams, anchors, pts, groups, c, cap, shapes = args
    plan = tsmp.plan_dfa_backward(*args)
    assert plan.grid == (anchors, bs)
    assert plan.threads % 32 == 0 and plan.threads % (c // 8) == 0
    entries = cams * pts * len(shapes)
    assert plan.smem == entries * (56 + 4 * groups) + 4 * cams * (pts + 1)
    assert plan.smem <= _kernels.MAX_SMEM
    tiles = _tile_index(plan, shapes)
    assert plan.gcol_grid == (bs * cams, len(tiles))
    cover = [np.zeros(s, int) for s in shapes]
    for lvl, ty0, tx0 in tiles:
        cover[lvl][ty0:ty0 + TS, tx0:tx0 + TS] += 1
    assert all((m == 1).all() for m in cover)
    sizes = [shapes[lvl][0] * shapes[lvl][1] for lvl, _, _ in tiles]
    assert sizes == sorted(sizes)  # crowded (small) levels first
    n = min(cap, anchors * pts)
    assert plan.scratch == bs * cams * (
        len(shapes) * n * (5 + groups) + n + anchors + 1)
    dims = list(plan.dims)
    assert dims[9:11] == [plan.threads, plan.smem]
    assert dims[11 + 3 * len(shapes)] == len(tiles)
    if cfg is FAST:  # the step's call: 24 camera rows of 2048 slots
        assert (anchors, pts, cap) == (1220, 13, 2048)
        assert len(tiles) == 176 + 44 + 12 + 3
        assert plan.scratch * 4 < 11e6


def test_plan_dfa_backward_refuses_what_the_kernels_do_not_take():
    shapes = FAST.feature_shapes
    with pytest.raises(ValueError, match="powers of two"):
        tsmp.plan_dfa_backward(1, 6, 900, 13, 8, 192, 2048, shapes)
    with pytest.raises(ValueError, match="powers of two"):
        tsmp.plan_dfa_backward(1, 6, 900, 13, 1, 512, 2048, shapes)
    with pytest.raises(ValueError, match="groups"):
        tsmp.plan_dfa_backward(1, 6, 900, 13, 16, 256, 2048, shapes)
    with pytest.raises(ValueError, match="pixels a side"):
        tsmp.plan_dfa_backward(1, 6, 900, 13, 8, 256, 2048,
                               ((8, 1 << 15),))
    with pytest.raises(ValueError, match="shared memory"):
        tsmp.plan_dfa_backward(1, 60, 900, 13, 8, 256, 2048, shapes)


def _inputs(rng, bs, anchors, pts, shapes, c, groups, dtype):
    """Points over and across the image border (some exactly on it),
    whole anchors out of view, normalised weights, a random column."""
    edges = np.array([0.0, 1.0, -0.1, 1.1, 2 ** -9, 1 - 2 ** -8, 0.5, 0.3])
    loc = rng.uniform(-0.15, 1.15, (bs, anchors, pts, 6, 2))
    on = rng.uniform(size=loc.shape) < 0.1
    loc[on] = edges[rng.integers(0, len(edges), on.sum())]
    loc[:, :3] = -0.5
    w = rng.uniform(size=(bs, anchors, pts, 6, len(shapes), groups))
    w /= w.sum((2, 3, 4), keepdims=True)
    col = rng.normal(size=(bs, 6, sum(h * w_ for h, w_ in shapes), c))
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dtype)
    return t(col), t(loc), t(w)


def _ranks(points_2d, capacity):
    """B0 and B1's ranks: per camera row, the live slots before each
    anchor (B0's scan), plus the live points before p in the anchor (B1);
    -1 for a slot that is not live."""
    bs, anchors, pts, cams = points_2d.shape[:4]
    loc = points_2d.permute(0, 3, 1, 2, 4).reshape(bs * cams, anchors, pts,
                                                   2).float()
    live = ((loc > 0) & (loc < 1)).all(-1)
    if capacity is not None:
        live &= live.flatten(1).cumsum(1).reshape(live.shape) <= capacity
    per_anchor = live.sum(2)
    base = per_anchor.cumsum(1) - per_anchor  # B0
    rank = base[..., None] + live.cumsum(2) - live.int()  # B1
    return torch.where(live, rank, -1).flatten(1), per_anchor.sum(1)


@pytest.mark.parametrize("capacity,dtype", [
    (None, torch.float32), (50, torch.float32), (None, torch.bfloat16),
    (70, torch.bfloat16)])
def test_slot_rank_is_the_order_dfa_slots_keeps(capacity, dtype):
    """A live slot's rank (B0's per-anchor scan plus B1's count within the
    anchor) is its place among the slots `dfa_slots` keeps, in its order;
    the row's count is the number it keeps."""
    rng = np.random.default_rng(10)
    _, pts, w = _inputs(rng, 2, 12, 13, TINY.feature_shapes, 16, 4, dtype)
    rank, cnt = _ranks(pts, capacity)
    _, _, valid, sel = tsmp.dfa_slots(pts, w, capacity)
    for row in range(rank.shape[0]):
        kept = sel[row][valid[row]]
        assert cnt[row] == kept.numel() > 0
        assert torch.equal(rank[row][kept], torch.arange(kept.numel()))
        assert (rank[row] >= 0).sum() == kept.numel()
    if capacity is not None:
        assert (cnt == capacity).any()


def _records(col, pts, w, shapes, capacity):
    """B1's records by (row, level, rank): corner base (x0, y0), the four
    corner weights (fp32 products of the rounded ones), the anchor and the
    group weights."""
    bs, anchors, npts, cams = pts.shape[:4]
    rank, cnt = _ranks(pts, capacity)
    loc = pts.permute(0, 3, 1, 2, 4).reshape(bs * cams, anchors * npts, 2)
    wl = w.permute(0, 3, 1, 2, 4, 5).reshape(bs * cams, anchors * npts,
                                             len(shapes), -1)
    recs = []
    for row in range(bs * cams):
        slots = torch.argsort(torch.where(rank[row] >= 0, rank[row],
                                          anchors * npts))[:int(cnt[row])]
        per_level = []
        for lvl, (h, w_) in enumerate(shapes):
            wx0, wx1, wy0, wy1, x0, y0, _ = tsmp._corner_weights(
                loc[row, slots], h, w_, col.dtype, True)
            f = lambda t: t.float()
            wk = torch.stack([f(wy0) * f(wx0), f(wy0) * f(wx1),
                              f(wy1) * f(wx0), f(wy1) * f(wx1)], -1)
            per_level.append((x0, y0, wk, slots // npts,
                              wl[row, slots, lvl].float()))
        recs.append(per_level)
    return recs


def _b2_mirror(recs, shapes, gout, cams, c, groups):
    """B2's owner tiles over the records: (the number of tiles that sum
    each live corner of nonzero weight, the feature gradient in float64
    [rows, ΣHW, C])."""
    starts = [0]
    for h, w in shapes:
        starts.append(starts[-1] + h * w)
    total = starts[-1]
    gcol = torch.zeros(len(recs), total, c, dtype=torch.float64)
    owners = []
    for row, per_level in enumerate(recs):
        go = gout[row // cams].double()
        for lvl, (x0, y0, wk, anc, gw) in enumerate(per_level):
            h, w = shapes[lvl]
            px = x0[:, None] + torch.tensor([0, 1, 0, 1])
            py = y0[:, None] + torch.tensor([0, 0, 1, 1])
            count = torch.zeros(wk.shape, dtype=torch.int64)
            gg = go[anc] * gw.double().repeat_interleave(c // groups, -1)
            for ty0 in range(0, h, TS):
                for tx0 in range(0, w, TS):
                    # the block's hit test and its corners in the tile
                    hit = ((x0 - tx0 >= -1) & (x0 - tx0 < TS)
                           & (y0 - ty0 >= -1) & (y0 - ty0 < TS))
                    own = (hit[:, None] & (wk != 0) & (px >= tx0)
                           & (px < tx0 + TS) & (py >= ty0) & (py < ty0 + TS))
                    count += own.long()
                    r, k = own.nonzero(as_tuple=True)
                    gcol[row].index_add_(
                        0, starts[lvl] + py[r, k] * w + px[r, k],
                        gg[r] * wk[r, k].double()[:, None])
            owners.append(count[wk != 0])
    return torch.cat(owners), gcol


@pytest.mark.parametrize("capacity,dtype", [
    (None, torch.float32), (60, torch.float32), (60, torch.bfloat16)])
def test_b2_owners_sum_the_plain_feature_gradient(capacity, dtype):
    """Every live corner of nonzero weight has exactly one owner tile, and
    the owners' sums are the plain backward's feature gradient: fp32
    against float64 sums at 1e-6 of its largest value; bf16 rounds each
    sum once, so the two may also land one bf16 step apart (2^-7 of the
    value, as chip_smoke's GRAD_TOL)."""
    rng = np.random.default_rng(11)
    shapes = TINY.feature_shapes
    col, pts, w = _inputs(rng, 2, 12, 13, shapes, 16, 4, dtype)
    gout = torch.from_numpy(rng.normal(size=(2, 12, 16)).astype(np.float32))
    recs = _records(col, pts, w, shapes, capacity)
    owners, gcol = _b2_mirror(recs, shapes, gout, 6, 16, 4)
    assert owners.numel() > 100 and (owners == 1).all()
    ref = tsmp.deformable_aggregation_backward_plain(
        col, SpatialShapes(shapes), pts, w, gout, capacity)[0]
    assert ref.dtype == dtype
    got = gcol.to(dtype).double()
    ref = ref.double().reshape(gcol.shape)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert ((got - ref).abs() <= rel * ref.abs()
            + 1e-6 * ref.abs().max()).all()
    assert (ref != 0).sum() > 100


def test_b2_owners_at_the_step_shapes():
    """At the training step's widths (bs 1 of the fast config: 6 rows of
    2048 kept slots, 1220 anchors, the 4 levels and their tiles), every
    live corner of nonzero weight has exactly one owner tile."""
    bs, cams, anchors, npts, groups, c, cap, shapes = _train_shapes(FAST, 1)
    rng = np.random.default_rng(12)
    pts = torch.from_numpy(rng.uniform(-0.2, 1.2, (
        bs, anchors, npts, cams, 2)).astype(np.float32)).to(torch.bfloat16)
    w = torch.ones(bs, anchors, npts, cams, len(shapes), 1,
                   dtype=torch.bfloat16)
    col = torch.zeros(1, dtype=torch.bfloat16)
    recs = _records(col, pts, w, shapes, cap)
    assert all(per_level[0][0].numel() == cap for per_level in recs)
    for per_level in recs:
        for lvl, (x0, y0, wk, _, _) in enumerate(per_level):
            h, w_ = shapes[lvl]
            # each corner's owner tile, whose hit test must see the entry
            px = x0[:, None] + torch.tensor([0, 1, 0, 1])
            py = y0[:, None] + torch.tensor([0, 0, 1, 1])
            live = wk != 0
            assert ((px[live] >= 0) & (px[live] < w_) & (py[live] >= 0)
                    & (py[live] < h)).all()
            ty0, tx0 = py // TS * TS, px // TS * TS
            seen = ((x0[:, None] - tx0 >= -1) & (x0[:, None] - tx0 < TS)
                    & (y0[:, None] - ty0 >= -1) & (y0[:, None] - ty0 < TS))
            assert seen[live].all()
