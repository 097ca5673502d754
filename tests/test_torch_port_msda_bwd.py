"""Kernel D, the exact MSDA backward, on the CPU: the gradients of `msda`
against JAX's, the exact 2D cross-attention layer in training order
against JAX's, kernel D's planner, and a plain mirror of its
deterministic design.

Kernel D runs on the card only (`csrc/sampling.cu`): D1 (a half-warp
per camera row, query and head) writes the location and weight
gradients and each sample's record at its natural index (q * heads + h)
* P + p of its (camera row, level) list; the bin pass lists each
record under the 8x8 pixel tiles that own its weighing corners, each
list in record order (counts by tile and segment, their scan, a fill);
D2 (a block per tile, or a cluster of D2_CLUSTER blocks for a tile whose
list passes D_CHUNK records) owns those value-gradient rows and sums
its list in order, the chunks added in chunk order. The mirror here
repeats that bookkeeping in PyTorch and numpy: every weighing corner's
record must sit once in its owner tile's list, the lists in record
order, and the tiles' sums (fp32, in the kernel's order) must give the
plain backward's value gradient. The kernel against its plain version
is chip_smoke's `train_grad` phase.

Inputs come from numpy seeds; the JAX side is jitted, one trace per
(dtype, width). Tolerances: the gradients in fp32 within 1e-5 of each
gradient's range (the fp32 sums run in another order), a bf16 value
within 1e-2 of it, against JAX's `msda` evaluated in fp32 on the same
bf16 values: JAX's bf16 autodiff rounds its partial gradients to bf16
(ROADMAP C.3), and at C 256 its location gradient lies up to 1.2 % of
the range from its own fp32 evaluation, the port's (fp32 sums, the
value gradient rounded once) up to 0.14 %; the layer within 1e-4 of each output's
or gradient's largest value, as tests/test_torch_port_blocks.py holds
layers where matmuls chain.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs import base as jax_base
from simpb_tpu.models.group_attn import QueryGroupMSDA as JMSDA
from simpb_tpu.ops import sampling as jsmp
from simpb_tpu.ops.format import SpatialShapes as JSS
from simpb_tpu_torch.configs.base import simpb_r50_704x256, simpb_tiny
from simpb_tpu_torch.models.detector import SimPB
from simpb_tpu_torch.models.group_attn import QueryGroupMSDA
from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.ops.format import SpatialShapes
from simpb_tpu_torch.tools import train as train_cli
from simpb_tpu_torch.utils.convert import state_from_jax
from test_torch_port_blocks import _rand, _t, pair

torch.set_num_threads(1)
TINY_SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))  # simpb_tiny's pyramid
# odd widths, and the training pyramid's smallest level, 8x22
WIDE_SHAPES = ((8, 22), (4, 11), (2, 6), (1, 3))
# (heads, C, levels) of the tiny config and of the released one
WIDTHS = {"c64_h4": (4, 64, TINY_SHAPES), "c256_h8": (8, 256, WIDE_SHAPES)}
TS = tsmp.B2_TILE


def _inputs(rng, heads, c, shapes, b=2, q=6, points=4):
    """Values, locations [b, q, heads, L, P, 2] and softmax weights:
    query 0 on pixel centres (x = 0 and x = w - 1 among them, where floor
    sends the whole corner to one side), query 1 at 0 and 1 exactly and
    one ulp inside, query 2 past every border, query 3 a padded slot
    (location 0), the rest spread over and beyond the image."""
    levels = len(shapes)
    total = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, total, c))
    loc = rng.uniform(-0.3, 1.3, (b, q, heads, levels, points, 2))
    for lvl, (h, w) in enumerate(shapes):
        for axis, n in ((0, w), (1, h)):
            px = rng.integers(0, n, (b, heads, points))
            px[:, 0, 0], px[:, 0, 1] = 0, n - 1
            loc[:, 0, :, lvl, :, axis] = (px + 0.5) / n
    edges = np.array([0.0, 1.0, 2.0 ** -10, 1 - 2.0 ** -10])
    loc[:, 1] = rng.choice(edges, loc[:, 1].shape)
    loc[:, 2] = rng.choice(np.array([-2.0, -0.6, 1.6, 3.0]), loc[:, 2].shape)
    loc[:, 3] = 0.0
    logits = rng.normal(size=(b, q, heads, levels * points))
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (value.astype(np.float32), loc.astype(np.float32),
            attw.reshape(b, q, heads, levels, points).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _case(dtype, width):
    """Inputs, cotangents and JAX's gradients (value, loc, attw) of `msda`
    with raw_heads on and off, from one jitted trace."""
    heads, c, shapes = WIDTHS[width]
    rng = np.random.default_rng(20 + len(width) + c)
    value, loc, attw = _inputs(rng, heads, c, shapes)
    b, q = loc.shape[:2]
    cot = dict(raw=(rng.normal(size=(b, q, heads, c)).astype(np.float32),
                    rng.normal(size=(b, q, heads)).astype(np.float32)),
               heads=(rng.normal(size=(b, q, c)).astype(np.float32),))
    jss = JSS(shapes)

    def vjps(v, l, a, gs, gw, go):
        raw = jax.vjp(lambda *x: jsmp.msda(x[0], jss, x[1], x[2],
                                           raw_heads=True), v, l, a)[1]
        out = jax.vjp(lambda *x: jsmp.msda(x[0], jss, x[1], x[2]),
                      v, l, a)[1]
        return raw((gs, gw)), out(go)

    # a bf16 value as JAX's fp32 sees it (see the module docstring)
    jvalue = jnp.asarray(value, getattr(jnp, dtype)).astype(jnp.float32)
    raw, heads_ = jax.jit(vjps)(jvalue, loc, attw, *cot["raw"],
                                *cot["heads"])
    want = dict(raw=[np.asarray(g, np.float32) for g in raw],
                heads=[np.asarray(g, np.float32) for g in heads_])
    return (value, loc, attw), cot, want, shapes


def _close_to(got, want, frac, what):
    """|got - want| <= frac * (max want - min want), each gradient."""
    for name, g, w in zip(("value", "loc", "attw"), got, want):
        g = g.detach().float().numpy()
        bound = frac * max(float(w.max() - w.min()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{what} {name}: max err {err} > {bound}"


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("mode", ["raw", "heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_gradients_match_jax(dtype, mode, width):
    """Autograd through `msda` on the CPU (the plain version), and
    `msda_backward_plain` (kernel D's plain version) at the same
    cotangent, against `jax.vjp` of JAX's `msda`, raw_heads on and off:
    the gradients of the value (in its dtype), the locations and the
    weights, with pixel centres, borders, samples past them and padded
    slots among the samples. With raw_heads off the output gradient
    reaches kernel D as g_sampled masked to each head's channels and a
    zero g_wsum."""
    (value, loc, attw), cot, want, shapes = _case(dtype, width)
    tdt = getattr(torch, dtype)
    ss = SpatialShapes(shapes)
    args = [_t(value).to(tdt).requires_grad_(True),
            _t(loc).requires_grad_(True), _t(attw).requires_grad_(True)]
    frac = 1e-5 if dtype == "float32" else 1e-2
    tsmp.reset_launch_counts()
    out = tsmp.msda(*args[:1], ss, *args[1:], raw_heads=mode == "raw")
    outs = out if mode == "raw" else (out,)
    got = torch.autograd.grad(outs, args, [_t(c) for c in cot[mode]])
    assert got[0].dtype == tdt
    _close_to(got, want[mode], frac, "autograd")
    if mode == "raw":
        gs, gw = map(_t, cot["raw"])
    else:
        heads, c = loc.shape[2], value.shape[-1]
        mask = torch.repeat_interleave(torch.eye(heads), c // heads, dim=1)
        gs = _t(cot["heads"][0])[:, :, None, :] * mask
        gw = torch.zeros(loc.shape[:3])
    plain = tsmp.msda_backward_plain(*args[:1], ss, *args[1:], gs, gw)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype
        torch.testing.assert_close(g, p, rtol=0, atol=1e-6 * float(
            p.float().abs().max()))
    _close_to(plain, want[mode], frac, "plain")
    assert set(tsmp.launch_counts().values()) == {0}
    # the borders' one-sided location gradients are there
    assert (got[1] == 0).any() and (got[1] != 0).any()


def test_qg_msda_exact_training_order_matches_jax():
    """`QueryGroupMSDA(patch_mode=False)` in training order
    (`project_first`: the value projection before sampling, no pair
    table) against JAX's layer with `pair_table=None`, without and with
    the valid-slot compaction: the output, and the gradients of the
    parameters, the queries, their positions, the reference points and
    the feature column."""
    rng = np.random.default_rng(21)
    k = 5
    ss_j, ss_t = JSS(TINY_SHAPES), SpatialShapes(TINY_SHAPES)
    q, qpos = _rand(rng, 1, 6 * k, 16), _rand(rng, 1, 6 * k, 16)
    ref_pts = rng.uniform(0.05, 0.95, (1, 6 * k, 2)).astype(np.float32)
    depth = (rng.uniform(size=(1, 6 * k, 1)) < 0.7) * rng.uniform(
        1, 30, (1, 6 * k, 1))
    depth[0, :k] = 5.0  # camera 0: all five slots valid
    depth = depth.astype(np.float32)
    col = _rand(rng, 1, 6, ss_j.total, 16)
    cot = _rand(rng, 1, 6 * k, 32)
    inputs = (q, qpos, ref_pts, col)
    for cap in (None, 3):
        msda = QueryGroupMSDA(16, 4, 4, 4, 6, gather_capacity=cap,
                              patch_mode=False)
        jmsda = JMSDA(embed_dims=16, num_heads=4, num_levels=4, num_cams=6,
                      patch_mode=False, gather_capacity=cap)
        v = pair(jmsda, msda, *map(jnp.asarray, (q, qpos, ref_pts, depth,
                                                 col)), ss_j)

        def loss(v_, q_, qpos_, ref_, col_):
            out = jmsda.apply(v_, q_, qpos_, ref_, depth, col_, ss_j,
                              deterministic=True)
            return jnp.sum(out * cot), out

        (_, ref), jgrads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(v, *inputs)
        targs = [_t(a).requires_grad_(True) for a in inputs]
        out = msda(targs[0], targs[1], targs[2], _t(depth), targs[3], ss_t,
                   project_first=True)
        (out * _t(cot)).sum().backward()
        close = lambda g, w, what: np.testing.assert_allclose(
            g.detach().numpy(), np.asarray(w), rtol=0,
            atol=1e-4 * max(float(np.abs(np.asarray(w)).max()), 1e-30),
            err_msg=f"cap {cap}: {what}")
        close(out, ref, "output")
        for name, t, w in zip(("query", "query_pos", "reference_points",
                               "value"), targs, jgrads[1:]):
            close(t.grad, w, name)
        want = state_from_jax(msda, jgrads[0], unused_ok=None)
        for name, p in msda.named_parameters():
            close(p.grad, want[name], name)
        assert float(targs[3].grad.abs().max()) > 0


R50 = simpb_r50_704x256()


def _train_call(cfg, bs):
    """`msda`'s call in a training step: (camera rows, queries with the DN
    slots, heads, points, C, levels)."""
    h = cfg.head
    return (bs * h.num_cams, h.allocation_capacity + h.dn_allocation_capacity,
            h.num_groups, 4, h.embed_dims, cfg.feature_shapes)


def _tile_index(plan, shapes):
    """D2's tile numbering from the plan: [(level, ty0, tx0)] in tile
    order."""
    out = {}
    for lvl, (h, w) in enumerate(shapes):
        ntx = -(-w // TS)
        for t in range(-(-h // TS) * ntx):
            out[plan.first[lvl] + t] = (lvl, t // ntx * TS, t % ntx * TS)
    return [out[i] for i in range(len(out))]


@pytest.mark.parametrize("cfg,bs", [(R50, 4), (simpb_tiny(), 1)],
                         ids=["r50_bs4", "tiny_bs1"])
def test_plan_msda_backward_at_training_shapes(cfg, bs):
    """D1 the forward's items (a half-warp per camera row, query and
    head, 16 a block); the bin pass a warp per segment of D_SEGMENT
    records of a level; D2 one block per (tile, camera row, 256
    channels) with every pixel of every level in one tile, the smallest
    level's tiles first, and D2_CLUSTERS clusters of D2_CLUSTER blocks a
    camera row for the crowded tiles; the scratch and the dims the C
    entry reads."""
    rows, q, heads, points, c, shapes = _train_call(cfg, bs)
    plan = tsmp.plan_msda_backward(rows, q, heads, points, c, shapes)
    assert plan.threads == 256 and plan.grid == -(-rows * q * heads // 16)
    n = q * heads * points  # records a (camera row, level)
    nseg = -(-n // tsmp.D_SEGMENT)
    assert plan.bin_grid == (-(-nseg // tsmp.D_BIN_WARPS), len(shapes), rows)
    tiles = _tile_index(plan, shapes)
    slices = -(-c // 256)
    assert plan.gvalue_grid == (len(tiles), rows, slices)
    assert plan.cluster_grid == (tsmp.D2_CLUSTER * tsmp.D2_CLUSTERS, rows,
                                 slices)
    cover = [np.zeros(s, int) for s in shapes]
    for lvl, ty0, tx0 in tiles:
        cover[lvl][ty0:ty0 + TS, tx0:tx0 + TS] += 1
    assert all((m == 1).all() for m in cover)
    sizes = [shapes[lvl][0] * shapes[lvl][1] for lvl, _, _ in tiles]
    assert sizes == sorted(sizes)  # crowded (small) levels first
    # every level's tiles fit a bin warp's counters in shared memory
    level_tiles = max(-(-h // TS) * -(-w // TS) for h, w in shapes)
    assert plan.bin_smem_tiles == level_tiles
    records = rows * len(shapes) * n
    assert plan.chunk == tsmp.D_CHUNK
    assert plan.scratch == 9 * records + rows * len(tiles) * (nseg + 2)
    dims = list(plan.dims)
    assert dims[:15] == [rows, q, heads, len(shapes), points, c,
                         sum(h * w for h, w in shapes), 256, len(tiles),
                         slices, nseg, tsmp.D_SEGMENT, tsmp.D_CHUNK,
                         level_tiles, tsmp.D2_CLUSTERS]
    assert dims[15 + 3 * len(shapes):] == list(plan.first)
    if cfg is R50:  # 24 camera rows of 384 queries (256 + 128 DN slots)
        assert (rows, q) == (24, 384)
        assert len(tiles) == 176 + 44 + 12 + 3 and nseg == 48
        assert plan.scratch * 4 < 48e6  # 43.6 MB


def test_plan_msda_backward_refuses_what_the_kernels_do_not_take():
    shapes = R50.feature_shapes
    for args in ((24, 384, 9, 4, 288, shapes), (24, 384, 8, 4, 260, shapes),
                 (24, 384, 8, 4, 256, shapes * 3), (0, 384, 8, 4, 256,
                                                    shapes)):
        with pytest.raises(ValueError, match="the kernels take"):
            tsmp.plan_msda_backward(*args)
    with pytest.raises(ValueError, match="pixels a side"):
        tsmp.plan_msda_backward(24, 384, 8, 4, 256, ((8, 1 << 15),))


def test_msda_backward_takes_cuda_tensors_only():
    value, loc, attw = map(_t, _inputs(np.random.default_rng(22), 4, 64,
                                       TINY_SHAPES))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsmp.msda_backward(value, SpatialShapes(TINY_SHAPES), loc, attw,
                           torch.zeros(2, 6, 4, 64), torch.zeros(2, 6, 4))


def _d_records(value, loc, attw, shapes):
    """D1's records of each level, by camera row and natural index (q *
    heads + h) * P + p: the corner base (x0, y0), the four corner weights
    times the attention weight (fp32, from the forward's rounded weights)
    and the (query, head) row of g_sampled each reads."""
    b, q, heads, _, points = attw.shape
    recs = []
    for lvl, (h, w) in enumerate(shapes):
        wx0, wx1, wy0, wy1, x0, y0, _ = tsmp._corner_weights(
            loc[:, :, :, lvl].reshape(b, -1, 2), h, w, value.dtype, False)
        a = attw[:, :, :, lvl].reshape(b, -1)
        f = lambda t: t.float()
        wk = torch.stack([a * f(wy0) * f(wx0), a * f(wy0) * f(wx1),
                          a * f(wy1) * f(wx0), a * f(wy1) * f(wx1)], -1)
        recs.append((x0, y0, wk,
                     torch.arange(q * heads * points) // points))
    return recs


CORNER_DX, CORNER_DY = torch.tensor([0, 1, 0, 1]), torch.tensor([0, 0, 1, 1])


def _bin(x0, y0, wk, shape):
    """The bin pass over one level's records of one camera row, as the
    kernels run it: each record's weighing corners' tiles, a tile once a
    record (a later corner in a tile an earlier one holds is dropped);
    counts by (tile, segment of D_SEGMENT records); their exclusive scan
    in (tile, segment) order; each entry written at its (tile,
    segment)'s offset plus its rank there in (record, corner) order.
    Returns (list of record indices, each tile's start, each tile's
    length, the (record, tile) entries)."""
    h, w = shape
    ntx, nt = -(-w // TS), -(-h // TS) * -(-w // TS)
    n = wk.shape[0]
    px, py = x0[:, None] + CORNER_DX, y0[:, None] + CORNER_DY
    key0 = torch.where(wk != 0, py.div(TS, rounding_mode="floor") * ntx
                       + px.div(TS, rounding_mode="floor"), -1)
    key = key0.clone()
    for k in range(1, 4):
        for d in range(k):
            key[:, k] = torch.where(key0[:, d] == key0[:, k], -1, key[:, k])
    rec = torch.arange(n)[:, None].expand(n, 4)
    live = key >= 0
    e_key, e_rec = key[live], rec[live]  # (record, corner) order
    nseg = -(-n // tsmp.D_SEGMENT)
    group = e_key * nseg + e_rec // tsmp.D_SEGMENT
    counts = torch.bincount(group, minlength=nt * nseg)
    offsets = torch.cumsum(counts, 0) - counts
    order = torch.sort(group, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order)) - offsets[group[order]]
    lst = torch.empty(len(e_rec), dtype=torch.int64)
    lst[offsets[group] + rank] = e_rec
    start = offsets.reshape(nt, nseg)[:, 0]
    length = counts.reshape(nt, nseg).sum(1)
    return lst, start, length, (e_rec, e_key)


def _chunks(start, length):
    """D2's work on a tile: one block over its whole list, or, above
    D_CHUNK records, D2_CLUSTER chunks of ceil(n / D2_CLUSTER), in list
    order."""
    n, k = int(length), tsmp.D2_CLUSTER
    if n <= tsmp.D_CHUNK:
        return [(int(start), int(start) + n)]
    size = -(-n // k)
    return [(int(start) + min(n, i * size), int(start) + min(n, (i + 1) * size))
            for i in range(k)]


def _d2_mirror(recs, shapes, gs, dtype):
    """D2 over the bin pass's lists: each chunk sums its records in list
    order into fp32 (a fused multiply-add for each weighing corner in the
    tile), the chunks add in chunk order, and each row rounds once to
    `dtype`. Returns (the value gradient [rows, ΣHW, C], the number of
    chunks of each (camera row, level)'s tile (0, 0))."""
    starts = [0]
    for h, w in shapes:
        starts.append(starts[-1] + h * w)
    rows, c = gs.shape[0], gs.shape[-1]
    g = gs.reshape(rows, -1, c).numpy()
    gvalue = np.zeros((rows, starts[-1], c), np.float32)
    tile00 = []
    for lvl, (x0, y0, wk, g_row) in enumerate(recs):
        h, w = shapes[lvl]
        ntx = -(-w // TS)
        for row in range(rows):
            lst, start, length, _ = _bin(x0[row], y0[row], wk[row], (h, w))
            tile00.append(len(_chunks(start[0], length[0])))
            for t in range(len(start)):
                ty0, tx0 = t // ntx * TS, t % ntx * TS
                parts = []
                for e0, e1 in _chunks(start[t], length[t]):
                    acc = np.zeros((TS, TS, c), np.float32)
                    for r in lst[e0:e1].tolist():
                        gv = g[row, g_row[r]]
                        for k in range(4):
                            wt = np.float32(wk[row, r, k])
                            yy = int(y0[row, r]) + k // 2 - ty0
                            xx = int(x0[row, r]) + k % 2 - tx0
                            if wt != 0 and 0 <= yy < TS and 0 <= xx < TS:
                                # a fused multiply-add: exact product,
                                # one rounding to fp32
                                acc[yy, xx] = (acc[yy, xx].astype(np.float64)
                                               + gv.astype(np.float64)
                                               * np.float64(wt))
                    parts.append(acc)
                tot = parts[0]
                for part in parts[1:]:
                    tot = tot + part
                for yy in range(min(TS, h - ty0)):
                    at = starts[lvl] + (ty0 + yy) * w + tx0
                    gvalue[row, at:at + min(TS, w - tx0)] = \
                        tot[yy, :min(TS, w - tx0)]
    return torch.from_numpy(gvalue).to(dtype), tile00


def _hold_to_plain(got, ref, dtype):
    """fp32 within 1e-6 of the plain gradient's largest value (fp32 sums
    in another order); bf16 rounds each sum once, so the two may also
    land one bf16 step apart (2^-7 of the value, as chip_smoke's
    GRAD_TOL)."""
    got, ref = got.double(), ref.double()
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert ((got - ref).abs() <= rel * ref.abs()
            + 1e-6 * ref.abs().max()).all()
    assert (ref != 0).sum() > 100


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d2_owners_sum_the_plain_value_gradient(dtype):
    """The bin pass lists every weighing corner's record under its owner
    tile exactly once, each list in record order; D2's chunks summed in
    list order and added in chunk order are the plain backward's value
    gradient."""
    rng = np.random.default_rng(23)
    value, loc, attw = (_t(a) for a in _inputs(rng, 4, 16, WIDE_SHAPES))
    value = value.to(dtype)
    gs = _t(rng.normal(size=loc.shape[:3] + (16,)).astype(np.float32))
    gw = _t(rng.normal(size=loc.shape[:3]).astype(np.float32))
    recs = _d_records(value, loc, attw, WIDE_SHAPES)
    for (x0, y0, wk, _), shape in zip(recs, WIDE_SHAPES):
        ntx = -(-shape[1] // TS)
        for row in range(wk.shape[0]):
            lst, start, length, (e_rec, e_key) = _bin(x0[row], y0[row],
                                                      wk[row], shape)
            for t in range(len(start)):
                mine = lst[start[t]:start[t] + length[t]]
                assert (mine[1:] > mine[:-1]).all()  # record order
                assert torch.equal(mine, e_rec[e_key == t])
            # each weighing corner's owner lists its record
            live = wk[row] != 0
            px = (x0[row][:, None] + CORNER_DX)[live]
            py = (y0[row][:, None] + CORNER_DY)[live]
            owner = py // TS * ntx + px // TS
            r = torch.arange(len(wk[row]))[:, None].expand(-1, 4)[live]
            listed = set(zip(e_rec.tolist(), e_key.tolist()))
            assert all((a, b) in listed for a, b in zip(r.tolist(),
                                                        owner.tolist()))
            assert len(listed) == len(e_rec) > 0
    gvalue, _ = _d2_mirror(recs, WIDE_SHAPES, gs, dtype)
    ref = tsmp.msda_backward_plain(value, SpatialShapes(WIDE_SHAPES), loc,
                                   attw, gs, gw)[0]
    assert ref.dtype == dtype
    _hold_to_plain(gvalue, ref, dtype)


def test_d2_splits_the_padded_slots_tile():
    """Padded slots (every location 0) put all their samples on pixel
    (0, 0) of every level: tile (0, 0)'s list passes a chunk, so a
    cluster of D2_CLUSTER blocks splits it, and the chunks' sums, added in
    chunk order, are the plain backward's value gradient."""
    rng = np.random.default_rng(25)
    value, loc, attw = (_t(a) for a in _inputs(rng, 4, 8, WIDE_SHAPES, b=1,
                                               q=70))
    loc[:, 4:] = 0.0  # 66 padded slots: 1056 records a level at (0, 0)
    gs = _t(rng.normal(size=loc.shape[:3] + (8,)).astype(np.float32))
    gw = _t(rng.normal(size=loc.shape[:3]).astype(np.float32))
    recs = _d_records(value, loc, attw, WIDE_SHAPES)
    gvalue, tile00 = _d2_mirror(recs, WIDE_SHAPES, gs, torch.float32)
    assert all(n >= 2 for n in tile00)
    ref = tsmp.msda_backward_plain(value, SpatialShapes(WIDE_SHAPES), loc,
                                   attw, gs, gw)[0]
    _hold_to_plain(gvalue, ref, torch.float32)


def test_d2_owners_at_the_step_shapes():
    """At the training step's widths (one batch row of `simpb_r50_704x256`:
    6 camera rows of 384 queries x 8 heads x 4 points, the 4 levels and
    their tiles, the 128 DN slots padded), the bin pass lists every
    weighing corner's record under its owner tile once and in record
    order, and each level's tile (0, 0) holds the padded slots and splits
    into D2_CLUSTER chunks."""
    rows, q, heads, points, _, shapes = _train_call(R50, 1)
    rng = np.random.default_rng(24)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (
        rows, q, heads, len(shapes), points, 2)).astype(np.float32))
    loc[:, 256:] = 0.0
    attw = torch.ones(loc.shape[:-1])
    for (x0, y0, wk, _), shape in zip(
            _d_records(torch.zeros(1, dtype=torch.bfloat16), loc, attw,
                       shapes), shapes):
        ntx = -(-shape[1] // TS)
        for row in range(rows):
            lst, start, length, (e_rec, e_key) = _bin(x0[row], y0[row],
                                                      wk[row], shape)
            live = wk[row] != 0
            assert live.sum() > 1000
            px = (x0[row][:, None] + CORNER_DX)[live]
            py = (y0[row][:, None] + CORNER_DY)[live]
            r = torch.arange(len(wk[row]))[:, None].expand(-1, 4)[live]
            owner = py // TS * ntx + px // TS
            # the (record, owner) pairs are the listed entries, once each
            pairs = torch.unique(r * 1000003 + owner)
            assert torch.equal(pairs, torch.sort(e_rec * 1000003 + e_key)[0])
            assert torch.equal(lst, e_rec[torch.sort(e_key, stable=True)[1]])
            assert len(_chunks(start[0], length[0])) == tsmp.D2_CLUSTER
            assert int(length[0]) >= 128 * heads * points


def test_the_trainer_trains_the_exact_configs():
    """The trainer's `--config r50` (its default) and `--config tiny` are
    JAX's CLI's, field by field (trunk bf16), exact MSDA, and no flag of
    theirs is refused; the training model of each builds (the exact
    tiny's on the CPU)."""
    for config, name in (("r50", "simpb_r50_704x256"),
                         ("tiny", "simpb_tiny")):
        argv = ["--ann-file", "x"] + (["--config", config]
                                      if config != "r50" else [])
        args = train_cli.parse_args(argv)
        assert args.config == config and not train_cli.refused_flags(args)
        cfg = train_cli.build_config(args)
        want = dataclasses.replace(getattr(jax_base, name)(),
                                   compute_dtype="bfloat16")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert not cfg.head.msda_patch_mode
    model = SimPB(cfg, train=True)
    layers = [m for m in model.modules() if isinstance(m, QueryGroupMSDA)]
    assert len(layers) == 3 and not any(m.patch_mode for m in layers)
