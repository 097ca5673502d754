"""The hybrid serving path of the port (`simpb_r50_704x256_hybrid`) against
the JAX package, on the CPU: the clamp priority and `msda_clamp_demand`
(kernel H3's plain versions) against JAX's `_lost_weights` and
`msda_clamp_demand`; H3's two instances' plain versions against the
eager chains they replace, and a plain mirror of the op instance's
selection by sort keys; `msda_hybrid_plain` against JAX's `msda_hybrid`
(fp32 and bf16, raw heads on and off, demand under the capacity, where
the top-k's padding is gated out, and over it, with a tie at the
capacity's boundary); the windowed lane over every level (H1's plain
version) against JAX's `msda_patch(sel_levels=None)`; the exact lane's
wrapper (H2) in place, and a plain mirror of its kernel's walk (the
items each block walks, and the sums in that order); the hybrid
`QueryGroupMSDA` against JAX's layer, outputs and its three counters;
the planners' limits and refusals; the bench's hybrid switches; the
day-0 tool's decision against JAX's and its command line on the tiny
config.

Inputs come from numpy seeds; the JAX side is jitted. Tolerances: the
corrected entries and the clamp flags equal; the priorities within two
ulps of JAX's (JAX reduces its 32 samples in XLA's order, the port in
H3's fixed tree); outputs in fp32 within 1e-5 of the output's largest
value, in bf16 within 1e-2 (XLA's bf16 fusions may keep excess precision
where the port rounds); the layer as tests/test_torch_port_exact.py
holds it (1e-4 where matmuls chain); the counters equal.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs import base as jax_base
from simpb_tpu.models.group_attn import QueryGroupMSDA as JMSDA
from simpb_tpu.ops import sampling as jsmp
from simpb_tpu.ops.format import SpatialShapes as JSS
from simpb_tpu.ops.sampling import make_pair_table
from simpb_tpu_torch.configs import base as tbase
from simpb_tpu_torch.models.group_attn import QueryGroupMSDA
from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.ops.format import SpatialShapes
from test_torch_port_blocks import _rand, _t, pair

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((16, 24), (8, 12), (8, 8), (8, 10))  # the window fits each level
TINY_SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))  # simpb_tiny's pyramid
R50_SHAPES = ((64, 176), (32, 88), (16, 44), (8, 22))
R101_SHAPES = ((128, 352), (64, 176), (32, 88), (16, 44))


def _inputs(rng, b=2, q=10, heads=8, points=4, c=32, shapes=SHAPES,
            spread=0.12):
    """Values, locations [b, q, heads, L, P, 2] and softmax weights: the
    samples spread around a query's point, so that some (query, level)
    entries clamp; query 1 of row 0 a copy of query 0 (its entries tie
    with query 0's), query 2 a padded slot (location 0), query 3 past
    the borders."""
    levels = len(shapes)
    total = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, total, c)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (b, q, 1, 1, 1, 2))
    loc = ref + spread * rng.normal(size=(b, q, heads, levels, points, 2))
    loc[:, 3] = rng.choice(np.array([-0.2, 0.0, 1.0, 1.3]), loc[:, 3].shape)
    loc[:, 2] = 0.0
    logits = rng.normal(size=(b, q, heads, levels * points))
    attw = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(
        b, q, heads, levels, points)
    loc[0, 1], attw[0, 1] = loc[0, 0], attw[0, 0]
    return (value, loc.astype(np.float32), attw.astype(np.float32))


def _jax_selection(shapes, loc, attw, cap):
    """JAX's priorities [B, Q * L] and corrected entries, as msda_hybrid
    computes them (simpb_tpu/ops/sampling.py:1097-1120)."""
    b, q, heads, levels, points = loc.shape[:5]
    n = heads * points

    def sel(loc, attw):
        l_ = loc.transpose(0, 1, 3, 2, 4, 5).reshape(b, q, levels, n, 2)
        a_ = attw.transpose(0, 1, 3, 2, 4).reshape(b, q, levels, n)
        lost, _ = jsmp._lost_weights(JSS(shapes), l_, 8, 8)
        flag = (lost > 0).astype(jnp.float32)
        prio = (flag * a_).sum(-1).reshape(b, q * levels)
        prio = jnp.where(flag.any(-1).reshape(b, q * levels), prio + 1e-6,
                         0.0)
        _, idx = jax.lax.top_k(prio, min(cap, q * levels))
        gate = jnp.take_along_axis(prio, idx, axis=1) > 0.0
        mask = (jax.nn.one_hot(idx, q * levels) * gate[..., None]).sum(1)
        return prio, mask > 0

    prio, mask = jax.jit(sel)(loc, attw)
    return np.asarray(prio), np.asarray(mask)


@pytest.mark.parametrize("shapes", [SHAPES, TINY_SHAPES],
                         ids=["fits", "tiny_pyramid"])
def test_clamp_priority_and_demand_match_jax(shapes):
    """H3's plain version: the clamped entries exactly JAX's, the
    priorities within two ulps (the tree order against XLA's), 0 where
    nothing clamps; `msda_clamp_demand` equal to JAX's with and without a
    valid mask; without weights a lost sample weighs 1."""
    rng = np.random.default_rng(0)
    _, loc, attw = _inputs(rng, shapes=shapes)
    ss = SpatialShapes(shapes)
    jprio, _ = _jax_selection(shapes, loc, attw, 1)
    got = tsmp.clamp_priority_plain(ss, _t(loc), _t(attw), 8, 8).numpy()
    assert got.dtype == np.float32 and got.shape == jprio.shape
    np.testing.assert_array_equal(got > 0, jprio > 0)
    assert 0 < (got > 0).sum() < got.size
    np.testing.assert_allclose(got, jprio, rtol=2.5e-7, atol=0)
    assert (got[got <= 0] == 0).all()
    counts = tsmp.clamp_priority_plain(ss, _t(loc), None, 8, 8).numpy()
    np.testing.assert_array_equal(counts > 0, jprio > 0)
    valid = rng.uniform(size=loc.shape[:2]) < 0.7
    wants = jax.jit(lambda l_, v_: [jsmp.msda_clamp_demand(
        JSS(shapes), l_, 8, 8, valid=v) for v in (None, v_)])(loc, valid)
    for v, want in zip((None, valid), wants):
        tv = None if v is None else _t(v)
        dem = tsmp.msda_clamp_demand(ss, _t(loc), 8, 8, valid=tv)
        np.testing.assert_array_equal(dem.numpy(), np.asarray(want))
        # the guards' plain version: the eager count it replaces
        eager = torch.from_numpy(counts > 0).reshape(loc.shape[:2] + (-1,))
        if tv is not None:
            eager = eager & tv[:, :, None]
        plain = tsmp.msda_clamp_demand_plain(ss, _t(loc), 8, 8, valid=tv)
        assert plain.dtype == torch.float32
        assert torch.equal(plain, eager.sum((1, 2)).float())
        assert torch.equal(plain, dem)
    # the fixed tree: lane l + 16 onto lane l, then + 8, + 4, + 2, + 1
    x = torch.from_numpy(rng.normal(size=(3, 20)).astype(np.float32))
    pad = np.zeros((3, 32), np.float32)
    pad[:, :20] = x.numpy()
    for half in (16, 8, 4, 2, 1):
        pad = (pad[:, :half] + pad[:, half:2 * half]).astype(np.float32)
    np.testing.assert_array_equal(tsmp._tree_sum32(x).numpy(), pad[:, 0])


def _boundary_tie_capacity(prio):
    """The capacity that splits the first tie of row 0's priorities (the
    copied query's entries): the lower index must be the one taken."""
    vals = -np.sort(-prio[0], kind="stable")
    i = next(i for i in range(len(vals) - 1)
             if vals[i] == vals[i + 1] > 0)
    return i + 1


@pytest.mark.parametrize("dtype,regime,raw", [
    ("float32", "under", True), ("float32", "over_tie", False),
    ("bfloat16", "under", False), ("bfloat16", "over_tie", True)])
def test_msda_hybrid_matches_jax(dtype, regime, raw):
    """`msda_hybrid` on the CPU (`msda_hybrid_plain`) against JAX's, raw
    heads on and off: under the capacity (JAX's top-k then returns entries
    that do not clamp, gated out) and over it, the capacity splitting a
    tie (the lower index taken); the corrected entries equal JAX's."""
    rng = np.random.default_rng(1)
    value, loc, attw = _inputs(rng)
    b, q, _, levels = loc.shape[:4]
    ss = SpatialShapes(SHAPES)
    prio = tsmp.clamp_priority_plain(ss, _t(loc), _t(attw), 8, 8)
    demand = int((prio > 0).sum(-1).max())
    cap = (q * levels if regime == "under"
           else _boundary_tie_capacity(prio.numpy()))
    assert (cap > demand) == (regime == "under")
    _, jmask = _jax_selection(SHAPES, loc, attw, cap)
    np.testing.assert_array_equal(
        tsmp._hybrid_selection(prio, min(cap, q * levels)).numpy(), jmask)
    jv = jnp.asarray(value).astype(dtype)
    want = jax.jit(lambda v, l_, a: jsmp.msda_hybrid(
        v, JSS(SHAPES), l_, a, clamp_capacity=cap, raw_heads=raw))(
        jv, loc, attw)
    tv = _t(np.asarray(jv.astype(jnp.float32))).to(getattr(torch, dtype))
    args = (tv, ss, _t(loc), _t(attw))
    got = tsmp.msda_hybrid(*args, clamp_capacity=cap, raw_heads=raw)
    got, want = (got, want) if raw else ((got,), (want,))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for g, j in zip(got, want):
        j = np.asarray(j)
        assert g.dtype == torch.float32 and g.shape == j.shape
        assert np.abs(g.numpy() - j).max() <= tol * np.abs(j).max()


def _select_by_keys(prio, k_cap):
    """A plain mirror of H3's op instance's selection: each entry's sort
    key (its priority's bits made monotonic, NaN canonical and -0 as +0,
    inverted, then its index; no two equal), its rank the number of keys
    below it (its place in the ascending order); rank r corrected iff
    r < k_cap and its priority > 0."""
    p = np.where(prio == 0, np.float32(0), prio).astype(np.float32)
    u = p.view(np.uint32).astype(np.uint64)
    u = np.where(np.isnan(p), np.uint64(0x7FC00000), u)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    idx = np.arange(p.shape[-1], dtype=np.uint64)
    keys = ((~u & 0xFFFFFFFF) << np.uint64(32)) | idx
    order = np.argsort(keys, axis=-1)
    taken = np.zeros(p.shape, bool)
    for r in range(p.shape[0]):
        top = order[r, :k_cap]
        taken[r, top] = p[r, top] > 0
    return taken


@pytest.mark.parametrize("regime", ["tie", "none_clamp", "cap_covers",
                                    "padded"])
def test_hybrid_selection_plain_is_the_old_chain(regime):
    """H3's op instance, plain version (`hybrid_selection_plain`, which
    the CPU wrapper runs) against the chain it replaces, bit for bit: the
    clamp priority, `_hybrid_selection`, the weights zeroed and permuted
    into the windowed lane's layout, then H1's plain version on either
    layout. At a tie on the capacity's boundary, with no entry clamping,
    at a capacity of every entry, and with padded slots (location 0),
    which never clamp, beside corrected entries. The sort-key mirror of the kernel's
    selection gives the same mask, here and on ties, NaN and zero
    priorities."""
    rng = np.random.default_rng(7)
    value, loc, attw = _inputs(rng, spread=0.0 if regime == "none_clamp"
                               else 0.12)
    if regime == "none_clamp":  # every sample well inside every window
        loc[:] = 0.5
    if regime == "padded":
        loc[:, 4:7] = 0.0
    b, q, heads, levels, points = loc.shape[:5]
    ss = SpatialShapes(SHAPES)
    tl, ta = _t(loc), _t(attw)
    prio = tsmp.clamp_priority_plain(ss, tl, ta, 8, 8)
    cap = {"tie": _boundary_tie_capacity(prio.numpy()) if regime == "tie"
           else 0, "none_clamp": 5, "cap_covers": q * levels,
           "padded": 9}[regime]
    old_sel = tsmp._hybrid_selection(prio, cap).reshape(b, q, levels)
    old_w = ta * (~old_sel)[:, :, None, :, None].to(ta.dtype)
    sel, attw_win = tsmp.hybrid_selection(ss, tl, ta, 8, 8, cap)
    assert sel.dtype == torch.bool and attw_win.dtype == torch.float32
    assert torch.equal(sel, old_sel) and torch.equal(attw_win, old_w)
    assert torch.equal(sel, tsmp.hybrid_selection_plain(ss, tl, ta, 8, 8,
                                                        cap)[0])
    np.testing.assert_array_equal(
        _select_by_keys(prio.numpy(), cap).reshape(b, q, levels),
        sel.numpy())
    if regime == "none_clamp":
        assert not sel.any() and torch.equal(attw_win, ta)
    elif regime == "cap_covers":
        assert torch.equal(sel.reshape(b, -1), prio > 0)
    elif regime == "padded":  # their samples share one pixel: no loss
        assert sel.any() and not sel[:, 4:7].any()
    n = heads * points
    tv = _t(value)
    flat = tsmp._msda_patch_levels_plain(
        tv, ss, tl.permute(0, 1, 3, 2, 4, 5).reshape(b, q, levels, n, 2),
        old_w.permute(0, 1, 3, 2, 4).reshape(b, q, levels, n), heads, 8, 8)
    for g, w in zip(tsmp._msda_patch_levels(tv, ss, tl, attw_win, heads, 8,
                                            8), flat):
        assert torch.equal(g, w)
    # the key order on ties, zeros and NaN, against the stable sort's
    p = np.array([[0.5, 0.0, 0.5, np.nan, 0.25, 0.5, 0.0, 1.0]], np.float32)
    for k in range(p.shape[1] + 1):
        np.testing.assert_array_equal(
            _select_by_keys(p, k),
            tsmp._hybrid_selection(torch.from_numpy(p), k).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_msda_patch_levels_matches_jax(dtype):
    """H1's plain version (every level in level order, through its CPU
    wrapper and through `msda_patch` with `sel_levels` None) against
    JAX's `msda_patch(sel_levels=None)`, the all-level loop."""
    rng = np.random.default_rng(2)
    value, loc, attw = _inputs(rng, spread=0.2)
    b, q, heads, levels, points = loc.shape[:5]
    jv = jnp.asarray(value).astype(dtype)
    jraw = jax.jit(lambda v, l_, a: jsmp.msda_patch(
        v, JSS(SHAPES), l_, a, sel_levels=None, raw_heads=True))(
        jv, loc, attw)
    tv = _t(np.asarray(jv.astype(jnp.float32))).to(getattr(torch, dtype))
    n = heads * points
    got = tsmp._msda_patch_levels(
        tv, SpatialShapes(SHAPES),
        _t(loc).permute(0, 1, 3, 2, 4, 5).reshape(b, q, levels, n, 2),
        _t(attw).permute(0, 1, 3, 2, 4).reshape(b, q, levels, n), heads, 8,
        8)
    via = tsmp.msda_patch(tv, SpatialShapes(SHAPES), _t(loc), _t(attw),
                          raw_heads=True)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for g, v, j in zip(got, via, jraw):
        j = np.asarray(j)
        assert torch.equal(g, v)
        assert np.abs(g.numpy() - j).max() <= tol * np.abs(j).max()


def test_exact_lane_in_place_and_hybrid_exactness():
    """H2's wrapper adds the marked entries' exact samples into its
    inputs in place (the unmarked entries' bits unchanged) and returns
    them; with the capacity at least the demand, the hybrid equals exact
    `msda` within JAX's own bound for it (2e-4, tests/test_msda_hybrid.py:
    the windowed lane's taper clamp moves a sample within 1e-4 px of the
    window's edge)."""
    rng = np.random.default_rng(3)
    value, loc, attw = _inputs(rng)
    b, q, heads, levels = loc.shape[:4]
    c = value.shape[-1]
    ss = SpatialShapes(SHAPES)
    sel = torch.from_numpy(rng.uniform(size=(b, q, levels)) < 0.3)
    sampled = torch.randn(b, q, heads, c)
    wsum = torch.rand(b, q, heads)
    want = tsmp.msda_hybrid_exact_plain(_t(value), ss, _t(loc), _t(attw),
                                        sel, sampled, wsum)
    s0, w0 = sampled.clone(), wsum.clone()
    got = tsmp.msda_hybrid_exact(_t(value), ss, _t(loc), _t(attw), sel,
                                 sampled, wsum)
    assert got[0] is sampled and got[1] is wsum
    assert torch.equal(sampled, want[0]) and torch.equal(wsum, want[1])
    none = ~sel.any(-1)
    assert torch.equal(sampled[none], s0[none])
    assert torch.equal(wsum[none], w0[none])
    assert not torch.equal(sampled[~none], s0[~none])
    with pytest.raises(ValueError, match="bool"):
        tsmp.msda_hybrid_exact(_t(value), ss, _t(loc), _t(attw),
                               sel.float(), sampled, wsum)
    exact = np.asarray(jax.jit(lambda v, l_, a: jsmp.msda(
        v, JSS(SHAPES), l_, a))(value, loc, attw))
    hyb = tsmp.msda_hybrid(_t(value), ss, _t(loc), _t(attw),
                           clamp_capacity=q * levels)
    np.testing.assert_allclose(hyb.numpy(), exact, atol=2e-4)


def _exact_lane_walk(sel, heads, grid):
    """A plain mirror of H2's walk: for each of the plan's `grid` blocks,
    the (camera row, query, head) items that walk their samples, in its
    half-warps' order. Block b holds the 8 items from b x 8 in (row,
    query, head) order; an item whose query has no level marked in `sel`
    [B, Q, L] returns at once."""
    b, q = sel.shape[:2]
    items = b * q * heads
    marked = sel.reshape(b * q, -1).any(-1).tolist()
    per = tsmp.HYBRID_EXACT_ITEMS
    return [[(i // (q * heads), i // heads % q, i % heads)
             for i in range(blk * per, min(blk * per + per, items))
             if marked[i // heads]] for blk in range(grid)]


@pytest.mark.parametrize("shapes,q", [(R50_SHAPES, 208), (R101_SHAPES, 208),
                                      (R50_SHAPES, 207)],
                         ids=["r50", "r101", "ragged207"])
def test_exact_lane_walk_visits_each_marked_item_once(shapes, q):
    """A plain mirror of H2's walk (`_exact_lane_walk`) on the plan's
    grid: block b holds the 8 items from b x 8 in (row, query, head)
    order (one query's heads at 8 heads), and an item whose query has no
    marked level returns at once, so every item of a query with a marked
    level walks exactly once and no other, in item order. At the r50 and
    r101 plans (208 queries) and a ragged 207 (its last block's items
    past the end hold none), with about 5 %, 30 % and every entry
    marked, and at 4 heads (two queries a block)."""
    rng = np.random.default_rng(11)
    for heads in (8, 4):
        plan = tsmp.plan_msda_hybrid(6, q, heads, 4, 256, shapes)
        items = 6 * q * heads
        assert plan.threads == 128 and plan.grid == (-(-items // 8), 1)
        assert list(plan.dims[:8]) == [6, q, heads, 4, 4, 256,
                                       sum(h * w for h, w in shapes), 128]
        for share in (0.05, 0.3, 1.0):
            sel = torch.from_numpy(rng.uniform(size=(6, q, 4)) < share)
            sel[0, 0, 0] = True
            rows, queries = np.nonzero(sel.any(-1).numpy())
            want = [(r, qq, h) for r, qq in zip(rows.tolist(),
                                                queries.tolist())
                    for h in range(heads)]
            walks = _exact_lane_walk(sel, heads, plan.grid[0])
            assert len(walks) == plan.grid[0]
            got = [it for walk in walks for it in walk]
            assert got == want
            for blk, walk in enumerate(walks):
                assert all(((r * q + qq) * heads + h) // 8 == blk
                           for r, qq, h in walk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_lane_walk_sums_reproduce_plain(dtype):
    """Adding, item by item in H2's walk order, each walked item's marked
    levels' terms (the plain version's per-level sums, level by level in
    level order) into sampled and wsum reproduces
    `msda_hybrid_exact_plain` bit for bit: the walk's items own their
    rows, and unwalked items keep their inputs."""
    rng = np.random.default_rng(12)
    value, loc, attw = _inputs(rng)
    b, q, heads, levels = loc.shape[:4]
    ss = SpatialShapes(SHAPES)
    tv, tl, ta = _t(value).to(getattr(torch, dtype)), _t(loc), _t(attw)
    sel = torch.from_numpy(rng.uniform(size=(b, q, levels)) < 0.3)
    sampled = torch.randn(b, q, heads, value.shape[-1])
    wsum = torch.rand(b, q, heads)
    want = tsmp.msda_hybrid_exact_plain(tv, ss, tl, ta, sel, sampled, wsum)
    terms = []
    for lvl in range(levels):  # each level's sums alone, from zero
        one = torch.zeros_like(sel)
        one[:, :, lvl] = True
        terms.append(tsmp.msda_hybrid_exact_plain(
            tv, ss, tl, ta, one, torch.zeros_like(sampled),
            torch.zeros_like(wsum)))
    out, out_w = sampled.clone(), wsum.clone()
    plan = tsmp.plan_msda_hybrid(b, q, heads, 4, value.shape[-1], SHAPES)
    for walk in _exact_lane_walk(sel, heads, plan.grid[0]):
        for r, qq, h in walk:
            for lvl in range(levels):
                if sel[r, qq, lvl]:
                    out[r, qq, h] = out[r, qq, h] + terms[lvl][0][r, qq, h]
                    out_w[r, qq, h] = out_w[r, qq, h] + terms[lvl][1][r, qq,
                                                                     h]
    assert torch.equal(out, want[0]) and torch.equal(out_w, want[1])


def test_query_group_msda_hybrid():
    """The hybrid 2D cross-attention against JAX's
    `QueryGroupMSDA(hybrid_mode=True)` in post-projection mode (a pair
    table given) with the guard on and a slot capacity that bites:
    outputs, and `msda_overflow`, `msda_clamp_overflow`,
    `msda_clamp_demand` and `msda_percam_clamp_demand` equal to JAX's
    sown values, the correction lane overflowing; in the training order it
    refuses."""
    rng = np.random.default_rng(6)
    k, e, cap = 5, 32, 3
    ss_j, ss_t = JSS(SHAPES), SpatialShapes(SHAPES)
    q, qpos = _rand(rng, 1, 6 * k, e), _rand(rng, 1, 6 * k, e)
    ref_pts = rng.uniform(0.05, 0.95, (1, 6 * k, 2)).astype(np.float32)
    depth = (rng.uniform(size=(1, 6 * k, 1)) < 0.8) * rng.uniform(
        1, 30, (1, 6 * k, 1))
    depth[0, :k] = 5.0  # camera 0: all five slots valid
    depth = depth.astype(np.float32)
    col = _rand(rng, 1, 6, ss_j.total, e)
    msda = QueryGroupMSDA(e, 8, 4, 4, 6, gather_capacity=4, patch_mode=False,
                          hybrid_mode=True, clamp_capacity=cap)
    jmsda = JMSDA(embed_dims=e, num_heads=8, num_levels=4, num_cams=6,
                  patch_mode=False, gather_capacity=4, hybrid_mode=True,
                  clamp_capacity=cap, guard=True)
    pt = make_pair_table(jnp.asarray(col).reshape(-1, e))
    v = pair(jmsda, msda, jnp.asarray(q), jnp.asarray(qpos),
             jnp.asarray(ref_pts), jnp.asarray(depth), jnp.asarray(col),
             ss_j, pair_table=pt)
    ref, mut = jax.jit(lambda v_, *a: jmsda.apply(
        v_, *a, ss_j, deterministic=True, mutable=["guards"],
        pair_table=make_pair_table(a[-1].reshape(-1, e))))(
        v, q, qpos, ref_pts, depth, col)
    guards = {}
    with torch.no_grad():
        got = msda(_t(q), _t(qpos), _t(ref_pts), _t(depth), _t(col), ss_t,
                   guards=guards)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    names = ["msda_overflow", "msda_clamp_overflow", "msda_clamp_demand",
             "msda_percam_clamp_demand"]
    assert sorted(guards) == sorted(names)
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(guards[name][0]).reshape(-1),
            np.asarray(mut["guards"][name][0]).reshape(-1), err_msg=name)
    assert float(guards["msda_clamp_overflow"][0]) > 0
    with pytest.raises(NotImplementedError, match="no trainer"):
        msda(_t(q), _t(qpos), _t(ref_pts), _t(depth), _t(col), ss_t,
             project_first=True)


def test_hybrid_planners_and_limits():
    """H3's planner at the served shapes (the op's compacted 208 slots and
    the guards' 256, a cluster of 8 blocks a camera row, each holding the
    row's sort keys; 900 anchors x 4 levels taken) and its refusals; H1's
    bf16 plan (a ring of 2 window stages at C 256 and 4 at C 128, three
    blocks an SM; an odd level count taken; its refusals) and MSDA-sel's
    with every level (fp32 H1); H2's plan (the exact kernel's limits).
    Every configuration of configs/base.py fits the limits (ROADMAP
    C.4)."""
    for rows, q in ((6, 208), (6, 256), (6, 900)):
        plan = tsmp.plan_clamp_priority(rows, q, 8, 4, 8, 8, R50_SHAPES)
        assert plan.threads == 512 and plan.smem == 8 * q * 4
        assert plan.grid == (8 * rows, 1)
        assert list(plan.dims[:9]) == [rows, q, 8, 4, 4, 8, 8, 512,
                                       8 * q * 4]
    for bad in ((6, 208, 16, 4, 8, 8, R50_SHAPES),  # 64 samples an entry
                (6, 208, 8, 4, 8, 8, R50_SHAPES * 3),  # 12 levels
                (0, 208, 8, 4, 8, 8, R50_SHAPES),
                (6, 2049, 8, 4, 8, 8, R50_SHAPES)):  # 8,196 entries a row
        with pytest.raises(ValueError, match="clamp_priority"):
            tsmp.plan_clamp_priority(*bad)
    h1 = tsmp.plan_msda_levels(6, 208, 8, 256, R50_SHAPES, 1)
    assert list(h1.dims[:11]) == [6, 208, 4, 32, 8, 256, 14960, 2, 1, 256,
                                  h1.smem]
    assert h1.smem == tsmp._levels_smem(4, 32, 256, 2)
    assert 3 * (h1.smem + 1024) <= 228 * 1024 < 3 * (
        tsmp._levels_smem(4, 32, 256, 3) + 1024)
    assert tsmp.plan_msda_levels(6, 208, 8, 128, R50_SHAPES, 0).dims[7] == 4
    assert tsmp.plan_msda_levels(6, 208, 8, 256, R50_SHAPES[:3], 0).dims[7] \
        == 2
    for bad in ((6, 208, 8, 96, R50_SHAPES, 0), (6, 208, 9, 256,
                                                 R50_SHAPES, 0),
                (6, 208, 8, 256, R50_SHAPES, 2),
                (6, 0, 8, 256, R50_SHAPES, 0),
                (6, 208, 8, 256, R50_SHAPES * 3, 0)):
        with pytest.raises(ValueError, match="_msda_patch_levels"):
            tsmp.plan_msda_levels(*bad)
    two = tsmp.plan_msda_sel(6, 208, 32, 8, 256, 2, 8, 8, torch.bfloat16,
                             R50_SHAPES)
    four = tsmp.plan_msda_sel(6, 208, 32, 8, 256, 4, 8, 8, torch.bfloat16,
                              R50_SHAPES)
    assert four.grid == two.grid and four.smem == two.smem + 24
    assert 3 * (four.smem + 1024) <= 228 * 1024
    assert tsmp.plan_msda_sel(6, 208, 32, 8, 256, 4, 8, 8, torch.float32,
                              R50_SHAPES).grid == (208, 6)
    with pytest.raises(ValueError, match="multiple of 2"):
        tsmp.plan_msda_sel(6, 208, 32, 8, 256, 3, 8, 8, torch.bfloat16,
                           R50_SHAPES)
    tsmp.plan_msda(6, 208, 8, 4, 256, R50_SHAPES)
    for bad in ((6, 208, 9, 4, 256, R50_SHAPES), (6, 208, 8, 4, 252,
                                                  R50_SHAPES),
                (6, 208, 8, 4, 256, R50_SHAPES * 3)):
        with pytest.raises(ValueError, match="msda_hybrid_exact"):
            tsmp.plan_msda_hybrid(*bad)
    for name in dir(tbase):
        if not name.startswith("simpb_"):
            continue
        cfg = getattr(tbase, name)()
        h = cfg.head
        shapes = tuple(cfg.feature_shapes)
        tsmp.plan_clamp_priority(6, h.allocation_capacity, h.num_groups, 4,
                                 *h.msda_patch_hw, shapes)
        tsmp.plan_msda(6, h.allocation_capacity, h.num_groups, 4,
                       h.embed_dims, shapes)
        tsmp.plan_msda_hybrid(6, h.allocation_capacity, h.num_groups, 4,
                              h.embed_dims, shapes)
        if tsmp._patch_fits_all(SpatialShapes(shapes), *h.msda_patch_hw):
            for dtype in (torch.float32, torch.bfloat16):
                tsmp.plan_msda_sel(6, h.allocation_capacity,
                                   4 * h.num_groups, h.num_groups,
                                   h.embed_dims, len(shapes),
                                   *h.msda_patch_hw, dtype, shapes)
            for layout in (0, 1):
                tsmp.plan_msda_levels(6, h.allocation_capacity, h.num_groups,
                                      h.embed_dims, shapes, layout)


def test_hybrid_refuses_small_levels_off_the_cpu(monkeypatch):
    """Off the CPU `msda_hybrid` takes no plain branch: where a level is
    smaller than the window (the tiny pyramid) it raises naming ROADMAP
    B.5 before anything launches. Meta tensors stand in for the card's,
    with the device check lifted; the message is the one built for it."""
    assert not tsmp._patch_fits_all(SpatialShapes(TINY_SHAPES), 8, 8)
    assert tsmp._patch_fits_all(SpatialShapes(R50_SHAPES), 8, 8)
    monkeypatch.setattr(tsmp, "_check_msda", lambda *a: None)
    total = sum(h * w for h, w in TINY_SHAPES)
    meta = dict(device="meta")
    want = tsmp.hybrid_window_refusal(SpatialShapes(TINY_SHAPES), 8, 8)
    assert "ROADMAP B.5" in want and "(1, 2)" in want
    with pytest.raises(NotImplementedError) as err:
        tsmp.msda_hybrid(torch.empty(1, total, 32, **meta),
                         SpatialShapes(TINY_SHAPES),
                         torch.empty(1, 4, 8, 4, 4, 2, **meta),
                         torch.empty(1, 4, 8, 4, 4, **meta),
                         clamp_capacity=8)
    assert str(err.value) == want


def test_bench_hybrid_switches_match_bench_py(monkeypatch):
    """`SIMPB_HYBRID` with `SIMPB_CLAMP_CAP` selects bench.py's config,
    field by field, with the fused trunk; the head takes the hybrid."""
    from simpb_tpu_torch import bench
    from simpb_tpu_torch.models.detector import check_serving_config
    from test_torch_port_eval import _jax_bench_config

    monkeypatch.setenv("SIMPB_HYBRID", "1")
    monkeypatch.setenv("SIMPB_CLAMP_CAP", "832")
    cfg = bench.config()
    want = dataclasses.replace(_jax_bench_config(monkeypatch),
                               backbone_fused_infer=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.head.msda_hybrid_mode and cfg.head.msda_clamp_capacity == 832
    check_serving_config(cfg)


def _jax_day0_decision(monkeypatch, tmp_path, metrics, argv):
    """The decision JAX's tools/day0.py writes for demand-pass `metrics`,
    from its own main with the model, the conversion, the dataset and the
    stream replaced by stand-ins (nothing is built or compiled)."""
    from simpb_tpu.data import dataset as jds
    from simpb_tpu.models import detector as jdet
    from simpb_tpu.training import evaluate as jev
    from simpb_tpu.utils import torch_convert as jtc

    class Model:
        def __init__(self, cfg):
            pass

        def init(self, *a, **k):
            return {"params": {}, "batch_stats": {}}

    monkeypatch.setattr(jdet, "SimPB", Model)
    monkeypatch.setattr(jds, "NuScenesDataset", lambda *a, **k: None)
    monkeypatch.setattr(jtc, "load_torch_checkpoint",
                        lambda path, cfg: ({}, {}))
    monkeypatch.setattr(jev, "streaming_eval",
                        lambda *a, **k: (dict(metrics), [], []))
    spec = importlib.util.spec_from_file_location(
        "jax_day0", os.path.join(REPO, "tools", "day0.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "jax"
    monkeypatch.setattr(sys, "argv", ["day0.py", "--out-dir", str(out)]
                        + argv)
    mod.main()
    return json.loads((out / "day0_decision.json").read_text())


@pytest.mark.parametrize("demand,overflow,extra", [
    (0.0, 0.0, []), (100.0, 0.0, []), (409.0, 0.0, []), (410.0, 0.0, []),
    (50.0, 3.0, []), (200.0, 0.0, ["--hybrid-max-capacity", "128"]),
    (20.0, 0.0, ["--capacity-margin", "2.0"])])
def test_day0_decision_matches_jax(monkeypatch, tmp_path, demand, overflow,
                                   extra):
    """The day-0 decision (hybrid at a right-sized capacity, or guarded)
    on given demand figures equals the JAX tool's: the margin, the
    multiple of 32, `--hybrid-max-capacity`, and an overflow of the
    measurement that sends it to guarded; the serving command names the
    port's eval CLI."""
    from simpb_tpu_torch.tools import day0

    argv = ["--ann-file", "val.pkl", "--torch-checkpoint", "w.pth"] + extra
    metrics = {"guard_msda_clamp_demand": demand,
               "guard_msda_clamp_overflow": overflow,
               "guard_dfa_overflow": 0.0, "mAP": 0.0}
    want = _jax_day0_decision(monkeypatch, tmp_path, metrics, argv)
    _, total, _ = day0.measurement_config("r50")
    assert total == want["total_entries_per_camera"]
    got = day0.decide(demand, overflow, total, day0.parse_args(argv))
    for key in ("chosen_config", "msda_clamp_capacity"):
        assert got[key] == want[key], key
    assert got["serve_command"].startswith(
        "python -m simpb_tpu_torch.tools.test --config "
        + got["chosen_config"])


def test_day0_cli_on_cpu(tmp_path):
    """`python -m simpb_tpu_torch.tools.day0 --device cpu` on the tiny
    config over a synthetic pkl and a synthetic reference `.pth`: the
    demand pass under the hybrid with every entry's capacity (no
    overflow), the decision, its JSON and a confirmation pass; `--config
    r101` is taken (ResNet-101 at 1408x512 on the fused trunk)."""
    from simpb_tpu_torch.tools import day0
    from simpb_tpu_torch.utils.synthetic import write_synthetic_infos

    cfg = tbase.simpb_tiny()
    pkl = write_synthetic_infos(str(tmp_path), n_frames=3, gap_at=(),
                                src_hw=(60, 100), num_objects=4,
                                write_images=True)
    norm = cfg.head.operation_order.index("norm")
    rng = np.random.default_rng(4)
    pth = tmp_path / "release.pth"
    torch.save({"state_dict": {
        f"head.layers.{norm}.weight": torch.from_numpy(
            rng.normal(size=cfg.head.embed_dims).astype(np.float32)),
        f"head.layers.{norm}.bias": torch.zeros(cfg.head.embed_dims)}}, pth)
    out = tmp_path / "day0"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "simpb_tpu_torch.tools.day0", "--ann-file",
         pkl, "--torch-checkpoint", str(pth), "--config", "tiny",
         "--device", "cpu", "--out-dir", str(out), "--demand-frames", "2",
         "--confirm-frames", "1", "--src-h", "60", "--src-w", "100"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    d = json.loads((out / "day0_decision.json").read_text())
    assert d["total_entries_per_camera"] == 32
    assert d["guard_msda_clamp_overflow"] == 0
    assert 0 <= d["guard_msda_clamp_demand_max"] <= 32
    assert d["chosen_config"] in ("tiny-hybrid", "tiny-guarded")
    if d["chosen_config"] == "tiny-hybrid":
        cap = d["msda_clamp_capacity"]
        assert cap >= d["guard_msda_clamp_demand_max"] and cap % 32 == 0
    assert d["serve_command"].startswith(
        "python -m simpb_tpu_torch.tools.test")
    assert "mAP" in d["measurement_metrics"]
    assert "guard_msda_clamp_demand" in d["confirmation_metrics"]
    r101, _, _ = day0.measurement_config(day0.parse_args(
        ["--ann-file", pkl, "--torch-checkpoint", str(pth), "--config",
         "r101"]).config)
    assert (r101.backbone_depth, r101.input_size) == (101, (1408, 512))
    assert r101.head.msda_hybrid_mode and r101.backbone_fused_infer
    with pytest.raises(SystemExit, match="ROADMAP B.5"):
        day0.main(["--ann-file", pkl, "--torch-checkpoint", str(pth),
                   "--config", "tiny"])
