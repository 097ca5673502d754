"""The port's ops against the JAX package: box geometry, the packed
feature layout, the deformable sampling ops and the four trunk kernels'
plain versions.

Inputs come from numpy seeds and go to both packages. Tolerances:
1e-5 for fp32 ops (float32 rounding of a few dozen operations); 2e-5
for the trunk kernels' plain versions against the Pallas kernels run in
interpret mode, the bound tests/test_conv_fused.py holds them to; exact
equality for the max-pool; 1e-2 of the output range for bf16, where
one rounding of a stored intermediate (y1, y2) can differ by one bf16
ulp (2^-8) when two fp32 sums differ in their last bit.

The plain versions have no tiles; the CUDA kernels' tiling (ragged last
tiles at W = 22 and 44, stride 2) is held to them on the card by
chip_smoke.py at every full-width shape.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.core import box3d as jbox
from simpb_tpu.models.backbone import Bottleneck as JaxBottleneck
from simpb_tpu.models.backbone import maxpool_3x3_s2 as jax_maxpool_3x3_s2
from simpb_tpu.ops import conv_fused as jcf
from simpb_tpu.ops import format as jfmt
from simpb_tpu.ops import sampling as jsmp
from simpb_tpu_torch.core import box3d as tbox
from simpb_tpu_torch.models.backbone import Bottleneck
from simpb_tpu_torch.ops import conv_fused as tcf
from simpb_tpu_torch.ops import format as tfmt
from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.utils.convert import state_from_jax

ATOL = 1e-5
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit(fn, *args, **static):
    """A JAX reference, jitted: one compile instead of one per op."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _close(t, j, atol=ATOL, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               rtol=atol, err_msg=msg)


def _anchors(rng, n):
    a = np.concatenate([
        rng.uniform(-40, 40, (1, n, 3)), rng.normal(0.5, 0.3, (1, n, 3)),
        rng.normal(size=(1, n, 2)), rng.normal(size=(1, n, 3)),
    ], -1)
    return a.astype(np.float32)


# ---------------------------------------------------------------- box3d
def test_box_codec_corners_and_projection():
    rng = np.random.default_rng(0)
    a = _anchors(rng, 16)
    dec = np.asarray(_jit(jbox.decode_box, a))
    _close(tbox.decode_box(_t(a)), dec)
    _close(tbox.encode_box(_t(dec)), _jit(jbox.encode_box, dec))
    _close(tbox.box_corners(_t(a), size_clip=(3.0, 3.0, 1.0)),
           _jit(jbox.box_corners, a, size_clip=(3.0, 3.0, 1.0)), atol=1e-4)
    kp = rng.normal(size=(1, 16, 5, 3)).astype(np.float32) * 10
    kp[..., 1] += 20.0
    proj = np.tile(np.eye(4, dtype=np.float32), (1, 6, 1, 1))
    proj[:, :, :3, :3] = rng.normal(size=(1, 6, 3, 3)) + np.eye(3) * 3
    wh = np.full((1, 6, 2), (64.0, 32.0), np.float32)
    _close(tbox.project_points(_t(kp), _t(proj), _t(wh)),
           _jit(jbox.project_points, kp, proj, wh), atol=1e-4)


def test_anchor_projection_keeps_yaw_quirk():
    rng = np.random.default_rng(1)
    a = _anchors(rng, 12)
    t = np.eye(4, dtype=np.float32)[None]
    th = 0.3
    t[0, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    t[0, :3, 3] = [1.0, -2.0, 0.1]
    dt = np.array([0.4], np.float32)
    got = tbox.anchor_projection(_t(a), _t(t), -_t(dt))
    ref = _jit(jbox.anchor_projection, a, t, -dt)
    _close(got, ref, atol=1e-4)
    # the rotated (cos, sin) lands in the (sin, cos) slots unswapped
    rot = t[0, :2, :2] @ a[0, :, [tbox.COS_YAW, tbox.SIN_YAW]]
    np.testing.assert_allclose(
        got[0, :, tbox.SIN_YAW:tbox.COS_YAW + 1].numpy(), rot.T, atol=1e-5
    )


def test_pack_unpack_feature_maps():
    rng = np.random.default_rng(2)
    maps = [rng.normal(size=(1, 6, h, w, 8)).astype(np.float32)
            for h, w in ((8, 16), (4, 8), (2, 4), (1, 2))]
    tcol, tss = tfmt.pack_feature_maps([_t(m) for m in maps])
    jcol, jss = jfmt.pack_feature_maps([jnp.asarray(m) for m in maps])
    assert tss.shapes == jss.shapes and tss.start_indices == jss.start_indices
    np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
    for t, m in zip(tfmt.unpack_feature_maps(tcol, tss), maps):
        np.testing.assert_array_equal(t.numpy(), m)


# ------------------------------------------------------------- sampling
SHAPES_TINY = ((8, 16), (4, 8), (2, 4), (1, 2))
SHAPES_FIT = ((16, 24), (8, 12), (8, 8), (8, 10))  # 8x8 fits every level


def test_bilinear_sample():
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 8 * 16, 8)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (2, 40, 2)).astype(np.float32)
    for drop in (True, False):
        _close(tsmp.bilinear_sample(_t(feat), 8, 16, _t(loc), drop),
               _jit(lambda f, l: jsmp.bilinear_sample(f, 8, 16, l, drop),
                    feat, loc))


@pytest.mark.parametrize("capacity", [None, 40])
def test_deformable_aggregation(capacity):
    """Border-straddling locations exercise the whole-sample drop; a
    capacity below the in-range count exercises the compaction."""
    rng = np.random.default_rng(4)
    ss = jfmt.SpatialShapes(SHAPES_TINY)
    col = rng.normal(size=(1, 6, ss.total, 16)).astype(np.float32)
    pts = rng.uniform(-0.3, 1.3, (1, 8, 13, 6, 2)).astype(np.float32)
    w = rng.uniform(size=(1, 8, 13, 6, 4, 4)).astype(np.float32)
    ref = jax.jit(lambda c, p, w_: jsmp.deformable_aggregation(
        c, ss, p, w_, gather_capacity=capacity))(col, pts, w)
    got = tsmp.deformable_aggregation(
        _t(col), tfmt.SpatialShapes(SHAPES_TINY), _t(pts), _t(w),
        gather_capacity=capacity,
    )
    _close(got, ref)
    if capacity is not None:  # compaction really dropped slots
        full = tsmp.deformable_aggregation(
            _t(col), tfmt.SpatialShapes(SHAPES_TINY), _t(pts), _t(w))
        assert (full - got).abs().max() > 1e-3


@pytest.mark.parametrize("shapes,sel,raw", [
    (SHAPES_TINY, 2, True), (SHAPES_FIT, 2, True), (SHAPES_FIT, None, False),
])
def test_msda_patch(shapes, sel, raw):
    """Both branches: the per-level loop (the 8x8 patch does not fit the
    tiny pyramid, or no level selection) and `_msda_patch_sel` (the
    patch fits every level); samples spread past the window so the
    taper clamp engages, and some hang off the image border."""
    rng = np.random.default_rng(5)
    ss = jfmt.SpatialShapes(shapes)
    value = rng.normal(size=(3, ss.total, 16)).astype(np.float32)
    ref_pts = rng.uniform(0.0, 1.0, (3, 5, 1, 1, 1, 2))
    loc = (ref_pts + rng.normal(size=(3, 5, 4, 4, 4, 2)) * 0.15).astype(
        np.float32)
    attw = rng.uniform(size=(3, 5, 4, 4, 4)).astype(np.float32)
    attw /= attw.sum((-1, -2), keepdims=True)
    ref = jax.jit(lambda v, l, a: jsmp.msda_patch(
        v, ss, l, a, sel_levels=sel, raw_heads=raw))(value, loc, attw)
    got = tsmp.msda_patch(_t(value), tfmt.SpatialShapes(shapes), _t(loc),
                          _t(attw), sel_levels=sel, raw_heads=raw)
    if raw:
        _close(got[0], ref[0])
        _close(got[1], ref[1])
    else:
        _close(got, ref)


def test_window_helpers():
    assert tsmp.shrink_patch(8, 8, 2, 3) == jsmp.shrink_patch(8, 8, 2, 3)
    assert tsmp.shrink_patch(8, 8, 16, 16) == (8, 8)
    x = torch.tensor([[3.0, 1.0, 3.0, 0.5]])
    _, idx = tsmp.topk_stable(x, 3)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]))


# ------------------------------------------------- trunk kernels (plain)
def _block_pair(x, planes, stride, downsample, seed):
    """JAX and port bottlenecks holding the same seeded weights and
    non-trivial BN statistics (so the fold is exercised)."""
    rng = np.random.default_rng(seed)
    jblk = JaxBottleneck(planes=planes, stride=stride, downsample=downsample)
    shapes = jax.eval_shape(jblk.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def fill(path, leaf):
        name, n = str(getattr(path[-1], "key", path[-1])), leaf.shape
        if name == "kernel":
            v = rng.normal(size=n) / np.sqrt(np.prod(n[:-1]))
        elif name == "scale":
            v = rng.uniform(0.8, 1.2, n)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, n)
        else:  # bias, mean
            v = rng.normal(size=n) * 0.1
        return np.asarray(v, np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    tblk = Bottleneck(x.shape[-1], planes, stride, downsample)
    tblk.load_state_dict(state_from_jax(tblk, v, unused_ok=None),
                         strict=True)
    return v, tblk


def _pallas(fn, *args, **kw):
    """A Pallas kernel in interpret mode, jitted: one compile instead of
    one per interpreted operation."""
    return jax.jit(lambda *a: fn(*a, interpret=True, **kw))(*args)


@pytest.mark.parametrize("shape,planes", [
    ((1, 6, 22, 32), 8),  # W not a multiple of 8 (layer4's 22)
    ((1, 1, 7, 32), 8),  # one row, odd width
])
def test_bottleneck_plain_matches_pallas(shape, planes):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    v, tblk = _block_pair(x, planes, 1, False, 0)
    jfold = jcf.fold_block_params(v["params"], v["batch_stats"])
    tfold = tcf.fold_block_params(tblk)
    for t, j in zip(tfold, jfold):
        _close(t, j, atol=1e-6, msg="fold")
    ref = _pallas(jcf.bottleneck_fused_infer, jnp.asarray(x), jfold)
    _close(tcf.bottleneck_fused_infer(_t(x), tfold), ref, atol=2e-5)


@pytest.mark.parametrize("shape,stride", [
    ((1, 8, 12, 32), 1), ((1, 12, 22, 32), 2),
])
def test_bottleneck_down_plain_matches_pallas(shape, stride):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    v, tblk = _block_pair(x, 16, stride, True, 1)
    jfold = jcf.fold_block_params(v["params"], v["batch_stats"])
    jdown = jcf.fold_downsample_params(v["params"], v["batch_stats"])
    tdown = tcf.fold_downsample_params(tblk)
    _close(tdown[0], jdown[0], atol=1e-6)
    ref = _pallas(jcf.bottleneck_down_fused_infer, jnp.asarray(x), jfold,
                  jdown, stride=stride)
    got = tcf.bottleneck_down_fused_infer(
        _t(x), tcf.fold_block_params(tblk), tdown, stride)
    assert tuple(got.shape) == ref.shape
    _close(got, ref, atol=2e-5)


@pytest.mark.parametrize("down", [False, True])
def test_bottleneck_plain_bf16_rounding(down):
    """bf16 storage: the plain version rounds where the Pallas kernel
    does (y1, y2; y3 before the identity add, the skip sum after)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 4, 12, 32)).astype(np.float32)
    v, tblk = _block_pair(x, 8, 2 if down else 1, down, 2)
    xb = jnp.asarray(x, jnp.bfloat16)
    jfold = jcf.fold_block_params(v["params"], v["batch_stats"])
    tx = _t(x).to(torch.bfloat16)
    if down:
        jdown = jcf.fold_downsample_params(v["params"], v["batch_stats"])
        ref = _pallas(jcf.bottleneck_down_fused_infer, xb, jfold, jdown,
                      stride=2)
        got = tcf.bottleneck_down_fused_infer(
            tx, tcf.fold_block_params(tblk), tcf.fold_downsample_params(tblk),
            2)
    else:
        ref = _pallas(jcf.bottleneck_fused_infer, xb, jfold)
        got = tcf.bottleneck_fused_infer(tx, tcf.fold_block_params(tblk))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    assert np.abs(got.detach().float().numpy() - ref).max() <= 1e-2 * scale


@pytest.mark.parametrize("shape", [(1, 6, 22, 16)])
def test_conv3x3_plain_matches_pallas(shape):
    rng = np.random.default_rng(9)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, shape[-1], 16)) * 0.1).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    ref = _pallas(jcf.conv3x3_bias_fused, jnp.asarray(x), jnp.asarray(k),
                  jnp.asarray(b))
    _close(tcf.conv3x3_bias_fused(_t(x), _t(k), _t(b)), ref, atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 6, 22, 16)])
def test_maxpool_plain_matches_pallas(shape):
    x = np.random.default_rng(10).normal(size=shape).astype(np.float32)
    ref = _pallas(jcf.maxpool_3x3_s2_fused, jnp.asarray(x))
    np.testing.assert_array_equal(
        tcf.maxpool_3x3_s2_fused(_t(x)).numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(2, 7, 9, 16)])
def test_maxpool_odd_sizes_match_jax_trunk_pool(shape):
    """Odd H or W: the JAX trunk takes its plain pool there; the port's
    wrapper (and its kernel) handle every size."""
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    ref = jax_maxpool_3x3_s2(jnp.asarray(x))
    got = tcf.maxpool_3x3_s2_fused(_t(x))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_refuse_other_devices_and_count_nothing_on_cpu():
    tcf.reset_launch_counts()
    x = torch.zeros((1, 4, 4, 16))
    tcf.maxpool_3x3_s2_fused(x)
    assert tcf.launch_counts() == {
        "maxpool_3x3_s2": 0, "bottleneck_down": 0, "bottleneck": 0,
        "conv3x3_bias": 0,
    }
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tcf.maxpool_3x3_s2_fused(x.to("meta"))
