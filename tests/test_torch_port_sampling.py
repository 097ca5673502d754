"""The sampling wrappers of the port on the CPU: `deformable_aggregation`
and `_msda_patch_sel` check their arguments as the CUDA kernels need
them, then on CPU tensors return their plain versions' result bit for
bit and launch nothing. Their launch planners at the configs' shapes,
and the bf16 MSDA-sel kernel's three-part weight split, emulated in
torch. The plain versions are held to the JAX package in
tests/test_torch_port_ops.py; the kernels are held to the plain
versions on the card by chip_smoke.py.
"""
import pytest
import torch

from simpb_tpu_torch.ops import sampling as tsmp
from simpb_tpu_torch.ops.format import SpatialShapes

torch.set_num_threads(1)
SHAPES_FIT = ((16, 24), (8, 12), (8, 8), (8, 10))  # 8x8 fits every level


def _dfa_args(dtype, seed=0):
    """Inputs as the DFA module passes them: points and weights permuted
    (not contiguous), in the features' dtype."""
    g = torch.Generator().manual_seed(seed)
    ss = SpatialShapes(SHAPES_FIT)
    col = torch.randn(1, 6, ss.total, 16, generator=g).to(dtype)
    pts = (torch.rand(1, 6, 8, 13, 2, generator=g) * 1.6 - 0.3)
    w = torch.rand(1, 8, 6, 4, 13, 4, generator=g)
    return (col, ss, pts.permute(0, 2, 3, 1, 4).to(dtype),
            w.permute(0, 1, 4, 2, 3, 5).to(dtype))


def _msda_args(value_dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    ss = SpatialShapes(SHAPES_FIT)
    value = torch.randn(3, ss.total, 16, generator=g).to(value_dtype)
    ref = torch.rand(3, 5, 1, 1, 2, generator=g)
    loc = ref + 0.15 * torch.randn(3, 5, 4, 8, 2, generator=g)
    attw = torch.rand(3, 5, 4, 8, generator=g)
    return value, ss, loc, attw / attw.sum((2, 3), keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("capacity", [None, 40])
def test_dfa_wrapper_on_cpu_is_plain(dtype, capacity):
    tsmp.reset_launch_counts()
    args = _dfa_args(dtype)
    got = tsmp.deformable_aggregation(*args, gather_capacity=capacity)
    ref = tsmp.deformable_aggregation_plain(*args, gather_capacity=capacity)
    assert got.dtype == torch.float32 and got.shape == (1, 8, 16)
    assert torch.equal(got, ref)
    assert tsmp.launch_counts() == {
        "deformable_aggregation": 0, "msda_patch_sel": 0, "msda": 0,
        "deformable_aggregation_backward": 0, "msda_patch_sel_backward": 0,
        "msda_backward": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_msda_sel_wrapper_on_cpu_is_plain(dtype):
    tsmp.reset_launch_counts()
    value, ss, loc, attw = _msda_args(dtype)
    got = tsmp._msda_patch_sel(value, ss, loc, attw, 2, 8, 8, 2)
    ref = tsmp._msda_patch_sel_plain(value, ss, loc, attw, 2, 8, 8, 2)
    for g_, r_ in zip(got, ref):
        assert g_.dtype == torch.float32
        assert torch.equal(g_, r_)
    assert got[0].shape == (3, 5, 2, 16) and got[1].shape == (3, 5, 2)
    # the windowed-MSDA entry reaches the wrapper, and on the CPU counts
    # nothing either
    tsmp.msda_patch(value, ss, loc.reshape(3, 5, 4, 2, 4, 2).transpose(2, 3),
                    attw.reshape(3, 5, 4, 2, 4).transpose(2, 3),
                    sel_levels=2, raw_heads=True)
    assert set(tsmp.launch_counts().values()) == {0}


def test_dfa_wrapper_refuses_what_the_kernel_does_not_take():
    col, ss, pts, w = _dfa_args(torch.float32)
    dfa = tsmp.deformable_aggregation
    with pytest.raises(ValueError, match="tensors on cpu and meta"):
        dfa(col, ss, pts.to("meta"), w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dfa(col.to("meta"), ss, pts.to("meta"), w.to("meta"))
    with pytest.raises(TypeError, match="not supported"):
        dfa(col.half(), ss, pts.half(), w.half())
    with pytest.raises(TypeError, match="must match"):
        dfa(col, ss, pts.bfloat16(), w)
    with pytest.raises(ValueError, match="contiguous"):
        dfa(col.transpose(2, 3).contiguous().transpose(2, 3), ss, pts, w)
    with pytest.raises(ValueError, match="do not fit"):
        dfa(col, ss, pts, w[..., :3])  # 16 channels in 3 groups
    with pytest.raises(ValueError, match="cover"):
        dfa(col, SpatialShapes(((16, 24),)), pts, w[..., :1, :])


def test_msda_sel_wrapper_refuses_what_the_kernel_does_not_take():
    value, ss, loc, attw = _msda_args(torch.float32)
    sel = tsmp._msda_patch_sel
    with pytest.raises(ValueError, match="tensors on cpu and meta"):
        sel(value, ss, loc.to("meta"), attw, 2, 8, 8, 2)
    with pytest.raises(TypeError, match="not supported"):
        sel(value.half(), ss, loc, attw, 2, 8, 8, 2)
    with pytest.raises(TypeError, match="loc must be float32"):
        sel(value, ss, loc.bfloat16(), attw, 2, 8, 8, 2)
    with pytest.raises(ValueError, match="attw must be contiguous"):
        sel(value, ss, loc, attw.transpose(0, 1).contiguous().transpose(0, 1),
            2, 8, 8, 2)
    with pytest.raises(ValueError, match="heads"):
        sel(value, ss, loc, attw, 3, 8, 8, 2)  # 8 samples in 3 heads
    with pytest.raises(ValueError, match="must fit every level"):
        sel(value, ss, loc, attw, 2, 8, 10, 2)  # wider than level 2


# ------------------------------------------------------------ planners
# (config, DFA call (bs, cams, A, P, G, C, capacity), MSDA-sel call
# (rows, queries, samples, heads, C, levels kept, window h, w)) of the
# configurations the port serves; levels at strides 4-32 of the input
def _config_calls():
    from simpb_tpu_torch.configs.base import (simpb_r50_704x256_fast,
                                              simpb_r101_1408x512_fast,
                                              simpb_tiny)
    out = []
    for make in (simpb_r50_704x256_fast, simpb_r101_1408x512_fast,
                 simpb_tiny):
        cfg = make()
        h = cfg.head
        w_, h_ = cfg.input_size
        shapes = tuple((h_ // s, w_ // s) for s in (4, 8, 16, 32))
        cap = h.msda_gather_capacity
        queries = cap if cap is not None and cap < h.allocation_capacity \
            else h.allocation_capacity
        dfa = (1, h.num_cams, h.num_anchor, 7 + h.num_learnable_pts,
               h.num_groups, h.embed_dims, h.dfa_gather_capacity)
        msda = (h.num_cams, queries, 4 * h.num_groups, h.num_groups,
                h.embed_dims, h.msda_sel_levels or 2, *h.msda_patch_hw)
        out.append(pytest.param(shapes, dfa, msda, id=make.__name__))
    return out


def _covers_once(plan, total):
    """One block per work item: the blocks cover range(total) once."""
    return plan.grid[0] * plan.grid[1] == total


@pytest.mark.parametrize("shapes,dfa,msda", _config_calls())
def test_plan_dfa_at_config_shapes(shapes, dfa, msda):
    bs, cams, anchors, pts, groups, c, cap = dfa
    plan = tsmp.plan_dfa(bs, cams, anchors, pts, groups, c, cap, shapes)
    assert plan.smem <= tsmp._kernels.MAX_SMEM
    assert plan.threads % 32 == 0 and plan.threads <= tsmp.DFA_THREADS
    assert plan.threads % (c // 8) == 0  # whole teams of C / 8 threads
    assert plan.grid == (anchors, bs) and _covers_once(plan, anchors * bs)
    bites = cap is not None and cap < anchors * pts
    assert plan.scratch == (bs * cams if bites else 0)
    dims = list(plan.dims)
    assert dims[:9] == [bs, cams, anchors, pts, len(shapes), groups, c,
                        sum(h * w for h, w in shapes), cap if bites else -1]
    assert tsmp.plan_dfa(bs, cams, anchors, pts, groups, c, cap,
                         shapes) is plan  # cached


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,dfa,msda", _config_calls())
def test_plan_msda_sel_at_config_shapes(shapes, dfa, msda, dtype):
    rows, queries = msda[:2]
    plan = tsmp.plan_msda_sel(*msda, dtype, shapes)
    n, heads, c, k, ph, pw = msda[2:]
    assert plan.smem <= tsmp._kernels.MAX_SMEM
    assert _covers_once(plan, rows * queries) and plan.scratch == 0
    assert list(plan.dims) == [rows, queries, len(shapes), n, heads, c,
                               sum(h * w for h, w in shapes), k, ph, pw,
                               plan.threads, plan.smem] + [
        h for h, _ in shapes] + [w for _, w in shapes] + [
        sum(h * w for h, w in shapes[:i]) for i in range(len(shapes))]
    if dtype == torch.bfloat16:  # one query a block, three an SM at r50
        assert plan.grid == (rows * queries, 1) and plan.threads == 256
        assert 3 * (plan.smem + 1024) <= 228 * 1024
    else:
        assert plan.grid == (queries, rows)
    assert tsmp.plan_msda_sel(*msda, dtype, shapes) is plan  # cached


def test_planners_refuse_what_the_kernels_do_not_take():
    shapes = ((64, 176), (32, 88), (16, 44), (8, 22))
    with pytest.raises(ValueError, match="multiple of 8"):
        tsmp.plan_dfa(1, 6, 900, 13, 8, 96, 2048, shapes)  # C/G = 12
    with pytest.raises(ValueError, match="groups"):
        tsmp.plan_dfa(1, 6, 900, 13, 16, 256, 2048, shapes)  # G > 8
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="heads"):  # above MAX_HEADS
            tsmp.plan_msda_sel(6, 208, 4 * 32, 32, 256, 2, 8, 8, dtype,
                               shapes)
    with pytest.raises(ValueError, match="bf16 kernel"):  # 4x8 window
        tsmp.plan_msda_sel(6, 208, 32, 8, 256, 2, 4, 8, torch.bfloat16,
                           shapes)
    for c in (96, 320):  # C no multiple of 64, or above 256
        with pytest.raises(ValueError, match="bf16 kernel"):
            tsmp.plan_msda_sel(6, 208, 32, 8, c, 2, 8, 8, torch.bfloat16,
                               shapes)
    with pytest.raises(ValueError, match="bf16 kernel"):  # 16 heads
        tsmp.plan_msda_sel(6, 208, 64, 16, 256, 2, 8, 8, torch.bfloat16,
                           shapes)


# ------------------------------- the bf16 MSDA-sel kernel's weight split
SPLIT_SHAPES = SpatialShapes(((64, 176), (32, 88), (16, 44), (8, 22)))


@pytest.fixture(scope="module")
def main_path_window():
    """One camera row x 208 queries of the main path's MSDA-sel: bf16
    values, fp32 locations and weights (seeded), the plain version's
    output, and the per-head window weights W [1, Q, k, heads, 64] it
    contracts, made as the plain version makes them."""
    g = torch.Generator().manual_seed(5)
    heads, pts, q, c = 8, 4, 208, 256
    n = heads * pts
    value = (4 * torch.randn(1, SPLIT_SHAPES.total, c, generator=g)
             ).bfloat16()
    ref = torch.rand(1, q, 1, 1, 2, generator=g)
    loc = ref + 0.1 * torch.randn(1, q, 4, n, 2, generator=g)
    attw = torch.rand(1, q, 4, n, generator=g)
    attw = attw / attw.sum((2, 3), keepdim=True)
    plain = tsmp._msda_patch_sel_plain(value, SPLIT_SHAPES, loc, attw, heads,
                                       8, 8, 2)[0]
    rows, px, py, keep, a_s, bx, by = tsmp.msda_sel_windows(
        SPLIT_SHAPES.total, SPLIT_SHAPES, loc, attw, 8, 8, 2)
    w = tsmp._window_weights(px, py, keep, a_s, bx, by, 8, 8)
    w = w.reshape(1, q, 2, heads, pts, 64).sum(4)
    patch = tsmp._take_rows(value.reshape(-1, c), rows).reshape(
        1, q, 2, 64, c)
    return plain, w, patch


def _split3(w):
    hi = w.bfloat16().float()
    mid = (w - hi).bfloat16().float()
    return hi, mid, (w - hi - mid).bfloat16().float()


def test_three_part_weight_split_is_exact(main_path_window):
    _, w, _ = main_path_window
    hi, mid, lo = _split3(w)
    assert w.abs().max() > 0 and (w != hi).any()  # the parts are needed
    assert torch.equal(hi + mid + lo, w)


def test_split_contraction_keeps_the_fp32_function(main_path_window):
    """The tensor-core route in torch: three products of the bf16 weight
    parts with the bf16 window pixels (each exact in fp32), summed."""
    plain, w, patch = main_path_window
    got = sum(torch.einsum("bqkhe,bqkec->bqhc", part, patch.float())
              for part in _split3(w))
    scale = max(plain.abs().max().item(), 1.0)
    assert (got - plain).abs().max().item() <= 1e-6 * scale
