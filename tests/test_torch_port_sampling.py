"""The sampling wrappers of the port on the CPU: `deformable_aggregation`
and `_msda_patch_sel` check their arguments as the CUDA kernels need
them, then on CPU tensors return their plain versions' result bit for
bit and launch nothing. The plain versions are held to the JAX package
in tests/test_torch_port_ops.py; the kernels are held to the plain
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
    assert tsmp.launch_counts() == {"deformable_aggregation": 0,
                                    "msda_patch_sel": 0}


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
