"""The launch planner of the bf16 tensor-core kernels (K2, K3, K4 in
csrc/conv_tc.cu): every shape the repo's configs run gets a plan that
fits shared memory, meets the kernels' alignment rules and launches the
blocks PERF.md lists; bf16 shapes outside the rules raise ValueError.

The kernels themselves run only on the card; chip_smoke.py holds them
to their plain versions there at every main-path shape.
"""
import pytest
import torch

from simpb_tpu_torch.ops import _kernels
from simpb_tpu_torch.ops import conv_fused as cf

torch.set_num_threads(1)

# ResNet stages: (mid channels, channels, stride of the map vs the input)
STAGES = ((64, 256, 4), (128, 512, 8), (256, 1024, 16), (512, 2048, 32))
# (config, W, H, cameras): the inputs of the configs the repo runs
INPUTS = (("r50_704x256", 704, 256, 6), ("r101_1408x512", 1408, 512, 6),
          ("tiny", 64, 32, 6))


def _shapes():
    """(config, B, H, W, C, Cm, Co, stride) of every K2 call (each stage
    head, on the previous stage's map: stride 1 for the first, 2 after),
    (config, B, H, W, C, Cm) of every K3 call and (config, B, H, W, 256)
    of every K4 call (the FPN's outputs are 256 wide)."""
    k2, k3, k4 = [], [], []
    for name, w, h, cams in INPUTS:
        cin, prev = 64, 4
        for cm, c, s in STAGES:
            k2.append((name, cams, -(-h // prev), -(-w // prev), cin, cm, c,
                       s // prev))
            k3.append((name, cams, -(-h // s), -(-w // s), c, cm))
            k4.append((name, cams, -(-h // s), -(-w // s), 256))
            cin, prev = c, s
    return k2, k3, k4


K2_SHAPES, K3_SHAPES, K4_SHAPES = _shapes()
# blocks per launch at the main path's shapes (PERF.md section 6): K2 by
# mid channels, K3 and K4 by map height
MAIN_K2_BLOCKS = {64: 264, 128: 264, 256: 144, 512: 72}
MAIN_K3_BLOCKS = {64: 264, 32: 132, 16: 72, 8: 36}
MAIN_K4_BLOCKS = {64: 528, 32: 132, 16: 72, 8: 72}


def _check_pass(mt, wm, n):
    bm, bn = cf.tc_pass_shape(mt, wm)
    assert wm in (1, 2, 4, 8) and bm == 16 * mt * wm
    assert bn * wm == 64 * cf.TC_WARPS and n % bn == 0


@pytest.mark.parametrize("shape", K2_SHAPES,
                         ids=lambda s: f"{s[0]}-{s[5]}-s{s[7]}")
def test_bottleneck_down_plan(shape):
    name, b, h, w, c, cm, co, stride = shape
    plan = cf.plan_bottleneck_down_tc(b, h, w, c, cm, co, stride)
    assert plan.smem <= _kernels.MAX_SMEM
    assert plan.mt in cf.TC_MT_DOWN and plan.bk in cf.TC_BK
    assert len(plan.wm) == 3 and plan.tw % 8 == 0
    # the reduce and the 3x3 are Cm wide, the expansion and skip Co
    for wm, n in zip(plan.wm, (cm, cm, co)):
        _check_pass(plan.mt, wm, n)
    assert c % plan.bk == 0 and cm % plan.bk == 0
    oh, ow = h // stride, w // stride
    assert plan.blocks == -(-oh // plan.th) * -(-ow // plan.tw) * b
    if name == "r50_704x256":
        assert plan.blocks == MAIN_K2_BLOCKS[cm]


@pytest.mark.parametrize("shape", K3_SHAPES, ids=lambda s: f"{s[0]}-{s[4]}")
def test_bottleneck_plan(shape):
    name, b, h, w, c, cm = shape
    plan = cf.plan_bottleneck_tc(b, h, w, c, cm)
    assert plan.smem <= _kernels.MAX_SMEM
    assert plan.mt in cf.TC_MT and plan.bk in cf.TC_BK
    assert len(plan.wm) == 3
    # tiles 8 or 16 wide: the 8 rows of an ldmatrix are 8 neighbouring
    # pixels of one tile row, 16 B apart modulo 128 (conflict-free)
    assert plan.tw % 8 == 0
    for wm, n in zip(plan.wm, (cm, cm, c)):
        _check_pass(plan.mt, wm, n)
    assert c % plan.bk == 0 and cm % plan.bk == 0
    assert plan.blocks == -(-h // plan.th) * -(-w // plan.tw) * b
    if name == "r50_704x256":
        assert plan.blocks == MAIN_K3_BLOCKS[h]


@pytest.mark.parametrize("shape", K4_SHAPES, ids=lambda s: f"{s[0]}-{s[2]}")
def test_conv3x3_plan(shape):
    name, b, h, w, c = shape
    plan = cf.plan_conv3x3_tc(b, h, w, c, 256)
    assert plan.smem <= _kernels.MAX_SMEM
    assert plan.mt in cf.TC_MT and plan.bk in cf.TC_BK
    assert plan.tw % 8 == 0 and len(plan.wm) == 1
    _check_pass(plan.mt, plan.wm[0], 256)
    bn = cf.tc_pass_shape(plan.mt, plan.wm[0])[1]
    assert plan.blocks == -(-h // plan.th) * -(-w // plan.tw) * b * 256 // bn
    if name == "r50_704x256":
        assert plan.blocks == MAIN_K4_BLOCKS[h]


@pytest.mark.parametrize("c,cm", [(96, 64), (256, 48), (2048, 520)])
def test_bottleneck_plan_refuses_unaligned_channels(c, cm):
    with pytest.raises(ValueError, match="multiple of 64"):
        cf.plan_bottleneck_tc(6, 8, 22, c, cm)


@pytest.mark.parametrize("c,cm,co", [(96, 64, 256), (256, 48, 512),
                                     (512, 256, 1000)])
def test_bottleneck_down_plan_refuses_unaligned_channels(c, cm, co):
    with pytest.raises(ValueError, match="multiple of 64"):
        cf.plan_bottleneck_down_tc(6, 16, 44, c, cm, co, 2)


@pytest.mark.parametrize("h,w,stride", [(15, 44, 2), (16, 43, 2),
                                        (16, 44, 3)])
def test_bottleneck_down_plan_refuses_odd_maps_and_other_strides(h, w,
                                                                 stride):
    with pytest.raises(ValueError, match="divisible by it"):
        cf.plan_bottleneck_down_tc(6, h, w, 1024, 512, 2048, stride)


@pytest.mark.parametrize("c,co", [(200, 256), (256, 100)])
def test_conv3x3_plan_refuses_unaligned_channels(c, co):
    with pytest.raises(ValueError, match="multiple of 64"):
        cf.plan_conv3x3_tc(6, 8, 22, c, co)


def test_plans_refuse_what_shared_memory_cannot_hold():
    """A K4 input so wide that no halo tile fits in 227 KB."""
    with pytest.raises(ValueError, match="no bf16 tile fits"):
        cf.plan_conv3x3_tc(1, 8, 8, 8192, 256)
