"""The serving export on the CPU: the tiny config exported with
`torch.export`, loaded from its bytes in a process that never imports
the model code, two stream frames bit for bit the model's; the
artifact's signature and output keys against JAX's `example_inputs`
(shape structs: JAX traces, compiles nothing); and `torch.library.opcheck`
of every kernel op the artifact calls."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs.base import simpb_tiny as jax_tiny
from simpb_tpu.models.detector import SimPB as JaxSimPB
from simpb_tpu.utils import export as jax_export
from simpb_tpu_torch.configs.base import simpb_tiny
from simpb_tpu_torch.ops import conv_fused, sampling
from simpb_tpu_torch.ops.format import SpatialShapes
from simpb_tpu_torch.utils import export

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 2

# loads the artifact and serves FRAMES frames of the saved inputs, with
# nothing of simpb_tpu_torch.models imported
LOADER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from simpb_tpu_torch.utils.export import ServingModel
    art, inputs, outs = sys.argv[1:4]
    served = ServingModel.load(open(art, "rb").read())
    imgs, proj, dts, t2c = torch.load(inputs)
    state = served.init_temporal(*[int(a) for a in sys.argv[4:8]])
    got = []
    for img, dt in zip(imgs, dts):
        out = served(img, proj, dt, t2c, state)
        state = out["temporal"]
        got.append(out)
    torch.save(got, outs)
    print(sorted(m for m in sys.modules
                 if m.startswith("simpb_tpu_torch.models")))
""")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The tiny model's artifact, its frames in a fresh process and the
    model's own frames on the same inputs."""
    from simpb_tpu_torch.training.evaluate import build_model
    from simpb_tpu_torch.utils.synthetic import synthetic_rig

    torch.set_num_threads(1)
    cfg = simpb_tiny()
    hc = cfg.head
    model = build_model(cfg, device="cpu", seed=0)
    data = export.export_serving(cfg, model)
    d = tmp_path_factory.mktemp("export")
    (d / "tiny.pt2").write_bytes(data)
    w, h = cfg.input_size
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.normal(size=(1, 6, h, w, 3)).astype(
        np.float32)) for _ in range(FRAMES)]
    proj = torch.from_numpy(synthetic_rig(1, (w, h)))
    dts = [torch.full((1,), 5.0), torch.full((1,), 0.5)]
    t2c = torch.eye(4)[None]
    torch.save((imgs, proj, dts, t2c), d / "inputs.pt")
    sizes = (1, hc.num_temp_instances, hc.num_anchor, hc.embed_dims)
    proc = subprocess.run(
        [sys.executable, "-c", LOADER, str(d / "tiny.pt2"),
         str(d / "inputs.pt"), str(d / "outs.pt")] + [str(n) for n in sizes],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    step = export.make_serving_fn(cfg, model)
    state = export.init_temporal(*sizes)
    ref = []
    with torch.inference_mode():
        for img, dt in zip(imgs, dts):
            out = step(img, proj, dt, t2c, state)
            state = out["temporal"]
            ref.append(out)
    return dict(cfg=cfg, data=data, stdout=proc.stdout,
                got=torch.load(d / "outs.pt"), ref=ref)


def test_exported_frames_bit_identical(served):
    """Two stream frames (a cold stream's dt 5 s, then 0.5 s, the state
    threaded) through the loaded artifact equal the model's, every output
    and every state leaf bit for bit."""
    assert len(served["data"]) > 1_000_000
    for got, ref in zip(served["got"], served["ref"]):
        assert set(got) == set(ref)
        for k in ref:
            pairs = zip(got[k], ref[k]) if k == "temporal" else [(got[k],
                                                                 ref[k])]
            for a, b in pairs:
                assert a.dtype == b.dtype and torch.equal(a, b), k
    assert bool(served["got"][-1]["valid"].any())


def test_artifact_runs_without_model_code(served):
    """The loading process imported `simpb_tpu_torch.ops` (through
    utils/export.py) and no module of `simpb_tpu_torch.models`."""
    assert served["stdout"].strip().splitlines()[-1] == "[]"


def test_signature_matches_jax(served):
    """The artifact's inputs against JAX's `example_inputs` and its
    outputs against `jax.eval_shape` of JAX's serving function: the same
    keys, shapes and dtypes (the temporal state's 5-tuple in
    TEMPORAL_FIELDS order)."""
    cfg = served["cfg"]
    jcfg = jax_tiny()
    want = jax_export.example_inputs(jcfg)
    got = export.example_inputs(cfg)
    assert export.TEMPORAL_FIELDS == jax_export.TEMPORAL_FIELDS
    flat = lambda x: list(x[:4]) + list(x[4])
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in flat(got)] == [(tuple(s.shape), str(s.dtype))
                                    for s in flat(want)]
    model = JaxSimPB(jcfg)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
        ("params", "aug", "dropout", "sampling"))}
    variables = jax.eval_shape(lambda: model.init(
        rngs, jnp.zeros(want[0].shape), jnp.zeros(want[1].shape),
        train=False))
    jout = jax.eval_shape(
        lambda v, *a: jax_export.make_serving_fn(jcfg, v)(*a), variables,
        *want)
    out = served["got"][0]
    assert set(out) == set(jout)
    for k in jout:
        pairs = (zip(out[k], jout[k]) if k == "temporal"
                 else [(out[k], jout[k])])
        for t, s in pairs:
            assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (
                tuple(s.shape), str(s.dtype)), k


SS = SpatialShapes(((4, 6), (2, 4)))


def _op_cases():
    """(op, args) of every kernel op at small shapes on the CPU."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    u = lambda *s: torch.rand(s, generator=g)
    flat, total = SS.flat, SS.total
    c, q, heads, levels, points = 16, 3, 2, 2, 2
    loc6, attw5 = u(2, q, heads, levels, points, 2), u(2, q, heads, levels,
                                                       points)
    loc5 = u(2, q, levels, heads * points, 2)
    attw4 = u(2, q, levels, heads * points)
    return {
        "maxpool_3x3_s2": (conv_fused._maxpool_op, (r(1, 5, 6, 8),)),
        "bottleneck": (conv_fused._bottleneck_op, (
            r(1, 4, 4, 16), r(16, 8), r(8), r(3, 3, 8, 8), r(8), r(8, 16),
            r(16))),
        "bottleneck_down": (conv_fused._bottleneck_down_op, (
            r(1, 4, 4, 16), r(16, 8), r(8), r(3, 3, 8, 8), r(8), r(8, 32),
            r(32), r(16, 32), r(32), 2)),
        "conv3x3_bias": (conv_fused._conv3x3_op, (r(1, 4, 4, 8),
                                                  r(3, 3, 8, 16), r(16))),
        "deformable_aggregation": (sampling._dfa_op, (
            r(1, 2, total, c), u(1, 3, 2, 2, 2), u(1, 3, 2, 2, levels, 2),
            flat, 4)),
        "msda": (sampling._msda_op, (r(2, total, c), loc6, attw5, flat)),
        "msda_patch_sel": (sampling._msda_sel_op, (
            r(2, total, c), loc5, attw4, flat, heads, 2, 2, 1)),
        "msda_patch_levels": (sampling._msda_levels_op, (
            r(2, total, c), loc5, attw4, flat, heads, 2, 2)),
        "msda_hybrid_exact": (sampling._msda_hybrid_exact_op, (
            r(2, total, c), loc6, attw5, u(2, q, levels) > 0.5,
            r(2, q, heads, c), r(2, q, heads), flat)),
        "clamp_select": (sampling._clamp_select_op, (loc6, attw5, flat, 2, 2,
                                                     3)),
        "clamp_demand": (sampling._clamp_demand_op, (loc6, u(2, q) > 0.3,
                                                     flat, 2, 2)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_opcheck_every_op(name):
    """`torch.library.opcheck` (schema, fake implementation, autograd
    registration, AOT dispatch) of each kernel op on CPU tensors, where
    the op runs the plain version; the eleven ops are every launch the
    artifact can reach."""
    torch.set_num_threads(1)
    op, args = _op_cases()[name]
    assert str(op._qualname) == f"simpb::{name}"
    torch.library.opcheck(op, args)
