"""The head's 2D encoder (`models/encoder2d.py`) and its hook, against
JAX's `simpb_tpu/models/encoder2d.py` on the CPU: the sine encoding
exactly, the encoder and the decoder forward and their gradients at
1e-5, and (port only) the head's 2D cross-attention, and under
`share_encoder2d` DFA, reading the encoder's memory. The whole tiny head
with the encoder both ways and the decoupled attention off against JAX's
is a `slow` test (one JAX model compile a case)."""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpb_tpu.configs.base import simpb_tiny as jax_tiny
from simpb_tpu.models import encoder2d as jenc
from simpb_tpu.models.detector import SimPB as JaxSimPB
from simpb_tpu.ops.format import SpatialShapes as JaxShapes
from simpb_tpu_torch.configs.base import simpb_tiny
from simpb_tpu_torch.models import encoder2d as tenc
from simpb_tpu_torch.models.layers import Dense
from simpb_tpu_torch.ops.format import SpatialShapes
from simpb_tpu_torch.utils.convert import from_jax_variables, state_from_jax
from simpb_tpu_torch.utils.synthetic import synthetic_rig
from test_torch_port_slice import random_jax_variables

SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))
N = sum(h * w for h, w in SHAPES)
TOL = 1e-5
KW = dict(embed_dims=32, num_heads=4, num_levels=4, num_points=2,
          feedforward_channels=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol=TOL, msg=""):
    """|got - want| <= tol * max(max |want|, 1), elementwise."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    bound = tol * max(np.abs(want).max(), 1.0)
    assert got.shape == want.shape, msg
    assert np.abs(got - want).max() <= bound, (
        msg, np.abs(got - want).max(), bound)


def _grads(module, loss):
    module.zero_grad()
    loss.backward()
    return {k: p.grad for k, p in module.named_parameters()}


def _want_grads(module, jgrads):
    """JAX's gradient tree in the port's names and layouts."""
    return state_from_jax(module, {"params": jgrads}, unused_ok=None)


@pytest.mark.parametrize("h,w,f", [(8, 16, 16), (5, 7, 128), (1, 2, 16)])
def test_sine_encoding_exact(h, w, f):
    np.testing.assert_array_equal(tenc.sine_positional_encoding(h, w, f),
                                  jenc.sine_positional_encoding(h, w, f))


def test_packed_pos_and_refs_exact():
    for a, b in zip(tenc._packed_pos_and_refs(SpatialShapes(SHAPES), 16),
                    jenc._packed_pos_and_refs(JaxShapes(SHAPES), 16)):
        np.testing.assert_array_equal(a, b)


def test_encoder_forward_and_grad_match_jax():
    """Two encoder layers on [2, 3, ΣHW, 32] features: the output and the
    gradients of sum(out ** 2) to every parameter and to the features,
    within 1e-5 of each's largest value."""
    enc = jenc.DeformableEncoder2D(num_layers=2, **KW)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 3, N, 32)).astype(np.float32)
    ss = JaxShapes(SHAPES)
    params = random_jax_variables(jax.eval_shape(
        lambda: enc.init(jax.random.PRNGKey(0), jnp.asarray(feats), ss)))
    loss = lambda p, x: jnp.sum(enc.apply(p, x, ss) ** 2)
    jout = jax.jit(lambda p, x: enc.apply(p, x, ss))(params, feats)
    jg, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, feats)

    module = tenc.DeformableEncoder2D(num_layers=2, **KW)
    module.load_state_dict(state_from_jax(module, params, unused_ok=None),
                           strict=True)
    x = torch.from_numpy(feats).requires_grad_()
    out = module(x, SpatialShapes(SHAPES))
    _close(out, jout, msg="output")
    got = _grads(module, (out ** 2).sum())
    for k, want in _want_grads(module, jg["params"]).items():
        _close(got[k], want.numpy(), msg=k)
    _close(x.grad, jgx, msg="features")


def test_decoder_forward_and_grad_match_jax():
    """Three decoder layers with reference-point refinement through a
    regression branch: the stacked outputs and reference points, and the
    gradients of sum(outputs ** 2) to the decoder's parameters, within
    1e-5."""
    dec = jenc.DeformableDecoder2D(num_layers=3, **KW)
    reg = fnn.Dense(2)
    rng = np.random.default_rng(1)
    mem = rng.normal(size=(2, N, 32)).astype(np.float32)
    q = rng.normal(size=(2, 5, 32)).astype(np.float32)
    refs = (1 / (1 + np.exp(-rng.normal(size=(2, 5, 2))))).astype(np.float32)
    ss = JaxShapes(SHAPES)
    reg_p = random_jax_variables(jax.eval_shape(
        lambda: reg.init(jax.random.PRNGKey(1), jnp.asarray(q))), seed=2)
    bound = lambda x: reg.apply(reg_p, x)
    params = random_jax_variables(jax.eval_shape(
        lambda: dec.init(jax.random.PRNGKey(2), q, None, refs, mem, ss,
                         reg_branch=bound)), seed=3)
    apply = lambda p: dec.apply(p, q, None, refs, mem, ss, reg_branch=bound)
    jinter, jrefs = jax.jit(apply)(params)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(apply(p)[0] ** 2)))(params)

    module = tenc.DeformableDecoder2D(num_layers=3, **KW)
    module.load_state_dict(state_from_jax(module, params, unused_ok=None),
                           strict=True)
    head = Dense(32, 2)
    head.load_state_dict(state_from_jax(head, reg_p, unused_ok=None))
    inter, trefs = module(torch.from_numpy(q), None, torch.from_numpy(refs),
                          torch.from_numpy(mem), SpatialShapes(SHAPES),
                          reg_branch=head)
    _close(inter, jinter, msg="outputs")
    _close(trefs, jrefs, msg="reference points")
    got = _grads(module, (inter ** 2).sum())
    for k, want in _want_grads(module, jg["params"]).items():
        _close(got[k], want.numpy(), msg=k)


def test_msda_attention_reference_rank_equivalence():
    """[Q, 2] reference points shared across the batch act as the tiled
    [B, Q, 2] form."""
    attn = tenc.MSDAAttention(32, 4, 4, 2)
    g = torch.Generator().manual_seed(0)
    query = torch.randn(3, 10, 32, generator=g)
    value = torch.randn(3, N, 32, generator=g)
    refs = torch.rand(10, 2, generator=g)
    with torch.no_grad():
        attn.sampling_offsets.weight.normal_(0, 0.1, generator=g)
        a = attn(query, None, refs, value, SpatialShapes(SHAPES))
        b = attn(query, None, refs[None].expand(3, 10, 2), value,
                 SpatialShapes(SHAPES))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("share", [False, True], ids=["unshared", "shared"])
def test_head_reads_encoder_memory(share):
    """The tiny head with one encoder layer: every 2D cross-attention
    samples the encoder's output, and DFA the raw column (or, under
    `share_encoder2d`, the encoder's output); the encoder runs once a
    frame; with the decoupled attention off no fc_before / fc_after
    exists."""
    from simpb_tpu_torch.training.evaluate import build_model

    cfg = simpb_tiny()
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, encoder2d_layers=1, share_encoder2d=share,
        decouple_attn=share, decouple_attn2d=share))
    model = build_model(cfg, device="cpu", seed=0)
    head = model.head
    memory, msda_values, dfa_cols = [], [], []
    head.encoder2d.register_forward_hook(
        lambda m, a, out: memory.append(out))
    for name in head.op_names:
        if name and name.endswith("qg_cross_attn"):
            getattr(head, name).register_forward_pre_hook(
                lambda m, a: msda_values.append(a[4]))
        if name and name.endswith("deformable"):
            getattr(head, name).register_forward_pre_hook(
                lambda m, a: dfa_cols.append(a[3]))
    w, h = cfg.input_size
    img = torch.randn(1, 6, h, w, 3, generator=torch.Generator()
                      .manual_seed(0))
    model(img, torch.from_numpy(synthetic_rig(1, (w, h))))
    assert len(memory) == 1 and len(msda_values) == 3 and len(dfa_cols) == 3
    assert all(v is memory[0] for v in msda_values)
    assert all((c is memory[0]) == share for c in dfa_cols)
    assert hasattr(head, "fc_before") == share
    assert hasattr(head, "fc_before2d") == share


@pytest.mark.slow
@pytest.mark.parametrize("share", [False, True], ids=["unshared", "shared"])
def test_head_with_encoder_matches_jax(share):
    """JAX's tiny model with one encoder layer (tests/test_encoder2d.py's
    setting) and the decoupled attention off, one cold frame: every
    decoder layer's outputs within 5e-4 (one JAX model compile)."""
    from simpb_tpu_torch.models.detector import SimPB

    def knobs(cfg):
        return dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, encoder2d_layers=1, share_encoder2d=share,
            decouple_attn=False, decouple_attn2d=False))

    jcfg, tcfg = knobs(jax_tiny()), knobs(simpb_tiny())
    w, h = tcfg.input_size
    img = np.random.default_rng(4).normal(size=(1, 6, h, w, 3)).astype(
        np.float32)
    proj = synthetic_rig(1, (w, h))
    jmodel = JaxSimPB(jcfg)
    variables = random_jax_variables(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img),
                            jnp.asarray(proj), train=False)))
    jo = jax.jit(lambda v: jmodel.apply(v, img, proj, train=False))(
        variables)
    tmodel = SimPB(tcfg)
    tmodel.load_state_dict(from_jax_variables(variables, tcfg), strict=True)
    to = tmodel.eval()(torch.from_numpy(img), torch.from_numpy(proj))
    for key in ("prediction", "classification", "quality", "prediction2d",
                "classification2d"):
        for j, t in zip(jo[key], to[key]):
            if t is not None:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           atol=5e-4, rtol=1e-3,
                                           err_msg=key)
