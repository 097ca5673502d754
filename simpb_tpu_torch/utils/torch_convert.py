"""Reference torch checkpoint -> the port's state dict.

The released SimPB checkpoints are plain torch `state_dict`s over the
mmdet plugin's module tree. `load_torch_checkpoint` reads one and gives
the state dict of the port's `SimPB`, in two steps:

1. the port's own copy of the JAX package's numpy mapping
   (`simpb_tpu/utils/torch_convert.py`: `build_mapping`,
   `torch_to_flax`, `merge_params`) turns the mmdet names and layouts
   into the JAX package's `{"params", "batch_stats"}` tree, merged over
   the model's own values, so that keys the checkpoint lacks keep them;
2. `utils/convert.py::from_jax_variables` turns that tree into the
   port's names and layouts (the training tree for a training model).

`load_pretrained_backbone` does the same for an ImageNet ResNet `.pth`,
taking only the backbone.

The mapping covers the backbone (torchvision/mmdet ResNet naming), the
FPN and every decoder op of the head, including decoupled-attention
projections, mmcv `nn.MultiheadAttention` in_proj splitting,
MLP-stack Sequential indices and the `Scale` wrappers. Transforms:
Linear [out,in] -> kernel [in,out]; Conv [out,in,kh,kw] ->
[kh,kw,in,out]; BN running stats -> batch_stats; in_proj_weight [3E,E]
-> separate q/k/v kernels.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..models.backbone import RESNET_STAGE_BLOCKS


def _mlp_pairs(prefix_t: str, prefix_f: List[str], in_loops: int,
               out_loops: int):
    """linear_relu_ln Sequential index mapping -> (fcK, lnK) names."""
    out = []
    t_idx = 0
    fc = 0
    for _ in range(out_loops):
        for _ in range(in_loops):
            out.append((f"{prefix_t}.{t_idx}", prefix_f + [f"fc{fc}"], "linear"))
            t_idx += 2  # Linear, ReLU
            fc += 1
        out.append((f"{prefix_t}.{t_idx}", prefix_f + [f"ln{fc - 1}"], "ln"))
        t_idx += 1
    return out


def _mha(prefix_t: str, prefix_f: List[str]):
    return [(f"{prefix_t}", prefix_f, "mha")]


def build_mapping(cfg: ModelConfig) -> List[Tuple[str, List[str], str]]:
    """(torch_prefix, flax_path, kind) triples covering the whole model."""
    m: List[Tuple[str, List[str], str]] = []
    # ---------------- backbone ----------------
    m.append(("img_backbone.conv1", ["img_backbone", "conv1"], "conv"))
    m.append(("img_backbone.bn1", ["img_backbone", "bn1"], "bn"))
    for stage, blocks in enumerate(RESNET_STAGE_BLOCKS[cfg.backbone_depth]):
        for i in range(blocks):
            t = f"img_backbone.layer{stage + 1}.{i}"
            f = ["img_backbone", f"layer{stage + 1}_{i}"]
            for c in ("conv1", "conv2", "conv3"):
                m.append((f"{t}.{c}", f + [c], "conv"))
            for b in ("bn1", "bn2", "bn3"):
                m.append((f"{t}.{b}", f + [b], "bn"))
            if i == 0:
                m.append((f"{t}.downsample.0", f + ["downsample_conv"], "conv"))
                m.append((f"{t}.downsample.1", f + ["downsample_bn"], "bn"))
    # ---------------- neck ----------------
    for i in range(4):
        m.append(
            (f"img_neck.lateral_convs.{i}.conv",
             ["img_neck", f"lateral_{i}"], "convb")
        )
        m.append(
            (f"img_neck.fpn_convs.{i}.conv", ["img_neck", f"fpn_{i}"], "convb")
        )
    # ---------------- depth branch ----------------
    for i in range(cfg.num_depth_layers):
        m.append(
            (f"depth_branch.depth_layers.{i}",
             ["depth_branch", f"depth_layer_{i}"], "convb")
        )
    # ---------------- head ----------------
    h = cfg.head
    m.append(("head.instance_bank.anchor", ["head", "anchor"], "raw"))
    m.append(
        ("head.instance_bank.instance_feature",
         ["head", "instance_feature"], "raw")
    )
    for name in ("fc_before", "fc_after", "fc_before2d", "fc_after2d"):
        m.append((f"head.{name}", ["head", name], "linear_nobias"))
    # anchor encoders
    for comp in ("pos_fc", "size_fc", "yaw_fc", "vel_fc"):
        m += _mlp_pairs(
            f"head.anchor_encoder.{comp}",
            ["head", "anchor_encoder", comp], 1, 4,
        )
    m += _mlp_pairs(
        "head.anchor_encoder2d.query_embeddings2d",
        ["head", "anchor_encoder2d", "query_embeddings2d"], 1, 2,
    )
    # decoder ops
    for i, op in enumerate(h.operation_order):
        t = f"head.layers.{i}"
        if op == "norm":
            m.append((t, ["head", f"op{i}_norm"], "ln"))
        elif op == "ffn":
            f = ["head", f"op{i}_ffn"]
            m.append((f"{t}.pre_norm", f + ["pre_norm"], "ln"))
            m.append((f"{t}.layers.0.0", f + ["fc1"], "linear"))
            m.append((f"{t}.layers.1", f + ["fc2"], "linear"))
            m.append((f"{t}.identity_fc", f + ["identity_fc"], "linear"))
        elif op in ("gnn", "temp_gnn"):
            m += _mha(f"{t}.attn", ["head", f"op{i}_{op}", "attn"])
        elif op == "qg_self_attn":
            m += _mha(f"{t}.attn", ["head", f"op{i}_qg_self_attn", "attn"])
        elif op == "qg_cross_attn":
            f = ["head", f"op{i}_qg_cross_attn"]
            for lin in ("sampling_offsets", "attention_weights",
                        "value_proj", "output_proj"):
                m.append((f"{t}.{lin}", f + [lin], "linear"))
        elif op == "deformable":
            f = ["head", f"op{i}_deformable"]
            m += _mlp_pairs(f"{t}.camera_encoder", f + ["camera_encoder"], 1, 2)
            m.append((f"{t}.weights_fc", f + ["weights_fc"], "linear"))
            m.append((f"{t}.output_proj", f + ["output_proj"], "linear"))
            m.append(
                (f"{t}.kps_generator.learnable_fc",
                 f + ["kps_generator", "learnable_fc"], "linear")
            )
        elif op == "refine3d":
            f = ["head", f"op{i}_refine3d"]
            m += _mlp_pairs(f"{t}.layers", f + ["layers"], 2, 2)
            m.append((f"{t}.layers.10", f + ["out_fc"], "linear"))
            m.append((f"{t}.layers.11", f + ["scale"], "scale"))
            m += _mlp_pairs(f"{t}.cls_layers", f + ["cls_layers"], 1, 2)
            m.append((f"{t}.cls_layers.6", f + ["cls_fc"], "linear"))
            m += _mlp_pairs(f"{t}.quality_layers", f + ["quality_layers"], 1, 2)
            m.append((f"{t}.quality_layers.6", f + ["quality_fc"], "linear"))
        elif op == "refine2d":
            f = ["head", f"op{i}_refine2d"]
            m += _mlp_pairs(f"{t}.layers", f + ["layers"], 2, 2)
            m.append((f"{t}.layers.10", f + ["out_fc"], "linear"))
            m.append((f"{t}.layers.11", f + ["scale"], "scale"))
            m += _mlp_pairs(f"{t}.cls_layers", f + ["cls_layers"], 1, 2)
            m.append((f"{t}.cls_layers.6", f + ["cls_fc"], "linear"))
            m += _mlp_pairs(f"{t}.alpha_layers", f + ["alpha_layers"], 1, 2)
            m.append((f"{t}.alpha_layers.6", f + ["alpha_fc"], "linear"))
            m.append((f"{t}.alpha_layers.7", f + ["alpha_scale"], "scale"))
        elif op == "aggregation":
            f = ["head", f"op{i}_aggregation_attn"]
            m += _mha(f"{t}.self_attn.attn", f + ["attn"])
            fr = ["head", f"op{i}_reweight"]
            m.append((f"{t}.reweight.reduce.0", fr + ["reduce"], "linear"))
            m.append((f"{t}.reweight.alpha.0", fr + ["alpha"], "linear"))
        elif op == "allocation":
            pass
    return m


def _set(tree: Dict, path: List[str], leaf: str, value: np.ndarray):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = value


def torch_to_flax(
    state_dict: Dict[str, np.ndarray], cfg: ModelConfig
) -> Tuple[Dict, Dict]:
    """Torch state_dict (numpy values) -> (params, batch_stats) trees.

    Unknown torch keys are ignored; missing keys simply stay absent so
    the caller can merge over the model's own values.
    """
    params: Dict = {}
    stats: Dict = {}
    sd = state_dict
    for t, f, kind in build_mapping(cfg):
        if kind == "conv" and f"{t}.weight" in sd:
            _set(params, f, "kernel", np.transpose(sd[f"{t}.weight"], (2, 3, 1, 0)))
        elif kind == "convb" and f"{t}.weight" in sd:
            _set(params, f, "kernel", np.transpose(sd[f"{t}.weight"], (2, 3, 1, 0)))
            if f"{t}.bias" in sd:
                _set(params, f, "bias", sd[f"{t}.bias"])
        elif kind == "bn" and f"{t}.weight" in sd:
            _set(params, f, "scale", sd[f"{t}.weight"])
            _set(params, f, "bias", sd[f"{t}.bias"])
            _set(stats, f, "mean", sd[f"{t}.running_mean"])
            _set(stats, f, "var", sd[f"{t}.running_var"])
        elif kind == "linear" and f"{t}.weight" in sd:
            _set(params, f, "kernel", sd[f"{t}.weight"].T)
            if f"{t}.bias" in sd:
                _set(params, f, "bias", sd[f"{t}.bias"])
        elif kind == "linear_nobias" and f"{t}.weight" in sd:
            _set(params, f, "kernel", sd[f"{t}.weight"].T)
        elif kind == "ln" and f"{t}.weight" in sd:
            _set(params, f, "scale", sd[f"{t}.weight"])
            _set(params, f, "bias", sd[f"{t}.bias"])
        elif kind == "scale" and f"{t}.scale" in sd:
            _set(params, f, "scale", sd[f"{t}.scale"])
        elif kind == "raw" and t in sd:
            _set(params, f[:-1], f[-1], sd[t])
        elif kind == "mha" and f"{t}.in_proj_weight" in sd:
            w = sd[f"{t}.in_proj_weight"]
            b = sd[f"{t}.in_proj_bias"]
            e = w.shape[0] // 3
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                _set(params, f + [name], "kernel", w[j * e : (j + 1) * e].T)
                _set(params, f + [name], "bias", b[j * e : (j + 1) * e])
            _set(params, f + ["out_proj"], "kernel", sd[f"{t}.out_proj.weight"].T)
            _set(params, f + ["out_proj"], "bias", sd[f"{t}.out_proj.bias"])
    return params, stats


def merge_params(base: Dict, loaded: Dict) -> Dict:
    """Overlay loaded leaves onto a randomly-initialised tree, keeping
    base leaves where the checkpoint has none."""
    out = dict(base)
    for k, v in loaded.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            out[k] = merge_params(base[k], v)
        else:
            base_leaf = base.get(k)
            if base_leaf is not None and hasattr(base_leaf, "shape") and \
                    tuple(base_leaf.shape) != tuple(v.shape):
                raise ValueError(
                    f"shape mismatch for {k}: {base_leaf.shape} vs {v.shape}"
                )
            out[k] = v
    return out


def _state_over(model, cfg: ModelConfig, params: Dict, stats: Dict):
    """`model`'s state dict with the given JAX-layout leaves merged over
    its own values (a training model, one with the depth branch, takes
    the training tree)."""
    from .convert import from_jax_variables, to_jax_variables

    base = to_jax_variables(model)
    variables = {
        "params": merge_params(base["params"], params),
        "batch_stats": merge_params(base.get("batch_stats", {}), stats),
    }
    return from_jax_variables(variables, cfg,
                              train=hasattr(model, "depth_branch"))


def load_torch_checkpoint(path: str, cfg: ModelConfig, model=None):
    """The state dict of `model` (a freshly built `SimPB(cfg)` when
    None) from a reference torch `.pth`.

    Leaves the checkpoint lacks keep `model`'s values, as `merge_params`
    keeps the initialised leaves in the JAX package. A training model
    (`SimPB(cfg, train=True)`, `--load-from` of the training CLI) takes
    the checkpoint's depth branch and every layer's class and quality
    branches too. A leaf whose shape differs from the model's (another
    layout) is refused with ValueError, and so is a file in which no
    SimPB parameter is recognised."""
    import torch

    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    params, stats = torch_to_flax(sd, cfg)
    if not params:
        raise ValueError(
            f"no SimPB parameters recognised in {path} (found keys like "
            f"{list(sd)[:3]})"
        )
    if model is None:
        from ..models.detector import SimPB

        model = SimPB(cfg)
    return _state_over(model, cfg, params, stats)


def load_pretrained_backbone(path: str, cfg: ModelConfig, model):
    """The state dict of `model` with its backbone taken from an
    ImageNet-pretrained ResNet `.pth` (the reference's
    `pretrained='torchvision://resnet50'`, config:85); everything else
    keeps `model`'s values.

    Accepts the three naming layouts a user actually has: plain
    torchvision `resnet50/101` state dicts (`conv1.weight`,
    `layer1.0.conv1.weight`, ...), mmcv/mmdet detector checkpoints
    (`backbone.layer1...`, e.g. the nuImages-pretrained weights the
    reference's uimg config starts from, config:84 `load_from`), and
    already-prefixed `img_backbone.*` keys. Classifier heads
    (`fc.weight` etc.) and non-backbone branches are ignored by the
    mapping; a file with no backbone parameter raises ValueError."""
    import torch

    ckpt = torch.load(path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    renamed = {}
    for k, v in sd.items():
        if not hasattr(v, "numpy"):
            continue
        # DataParallel / EMA wrappers first, then the detector prefix
        for wrapper in ("module.", "model.", "ema."):
            if k.startswith(wrapper):
                k = k[len(wrapper):]
        for prefix in ("img_backbone.", "backbone.", ""):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        renamed[f"img_backbone.{k}"] = v.numpy()
    params, stats = torch_to_flax(renamed, cfg)

    def count(tree):
        return sum(
            count(v) if isinstance(v, dict) else 1 for v in tree.values()
        )

    if count(params) == 0:
        raise ValueError(
            f"no backbone parameters recognised in {path} — expected "
            "torchvision ResNet keys (conv1.weight, layer1.0...), an "
            "mmdet detector (backbone.*), or img_backbone.* "
            f"(found keys like {list(sd)[:3]})"
        )
    return _state_over(model, cfg, params, stats)
