"""Carry weights across from the JAX package: flax variables -> the port's
state_dict.

The port's modules use d2 parameter names, so this is the inverse of the JAX
package's d2 converter (``detectron2_tpu/checkpoint/d2_converter.py:49-330``).
This is the port's own copy of the part of that name mapping that the
R-CNN (FPN, C4, cascade, keypoint), ViTDet, RetinaNet, FCOS, RPN-only and
semantic / panoptic segmentation modules need, plus the layout transposes back to torch's, applied to leaves
named ``kernel`` (and a deformable conv's ``conv2_kernel``) only:

- flax conv kernel HWIO -> torch OIHW;
- flax ConvTranspose kernel HWIO -> torch IOHW, spatially flipped (torch
  applies a transposed kernel flipped relative to flax);
- flax Dense kernel ``[in, out]`` -> torch Linear ``[out, in]``.

Every other leaf goes across unchanged: biases and norm vectors, and the
tables that are no linear map, a ViT's ``rel_pos_h`` / ``rel_pos_w``
``[2S-1, head_dim]`` and ``pos_embed`` ``[1, N, D]``. The ``meters``
collection's ``loss_normalizer`` (a dense detector's EMA) becomes the
model's buffer of that name, and the ``buffers`` collection's CSE feature
tables the embedders' ``features``: the JAX ``cse_embedder/embedder_<mesh>``
is d2's ``embedder.<mesh>``.

A dense head's towers are flax scopes ``cls_subnet{i}`` / ``bbox_subnet{i}``
(conv, optional ``norm``); d2 holds each tower in one ``nn.Sequential`` of
conv, (norm) and ReLU, so conv ``i`` is index ``2i``, or ``3i`` and its norm
``3i + 1`` when the towers have norms (d2_converter.py:310-323, 394-406).
The sem-seg head's (and the DensePose decoder's) ``{p}_conv{k}`` is d2's
``{p}.{2k}``: each level is one ``nn.Sequential`` of conv and upsample
steps. The DensePose DeepLab head's ``convs_{i}_{j}`` and ``project_0`` are
d2's ``ASPP.convs.{i}.{j}`` and ``ASPP.project.0``.

A DeformBottleneckBlock's deformable-conv kernel is the leaf
``conv2_kernel`` of its block (HWIO, d2's ``conv2.weight``) and its norm the
scope ``conv2_norm`` (d2's ``conv2.norm``); ``conv2_offset`` is a plain conv
(d2_converter.py:60-63, 266-268).

The hierarchical backbones (d2_converter.py:104-170, 270-274): Swin's
``stage{i}_block{d}`` is ``layers.{i}.blocks.{d}``, ``merge{i}``
``layers.{i}.downsample``, ``out_norm{i}`` ``norm{i}``, ``patch_norm``
``patch_embed.norm`` and ``mlp_fc{k}`` (Swin and MViT) ``mlp.fc{k}``.
RegNet's ``s{i}_b{j}`` is ``s{i}.b{j + 1}``, a block's ``a`` / ``b`` / ``c``
/ ``se`` sit under ``f``, ``f_ex_{k}`` is ``f_ex.{k}``, and d2 keeps the
transform's norms as siblings (``f.a_bn``), the shortcut's as ``bn`` and
the stem's as ``stem.bn`` beside ``stem.conv``. MViT's scopes (``pool_q``,
``norm_q``, ``scale{n}_norm``) are d2's names already; its depthwise pool
kernels ``[k, k, 1, hd]`` go to ``[hd, 1, k, k]`` as every conv does.

PointRend (d2_converter.py:172-183, 293-305): the JAX coarse mask head's
scope ``roi_heads/mask_head`` (``reduce_*_conv``, ``fc{k}``,
``prediction``) is d2's ``roi_heads.mask_head.coarse_head``, and
``roi_heads/point_head`` / ``roi_heads/parameter_head`` (with the Implicit
point head's buffer ``positional_encoding_gaussian_matrix``) sit under
d2's ``roi_heads.mask_head``; a point head's Dense kernel ``[in, out]`` is
d2's ``Conv1d`` weight ``[out, in, 1]``. The semantic head's
``sem_seg_head/coarse_head`` is d2's ``sem_seg_head.coarse_sem_seg_head``.

HRNet and HRFPN (d2_converter.py:206-217): ``layer1_0``,
``transition2_2_0_0``, ``stage3_1``, ``branches_0_0``, ``fuse_layers_0_1_0``,
``downsample_1``, ``interp_conv_3_0``, ``reduction_pooling_conv_2_1`` and
``fpn_conv_4`` are d2's dotted ModuleList / Sequential paths; their named
BNs are d2's BN modules (no ``.norm`` child). HRFPN's ``interp_conv_{i}_0``
is a ConvTranspose, flipped and transposed as above.
"""

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["convert_jax_params", "flax_path_to_d2_name"]

# flax auto-named wrapper scopes that merge into their parent
_MERGE = ("Conv_", "ConvTranspose_", "Dense_")
# flax auto-named norm scopes, which are d2's ".norm" child
_NORMS = ("FrozenBatchNorm2d_", "GroupNorm_", "LayerNorm_", "SyncBatchNorm_", "BatchNorm_")
_COLLECTIONS = ("params", "batch_stats", "meters", "buffers")
_LEAF = {"kernel": "weight", "conv2_kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
# SimpleFeaturePyramid: d2 names each scale's stage simfp_{2 + idx} and its
# layers by their nn.Sequential index, for the scale factors (4, 2, 1, 0.5)
_SIMFP_SEQ = (
    {"up4_deconv1": 0, "up4_norm": 1, "up4_deconv2": 3, "lateral": 4, "output": 5},
    {"up2_deconv": 0, "lateral": 1, "output": 2},
    {"lateral": 0, "output": 1},
    {"lateral": 1, "output": 2},  # the max pool sits at index 0
)
_SIMFP_RE = re.compile(r"(up4_deconv1|up4_norm|up4_deconv2|up2_deconv|lateral|output)_(\d+)")
_TOWER_RE = re.compile(r"(cls_subnet|bbox_subnet)(\d+)")
_SEM_SEG_RE = re.compile(r"(p\d+)_conv(\d+)")
_ASPP_RE = re.compile(r"convs_(\d+)_(\d+)")
_TOWER_NORM_RE = re.compile(r"(cls_subnet|bbox_subnet)\.(\d+)\.norm\.")
_SWIN_BLOCK_RE = re.compile(r"stage(\d+)_block(\d+)")
_REGNET_BLOCK_RE = re.compile(r"s(\d+)_b(\d+)")
# HRNet / HRFPN: a scope is the d2 ModuleList / Sequential path with "_"
# for "." (d2_converter.py:206-217); the named BNs (``bn1``, ``..._1``)
# hold flax's BatchNorm_0, which is the d2 BN itself, not a ".norm" child
_HR_SEQ_RE = re.compile(
    r"(layer1|transition\d|stage\d|branches|fuse_layers|downsample|interp_conv|reduction_pooling_conv|fpn_conv)((?:_\d+)+)"
)
_HR_BN_RE = re.compile(r"bn\d|(downsample|fuse_layers|transition\d|interp_conv|reduction_pooling_conv)(_\d+)*_1")
# RegNet's norms: d2 keeps them beside their convs, not as their children
_REGNET_NORMS = (
    (re.compile(r"\.f\.([abc])\.norm\."), r".f.\1_bn."),
    (re.compile(r"(\.b\d+)\.proj\.norm\."), r"\1.bn."),
    (re.compile(r"(^|\.)stem\.weight$"), r"\1stem.conv.weight"),
    (re.compile(r"(^|\.)stem\.norm\."), r"\1stem.bn."),
)

# PointRend's heads: d2 nests them in roi_heads.mask_head
_POINT_REND = (
    (re.compile(r"(^|\.)roi_heads\.mask_head\.(reduce_channel_dim_conv|reduce_spatial_dim_conv|fc\d+|prediction)\."),
     r"\1roi_heads.mask_head.coarse_head.\2."),
    (re.compile(r"(^|\.)roi_heads\.(point_head|parameter_head)\."), r"\1roi_heads.mask_head.\2."),
)
_POINT_HEAD_DENSE = re.compile(r"point_head\.(fc\d+|predictor)\.weight$")


def flax_path_to_d2_name(path: Tuple[str, ...], tower_step: int = 2) -> str:
    """``('backbone', 'bottom_up', 'res2_0', 'conv1', 'Conv_0', 'kernel')`` ->
    ``'backbone.bottom_up.res2.0.conv1.weight'``. ``tower_step`` is a dense
    head tower's index step per conv: 2, or 3 when the towers have norms."""
    segs = []
    prev = None
    for seg in path[:-1]:
        if seg.startswith(_MERGE):
            pass
        elif seg.startswith(_NORMS):
            if _HR_BN_RE.fullmatch(prev or ""):
                pass
            elif not segs or segs[-1] != "norm":
                segs.append("norm")
        elif seg == "conv2_norm":
            segs.extend(["conv2", "norm"])
        elif seg == "head" and prev == "proposal_generator":
            segs.append("rpn_head")
        elif segs and segs[-1] == "rpn_head" and re.fullmatch(r"conv\d+", seg):
            segs.extend(["conv", seg])  # the multi-conv RPN head's nn.Sequential
        elif re.fullmatch(r"(res\d|box_head|box_predictor)_\d+", seg):
            # stage blocks (the C4 heads' res5_{b} too) and a cascade's
            # per-stage tuples: d2's ModuleList index
            segs.extend(seg.rsplit("_", 1))
        elif seg == "coarse_head" and prev == "sem_seg_head":
            segs.append("coarse_sem_seg_head")  # PointRend's coarse semantic head
        elif prev in ("sem_seg_head", "decoder", "coarse_head") and _SEM_SEG_RE.fullmatch(seg):
            # a sem-seg (or DensePose decoder) level's nn.Sequential: conv k
            # at index 2k (d2_converter.py:171-177)
            level, k = _SEM_SEG_RE.fullmatch(seg).groups()
            segs.extend([level, str(2 * int(k))])
        elif prev == "densepose_head" and _ASPP_RE.fullmatch(seg):
            # the DeepLab head's ASPP: Sequential-indexed convs and GNs (d2_converter.py:218-226)
            segs.extend(["ASPP", "convs", *_ASPP_RE.fullmatch(seg).groups()])
        elif prev == "densepose_head" and seg == "project_0":
            segs.extend(["ASPP", "project", "0"])
        elif seg == "cse_embedder":
            segs.append("embedder")  # d2's roi_heads.embedder
        elif prev == "cse_embedder" and seg.startswith("embedder_"):
            segs.append(seg[len("embedder_"):])  # one child a mesh, named by it
        elif _TOWER_RE.fullmatch(seg):
            kind, i = _TOWER_RE.fullmatch(seg).groups()
            segs.extend([kind, str(tower_step * int(i))])
        elif re.fullmatch(r"blocks_\d+", seg):
            segs.extend(seg.split("_"))  # a ViT's blocks are a ModuleList
        elif seg == "patch_embed":
            segs.extend(["patch_embed", "proj"])  # d2 wraps the conv in PatchEmbed
        elif seg == "patch_norm":
            segs.extend(["patch_embed", "norm"])
        elif _SWIN_BLOCK_RE.fullmatch(seg):
            i, d = _SWIN_BLOCK_RE.fullmatch(seg).groups()
            segs.extend(["layers", i, "blocks", d])
        elif re.fullmatch(r"merge\d+", seg):
            segs.extend(["layers", seg[len("merge"):], "downsample"])
        elif re.fullmatch(r"out_norm\d+", seg):
            segs.append("norm" + seg[len("out_norm"):])
        elif re.fullmatch(r"mlp_fc\d+", seg):
            segs.extend(["mlp", seg[len("mlp_"):]])
        elif _REGNET_BLOCK_RE.fullmatch(seg):
            i, j = _REGNET_BLOCK_RE.fullmatch(seg).groups()
            segs.extend([f"s{i}", f"b{int(j) + 1}"])
        elif seg in ("a", "b", "c", "se") and _REGNET_BLOCK_RE.fullmatch(prev or ""):
            segs.extend(["f", seg])
        elif re.fullmatch(r"f_ex_\d+", seg):
            segs.extend(["f_ex", seg[len("f_ex_"):]])
        elif _HR_SEQ_RE.fullmatch(seg):
            kind, idx = _HR_SEQ_RE.fullmatch(seg).groups()
            segs.extend([kind] + idx.strip("_").split("_"))
        elif _SIMFP_RE.fullmatch(seg):
            kind, idx = _SIMFP_RE.fullmatch(seg).groups()
            segs.extend([f"simfp_{int(idx) + 2}", str(_SIMFP_SEQ[int(idx)][kind])])
        else:
            segs.append(seg)
        prev = seg
    if path[-1] == "conv2_kernel":
        segs.append("conv2")
    name = ".".join(segs + [_LEAF.get(path[-1], path[-1])])
    for pattern, repl in _REGNET_NORMS + _POINT_REND:
        name = pattern.sub(repl, name)
    # a tower's norm is the Sequential entry after its conv
    return _TOWER_NORM_RE.sub(lambda m: f"{m.group(1)}.{int(m.group(2)) + 1}.", name)


def _flatten(tree: Mapping, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def convert_jax_params(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax variables of the JAX model (nested dicts of arrays) -> a state
    dict for the port's model with the same config: float64 arrays stay
    float64, every other array becomes float32."""
    state = {}
    flat = {tuple(p for p in path if p not in _COLLECTIONS): v for path, v in _flatten(variables).items()}
    normed = any("norm" in path and any(_TOWER_RE.fullmatch(p) for p in path) for path in flat)
    for path, value in flat.items():
        name = flax_path_to_d2_name(path, tower_step=3 if normed else 2)
        if path[-1] in ("kernel", "conv2_kernel") and value.ndim == 4:
            if any(p.startswith("ConvTranspose_") for p in path):
                value = value[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                value = value.transpose(3, 2, 0, 1)
        elif path[-1] == "kernel" and value.ndim == 2:
            value = value.T[..., None] if _POINT_HEAD_DENSE.search(name) else value.T
        dtype = np.float64 if value.dtype == np.float64 else np.float32
        # (ascontiguousarray would make a 0-d array, the loss normalizer, 1-d)
        state[name] = torch.tensor(np.ascontiguousarray(value, dtype=dtype).reshape(value.shape))
    return state
