"""The port's ViT backbone and SimpleFeaturePyramid against the JAX package on
the same numpy inputs, float32 on the CPU, piece by piece and as a whole:
window partition, relative-position tables and factors in both layouts, the
position-table resize, LayerNorm, the backbone against the JAX module with
weights carried across by ``convert_jax_params`` (1e-4) and against the
reference's golden through the d2 names (2e-3, the tolerance of
``tests/parity/test_vitdet_backbone_golden.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from detectron2_tpu.layers.batch_norm import LayerNorm as JaxLayerNorm
from detectron2_tpu.modeling.backbone import vit as jax_vit
from detectron2_tpu_torch.checkpoint import convert_jax_params, load_state_dict_report
from detectron2_tpu_torch.checkpoint.jax_params import flax_path_to_d2_name
from detectron2_tpu_torch.layers import DropPath, LayerNorm, get_norm
from detectron2_tpu_torch.modeling.backbone import vit as port_vit
from detectron2_tpu_torch.testing import golden_state_dict, golden_vitdet_backbone

from _torch_port import load_golden, n, t

LEVELS = ("p2", "p3", "p4", "p5", "p6")


@pytest.mark.parametrize("hw, ws", [((16, 16), 8), ((64 // 4, 20), 7), ((5, 9), 14)])
def test_window_partition_and_unpartition(hw, ws):
    x = np.random.RandomState(0).randn(2, *hw, 6).astype(np.float32)
    jw, jpad = jax_vit.window_partition(jnp.asarray(x), ws)
    pw, ppad = port_vit.window_partition(t(x), ws)
    assert tuple(ppad) == tuple(jpad)
    np.testing.assert_array_equal(n(pw), np.asarray(jw))
    back = port_vit.window_unpartition(pw, ws, ppad, hw)
    np.testing.assert_array_equal(n(back), x)
    np.testing.assert_array_equal(n(back), np.asarray(jax_vit.window_unpartition(jw, ws, jpad, hw)))


@pytest.mark.parametrize(
    "q_size, k_size, rows",
    [(14, 14, 27), (8, 8, 15), (16, 16, 27), (64, 64, 27), (6, 6, 27), (8, 4, 15), (4, 8, 9)],
    ids=["same", "same8", "up", "up-far", "down", "q>k", "q<k-up"],
)
def test_get_rel_pos_matches_jax(q_size, k_size, rows):
    """Table of the needed length, a longer and a shorter one (jax's linear
    resize antialiases when it shrinks; so does the port's), unequal sizes."""
    table = np.random.RandomState(1).randn(rows, 5).astype(np.float32)
    ref = np.asarray(jax_vit.get_rel_pos(q_size, k_size, jnp.asarray(table)))
    out = n(port_vit.get_rel_pos(q_size, k_size, t(table)))
    assert out.shape == ref.shape == (q_size, k_size, 5)
    # jax builds its resize weights in float32, the port in float64
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
@pytest.mark.parametrize("size, rows", [((7, 5), (13, 9)), ((6, 6), (27, 27))], ids=["exact", "resized"])
def test_decomposed_rel_pos_factors_match_jax(transposed, size, rows):
    r = np.random.RandomState(2)
    q = r.randn(3, size[0] * size[1], 8).astype(np.float32)
    th, tw = (r.randn(m, 8).astype(np.float32) for m in rows)
    ref = jax_vit.decomposed_rel_pos_factors(
        jnp.asarray(q), jnp.asarray(th), jnp.asarray(tw), size, size, transposed=transposed
    )
    out = port_vit.decomposed_rel_pos_factors(t(q), t(th), t(tw), size, size, transposed=transposed)
    for o, r_ in zip(out, ref):
        assert o.is_contiguous() and tuple(o.shape) == r_.shape
        np.testing.assert_allclose(n(o), np.asarray(r_), rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["bicubic", "linear"])
@pytest.mark.parametrize("sizes", [(14, 64), (14, 16), (16, 14), (64, 14), (7, 7)], ids=lambda s: f"{s[0]}to{s[1]}")
def test_resize_matrix_matches_jax_image_resize(method, sizes):
    src, dst = sizes
    x = np.random.RandomState(3).randn(src, 4).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (dst, 4), method=method))
    m = port_vit.resize_matrix(src, dst, method)
    assert m.shape == (dst, src) and m.dtype == torch.float32
    np.testing.assert_allclose(n(m @ t(x)), ref, rtol=0, atol=2e-6)


def test_torch_bicubic_is_not_the_jax_bicubic():
    """Why the port builds its own matrix: F.interpolate's cubic (a = -0.75,
    clamped border) is far from jax.image.resize's (a = -0.5)."""
    x = np.random.RandomState(4).randn(1, 14, 14, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 64, 64, 3), method="bicubic"))
    theirs = torch.nn.functional.interpolate(t(x).permute(0, 3, 1, 2), size=(64, 64), mode="bicubic")
    assert np.abs(n(theirs.permute(0, 2, 3, 1)) - ref).max() > 1e-2


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm_matches_jax_on_both_layouts(eps):
    r = np.random.RandomState(5)
    x = (r.randn(2, 5, 7, 12) * 3 + 1).astype(np.float32)
    w, b = r.randn(12).astype(np.float32), r.randn(12).astype(np.float32)
    ref = np.asarray(JaxLayerNorm(features=12, eps=eps).apply({"params": {"weight": w, "bias": b}}, jnp.asarray(x)))
    for dim, inp in ((-1, t(x)), (1, t(x).permute(0, 3, 1, 2))):
        ln = LayerNorm(12, eps=eps, channel_dim=dim)
        with torch.no_grad():
            ln.weight.copy_(t(w))
            ln.bias.copy_(t(b))
            out = ln(inp)
        out = out if dim == -1 else out.permute(0, 2, 3, 1)
        np.testing.assert_allclose(n(out), ref, rtol=0, atol=2e-6)
    assert get_norm("LN", 12).eps == 1e-6 and get_norm("LN", 12).channel_dim == 1


def test_layer_norm_bfloat16_computes_in_bfloat16():
    """The statistics are taken in the input's dtype, as the JAX module
    takes them: within 3 bf16 ulps of the largest value of the float32 result."""
    x = (np.random.RandomState(6).randn(4, 9, 64) * 2).astype(np.float32)
    ref = np.asarray(JaxLayerNorm(features=64).apply({"params": {"weight": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    out = LayerNorm(64, channel_dim=-1)(t(x).bfloat16())
    assert out.dtype == torch.bfloat16
    assert np.abs(n(out.float()) - ref).max() <= 3 * 2.0**-8 * np.abs(ref).max()


def test_drop_path_is_identity_at_inference_and_draws_from_its_generator():
    x = torch.ones(64, 3, 2)
    assert DropPath(0.5)(x) is x and DropPath(0.0)(x, train=True) is x
    gen = torch.Generator().manual_seed(0)
    a = DropPath(0.25)(x, train=True, generator=gen)
    b = DropPath(0.25)(x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    kept = a[:, 0, 0] != 0
    assert 0 < kept.sum() < 64 and torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))


@pytest.mark.parametrize("batch", [1, 3])
def test_attention_hands_the_kernel_contiguous_tensors(batch, monkeypatch):
    """What the CUDA wrapper insists on, checked where the CPU tests reach:
    q, k, v and the factors are contiguous for one image too, where a
    reshape of the permuted qkv would be a view."""
    seen = []
    entry = port_vit.attention_with_rel_pos

    def recording(*args, **kwargs):
        seen.extend(a for a in args if a is not None)
        return entry(*args, **kwargs)

    monkeypatch.setattr(port_vit, "attention_with_rel_pos", recording)
    attn = port_vit.Attention(32, num_heads=2, use_rel_pos=True, input_size=(4, 4))
    attn(torch.randn(batch, 4, 4, 32))
    assert len(seen) == 5 and all(a.is_contiguous() and a.shape[0] == batch * 2 for a in seen)


def test_vit_lr_decay_rate_matches_jax():
    cases = {
        "backbone.net.pos_embed": "backbone/net/pos_embed",
        "backbone.net.patch_embed.proj.weight": "backbone/net/patch_embed/kernel",
        "backbone.net.blocks.0.attn.qkv.weight": "backbone/net/blocks_0/attn/qkv/kernel",
        "backbone.net.blocks.11.mlp.fc2.bias": "backbone/net/blocks_11/mlp/fc2/bias",
        "backbone.simfp_2.0.weight": "backbone/up4_deconv1_0/ConvTranspose_0/kernel",
        "roi_heads.box_head.fc1.weight": "roi_heads/box_head/fc1/kernel",
    }
    want = [0.7**13, 0.7**13, 0.7**12, 0.7, 1.0, 1.0]
    for (ours, theirs), w in zip(cases.items(), want):
        assert port_vit.get_vit_lr_decay_rate(ours, 0.7, 12) == pytest.approx(w)
        assert jax_vit.get_vit_lr_decay_rate(theirs, 0.7, 12) == pytest.approx(w)


def test_residual_block_is_refused():
    with pytest.raises(NotImplementedError, match="use_residual_block"):
        port_vit.ViT(img_size=64, embed_dim=32, depth=2, num_heads=2, residual_block_indexes=(1,))


# ------------------------------------------------------------ whole backbone


def _jax_backbone(img_size, pretrain_img_size, cls_token=True, **net_kwargs):
    net = jax_vit.ViT(
        img_size=img_size, patch_size=16, embed_dim=64, depth=4, num_heads=2, window_size=8, mlp_ratio=4,
        qkv_bias=True, window_block_indexes=(0, 2), use_rel_pos=True, pretrain_img_size=pretrain_img_size,
        pretrain_use_cls_token=cls_token, out_feature="last_feat", name="net", **net_kwargs,
    )
    return jax_vit.SimpleFeaturePyramid(
        net=net, in_feature="last_feat", out_channels=48, scale_factors=(4.0, 2.0, 1.0, 0.5),
        top_block_levels=1, norm="LN",
    )


def _random_variables(model, x, seed):
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, x, train=False))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.1), shapes)


def test_backbone_matches_jax_module_through_convert_jax_params():
    """The golden's architecture with seeded random weights, every leaf of
    which (the relative-position tables too) is non-zero."""
    x = np.random.RandomState(7).randn(2, 256, 256, 3).astype(np.float32)
    jmodel = _jax_backbone(256, 256)
    variables = _random_variables(jmodel, jnp.asarray(x), seed=8)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)

    model = golden_vitdet_backbone()
    state = convert_jax_params(jax.tree_util.tree_map(np.asarray, variables))
    report = load_state_dict_report(model, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(model.state_dict())} tensors from the checkpoint."], report
    with torch.no_grad():
        out = model(t(x))
    assert tuple(out) == LEVELS
    for name in LEVELS:
        assert tuple(out[name].shape) == ref[name].shape
        np.testing.assert_allclose(n(out[name]), np.asarray(ref[name]), rtol=0, atol=1e-4)
    assert model.padding_constraints == {"size_divisibility": 16, "square_size": 256}
    assert model.size_divisibility == jmodel.size_divisibility == 32
    assert {k: (v.channels, v.stride) for k, v in model.output_shape().items()} == {
        k: (v.channels, v.stride) for k, v in jmodel.output_shape().items()
    }


@pytest.mark.parametrize("cls_token", [True, False], ids=["cls", "nocls"])
def test_backbone_with_resized_position_tables_matches_jax(cls_token):
    """Pretraining size 224 (a 14x14 table) on a 128x128 input (8x8 tokens):
    the bicubic resize shrinks; global tables sized for 256 (31 rows) are
    resized linearly to 15."""
    x = np.random.RandomState(9).randn(1, 128, 128, 3).astype(np.float32)
    jmodel = _jax_backbone(256, 224, cls_token)
    variables = _random_variables(jmodel, jnp.asarray(x), seed=10)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    net = port_vit.ViT(
        img_size=256, patch_size=16, embed_dim=64, depth=4, num_heads=2, window_size=8, mlp_ratio=4,
        window_block_indexes=(0, 2), use_rel_pos=True, pretrain_img_size=224, pretrain_use_cls_token=cls_token,
    )
    model = port_vit.SimpleFeaturePyramid(net=net, out_channels=48).eval()
    load_state_dict_report(model, convert_jax_params(jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        out = model(t(x))
    for name in LEVELS:
        np.testing.assert_allclose(n(out[name]), np.asarray(ref[name]), rtol=0, atol=1e-4)


def test_backbone_position_upsampling_matches_jax():
    """The full-width case in small: a 4x4 table (pretraining size 64) on a
    16x16 token grid."""
    x = np.random.RandomState(11).randn(1, 256, 256, 3).astype(np.float32)
    jmodel = _jax_backbone(256, 64)
    variables = _random_variables(jmodel, jnp.asarray(x), seed=12)
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    net = port_vit.ViT(
        img_size=256, patch_size=16, embed_dim=64, depth=4, num_heads=2, window_size=8, mlp_ratio=4,
        window_block_indexes=(0, 2), use_rel_pos=True, pretrain_img_size=64,
    )
    model = port_vit.SimpleFeaturePyramid(net=net, out_channels=48).eval()
    load_state_dict_report(model, convert_jax_params(jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        out = model(t(x))
    for name in LEVELS:
        np.testing.assert_allclose(n(out[name]), np.asarray(ref[name]), rtol=0, atol=1e-4)


def test_backbone_transposed_factor_layout_gives_the_same_features(monkeypatch):
    x = t(np.random.RandomState(13).randn(1, 256, 256, 3).astype(np.float32))
    model = golden_vitdet_backbone()
    load_state_dict_report(model, golden_state_dict(load_golden("vitdet_backbone")))
    with torch.no_grad():
        monkeypatch.delenv("D2T_FLASH_V2", raising=False)
        std = model(x)
        monkeypatch.setenv("D2T_FLASH_V2", "1")
        tr = model(x)
    for name in LEVELS:
        np.testing.assert_allclose(n(tr[name]), n(std[name]), rtol=0, atol=1e-5)


def test_backbone_reproduces_the_reference_golden_through_d2_names():
    """``synth_weight_value`` weights under d2's names load with no key left
    over either way, and p2..p6 reproduce the reference's features."""
    g = load_golden("vitdet_backbone")
    model = golden_vitdet_backbone()
    state = golden_state_dict(g)
    report = load_state_dict_report(model, state)
    assert report.splitlines() == [f"Loaded {len(state)}/{len(model.state_dict())} tensors from the checkpoint."], report
    with torch.no_grad():
        out = model(t(g["image"][None]))
    for name in LEVELS:
        ref = g[f"feat_{name}"].transpose(0, 2, 3, 1)
        assert tuple(out[name].shape) == ref.shape
        err = np.abs(n(out[name]) - ref).max()
        assert err < 2e-3, (name, err)


# --------------------------------------------- carrying weights across by name


def test_rel_pos_table_is_not_transposed():
    """A 2-D leaf that is no ``kernel`` crosses unchanged: a square
    relative-position table would load transposed without any shape error."""
    table = np.arange(15 * 15, dtype=np.float32).reshape(15, 15)
    kernel = np.arange(6, dtype=np.float32).reshape(2, 3)
    pos = np.arange(2 * 5 * 4, dtype=np.float32).reshape(1, 10, 4)
    params = {"params": {"backbone": {"net": {
        "pos_embed": pos,
        "blocks_1": {"attn": {"rel_pos_h": table, "rel_pos_w": table + 1, "qkv": {"kernel": kernel}}},
    }}}}
    state = convert_jax_params(params)
    by_leaf = {k.rsplit(".", 1)[-1]: n(v) for k, v in state.items()}
    np.testing.assert_array_equal(by_leaf["rel_pos_h"], table)
    np.testing.assert_array_equal(by_leaf["rel_pos_w"], table + 1)
    np.testing.assert_array_equal(by_leaf["weight"], kernel.T)
    np.testing.assert_array_equal(by_leaf["pos_embed"], pos)
    assert sorted(state) == [
        "backbone.net.blocks.1.attn.qkv.weight",
        "backbone.net.blocks.1.attn.rel_pos_h",
        "backbone.net.blocks.1.attn.rel_pos_w",
        "backbone.net.pos_embed",
    ]


def test_vit_names_follow_the_jax_converter():
    """Every parameter path of the JAX backbone maps to the d2 name the JAX
    package's own converter gives it."""
    from detectron2_tpu.checkpoint.d2_converter import _path_entry_str
    from detectron2_tpu.checkpoint.d2_converter import flax_path_to_d2_name as jax_name

    jmodel = _jax_backbone(256, 256)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 256, 256, 3)), train=False))
    paths = [tuple(_path_entry_str(p) for p in path)[1:] for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert len(paths) == len(golden_vitdet_backbone().state_dict())
    for path in paths:
        assert flax_path_to_d2_name(path) == jax_name(path), path
