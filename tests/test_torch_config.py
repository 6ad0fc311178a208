"""The port's config: the in-code R50-FPN 3x config equals the zoo yaml merged
through the JAX package's ``get_cfg()`` on every key the port reads, and the
port's own yaml merge gives the same config."""

import os

import pytest

from _torch_port import leaf_items

from detectron2_tpu_torch.config import get_cfg
from detectron2_tpu_torch.model_zoo import mask_rcnn_R_50_FPN_3x_config

YAML = os.path.join(
    os.path.dirname(__file__), "..", "configs", "COCO-InstanceSegmentation", "mask_rcnn_R_50_FPN_3x.yaml"
)
# MODEL.DEVICE is "cuda" in the port and "tpu" in the JAX package; the zoo
# yaml's MODEL.WEIGHTS is a download the in-code config leaves empty
_DIFFERENT_BY_DESIGN = {"MODEL.DEVICE", "MODEL.WEIGHTS"}


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


def _lookup(cfg, key):
    node = cfg
    for k in key.split("."):
        node = node[k]
    return node


def test_in_code_3x_config_equals_the_yaml_through_jax_get_cfg():
    from detectron2_tpu.config import get_cfg as jax_get_cfg

    ref = jax_get_cfg()
    ref.merge_from_file(YAML)
    ours = mask_rcnn_R_50_FPN_3x_config()
    keys = [k for k, _ in leaf_items(ours) if k not in _DIFFERENT_BY_DESIGN]
    assert len(keys) > 60
    for key in keys:
        assert _norm(_lookup(ours, key)) == _norm(_lookup(ref, key)), key


def test_port_merge_from_file_equals_the_in_code_config():
    pytest.importorskip("yaml")
    cfg = get_cfg()
    cfg.merge_from_file(YAML)
    expected = mask_rcnn_R_50_FPN_3x_config()
    assert cfg.MODEL.WEIGHTS.endswith("R-50.pkl")
    cfg.MODEL.WEIGHTS = ""
    assert dict(leaf_items(cfg)) == dict(leaf_items(expected))


def test_every_jax_default_is_in_the_port_config_with_an_equal_value():
    from detectron2_tpu.config import get_cfg as jax_get_cfg

    ours = dict(leaf_items(get_cfg()))
    theirs = dict(leaf_items(jax_get_cfg()))
    assert len(theirs) > 200
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if key != "MODEL.DEVICE":
            assert _norm(ours[key]) == _norm(value), key
    assert ours["MODEL.DEVICE"] == "cuda"


def test_merge_rejects_unknown_keys_and_coerces_types():
    cfg = get_cfg()
    with pytest.raises(KeyError):
        cfg.merge_from_list(["MODEL.NO_SUCH_KEY", "1"])
    cfg.merge_from_list(["MODEL.RPN.NMS_THRESH", "1", "MODEL.RPN.BBOX_REG_WEIGHTS", "[2.0, 2.0, 1.0, 1.0]"])
    assert cfg.MODEL.RPN.NMS_THRESH == 1.0 and isinstance(cfg.MODEL.RPN.NMS_THRESH, float)
    assert cfg.MODEL.RPN.BBOX_REG_WEIGHTS == (2.0, 2.0, 1.0, 1.0)
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.MODEL.MASK_ON = True
