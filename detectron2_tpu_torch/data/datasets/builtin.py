"""The builtin datasets, registered under ``$DETECTRON2_DATASETS`` (default
``datasets``) at import of :mod:`detectron2_tpu_torch.data.datasets` (a
copy of the COCO, LVIS and Pascal VOC parts of
``detectron2_tpu/data/datasets/builtin.py``: ``register_all_coco`` :64,
``register_all_coco_panoptic`` :98, ``register_all_lvis`` :146,
``register_all_cityscapes`` :165, ``register_all_pascal_voc`` :196,
``register_all_ade20k`` :213), in d2's layout:

- ``coco/{train,val}2017``, ``coco/annotations/instances_*.json`` and
  ``person_keypoints_*.json``;
- COCO panoptic over those images: ``coco/panoptic_{train,val}2017`` (the
  RGB-id PNGs), ``coco/annotations/panoptic_*.json`` and
  ``coco/panoptic_stuff_*`` (the stuff labels), as
  ``coco_2017_*_panoptic``, ``..._panoptic_separated`` and, as d2 has it,
  ``..._panoptic_stuffonly``;
- ``lvis/lvis_v1_{train,val}.json`` (and v0.5) over the COCO images under
  ``coco/``;
- ``cityscapes/leftImg8bit/{train,val,test}/<city>/*_leftImg8bit.png``
  with ``cityscapes/gtFine/<split>/<city>/*_gtFine_polygons.json``,
  ``*_gtFine_labelIds.png`` and ``*_gtFine_labelTrainIds.png``, as
  ``cityscapes_fine_{instance_seg,sem_seg}_{train,val,test}``, and
  ``cityscapes/gtFine/cityscapes_panoptic_{train,val}{,.json}`` as
  ``cityscapes_fine_panoptic_{train,val}`` (d2's; the JAX package never
  registers them, ROADMAP C);
- ``VOC2007`` and ``VOC2012``, each with ``Annotations``,
  ``ImageSets/Main`` and ``JPEGImages``;
- ``ADEChallengeData2016/images/{training,validation}`` with the labels in
  ``ADEChallengeData2016/annotations_detectron2/``;
- the DensePose-COCO splits, ``coco/annotations/densepose_*.json`` over
  the COCO 2014 images (and DensePose-Chimps), as ``densepose_coco_2014_*``,
  their CSE re-annotations ``densepose_*_cse.json`` as ``..._cse``, and
  DensePose-LVIS, ``lvis/densepose_lvis_v1_*.json`` over ``coco_``, as
  ``densepose_lvis_v1_*`` (``detectron2_tpu/projects/densepose/
  dataset_mapper.py:253``, ``datasets.py:233``), and
  ``base_coco_2017_{train,val}`` over ``coco/{train,val}2017`` with raw
  category ids (d2's DensePose names; the JAX package has none).

Nothing is read until a dataset is loaded.
"""

import os

from detectron2_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from detectron2_tpu_torch.data.datasets.builtin_meta import ADE20K_SEM_SEG_CATEGORIES, _get_builtin_metadata
from detectron2_tpu_torch.data.datasets.cityscapes import load_cityscapes_instances, load_cityscapes_semantic
from detectron2_tpu_torch.data.datasets.cityscapes_panoptic import register_all_cityscapes_panoptic
from detectron2_tpu_torch.data.datasets.coco import load_coco_json, load_sem_seg, register_coco_instances
from detectron2_tpu_torch.data.datasets.coco_panoptic import register_coco_panoptic, register_coco_panoptic_separated
from detectron2_tpu_torch.data.datasets.lvis import get_lvis_instances_meta, register_lvis_instances
from detectron2_tpu_torch.data.datasets.pascal_voc import register_pascal_voc

__all__ = [
    "register_all_ade20k",
    "register_all_cityscapes",
    "register_all_cityscapes_panoptic",
    "register_all_coco",
    "register_all_coco_panoptic",
    "register_all_lvis",
    "register_all_pascal_voc",
    "register_densepose_coco",
]

_PREDEFINED_SPLITS_COCO = {
    "coco": {
        "coco_2014_train": ("coco/train2014", "coco/annotations/instances_train2014.json"),
        "coco_2014_val": ("coco/val2014", "coco/annotations/instances_val2014.json"),
        "coco_2014_minival": ("coco/val2014", "coco/annotations/instances_minival2014.json"),
        "coco_2014_valminusminival": ("coco/val2014", "coco/annotations/instances_valminusminival2014.json"),
        "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
        "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
        "coco_2017_test": ("coco/test2017", "coco/annotations/image_info_test2017.json"),
        "coco_2017_test-dev": ("coco/test2017", "coco/annotations/image_info_test-dev2017.json"),
        "coco_2017_val_100": ("coco/val2017", "coco/annotations/instances_val2017_100.json"),
    },
    "coco_person": {
        "keypoints_coco_2014_train": ("coco/train2014", "coco/annotations/person_keypoints_train2014.json"),
        "keypoints_coco_2014_val": ("coco/val2014", "coco/annotations/person_keypoints_val2014.json"),
        "keypoints_coco_2014_minival": ("coco/val2014", "coco/annotations/person_keypoints_minival2014.json"),
        "keypoints_coco_2017_train": ("coco/train2017", "coco/annotations/person_keypoints_train2017.json"),
        "keypoints_coco_2017_val": ("coco/val2017", "coco/annotations/person_keypoints_val2017.json"),
        "keypoints_coco_2017_val_100": ("coco/val2017", "coco/annotations/person_keypoints_val2017_100.json"),
    },
}

_PREDEFINED_SPLITS_COCO_PANOPTIC = {
    "coco_2017_train_panoptic": (
        "coco/panoptic_train2017", "coco/annotations/panoptic_train2017.json", "coco/panoptic_stuff_train2017"),
    "coco_2017_val_panoptic": (
        "coco/panoptic_val2017", "coco/annotations/panoptic_val2017.json", "coco/panoptic_stuff_val2017"),
    "coco_2017_val_100_panoptic": (
        "coco/panoptic_val2017_100", "coco/annotations/panoptic_val2017_100.json", "coco/panoptic_stuff_val2017_100"),
}

_PREDEFINED_SPLITS_LVIS = {
    "lvis_v1": {
        "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
        "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
        "lvis_v1_test_dev": ("coco/", "lvis/lvis_v1_image_info_test_dev.json"),
        "lvis_v1_test_challenge": ("coco/", "lvis/lvis_v1_image_info_test_challenge.json"),
    },
    "lvis_v0.5": {
        "lvis_v0.5_train": ("coco/", "lvis/lvis_v0.5_train.json"),
        "lvis_v0.5_val": ("coco/", "lvis/lvis_v0.5_val.json"),
        "lvis_v0.5_val_rand_100": ("coco/", "lvis/lvis_v0.5_val_rand_100.json"),
        "lvis_v0.5_test": ("coco/", "lvis/lvis_v0.5_image_info_test.json"),
    },
    "lvis_v0.5_cocofied": {
        "lvis_v0.5_train_cocofied": ("coco/", "lvis/lvis_v0.5_train_cocofied.json"),
        "lvis_v0.5_val_cocofied": ("coco/", "lvis/lvis_v0.5_val_cocofied.json"),
    },
}

_RAW_CITYSCAPES_SPLITS = {
    "cityscapes_fine_{task}_train": ("cityscapes/leftImg8bit/train/", "cityscapes/gtFine/train/"),
    "cityscapes_fine_{task}_val": ("cityscapes/leftImg8bit/val/", "cityscapes/gtFine/val/"),
    "cityscapes_fine_{task}_test": ("cityscapes/leftImg8bit/test/", "cityscapes/gtFine/test/"),
}

_PASCAL_VOC_SPLITS = (
    ("voc_2007_trainval", "VOC2007", "trainval"),
    ("voc_2007_train", "VOC2007", "train"),
    ("voc_2007_val", "VOC2007", "val"),
    ("voc_2007_test", "VOC2007", "test"),
    ("voc_2012_trainval", "VOC2012", "trainval"),
    ("voc_2012_train", "VOC2012", "train"),
    ("voc_2012_val", "VOC2012", "val"),
)


def _under(root: str, path: str) -> str:
    return path if "://" in path else os.path.join(root, path)


def register_all_coco(root: str) -> None:
    for dataset_name, splits_per_dataset in _PREDEFINED_SPLITS_COCO.items():
        for key, (image_root, json_file) in splits_per_dataset.items():
            register_coco_instances(
                key, _get_builtin_metadata(dataset_name), _under(root, json_file), os.path.join(root, image_root)
            )


def register_all_coco_panoptic(root: str) -> None:
    """Each split in the separated (and stuff-only) and standard formats,
    over the images and instances json of its COCO split."""
    for prefix, (panoptic_root, panoptic_json, semantic_root) in _PREDEFINED_SPLITS_COCO_PANOPTIC.items():
        instances_meta = MetadataCatalog.get(prefix[: -len("_panoptic")])
        image_root, instances_json = instances_meta.image_root, instances_meta.json_file
        register_coco_panoptic_separated(
            prefix,
            _get_builtin_metadata("coco_panoptic_separated"),
            image_root,
            os.path.join(root, panoptic_root),
            os.path.join(root, panoptic_json),
            os.path.join(root, semantic_root),
            instances_json,
        )
        register_coco_panoptic(
            prefix,
            _get_builtin_metadata("coco_panoptic_standard"),
            image_root,
            os.path.join(root, panoptic_root),
            os.path.join(root, panoptic_json),
            instances_json,
        )


def register_all_lvis(root: str) -> None:
    for dataset_name, splits_per_dataset in _PREDEFINED_SPLITS_LVIS.items():
        for key, (image_root, json_file) in splits_per_dataset.items():
            register_lvis_instances(
                key, get_lvis_instances_meta(dataset_name), _under(root, json_file), os.path.join(root, image_root)
            )


def register_all_cityscapes(root: str) -> None:
    """Each split as ``instance_seg`` (``evaluator_type``
    ``cityscapes_instance``) and ``sem_seg`` (``cityscapes_sem_seg``, ignore
    label 255), with the 19 classes' metadata."""
    for key, (image_dir, gt_dir) in _RAW_CITYSCAPES_SPLITS.items():
        meta = _get_builtin_metadata("cityscapes")
        image_dir, gt_dir = os.path.join(root, image_dir), os.path.join(root, gt_dir)
        inst_key = key.format(task="instance_seg")
        DatasetCatalog.register(inst_key, lambda x=image_dir, y=gt_dir: load_cityscapes_instances(x, y))
        MetadataCatalog.get(inst_key).set(
            image_dir=image_dir, gt_dir=gt_dir, evaluator_type="cityscapes_instance", **meta
        )
        sem_key = key.format(task="sem_seg")
        DatasetCatalog.register(sem_key, lambda x=image_dir, y=gt_dir: load_cityscapes_semantic(x, y))
        MetadataCatalog.get(sem_key).set(
            image_dir=image_dir, gt_dir=gt_dir, evaluator_type="cityscapes_sem_seg", ignore_label=255, **meta
        )


def register_all_pascal_voc(root: str) -> None:
    for name, dirname, split in _PASCAL_VOC_SPLITS:
        year = 2007 if "2007" in name else 2012
        register_pascal_voc(name, os.path.join(root, dirname), split, year)


_PREDEFINED_SPLITS_DENSEPOSE = {
    "densepose_coco_2014_train": ("coco/train2014", "coco/annotations/densepose_train2014.json"),
    "densepose_coco_2014_minival": ("coco/val2014", "coco/annotations/densepose_minival2014.json"),
    "densepose_coco_2014_minival_100": ("coco/val2014", "coco/annotations/densepose_minival2014_100.json"),
    "densepose_coco_2014_valminusminival": ("coco/val2014", "coco/annotations/densepose_valminusminival2014.json"),
    "densepose_chimps": ("densepose_chimps/images", "densepose_chimps/densepose_chimps_densepose.json"),
}
# the CSE re-annotations: vertex ids on a mesh (dp_vertex, ref_model) in
# place of the charts
_PREDEFINED_SPLITS_DENSEPOSE_CSE = {
    "densepose_coco_2014_train_cse": ("coco/train2014", "coco/annotations/densepose_train2014_cse.json"),
    "densepose_coco_2014_minival_cse": ("coco/val2014", "coco/annotations/densepose_minival2014_cse.json"),
    "densepose_coco_2014_minival_100_cse": ("coco/val2014", "coco/annotations/densepose_minival2014_100_cse.json"),
    "densepose_coco_2014_valminusminival_cse": (
        "coco/val2014", "coco/annotations/densepose_valminusminival2014_cse.json"
    ),
    "densepose_chimps_cse_train": ("densepose_chimps/images", "densepose_chimps/densepose_chimps_cse_train.json"),
    "densepose_chimps_cse_val": ("densepose_chimps/images", "densepose_chimps/densepose_chimps_cse_val.json"),
}
# DensePose-LVIS (the animals), read by the DensePose project's loader
_PREDEFINED_SPLITS_DENSEPOSE_LVIS = {
    "densepose_lvis_v1_ds1_train_v1": ("coco_", "lvis/densepose_lvis_v1_ds1_train_v1.json"),
    "densepose_lvis_v1_ds1_val_v1": ("coco_", "lvis/densepose_lvis_v1_ds1_val_v1.json"),
    "densepose_lvis_v1_ds2_train_v1": ("coco_", "lvis/densepose_lvis_v1_ds2_train_v1.json"),
    "densepose_lvis_v1_ds2_val_v1": ("coco_", "lvis/densepose_lvis_v1_ds2_val_v1.json"),
    "densepose_lvis_v1_ds1_val_animals_100": ("coco_", "lvis/densepose_lvis_v1_val_animals_100_v2.json"),
}
DENSEPOSE_ANN_KEYS = ["dp_x", "dp_y", "dp_I", "dp_U", "dp_V", "dp_masks"]
DENSEPOSE_CSE_ANN_KEYS = ["dp_x", "dp_y", "dp_vertex", "ref_model", "dp_masks"]


# d2's DensePose COCO 2017 names (as recalled from its densepose/data/
# datasets/coco.py): COCO's instances with the raw category ids, which the
# evolution configs whitelist and map (ROADMAP C, correction 18)
_PREDEFINED_SPLITS_DENSEPOSE_BASE_COCO = {
    "base_coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "base_coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
}


def _load_coco_raw_ids(json_file: str, image_root: str, name: str):
    from detectron2_tpu_torch.projects.densepose.datasets import load_coco_json_raw_ids

    return load_coco_json_raw_ids(json_file, image_root, name)


def _load_densepose_lvis(json_file: str, image_root: str, name: str):
    from detectron2_tpu_torch.projects.densepose.datasets import load_densepose_lvis_json

    return load_densepose_lvis_json(json_file, image_root, name)


def register_densepose_coco(root: str) -> None:
    """The DensePose splits: COCO jsons whose person annotations carry the
    chart ``dp_*`` keys, or with ``_cse`` the CSE keys, with
    ``evaluator_type`` "densepose_coco"; the DensePose-LVIS jsons, with
    ``evaluator_type`` "lvis"; and ``base_coco_2017_{train,val}``, COCO
    2017's instances with raw category ids."""
    for splits, keys in ((_PREDEFINED_SPLITS_DENSEPOSE, DENSEPOSE_ANN_KEYS),
                         (_PREDEFINED_SPLITS_DENSEPOSE_CSE, DENSEPOSE_CSE_ANN_KEYS)):
        for name, (image_root, json_file) in splits.items():
            image_dir, json_path = os.path.join(root, image_root), _under(root, json_file)
            DatasetCatalog.register(
                name, lambda j=json_path, d=image_dir, n=name, k=keys: load_coco_json(j, d, n, extra_annotation_keys=k)
            )
            MetadataCatalog.get(name).set(
                json_file=json_path, image_root=image_dir, evaluator_type="densepose_coco", thing_classes=["person"]
            )
    for name, (image_root, json_file) in _PREDEFINED_SPLITS_DENSEPOSE_LVIS.items():
        image_dir, json_path = os.path.join(root, image_root), _under(root, json_file)
        DatasetCatalog.register(name, lambda j=json_path, d=image_dir, n=name: _load_densepose_lvis(j, d, n))
        MetadataCatalog.get(name).set(json_file=json_path, image_root=image_dir, evaluator_type="lvis")
    for name, (image_root, json_file) in _PREDEFINED_SPLITS_DENSEPOSE_BASE_COCO.items():
        image_dir, json_path = os.path.join(root, image_root), _under(root, json_file)
        DatasetCatalog.register(name, lambda j=json_path, d=image_dir, n=name: _load_coco_raw_ids(j, d, n))
        MetadataCatalog.get(name).set(json_file=json_path, image_root=image_dir, evaluator_type="coco")


def register_all_ade20k(root: str) -> None:
    root = os.path.join(root, "ADEChallengeData2016")
    for name, dirname in (("train", "training"), ("val", "validation")):
        image_dir = os.path.join(root, "images", dirname)
        gt_dir = os.path.join(root, "annotations_detectron2", dirname)
        name = f"ade20k_sem_seg_{name}"
        DatasetCatalog.register(name, lambda x=image_dir, y=gt_dir: load_sem_seg(y, x, gt_ext="png", image_ext="jpg"))
        MetadataCatalog.get(name).set(
            stuff_classes=ADE20K_SEM_SEG_CATEGORIES[:],
            image_root=image_dir,
            sem_seg_root=gt_dir,
            evaluator_type="sem_seg",
            ignore_label=255,
        )


_root = os.path.expanduser(os.getenv("DETECTRON2_DATASETS", "datasets"))
# register once, however often the module is imported
if "coco_2017_train" not in MetadataCatalog.list():
    register_all_coco(_root)
    register_all_coco_panoptic(_root)
    register_all_lvis(_root)
    register_all_cityscapes(_root)
    register_all_cityscapes_panoptic(_root)
    register_all_pascal_voc(_root)
    register_all_ade20k(_root)
    register_densepose_coco(_root)
