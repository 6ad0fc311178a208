"""The port's numpy mask codecs and COCOeval against the JAX package's on the
CPU: the RLE codec and IoU equal (``==``); ``polygons_to_mask`` equal to
the JAX package's, which calls ``cv2.fillPoly``, on 360 seeded polygons of
six classes; COCOevalNP's precision, recall and scores within 1e-9 of
``tests/goldens/cocoeval_reference.npz`` (the tolerance of
``tests/test_coco_eval_fuzz.py`` for the Python matcher) and its stats
within 1e-12 of the JAX package's Python matcher on seeded datasets; and the
analytic cases of ``tests/test_coco_eval.py``."""

import json
import os

import numpy as np
import pytest

import detectron2_tpu.evaluation._native as jax_native
from detectron2_tpu.evaluation import rle as jax_rle
from detectron2_tpu.evaluation.coco_eval_np import COCOevalNP as JaxCOCOevalNP
from detectron2_tpu.evaluation.coco_eval_np import COCOStyleDataset as JaxCOCOStyleDataset
from detectron2_tpu_torch.evaluation import rle
from detectron2_tpu_torch.evaluation.coco_eval_np import COCOevalNP, COCOStyleDataset


def _masks(seed, n=12):
    r = np.random.RandomState(seed)
    out = [np.zeros((5, 7), bool), np.ones((6, 4), bool)]
    for _ in range(n):
        h, w = r.randint(1, 40, 2)
        kind = r.randint(3)
        if kind == 0:
            m = r.rand(h, w) > r.uniform(0.2, 0.8)
        else:
            m = np.zeros((h, w), bool)
            y0, x0 = r.randint(0, h), r.randint(0, w)
            m[y0 : y0 + r.randint(1, h + 1), x0 : x0 + r.randint(1, w + 1)] = True
        out.append(m)
    return out


def test_rle_codec_equals_the_jax_package():
    for m in _masks(0):
        ours, ref = rle.mask_to_rle(m), jax_rle.mask_to_rle(m)
        assert ours == ref
        np.testing.assert_array_equal(rle.rle_to_mask(ours), m)
        np.testing.assert_array_equal(rle.rle_to_mask(ref), jax_rle.rle_to_mask(ref))
        counts = jax_rle.decode_counts(ref["counts"])
        assert rle.decode_counts(ref["counts"]) == counts
        assert rle.encode_counts(counts) == jax_rle.encode_counts(counts) == ref["counts"]
        assert rle.rle_area(ref) == jax_rle.rle_area(ref) == int(m.sum())
        np.testing.assert_array_equal(rle.rle_to_bbox(ref), jax_rle.rle_to_bbox(ref))
        # uncompressed counts too
        assert rle.rle_area({"size": ref["size"], "counts": counts}) == rle.rle_area(ref)
    r = np.random.RandomState(1)
    counts = [int(c) for c in r.randint(0, 3000, 50)]
    assert rle.encode_counts(counts) == jax_rle.encode_counts(counts)


def test_rle_iou_and_merge_equal_the_jax_package():
    r = np.random.RandomState(2)
    h, w = 30, 41
    masks = [r.rand(h, w) > t for t in (0.3, 0.5, 0.7, 0.9)] + [np.zeros((h, w), bool)]
    rles = [jax_rle.mask_to_rle(m) for m in masks]
    for iscrowd in ([0, 0, 0, 0, 0], [1, 0, 1, 0, 1]):
        ours = rle.rle_iou(rles[:3], rles, iscrowd)
        ref = jax_rle.rle_iou(rles[:3], rles, iscrowd)
        np.testing.assert_array_equal(ours, ref)
    for intersect in (False, True):
        assert rle.rle_merge(rles[:3], intersect) == jax_rle.rle_merge(rles[:3], intersect)
    assert rle.rle_iou([], rles, [0] * 5).shape == (0, 5)


def _polygons(kind, r, h, w):
    """Seeded polygons of one class, each a list of flat vertex arrays."""
    n = r.randint(3, 12)
    if kind == "rectangle":
        x0, x1 = np.sort(r.uniform(0, w, 2))
        y0, y1 = np.sort(r.uniform(0, h, 2))
        return [np.array([x0, y0, x1, y0, x1, y1, x0, y1])]
    if kind == "convex":
        cx, cy, rad = r.uniform(0, w), r.uniform(0, h), r.uniform(1, max(h, w) / 2)
        ang = np.sort(r.uniform(0, 2 * np.pi, n))
        return [np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).ravel()]
    if kind == "concave":
        cx, cy = r.uniform(0, w), r.uniform(0, h)
        ang = np.sort(r.uniform(0, 2 * np.pi, n))
        rad = r.uniform(1, max(h, w) / 2, n)
        return [np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1).ravel()]
    if kind == "several":  # several polygons per object, overlapping at times
        return [np.stack([r.uniform(0, w, k), r.uniform(0, h, k)], 1).ravel() for k in r.randint(3, 8, r.randint(2, 5))]
    if kind == "border":  # vertices on the image's edges (x = 0 or w, y = 0 or h) and between
        return [np.stack([r.choice([0.0, w, r.uniform(0, w)], n), r.choice([0.0, h, r.uniform(0, h)], n)], 1).ravel()]
    # off the image: vertices outside it, the polygon crossing itself
    return [np.stack([r.uniform(-6, w + 6, n), r.uniform(-6, h + 6, n)], 1).ravel()]


@pytest.mark.parametrize("kind", ["rectangle", "convex", "concave", "several", "border", "outside"])
def test_polygons_to_mask_equals_cv2_fillpoly(kind):
    """60 polygons of each class, vertices off the pixel grid (rounded half
    to even first, as the JAX package rounds them), at sizes from 5 to 90."""
    r = np.random.RandomState(["rectangle", "convex", "concave", "several", "border", "outside"].index(kind))
    for i in range(60):
        h, w = r.randint(5, 90, 2)
        polys = _polygons(kind, r, h, w)
        ours = rle.polygons_to_mask(polys, h, w)
        ref = jax_rle.polygons_to_mask(polys, h, w)
        assert ours.dtype == ref.dtype == np.uint8
        assert np.array_equal(ours, ref), (kind, i, h, w, [np.round(p).tolist() for p in polys])
    # at a COCO image size, and the RLE of the polygons
    polys = _polygons("several", r, 480, 640) + _polygons("concave", r, 480, 640)
    np.testing.assert_array_equal(rle.polygons_to_mask(polys, 480, 640), jax_rle.polygons_to_mask(polys, 480, 640))
    assert rle.polygons_to_rle(polys, 480, 640) == jax_rle.polygons_to_rle(polys, 480, 640)
    # polygons of fewer than three points draw nothing
    assert not rle.polygons_to_mask([np.array([1.0, 2.0, 3.0, 4.0])], 8, 8).any()


_REF_GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "cocoeval_reference.npz")
_REF_DATA = np.load(_REF_GOLDENS)
_REF_CASES = sorted({k.split("/")[0] for k in _REF_DATA.files})


def _json_of(arr):
    return json.loads(bytes(arr.tobytes()).decode())


@pytest.mark.parametrize("name", _REF_CASES)
def test_reproduces_the_reference_cpp_goldens(name):
    gt = _json_of(_REF_DATA[f"{name}/gt"])
    dets = _json_of(_REF_DATA[f"{name}/dt"])
    meta = _json_of(_REF_DATA[f"{name}/meta"])
    coco_gt = COCOStyleDataset(gt)
    ev = COCOevalNP(coco_gt, coco_gt.loadRes(dets), iouType=meta["iou_type"])
    ev.params.useCats = meta["use_cats"]
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    for key in ("precision", "recall", "scores"):
        np.testing.assert_allclose(ev.eval[key], _REF_DATA[f"{name}/{key}"], atol=1e-9, err_msg=f"{name} {key}")


def _fuzz_dataset(seed, n_images=8, n_cats=5):
    """Boxes over small, medium and large areas, crowd annotations, and for
    segm a polygon per box; detections: the gt jittered, some missed, some
    of a wrong class, extra false positives, tied scores."""
    rng = np.random.RandomState(seed)
    images = [{"id": i, "height": 120, "width": 160} for i in range(n_images)]
    anns, dets = [], []
    for i in range(n_images):
        for _ in range(rng.randint(0, 10)):
            w = float(rng.choice([6, 20, 48, 110])) * (0.5 + rng.rand() / 2)
            h = float(rng.choice([6, 20, 48, 110])) * (0.5 + rng.rand() / 2)
            x, y = rng.rand() * (160 - w), rng.rand() * (120 - h)
            poly = [x, y, x + w, y, x + w * 0.8, y + h, x, y + h * 0.7]
            ann = {
                "id": len(anns) + 1, "image_id": i, "category_id": int(rng.randint(1, n_cats + 1)),
                "bbox": [x, y, w, h], "area": w * h * 0.85, "iscrowd": int(rng.rand() < 0.15),
                "segmentation": [poly],
            }
            anns.append(ann)
            if rng.rand() < 0.2:
                continue
            j = rng.randn(4) * 4
            dpoly = (np.asarray(poly) + rng.randn(8) * 2).tolist()
            dets.append({
                "image_id": i, "category_id": ann["category_id"] if rng.rand() > 0.1 else int(rng.randint(1, n_cats + 1)),
                "bbox": [x + j[0], y + j[1], max(w + j[2], 2), max(h + j[3], 2)],
                "segmentation": rle.polygons_to_rle([np.asarray(dpoly)], 120, 160),
                "score": float(np.round(rng.rand(), 1)),
            })
        for _ in range(rng.randint(0, 4)):
            x, y = rng.rand() * 120, rng.rand() * 90
            m = np.zeros((120, 160), np.uint8)
            m[int(y) : int(y) + 30, int(x) : int(x) + 30] = 1
            dets.append({
                "image_id": i, "category_id": int(rng.randint(1, n_cats + 1)), "bbox": [x, y, 30.0, 30.0],
                "segmentation": rle.mask_to_rle(m), "score": float(rng.rand()),
            })
    for d in dets:
        d["segmentation"]["counts"] = d["segmentation"]["counts"].decode("ascii")
    cats = [{"id": c + 1, "name": f"c{c}"} for c in range(n_cats)]
    return {"images": images, "annotations": anns, "categories": cats}, dets


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_equal_the_jax_python_matcher(iou_type, seed, monkeypatch):
    gt, dets = _fuzz_dataset(seed)
    monkeypatch.setattr(jax_native, "native_evaluate_img", lambda *a, **k: None)
    stats = []
    for dataset_cls, eval_cls in ((COCOStyleDataset, COCOevalNP), (JaxCOCOStyleDataset, JaxCOCOevalNP)):
        coco_gt = dataset_cls(json.loads(json.dumps(gt)))
        res = [dict(d) for d in dets]
        if iou_type == "segm":
            for d in res:
                d.pop("bbox")
        ev = eval_cls(coco_gt, coco_gt.loadRes(res), iou_type)
        ev.evaluate()
        ev.accumulate()
        stats.append(ev.summarize())
    assert (stats[0] >= 0).any()
    np.testing.assert_allclose(stats[0], stats[1], rtol=0, atol=1e-12)


# --- the analytic cases of tests/test_coco_eval.py, against the port


def _make_gt(num_images=4, boxes_per_image=2):
    images = [{"id": i, "width": 100, "height": 100, "file_name": f"{i}.jpg"} for i in range(num_images)]
    annotations = [
        {"id": i * boxes_per_image + b + 1, "image_id": i, "category_id": 1, "bbox": [10 + 30 * b, 10, 20, 20],
         "area": 400, "iscrowd": 0}
        for i in range(num_images)
        for b in range(boxes_per_image)
    ]
    return COCOStyleDataset({"images": images, "categories": [{"id": 1, "name": "thing"}], "annotations": annotations})


def _run(gt, results, iou_type="bbox"):
    ev = COCOevalNP(gt, gt.loadRes(results), iou_type)
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev.stats


def test_analytic_perfect_predictions():
    gt = _make_gt()
    stats = _run(gt, [{"image_id": a["image_id"], "category_id": 1, "bbox": list(a["bbox"]), "score": 0.9}
                      for a in gt.dataset["annotations"]])
    assert stats[0] == pytest.approx(1.0, abs=1e-6) and stats[1] == pytest.approx(1.0, abs=1e-6)
    assert stats[8] == pytest.approx(1.0, abs=1e-6)


def test_analytic_half_of_the_images_missing():
    gt = _make_gt(num_images=4)
    stats = _run(gt, [{"image_id": a["image_id"], "category_id": 1, "bbox": list(a["bbox"]), "score": 0.9}
                      for a in gt.dataset["annotations"] if a["image_id"] < 2])
    assert stats[8] == pytest.approx(0.5, abs=1e-6)
    assert stats[0] == pytest.approx(51 / 101, abs=1e-6)  # precision 1 up to recall 0.5


def test_analytic_false_positive_and_localization():
    gt = _make_gt(num_images=1, boxes_per_image=1)
    stats = _run(gt, [
        {"image_id": 0, "category_id": 1, "bbox": [10, 10, 20, 20], "score": 0.9},
        {"image_id": 0, "category_id": 1, "bbox": [70, 70, 20, 20], "score": 0.95},  # a false positive ranked first
    ])
    assert stats[0] == pytest.approx(0.5, abs=1e-6)
    # 5 px off: IoU 0.6, matched at 0.5, 0.55 and 0.6
    stats = _run(gt, [{"image_id": 0, "category_id": 1, "bbox": [15, 10, 20, 20], "score": 0.9}])
    assert stats[1] == pytest.approx(1.0, abs=1e-6) and stats[2] == pytest.approx(0.0, abs=1e-6)
    assert stats[0] == pytest.approx(0.3, abs=1e-6)


def test_analytic_crowd_is_not_penalized():
    annotations = [
        {"id": 1, "image_id": 0, "category_id": 1, "bbox": [10, 10, 20, 20], "area": 400, "iscrowd": 0},
        {"id": 2, "image_id": 0, "category_id": 1, "bbox": [50, 50, 40, 40], "area": 1600, "iscrowd": 1},
    ]
    gt = COCOStyleDataset({"images": [{"id": 0, "width": 100, "height": 100}],
                           "categories": [{"id": 1, "name": "thing"}], "annotations": annotations})
    stats = _run(gt, [
        {"image_id": 0, "category_id": 1, "bbox": [10, 10, 20, 20], "score": 0.9},
        {"image_id": 0, "category_id": 1, "bbox": [55, 55, 20, 20], "score": 0.8},  # inside the crowd: ignored
    ])
    assert stats[0] == pytest.approx(1.0, abs=1e-6)


def test_analytic_segm_of_a_perfect_mask():
    m = np.zeros((50, 50), bool)
    m[10:30, 10:30] = True
    seg = rle.mask_to_rle(m)
    seg["counts"] = seg["counts"].decode("utf-8")
    gt = COCOStyleDataset({
        "images": [{"id": 0, "width": 50, "height": 50}], "categories": [{"id": 1, "name": "thing"}],
        "annotations": [{"id": 1, "image_id": 0, "category_id": 1, "bbox": [10, 10, 20, 20], "area": 400,
                         "iscrowd": 0, "segmentation": seg}],
    })
    assert _run(gt, [{"image_id": 0, "category_id": 1, "segmentation": seg, "score": 0.9}], "segm")[0] == pytest.approx(1.0)
