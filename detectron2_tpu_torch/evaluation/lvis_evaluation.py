"""LVIS evaluation (counterpart of ``detectron2_tpu/evaluation/lvis_evaluation.py``:
``LVISEvaluator`` :31).

As in the JAX package, LVIS is scored by the numpy COCOeval with LVIS's
parameters, not by the LVIS API: 300 detections an image, every category's
precision at once, and APr / APc / APf averaged over the categories of each
frequency band. So the json's not-exhaustive and negative category ids are
not used (ROADMAP C). ``process`` takes the port's padded batch outputs and
copies them to the host once a batch, as the port's ``COCOEvaluator`` does.
"""

import copy
import itertools
import json
import logging
import os
from collections import OrderedDict

import numpy as np
import torch

from detectron2_tpu_torch.data.catalog import MetadataCatalog
from detectron2_tpu_torch.evaluation.coco_eval_np import COCOevalNP, COCOStyleDataset
from detectron2_tpu_torch.evaluation.coco_evaluation import _coco_json, _instances_to_host
from detectron2_tpu_torch.evaluation.evaluator import DatasetEvaluator
from detectron2_tpu_torch.modeling.postprocessing import detector_postprocess

logger = logging.getLogger(__name__)

__all__ = ["LVISEvaluator"]


class LVISEvaluator(DatasetEvaluator):
    """Box and mask AP of an LVIS dataset, with APr, APc and APf.
    ``distributed`` is kept for d2's signature: the port runs one process."""

    def __init__(self, dataset_name: str, tasks=None, distributed: bool = True, output_dir=None, *, max_dets_per_image=None):
        self._distributed = distributed
        self._output_dir = output_dir
        self._max_dets_per_image = max_dets_per_image or 300
        self._metadata = MetadataCatalog.get(dataset_name)
        self._lvis_api = COCOStyleDataset.from_json(self._metadata.json_file)
        self._tasks = tasks
        self._do_evaluation = len(self._lvis_api.getAnnIds()) > 0
        self._predictions = []

    def reset(self):
        self._predictions = []

    def process(self, inputs, outputs):
        """``inputs``: the batch dict (with "metadata" and "image_sizes");
        ``outputs``: the model's padded detections for the batch."""
        metadata = inputs["metadata"]
        image_sizes = torch.as_tensor(inputs["image_sizes"]).tolist()
        instances = [
            detector_postprocess(
                {k: v[i] for k, v in outputs.items()}, meta.get("height", hw[0]), meta.get("width", hw[1]), *hw
            )
            for i, (meta, hw) in enumerate(zip(metadata, image_sizes))
        ]
        for meta, host in zip(metadata, _instances_to_host(instances)):
            self._predictions.append({"image_id": meta["image_id"], "instances": _coco_json(host, meta["image_id"])})

    def evaluate(self):
        predictions = self._predictions
        if len(predictions) == 0:
            logger.warning("[LVISEvaluator] Did not receive valid predictions.")
            return {}

        lvis_results = list(itertools.chain(*[x["instances"] for x in predictions]))
        tasks = self._tasks or ["bbox"] + (["segm"] if lvis_results and "segmentation" in lvis_results[0] else [])

        # the contiguous ids back to the dataset's: through the registered
        # mapping where there is one, else LVIS's 1-based ids
        if hasattr(self._metadata, "thing_dataset_id_to_contiguous_id"):
            reverse_id_mapping = {v: k for k, v in self._metadata.thing_dataset_id_to_contiguous_id.items()}
            for result in lvis_results:
                result["category_id"] = reverse_id_mapping[result["category_id"]]
        else:
            for result in lvis_results:
                result["category_id"] += 1

        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "lvis_instances_results.json"), "w") as f:
                json.dump(lvis_results, f)

        if not self._do_evaluation:
            logger.info("Annotations are not available for evaluation.")
            return {}

        self._results = OrderedDict()
        for task in sorted(tasks):
            self._results[task] = self._eval_task(lvis_results, task)
        return copy.deepcopy(self._results)

    def _eval_task(self, lvis_results, iou_type):
        if iou_type == "segm":
            lvis_results = copy.deepcopy(lvis_results)
            for c in lvis_results:
                c.pop("bbox", None)

        lvis_eval = COCOevalNP(self._lvis_api, self._lvis_api.loadRes(lvis_results), iou_type)
        lvis_eval.params.maxDets = [self._max_dets_per_image] * 3
        lvis_eval.evaluate()
        lvis_eval.accumulate()
        lvis_eval.summarize()

        metrics = ["AP", "AP50", "AP75", "APs", "APm", "APl"]
        results = {m: float(lvis_eval.stats[i] * 100 if lvis_eval.stats[i] >= 0 else "nan") for i, m in enumerate(metrics)}

        # APr / APc / APf: the precision of each frequency band's categories
        cats = sorted(self._lvis_api.dataset.get("categories", []), key=lambda x: x["id"])
        freq_groups = {"r": [], "c": [], "f": []}
        for idx, cat in enumerate(cats):
            if cat.get("frequency", None) in freq_groups:
                freq_groups[cat["frequency"]].append(idx)
        precisions = lvis_eval.eval["precision"]
        for band, idxs in freq_groups.items():
            if not idxs:
                continue
            p = precisions[:, :, idxs, 0, -1]
            p = p[p > -1]
            results[f"AP{band}"] = float(np.mean(p) * 100) if p.size else float("nan")

        logger.info(f"Evaluation results for {iou_type}: \n{results}")
        return results
