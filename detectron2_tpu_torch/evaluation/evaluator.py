"""The evaluation loop: the DatasetEvaluator protocol and inference_on_dataset
(a copy of ``detectron2_tpu/evaluation/evaluator.py``), on the padded batch
contract: the loader yields fixed-shape batch dicts, the model callable
returns the padded detections dict, and evaluators receive (batch, outputs)
where batch["metadata"] carries the per-image info.
"""

import datetime
import logging
import time
from collections import OrderedDict, abc
from typing import Callable, List, Optional, Union

import torch

__all__ = ["DatasetEvaluator", "DatasetEvaluators", "inference_on_dataset"]


class DatasetEvaluator:
    """Base class for a dataset evaluator: reset / process / evaluate."""

    def reset(self):
        pass

    def process(self, inputs, outputs):
        """
        Args:
            inputs: the batch dict fed to the model (with "metadata").
            outputs: the model's padded outputs for the batch.
        """
        pass

    def evaluate(self):
        pass


class DatasetEvaluators(DatasetEvaluator):
    """Wrapper for running multiple evaluators together."""

    def __init__(self, evaluators: List[DatasetEvaluator]):
        super().__init__()
        self._evaluators = evaluators

    def reset(self):
        for evaluator in self._evaluators:
            evaluator.reset()

    def process(self, inputs, outputs):
        for evaluator in self._evaluators:
            evaluator.process(inputs, outputs)

    def evaluate(self):
        results = OrderedDict()
        for evaluator in self._evaluators:
            result = evaluator.evaluate()
            if result is not None and len(result):
                for k, v in result.items():
                    assert k not in results, f"Different evaluators produce results with the same key {k}"
                    results[k] = v
        return results


def _synchronize(outputs) -> None:
    """Wait for the device work behind ``outputs``: a CUDA synchronize of each
    CUDA device they lie on (where the JAX package blocks until ready)."""
    devices = {v.device for v in outputs.values() if isinstance(v, torch.Tensor) and v.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def inference_on_dataset(
    predict_fn: Callable,
    data_loader,
    evaluator: Optional[Union[DatasetEvaluator, List[DatasetEvaluator]]],
    total: Optional[int] = None,
    timing: Optional[dict] = None,
):
    """Run predict_fn over all batches and evaluate.

    Args:
        predict_fn: batch dict -> padded detections (the model in eval mode).
        data_loader: an iterable of batch dicts.
        evaluator: evaluator(s) or None (for benchmarking only).
        total: optional total batch count for ETA logging.
        timing: optional dict that receives the batch count and the seconds
            of the whole loop and of its data, compute and evaluator parts,
            over the ``timed_batches`` after the first two (the warm-up;
            over all batches when there are no more).

    Returns:
        evaluator.evaluate() results.
    """
    logger = logging.getLogger(__name__)
    logger.info("Start inference on %s batches", total if total is not None else "?")

    timing = {} if timing is None else timing
    if evaluator is None:
        evaluator = DatasetEvaluators([])
    if isinstance(evaluator, abc.MutableSequence):
        evaluator = DatasetEvaluators(evaluator)
    evaluator.reset()

    num_warmup = 2
    start_time = time.perf_counter()
    total_data_time = 0.0
    total_compute_time = 0.0
    total_eval_time = 0.0

    idx = -1
    last_log = time.perf_counter()
    start_data_time = time.perf_counter()
    for idx, batch in enumerate(data_loader):
        total_data_time += time.perf_counter() - start_data_time
        if idx == num_warmup:
            start_time = time.perf_counter()
            total_data_time = 0.0
            total_compute_time = 0.0
            total_eval_time = 0.0

        start_compute_time = time.perf_counter()
        outputs = predict_fn(batch)
        _synchronize(outputs)
        total_compute_time += time.perf_counter() - start_compute_time

        start_eval_time = time.perf_counter()
        evaluator.process(batch, outputs)
        total_eval_time += time.perf_counter() - start_eval_time

        iters_after_start = idx + 1 - num_warmup * int(idx >= num_warmup)
        if idx >= num_warmup * 2:
            compute_seconds_per_iter = total_compute_time / iters_after_start
            total_seconds_per_iter = (time.perf_counter() - start_time) / iters_after_start
            if total is not None:
                eta = datetime.timedelta(seconds=int(total_seconds_per_iter * (total - idx - 1)))
                now = time.perf_counter()
                if now - last_log >= 5:
                    logger.info(f"Inference done {idx + 1}/{total}. {compute_seconds_per_iter:.4f} s/batch. ETA={eta}")
                    last_log = now
        start_data_time = time.perf_counter()

    total_time = time.perf_counter() - start_time
    timing.update(
        batches=idx + 1,
        timed_batches=idx + 1 - num_warmup if idx >= num_warmup else idx + 1,
        total_s=total_time,
        data_s=total_data_time,
        compute_s=total_compute_time,
        eval_s=total_eval_time,
    )
    logger.info(
        "Total inference time: %s (%d batches, %.4f s/batch data, %.4f s/batch compute, %.4f s/batch eval)",
        str(datetime.timedelta(seconds=total_time)),
        idx + 1,
        total_data_time / max(idx + 1, 1),
        total_compute_time / max(idx + 1, 1),
        total_eval_time / max(idx + 1, 1),
    )

    results = evaluator.evaluate()
    if results is None:
        results = {}
    return results
