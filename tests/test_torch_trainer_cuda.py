"""DefaultTrainer on the card: two steps of the train->AP gate's config
(``testing.overfit_config``) from a registered synthetic COCO dataset launch
the RoIAlign forward and backward kernels twice each per step, and the
checkpoint they save loads back onto the card, equal to the trained model.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit (``tests/conftest.py``
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trainer_cuda.py -q

Without a card every test skips.
"""

import os

import pytest
import torch

from detectron2_tpu_torch.data import DatasetCatalog
from detectron2_tpu_torch.data.datasets import register_coco_instances
from detectron2_tpu_torch.engine import DefaultTrainer
from detectron2_tpu_torch.ops.roi_align import roi_align_multilevel_backward_cuda, roi_align_multilevel_cuda
from detectron2_tpu_torch.testing import overfit_config, write_synthetic_overfit_coco

NAME = "card_overfit"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RoIAlign kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_trainer_steps_launch_both_kernels_and_checkpoint_on_the_card(cuda, tmp_path):
    json_file, image_dir = write_synthetic_overfit_coco(str(tmp_path / "data"))
    if NAME not in DatasetCatalog:
        register_coco_instances(NAME, {}, json_file, image_dir)
    cfg = overfit_config(str(tmp_path / "out"), NAME)
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 1
    cfg.DATASETS.TEST = ()
    cfg.TEST.EXPECTED_RESULTS = []
    trainer = DefaultTrainer(cfg)
    assert trainer.model.device.type == "cuda"
    roi_align_multilevel_cuda.launches = 0
    roi_align_multilevel_backward_cuda.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    assert roi_align_multilevel_cuda.launches == 2 * 2
    assert roi_align_multilevel_backward_cuda.launches == 2 * 2
    losses = trainer.storage.history("total_loss").values()
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(v)) for v, _ in losses)

    path = os.path.join(cfg.OUTPUT_DIR, "model_final.pth")
    saved = torch.load(path, weights_only=True)
    assert saved["iteration"] == 1
    second = DefaultTrainer(cfg)
    second.resume_or_load(resume=True)
    assert second.start_iter == 2
    for k, v in second.model.state_dict().items():
        assert v.device.type == "cuda", k
        assert torch.equal(v, trainer.model.state_dict()[k]), k
    for i, state in second.optimizer.state_dict()["state"].items():
        assert state["momentum_buffer"].device.type == "cuda"
        assert torch.equal(state["momentum_buffer"], trainer.optimizer.state_dict()["state"][i]["momentum_buffer"])
