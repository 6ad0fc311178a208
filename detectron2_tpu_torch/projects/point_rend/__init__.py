from detectron2_tpu_torch.projects.point_rend.point_features import point_sample

__all__ = ["point_sample"]
