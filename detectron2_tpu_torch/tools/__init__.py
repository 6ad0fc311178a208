"""Command-line entry points of the port (``python -m detectron2_tpu_torch.tools.train_net``)."""
