"""Command-line entry points: ``python -m distributed_tensorflow_tpu_torch.cli.serve``."""
