"""Stands in for TensorFlow in the tool subprocesses of
``tests/test_torch_protocol.py``, which put this directory first on their
``PYTHONPATH``: importing it fails, as on a machine without TensorFlow (the
card's), so ``tensorboard`` takes its own stub and the trainer's stage
starts in seconds instead of loading TensorFlow."""

raise ImportError("TensorFlow is hidden from this process")
