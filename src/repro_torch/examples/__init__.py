"""The examples of ``examples/`` on the port: run as ``python -m
repro_torch.examples.<name> [--device cpu]``."""
