"""Profiling entry points of the port (`python -m castro_tpu_torch.scripts.<name>`)."""
