"""Command-line tools of the port (``python -m plade_tpu_torch.tools.NAME``)."""
