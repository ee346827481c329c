"""Command-line tools of the port (`python -m accl_tpu_torch.tools.<name>`)."""
