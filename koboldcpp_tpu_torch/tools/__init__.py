"""Command-line tools of the port (`python -m koboldcpp_tpu_torch.tools.<name>`)."""
