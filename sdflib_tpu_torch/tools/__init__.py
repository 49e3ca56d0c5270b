"""The CLI tools, each run as ``python -m sdflib_tpu_torch.tools.<tool>``."""
