"""Command-line tools of the port (``python -m nct_tpu_torch.tools.<name>``)."""
