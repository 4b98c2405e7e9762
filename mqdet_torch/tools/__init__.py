"""Command-line tools of the port (run with `python -m mqdet_torch.tools.<name>`)."""
