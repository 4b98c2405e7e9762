"""Data parallelism of the port: one process per card over `torch.distributed`."""
