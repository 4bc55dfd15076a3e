"""The sharded round over torch.distributed; see the package docstring."""
