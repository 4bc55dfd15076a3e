"""Tree arithmetic, optimizer ops, server rules and the RLR kernels; see
the package docstring."""
