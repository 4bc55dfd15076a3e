"""The fault model and the participation mask; see the package docstring."""
