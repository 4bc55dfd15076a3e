"""Slice-1 port; see the package docstring."""
