"""The in-round health lanes; see the package docstring."""
