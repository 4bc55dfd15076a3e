"""Local training, the rounds and eval; see the package docstring."""
