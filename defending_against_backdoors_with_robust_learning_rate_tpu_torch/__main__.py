"""`python -m defending_against_backdoors_with_robust_learning_rate_tpu_torch`
— the port's CLI (counterpart: the JAX package's `__main__.py`)."""

import sys

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.train import main

if __name__ == "__main__":
    sys.exit(main())
