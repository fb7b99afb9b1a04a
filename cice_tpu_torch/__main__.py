"""`python -m cice_tpu_torch` is `python -m cice_tpu_torch.cli`."""

import sys

from .cli.main import main

if __name__ == "__main__":
    sys.exit(main())
