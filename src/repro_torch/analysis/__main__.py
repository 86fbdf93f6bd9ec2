"""``python -m repro_torch.analysis`` == the ``reprolint-torch`` console script."""
import sys

from .cli import main

sys.exit(main())
