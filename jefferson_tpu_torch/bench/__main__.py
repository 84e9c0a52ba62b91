"""``python -m jefferson_tpu_torch.bench --device cuda``: the bench (see
``jefferson_tpu_torch/bench/__init__.py``)."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
