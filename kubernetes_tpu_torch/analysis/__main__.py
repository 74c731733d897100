"""`python -m kubernetes_tpu_torch.analysis` — the ktpu-lint CLI."""

import sys

from kubernetes_tpu_torch.analysis import main

if __name__ == "__main__":
    sys.exit(main())
