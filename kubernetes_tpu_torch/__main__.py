"""``python -m kubernetes_tpu_torch`` — cmd/kube-scheduler/scheduler.go:33
main (the configuration half; see :mod:`kubernetes_tpu_torch.cli`)."""

import sys

from kubernetes_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
