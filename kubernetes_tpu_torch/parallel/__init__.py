"""The sharded execution backend's host side (the port of
``kubernetes_tpu/parallel``). Only :mod:`.costmodel` is ported: the
analytic scale-out model the perf ledger divides by. The node-axis mesh
(``parallel/mesh.py``) is ROADMAP A.17."""
