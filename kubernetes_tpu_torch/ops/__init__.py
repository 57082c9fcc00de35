"""Device-side scheduling operators on PyTorch tensors: device tables
(arrays), Filter (predicates), Score (priorities, fused_score), the
transport plan (sinkhorn) and the batch solvers (assign)."""
