"""Device-side scheduling operators on PyTorch tensors: device tables
(arrays), Filter (predicates), Score (priorities, fused_score), the
transport plan (sinkhorn), the batch solvers (assign) and the scenario
packs' cost terms and quality reduction (scenario_cost)."""
