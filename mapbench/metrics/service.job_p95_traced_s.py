"""The 95th percentile over the jobs of the traced part, from due time to
result, under the CUDA-only trace (service cells; per layer)."""
from mapbench.harness.records import job_p95_traced_s as read  # noqa: F401
