"""Operational tools (ref: src/tools, src/benchmarks, scripts/run-tsbs.sh)."""
