"""Command-line tools of the port (micro-benchmarks)."""
