"""Command-line entry point and the flagship workload."""
