"""Data pipelines: whitened template-bank synthesis."""
