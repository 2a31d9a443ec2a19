"""Data pipelines: whitened template-bank synthesis, bank and event-product
files, MDC sets, and image directories."""
