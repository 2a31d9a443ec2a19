"""Compute ops: inverse real DFT tables and the phasor → iDFT CUDA kernel."""
