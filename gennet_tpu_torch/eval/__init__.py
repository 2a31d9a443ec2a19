"""Evaluation: β overlap, residual whiteness, exact grid posterior."""
