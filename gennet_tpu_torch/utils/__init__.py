"""Small shared utilities."""

from gennet_tpu_torch.utils.summary import model_summary, param_count

__all__ = ["model_summary", "param_count"]
