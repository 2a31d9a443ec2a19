"""Networks of the flagship path: generator, pair discriminator, CNN PE."""

from gennet_tpu_torch.models.cnn_pe import DualBranchPE
from gennet_tpu_torch.models.discriminator import PairDiscriminator
from gennet_tpu_torch.models.generator import BBHGenerator

__all__ = ["BBHGenerator", "PairDiscriminator", "DualBranchPE"]
