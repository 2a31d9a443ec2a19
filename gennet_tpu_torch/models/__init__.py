"""Networks of the flagship path (generator, pair discriminator, CNN PE) and
of the burst ``smoke`` workload."""

from gennet_tpu_torch.models.cnn_pe import BurstPE, CombinedPE, DualBranchPE
from gennet_tpu_torch.models.discriminator import BurstDiscriminator, PairDiscriminator
from gennet_tpu_torch.models.generator import BBHGenerator, BurstGenerator

__all__ = ["BBHGenerator", "PairDiscriminator", "DualBranchPE", "CombinedPE", "BurstGenerator",
           "BurstDiscriminator", "BurstPE"]
