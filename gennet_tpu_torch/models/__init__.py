"""Networks of the flagship path (generator, pair discriminator, CNN PE), of
the burst ``smoke`` workload, and of the variant generations (the image
models live in :mod:`~gennet_tpu_torch.models.image_models`, as in the JAX
package)."""

from gennet_tpu_torch.models.cnn_pe import BurstPE, CombinedPE, DualBranchPE, MCDropoutPE
from gennet_tpu_torch.models.discriminator import (BurstDiscriminator, PairDiscriminator,
                                                   SoftmaxDiscriminator)
from gennet_tpu_torch.models.generator import (BBHGenerator, BurstGenerator, DenseGenerator,
                                               TransposeGenerator)

__all__ = ["BBHGenerator", "BurstGenerator", "DenseGenerator", "TransposeGenerator",
           "PairDiscriminator", "BurstDiscriminator", "SoftmaxDiscriminator", "DualBranchPE",
           "CombinedPE", "BurstPE", "MCDropoutPE"]
