"""2-D image GAN and PE models, the gen-1 (ganymede) family (port of
``gennet_tpu.models.image_models``; ref: tests/ganymede.py:74-261).

The public layouts are the JAX package's: images (B, n_pix, n_pix, 1),
channels last. Inside, the networks run (B, C, H, W), which is what
``F.conv2d`` takes, and flatten in flax's channels-last order, so converted
Dense kernels apply unchanged. Every layer is ``nn.Conv``, ``nn.Dense`` or
``nn.max_pool`` in the reference, so here it is cuDNN or cuBLAS; neither
of the port's kernels runs on this path.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gennet_tpu_torch.models.layers import (BatchNorm, Conv2d, Dense, PermaDropout,
                                            channels_last_flatten, upsample2d)


class ImageGenerator(nn.Module):
    """latent → Dense(1024) tanh → Dense(128·q·q) → BatchNorm(0.9) → tanh
    → reshape (q, q, 128) → Up2 → Conv(64, 5) tanh → Up2 → Conv(1, 5) tanh,
    q = n_pix / 4 (ref: ganymede.py:74-117, DCGAN shape).

    The BatchNorm acts on the flat Dense output, before the reshape, as in
    the JAX module. The keyword arguments of :meth:`forward` are the GAN
    step's (:class:`~gennet_tpu_torch.models.generator.BBHGenerator`'s);
    there is no dropout, so ``gen`` changes nothing."""

    def __init__(self, n_pix: int = 28, latent_dim: int = 100, bn_momentum: float = 0.9):
        super().__init__()
        self.n_pix, self.latent_dim = n_pix, latent_dim
        q = n_pix // 4
        self.dense0 = Dense(latent_dim, 1024)
        self.dense1 = Dense(1024, 128 * q * q)
        self.bn = BatchNorm(128 * q * q, bn_momentum)
        self.conv0 = Conv2d(128, 64, 5)
        self.conv1 = Conv2d(64, 1, 5)

    def forward(self, z, train: bool = False, bn_train: bool | None = None,
                gen: torch.Generator | None = None, commit_stats: bool = False):
        """z (B, latent) → (B, n_pix, n_pix, 1). ``bn_train`` (default:
        ``train``) picks batch-statistics BN; ``commit_stats`` advances its
        running averages from this pass."""
        bn = train if bn_train is None else bn_train
        q = self.n_pix // 4
        x = self.dense1(torch.tanh(self.dense0(z)))
        x = torch.tanh(self.bn(x, bn, commit_stats))
        x = x.view(x.shape[0], q, q, 128).permute(0, 3, 1, 2)  # NHWC → (B, 128, q, q)
        x = torch.tanh(self.conv0(upsample2d(x)))
        x = torch.tanh(self.conv1(upsample2d(x)))
        return x.permute(0, 2, 3, 1)


class ImagePE(nn.Module):
    """Conv PE: image → (x, y) blob-centre estimate (ref: ganymede.py:141-173):

    Conv(64, 5) SAME tanh → maxpool 2 → Conv(128, 5) VALID tanh → maxpool 2
    → channels-last flatten → Dense(1024) tanh → Dense(npar).

    Takes (B, n_pix, n_pix, 1); at n_pix 28 the flatten is 5·5·128.
    """

    def __init__(self, n_pix: int = 28, npar: int = 2):
        super().__init__()
        self.conv0 = Conv2d(1, 64, 5)
        self.conv1 = Conv2d(64, 128, 5, padding="VALID")
        L = (n_pix // 2 - 4) // 2
        self.dense0 = Dense(128 * L * L, 1024)
        self.dense1 = Dense(1024, npar)

    def _net(self, x, drop):
        """The network, with ``drop`` applied after each block."""
        x = F.max_pool2d(torch.tanh(self.conv0(x.permute(0, 3, 1, 2))), 2)
        x = F.max_pool2d(torch.tanh(self.conv1(drop(x))), 2)
        x = torch.tanh(self.dense0(drop(channels_last_flatten(x))))
        return self.dense1(drop(x))

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        return self._net(x, lambda h: h)


class ImageDiscriminator(ImagePE):
    """Conv(64, 5) tanh → maxpool → Conv(128, 5) VALID tanh → maxpool →
    Dense(1024) tanh → Dense(1) logit (ref: ganymede.py:211-239): the
    network of :class:`ImagePE` with one output."""

    def __init__(self, n_pix: int = 28):
        super().__init__(n_pix, npar=1)


class ImageMCDropoutPE(ImagePE):
    """MC-dropout variant of :class:`ImagePE`: :class:`PermaDropout` after
    each block stays on at inference, so repeated predictions of one image
    draw an approximate posterior (ref: ganymede.py:175-209,617-620). Every
    call needs ``gen``; each row of a batch gets its own masks, so a batch
    of copies of one image is a batch of independent draws."""

    def __init__(self, n_pix: int = 28, npar: int = 2, rate: float = 0.5):
        super().__init__(n_pix, npar)
        self.drop = PermaDropout(rate)

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        return self._net(x, lambda h: self.drop(h, gen))


class FlatImageGenerator(nn.Module):
    """:class:`ImageGenerator` emitting a flattened (B, n_pix², 1) series,
    so the image workloads run the shared GAN step
    (:func:`~gennet_tpu_torch.train.gan.gan_update`) unchanged."""

    def __init__(self, n_pix: int = 28, latent_dim: int = 100):
        super().__init__()
        self.n_pix, self.latent_dim = n_pix, latent_dim
        self.net = ImageGenerator(n_pix, latent_dim)

    def forward(self, z, train: bool = False, bn_train: bool | None = None,
                gen: torch.Generator | None = None, commit_stats: bool = False):
        img = self.net(z, train, bn_train, gen, commit_stats)
        return img.reshape(z.shape[0], -1, 1)


class FlatImageDiscriminator(nn.Module):
    """:class:`ImageDiscriminator` over a flattened (B, n_pix², 1) input."""

    def __init__(self, n_pix: int = 28):
        super().__init__()
        self.n_pix = n_pix
        self.net = ImageDiscriminator(n_pix)

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        return self.net(x.reshape(x.shape[0], self.n_pix, self.n_pix, -1), train, gen)
