"""Discriminator networks."""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gennet_tpu_torch.models.layers import (Conv1d, Dense, activation, channels_last_flatten,
                                            conv1d_layer, dropout)


class PairDiscriminator(nn.Module):
    """The flagship discriminator over (waveform, residual) pairs
    (ref: signal_discriminator_model, bbhMahoGANy.py:408-498), as a 1-D
    convolution over time with the pair as 2 input channels:
    Conv(256, 5, s2) → Conv(512, 5, s2), LeakyReLU 0.2, Dropout 0.4,
    Dense(1) logit. Takes (B, n_pix, in_ch): ``in_ch`` 2 for the pairs,
    1 for the raw series of ``pair_discriminator=False``. ``conv_impl`` as
    in :class:`~gennet_tpu_torch.models.generator.BBHGenerator` (under
    ``"pallas"`` the first layer then runs the conv kernel at Cin 1).
    ``dtype`` is the convs' compute dtype; the Dense computes in float32, so
    the logits are float32 at every ``dtype``, as in the JAX module."""

    def __init__(self, features: Sequence[int] = (256, 512), filt: int = 5, drate: float = 0.4,
                 alpha: float = 0.2, n_pix: int = 1024, in_ch: int = 2, conv_impl: str = "xla",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drate, self.alpha = drate, alpha
        self.convs = nn.ModuleList()
        cin, L = in_ch, n_pix
        for feat in features:
            self.convs.append(conv1d_layer(conv_impl, cin, feat, filt, stride=2,
                                           compute_dtype=dtype))
            cin, L = feat, -(-L // 2)
        self.dense = Dense(cin * L, 1)

    def forward(self, pair, train: bool = False, gen: torch.Generator | None = None):
        x = pair.transpose(1, 2)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), negative_slope=self.alpha)
            x = dropout(x, self.drate, train, gen)
        return self.dense(channels_last_flatten(x))


class BurstDiscriminator(nn.Module):
    """The ``smoke`` workload's discriminator on raw 1-D series (port of
    ``BurstDiscriminator``; ref: burstMahoGANy.py:295-402):

    Conv(64, 5) SAME tanh → maxpool 2 → Conv(128, 5) VALID tanh → maxpool 2
    → channels-last flatten → Dense(1024) tanh → Dense(1) logit.

    Takes (B, n_pix, 1); at n_pix 512 the flatten is 126·128. The convs are
    :class:`Conv1d` (cuDNN on the card), as the JAX module's are ``nn.Conv``.
    """

    def __init__(self, n_pix: int = 512, act: str = "tanh"):
        super().__init__()
        self.act_name = act
        self.conv0 = Conv1d(1, 64, 5)
        self.conv1 = Conv1d(64, 128, 5, padding="VALID")
        L = ((n_pix // 2) - 4) // 2
        self.dense0 = Dense(128 * L, 1024)
        self.dense1 = Dense(1024, 1)

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        act = activation(self.act_name)
        x = F.max_pool1d(act(self.conv0(x.transpose(1, 2))), 2)
        x = F.max_pool1d(act(self.conv1(x)), 2)
        return self.dense1(act(self.dense0(channels_last_flatten(x))))


class SoftmaxDiscriminator(nn.Module):
    """The gen-3 two-class discriminator (port of ``SoftmaxDiscriminator``;
    ref: train_on_wvf_version/nn.py:83-93):

    Conv(n_channels, conv_sz) VALID relu → Dropout(drate) → channels-last
    flatten → Dense(n_channels) → Dense(2) logits.

    Takes (B, n_pix, 1), or (B, n_pix) as one channel. Dropout is flax
    ``nn.Dropout`` (:func:`~gennet_tpu_torch.models.layers.dropout`), on
    with ``train`` and masks from ``gen``.
    """

    def __init__(self, n_pix: int = 512, n_channels: int = 25, conv_sz: int = 5,
                 drate: float = 0.25):
        super().__init__()
        self.drate = drate
        self.conv = Conv1d(1, n_channels, conv_sz, padding="VALID")
        self.dense0 = Dense(n_channels * (n_pix - conv_sz + 1), n_channels)
        self.dense1 = Dense(n_channels, 2)

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        if x.ndim == 2:
            x = x[..., None]
        x = dropout(F.relu(self.conv(x.transpose(1, 2))), self.drate, train, gen)
        return self.dense1(self.dense0(channels_last_flatten(x)))
