"""Discriminator network."""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gennet_tpu_torch.models.layers import Dense, channels_last_flatten, conv1d_layer, dropout


class PairDiscriminator(nn.Module):
    """The flagship discriminator over (waveform, residual) pairs
    (ref: signal_discriminator_model, bbhMahoGANy.py:408-498), as a 1-D
    convolution over time with the pair as 2 input channels:
    Conv(256, 5, s2) → Conv(512, 5, s2), LeakyReLU 0.2, Dropout 0.4,
    Dense(1) logit. Takes (B, n_pix, 2). ``conv_impl`` as in
    :class:`~gennet_tpu_torch.models.generator.BBHGenerator`."""

    def __init__(self, features: Sequence[int] = (256, 512), filt: int = 5, drate: float = 0.4,
                 alpha: float = 0.2, n_pix: int = 1024, in_ch: int = 2, conv_impl: str = "xla"):
        super().__init__()
        self.drate, self.alpha = drate, alpha
        self.convs = nn.ModuleList()
        cin, L = in_ch, n_pix
        for feat in features:
            self.convs.append(conv1d_layer(conv_impl, cin, feat, filt, stride=2))
            cin, L = feat, -(-L // 2)
        self.dense = Dense(cin * L, 1)

    def forward(self, pair, train: bool = False, gen: torch.Generator | None = None):
        x = pair.transpose(1, 2)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), negative_slope=self.alpha)
            x = dropout(x, self.drate, train, gen)
        return self.dense(channels_last_flatten(x))
