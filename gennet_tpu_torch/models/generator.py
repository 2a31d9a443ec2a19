"""Generator networks: latent vector → noise-free waveform estimate."""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gennet_tpu_torch.models.layers import (BatchNorm, Conv1d, Dense, GaussianDropout, activation,
                                            conv1d_layer, dropout, norm_layer, upsample1d)


class BBHGenerator(nn.Module):
    """The flagship 1-D convolutional generator
    (ref: generator_model, bbhMahoGANy.py:212-295):

    latent(100) → Dense(256·n/2) → BN → tanh → Dropout(0.2) → reshape(n/2, 256)
    → [Up2 → Conv(64, 5, s2) → BN/tanh/Drop]     (length n/2)
    → [Up2 → Conv(128, 5)    → BN/tanh/Drop]     (length n)
    → [Conv(256, 5) → Conv(512, 5) → Conv(1024, 5), BN/tanh/Drop each]
    → Conv(1, 5) linear → (B, n, 1)

    BN_0 acts on the flat 256·n/2 Dense features before the reshape, as in
    the JAX module. ``norm`` is ``"batch"`` (the reference's), ``"group"``
    (flax GroupNorm, groups of 16 channels) or ``"none"``; the parameters
    differ between them, as in the JAX module. ``conv_impl`` picks
    Conv_0..n−1's implementation (``"xla"``: cuDNN, ``"pallas"``: the port's
    conv1d kernel); the 1-channel output conv is always :class:`Conv1d`, as
    in the JAX module. Parameters are the same under both.

    ``dtype`` is the compute dtype of the Dense, the norms and
    Conv_0..n−1 (``torch.bfloat16`` for ``--bf16``; the parameters and BN
    statistics stay float32). The output conv computes in float32, so the
    output is float32 at every ``dtype``, as in the JAX module.
    """

    def __init__(self, n_out: int = 1024, latent_dim: int = 100, filt: int = 5,
                 act: str = "tanh", drate: float = 0.2, bn_momentum: float = 0.99,
                 features: Sequence[int] = (64, 128, 256, 512, 1024), norm: str = "batch",
                 conv_impl: str = "xla", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_out, self.latent_dim, self.act_name, self.drate = n_out, latent_dim, act, drate
        half = n_out // 2
        self.dense = Dense(latent_dim, 256 * half, compute_dtype=dtype)
        self.norms = nn.ModuleList([norm_layer(norm, 256 * half, bn_momentum, dtype)])
        self.convs = nn.ModuleList()
        cin = 256
        for i, feat in enumerate(features):
            self.convs.append(conv1d_layer(conv_impl, cin, feat, filt, stride=2 if i == 0 else 1,
                                           compute_dtype=dtype))
            self.norms.append(norm_layer(norm, feat, bn_momentum, dtype))
            cin = feat
        self.out_conv = Conv1d(cin, 1, filt)

    def forward(self, z, train: bool = False, bn_train: bool | None = None,
                gen: torch.Generator | None = None, commit_stats: bool = False):
        """z (B, latent) → (B, n_out, 1).

        ``train`` turns dropout on (masks from ``gen``); ``bn_train``
        (default: ``train``) picks batch-statistics BN; ``commit_stats``
        advances the BN running averages from this pass.
        """
        bn = train if bn_train is None else bn_train
        act = activation(self.act_name)
        x = self.dense(z)
        x = self.norms[0](x, bn, commit_stats)
        x = dropout(act(x), self.drate, train, gen)
        x = x.view(x.shape[0], self.n_out // 2, 256).transpose(1, 2)  # (B, 256, n/2)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms[1:])):
            if i <= 1:
                x = upsample1d(x, 2)
            x = norm(conv(x), bn, commit_stats)
            x = dropout(act(x), self.drate, train, gen)
        return self.out_conv(x).transpose(1, 2)


class BurstGenerator(nn.Module):
    """The ``smoke`` workload's generator (port of ``BurstGenerator``;
    ref: burstMahoGANy.py:127-251):

    latent(100) → Dense(256·n/2) relu → reshape(n/2, 256) → Up2
    → [Conv(64) → Conv(64) → Conv(256) → Conv(512)], K 5 SAME, each relu
      then GaussianDropout(drate)
    → Conv(1, 5) tanh → (B, n, 1)

    The reshape is flax's channels-last (n/2, 256), so a converted Dense
    kernel applies unchanged. The convs are :class:`Conv1d` (cuDNN on the
    card), as the JAX module's are ``nn.Conv``. The keyword arguments of
    :meth:`forward` are :class:`BBHGenerator`'s; there is no BatchNorm, so
    ``bn_train`` and ``commit_stats`` change nothing.
    """

    def __init__(self, n_out: int = 512, latent_dim: int = 100, drate: float = 0.3,
                 features: Sequence[int] = (64, 64, 256, 512)):
        super().__init__()
        self.n_out, self.latent_dim, self.drate = n_out, latent_dim, drate
        self.dense = Dense(latent_dim, 256 * (n_out // 2))
        self.convs = nn.ModuleList()
        self.drops = nn.ModuleList()
        cin = 256
        for feat in features:
            self.convs.append(Conv1d(cin, feat, 5))
            self.drops.append(GaussianDropout(drate))
            cin = feat
        self.out_conv = Conv1d(cin, 1, 5)

    def forward(self, z, train: bool = False, bn_train: bool | None = None,
                gen: torch.Generator | None = None, commit_stats: bool = False):
        """z (B, latent) → (B, n_out, 1); ``train`` turns the Gaussian
        dropout on (noise from ``gen``)."""
        x = F.relu(self.dense(z))
        x = x.view(x.shape[0], self.n_out // 2, 256).transpose(1, 2)  # (B, 256, n/2)
        x = upsample1d(x, 2)
        for conv, drop in zip(self.convs, self.drops):
            x = drop(F.relu(conv(x)), train, gen)
        return torch.tanh(self.out_conv(x)).transpose(1, 2)


class DenseGenerator(nn.Module):
    """The gen-3 softmax-GAN generator (port of ``DenseGenerator``; ref:
    train_on_wvf_version/nn.py:72-81): Dense(dense_dim) relu → Dense(150)
    relu → Dense(n_out) tanh. z (B, latent) → (B, n_out)."""

    def __init__(self, n_out: int = 512, latent_dim: int = 10, dense_dim: int = 300):
        super().__init__()
        self.n_out, self.latent_dim = n_out, latent_dim
        self.dense0 = Dense(latent_dim, dense_dim)
        self.dense1 = Dense(dense_dim, 150)
        self.dense2 = Dense(150, n_out)

    def forward(self, z, train: bool = False, gen: torch.Generator | None = None):
        x = F.relu(self.dense1(F.relu(self.dense0(z))))
        return torch.tanh(self.dense2(x))


class TransposeGenerator(nn.Module):
    """The gen-4 anti-mode-collapse generator (port of
    ``TransposeGenerator``; ref: 2_model_version/*/no_mode_collapse_network.py):

    latent(1) → Dense(n_out) → reshape (n_out, 1)
    → [ConvT(512/256/128/64, 5) → act → BatchNorm(0.9)] → ConvT(1, 5) tanh
    → (B, n_out, 1)

    flax's ``nn.ConvTranspose`` at stride 1 with SAME padding (and
    ``transpose_kernel=False``) is a cross-correlation with the kernel's
    taps as stored, the very computation of ``nn.Conv``: so its layers are
    :class:`Conv1d` with the converted kernel, and not
    ``nn.ConvTranspose1d``, which flips the taps. The keyword arguments of
    :meth:`forward` are :class:`BBHGenerator`'s; there is no dropout.
    """

    def __init__(self, n_out: int = 512, latent_dim: int = 1,
                 features: Sequence[int] = (512, 256, 128, 64), act: str = "relu",
                 bn_momentum: float = 0.9):
        super().__init__()
        self.n_out, self.latent_dim, self.act_name = n_out, latent_dim, act
        self.dense = Dense(latent_dim, n_out)
        self.convs, self.norms = nn.ModuleList(), nn.ModuleList()
        cin = 1
        for feat in features:
            self.convs.append(Conv1d(cin, feat, 5))
            self.norms.append(BatchNorm(feat, bn_momentum))
            cin = feat
        self.out_conv = Conv1d(cin, 1, 5)

    def forward(self, z, train: bool = False, bn_train: bool | None = None,
                gen: torch.Generator | None = None, commit_stats: bool = False):
        bn = train if bn_train is None else bn_train
        act = activation(self.act_name)
        x = self.dense(z)[:, None, :]  # (B, 1, n_out)
        for conv, norm in zip(self.convs, self.norms):
            x = norm(act(conv(x)), bn, commit_stats)
        return torch.tanh(self.out_conv(x)).transpose(1, 2)
