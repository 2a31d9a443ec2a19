"""CNN parameter point-estimators: whitened series → parameter estimates
((mc, q) for the flagship, (t0, τ) for the burst)."""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gennet_tpu_torch.models.layers import (BatchNorm, Conv1d, Dense, PermaDropout, PReLU,
                                            channels_last_flatten, dropout)


def _out_len(L: int, k: int, s: int, padding: str) -> int:
    return -(-L // s) if padding == "SAME" else (L - k) // s + 1


class DualBranchPE(nn.Module):
    """The flagship PE net (ref: signal_pe_model with comb_pe_model=False,
    bbhMahoGANy.py:356-404), one conv branch per parameter:

    mc: Conv 64 (s2 SAME), 128/256/512 (s2 VALID) → flatten → Dense(1) → relu
    q:  Conv 64 (SAME), 128/256 (VALID), 512/1024 (s2 VALID) → flatten
        → Dense(1) → sigmoid
    Takes (B, n_pix, 1), returns (B, 2) = [mc, q].
    """

    _MC = ((64, 2, "SAME"), (128, 2, "VALID"), (256, 2, "VALID"), (512, 2, "VALID"))
    _Q = ((64, 1, "SAME"), (128, 1, "VALID"), (256, 1, "VALID"),
          (512, 2, "VALID"), (1024, 2, "VALID"))

    def __init__(self, n_pix: int = 1024, filt: int = 5):
        super().__init__()
        self.mc_convs, mc_flat = self._branch(self._MC, n_pix, filt)
        self.mc_dense = Dense(mc_flat, 1)
        self.q_convs, q_flat = self._branch(self._Q, n_pix, filt)
        self.q_dense = Dense(q_flat, 1)

    @staticmethod
    def _branch(spec, L, filt):
        convs, cin = nn.ModuleList(), 1
        for feat, s, pad in spec:
            convs.append(Conv1d(cin, feat, filt, stride=s, padding=pad))
            cin, L = feat, _out_len(L, filt, s, pad)
        return convs, cin * L

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        x = x.transpose(1, 2)
        mc = x
        for conv in self.mc_convs:
            mc = F.relu(conv(mc))
        mc = F.relu(self.mc_dense(channels_last_flatten(mc)))
        q = x
        for conv in self.q_convs:
            q = F.relu(conv(q))
        q = torch.sigmoid(self.q_dense(channels_last_flatten(q)))
        return torch.cat([mc, q], dim=-1)


class CombinedPE(nn.Module):
    """The single-net PE variant (``comb_pe_model``; ref: bbhMahoGANy.py:
    308-354):

    4 × [Conv(64/128/256/512, 5, s2) VALID → PReLU → BatchNorm(0.9)], with
    Dropout(0.5) after the first block → flatten → Dense(1024) → PReLU
    → Dense(npar) → relu

    In training mode BatchNorm uses and commits the batch statistics (as
    the JAX ``cnn_update`` does with ``mutable=["batch_stats"]``) and the
    dropout mask comes from ``gen``; in eval mode BatchNorm uses the
    running averages. Takes (B, n_pix, 1), returns (B, npar).
    """

    def __init__(self, n_pix: int = 1024, npar: int = 2, filt: int = 5, bn_momentum: float = 0.9,
                 features: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.convs, self.prelus, self.norms = nn.ModuleList(), nn.ModuleList(), nn.ModuleList()
        cin, L = 1, n_pix
        for feat in features:
            self.convs.append(Conv1d(cin, feat, filt, stride=2, padding="VALID"))
            self.prelus.append(PReLU())
            self.norms.append(BatchNorm(feat, bn_momentum))
            cin, L = feat, _out_len(L, filt, 2, "VALID")
        self.dense0 = Dense(cin * L, 1024)
        self.prelu_out = PReLU()
        self.dense1 = Dense(1024, npar)

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        x = x.transpose(1, 2)
        for i, (conv, prelu, norm) in enumerate(zip(self.convs, self.prelus, self.norms)):
            x = norm(prelu(conv(x)), train, commit=train)
            if i == 0:
                x = dropout(x, 0.5, train, gen)
        x = self.prelu_out(self.dense0(channels_last_flatten(x)))
        return F.relu(self.dense1(x))


class BurstPE(nn.Module):
    """The ``smoke`` workload's PE net (port of ``BurstPE``;
    ref: burstMahoGANy.py:263-293):

    Conv(64, 5, s2) SAME relu → Conv(128, 5, s2) VALID relu → flatten
    → Dense(1024) relu → Dense(npar) linear.

    The SAME stride-2 layer pads flax's asymmetric (1, 2) (:class:`Conv1d`).
    Takes (B, n_pix, 1); at n_pix 512 the flatten is 126·128.
    """

    def __init__(self, n_pix: int = 512, npar: int = 2, filt: int = 5):
        super().__init__()
        self.conv0 = Conv1d(1, 64, filt, stride=2)
        self.conv1 = Conv1d(64, 128, filt, stride=2, padding="VALID")
        L = _out_len(_out_len(n_pix, filt, 2, "SAME"), filt, 2, "VALID")
        self.dense0 = Dense(128 * L, 1024)
        self.dense1 = Dense(1024, npar)

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        x = F.relu(self.conv0(x.transpose(1, 2)))
        x = F.relu(self.conv1(x))
        return self.dense1(F.relu(self.dense0(channels_last_flatten(x))))


class MCDropoutPE(nn.Module):
    """Monte-Carlo-dropout PE on 1-D series (port of ``MCDropoutPE``; ref:
    PermaDropout + signal_dropout_pe_model, ganymede.py:67-72,175-209):

    Conv(64, 5) SAME tanh → maxpool 2 → PermaDropout → Conv(128, 5) VALID
    tanh → maxpool 2 → flatten → PermaDropout → Dense(1024) tanh
    → PermaDropout → Dense(npar).

    The dropout stays on at inference, so every call needs ``gen`` and
    repeated calls draw an approximate posterior. Takes (B, n_pix, 1).
    """

    def __init__(self, n_pix: int = 512, npar: int = 2, rate: float = 0.5):
        super().__init__()
        self.conv0 = Conv1d(1, 64, 5)
        self.conv1 = Conv1d(64, 128, 5, padding="VALID")
        L = (n_pix // 2 - 4) // 2
        self.dense0 = Dense(128 * L, 1024)
        self.dense1 = Dense(1024, npar)
        self.drop = PermaDropout(rate)

    def forward(self, x, train: bool = False, gen: torch.Generator | None = None):
        x = F.max_pool1d(torch.tanh(self.conv0(x.transpose(1, 2))), 2)
        x = F.max_pool1d(torch.tanh(self.conv1(self.drop(x, gen))), 2)
        x = torch.tanh(self.dense0(self.drop(channels_last_flatten(x), gen)))
        return self.dense1(self.drop(x, gen))
