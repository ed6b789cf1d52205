"""Fully convolutional siamese UNets for change detection (Daudt et al.
2018); counterpart of ``kurosiwo_tpu/models/siam.py``. ``SiamUnetDiff``'s
decoder skips take |f1 - f2| per level, ``SiamUnetConc``'s concatenate
(f1, f2). A shared 4-stage encoder runs on both frames; the decoder runs on
frame B's pooled bottom, with torch-geometry transposed convs, the
replication pad to each skip's shape, and channel dropout 0.2 after every
BatchNorm. The outputs are the reference's: log-softmax for diff, softmax
for conc, both consumed by the trainer's cross entropy as "logits".

Module names are the flax ones (``encoder.c11`` ... ``c43``, ``upconv4``
... ``upconv1``, ``dec4_0`` ... ``dec1_0``, ``classifier``; in a block
``conv``, ``bn``, ``do``). The dropout masks come from the ``generator``
``forward`` is given (``ops/nn.Dropout2d``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.batchnorm import BatchNorm
from ..ops.nn import Conv, Dropout2d, TorchConvTranspose, max_pool, replication_pad_to

_ENCODER = (("c11", 16), ("c12", 16), None, ("c21", 32), ("c22", 32), None,
            ("c31", 64), ("c32", 64), ("c33", 64), None,
            ("c41", 128), ("c42", 128), ("c43", 128), None)  # None: a 2x2 max-pool
# (upconv channels, the conv chain's channels) of decoder stages 4 .. 1
_DECODER = ((128, (128, 128, 64)), (64, (64, 64, 32)), (32, (32, 16)), (16, (16,)))


class _ConvBNDrop(nn.Module):
    """conv3x3 (or, decoder flavour, a k3/s1/p1 transposed conv) -> BN ->
    ReLU -> Dropout2d(0.2)."""

    def __init__(self, cin: int, features: int, transposed: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if transposed:
            self.conv = TorchConvTranspose(cin, features, 3, 1, 1, generator=generator)
        else:
            self.conv = Conv(cin, features, 3, padding=1, bias=True, generator=generator)
        self.bn = BatchNorm(features)
        self.do = Dropout2d(0.2)

    def forward(self, x, dtype, generator=None):
        return self.do(torch.relu(self.bn(self.conv(x, dtype), dtype)), generator)


class _Encoder(nn.Module):
    def __init__(self, in_channels: int, generator: torch.Generator | None = None):
        super().__init__()
        cin = in_channels
        for spec in _ENCODER:
            if spec is not None:
                self.add_module(spec[0], _ConvBNDrop(cin, spec[1], generator=generator))
                cin = spec[1]

    def forward(self, x, dtype, generator=None):
        """The four stages' pre-pool features and the pooled bottom."""
        skips = []
        for spec in _ENCODER:
            if spec is None:
                skips.append(x)
                x = max_pool(x, 2, 2)
            else:
                x = getattr(self, spec[0])(x, dtype, generator)
        return skips, x


class _SiamUNet(nn.Module):
    fuse_factor = 1  # channels of the fused skip per channel of one frame's

    def __init__(self, in_channels: int, num_classes: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.encoder = _Encoder(in_channels, generator=g)
        cin, skip_ch = 128, (128, 64, 32, 16)
        for idx, (up_ch, chain) in enumerate(_DECODER):
            stage = 4 - idx
            self.add_module(f"upconv{stage}", TorchConvTranspose(cin, up_ch, 3, 2, 1, 1,
                                                                 generator=g))
            cin = up_ch + self.fuse_factor * skip_ch[idx]
            for ci, ch in enumerate(chain):
                self.add_module(f"dec{stage}_{ci}", _ConvBNDrop(cin, ch, transposed=True,
                                                                generator=g))
                cin = ch
        self.classifier = TorchConvTranspose(cin, num_classes, 3, 1, 1, generator=g)

    def fuse(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def activation(self, logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        skips_a, _ = self.encoder(x1, dt, generator)
        skips_b, y = self.encoder(x2, dt, generator)
        for idx, (_, chain) in enumerate(_DECODER):
            stage = 4 - idx
            a, b = skips_a[3 - idx], skips_b[3 - idx]
            y = getattr(self, f"upconv{stage}")(y, dt)
            y = replication_pad_to(y, a.shape[1], a.shape[2])
            y = torch.cat([y, self.fuse(a, b)], dim=-1)
            for ci in range(len(chain)):
                y = getattr(self, f"dec{stage}_{ci}")(y, dt, generator)
        return self.activation(self.classifier(y, dt).float())


class SiamUnetDiff(_SiamUNet):
    def fuse(self, a, b):
        return torch.abs(a - b)

    def activation(self, logits):
        return torch.log_softmax(logits, dim=-1)


class SiamUnetConc(_SiamUNet):
    fuse_factor = 2

    def fuse(self, a, b):
        return torch.cat([a, b], dim=-1)

    def activation(self, logits):
        return torch.softmax(logits, dim=-1)
