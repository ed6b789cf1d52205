"""FloodViT finetuned for dense segmentation; counterpart of
``kurosiwo_tpu/models/finetuner.py`` (``DeconvDecoder``,
``FinetunerSegmentation``, ``:24-65``).

The ViT (``pool="cls"``) returns its patch tokens; they are laid out as
the (image_size / patch, image_size / patch) grid with the embedding as
channels, and one of three heads makes the logits:
  mlp     : bilinear resize to image_size, 1x1 conv -> ReLU -> 1x1 conv
            (``head_fc1``, ``head_fc2``)
  decoder : ``head``, three k4/s2/p1 transposed convs with a 2x nearest
            upsample between the first and the second
  linear  : bilinear resize to image_size, one 1x1 conv (``head_fc``)
The logits come out in f32. The encoder's attention is the ViT's: the
short-attention kernel (B4) at 197 tokens in heads of 64.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nn import Conv, TorchConvTranspose, resize_bilinear, upsample2x
from .vit import ViT

HEADS = ("mlp", "decoder", "linear")


class DeconvDecoder(nn.Module):
    """``deconv1`` (to 128), ReLU, 2x nearest, ``deconv2`` (to 64), ReLU,
    ``deconv3`` (to num_classes): each k4/s2/p1, 16x in all."""

    def __init__(self, cin: int, num_classes: int, generator: torch.Generator | None = None):
        super().__init__()
        self.deconv1 = TorchConvTranspose(cin, 128, 4, 2, 1, generator=generator)
        self.deconv2 = TorchConvTranspose(128, 64, 4, 2, 1, generator=generator)
        self.deconv3 = TorchConvTranspose(64, num_classes, 4, 2, 1, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = upsample2x(torch.relu(self.deconv1(x, dtype)))
        return self.deconv3(torch.relu(self.deconv2(x, dtype)), dtype)


class FinetunerSegmentation(nn.Module):
    """NHWC image of side ``image_size`` in, (B, image_size, image_size,
    num_classes) f32 logits out; another side raises, naming the key."""

    def __init__(self, encoder: ViT, num_classes: int = 3, head: str = "mlp",
                 finetuning_patch_size: int = 16, image_size: int = 224,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"finetuner head {head!r}: one of {HEADS}")
        self.encoder = encoder
        self.head_kind = head
        self.image_size = image_size
        self.grid = image_size // finetuning_patch_size
        self.dtype = dtype
        dim, g = encoder.dim, generator
        if head == "decoder":
            self.head = DeconvDecoder(dim, num_classes, generator=g)
        elif head == "mlp":
            self.head_fc1 = Conv(dim, 512, 1, bias=True, generator=g)
            self.head_fc2 = Conv(512, num_classes, 1, bias=True, generator=g)
        else:
            self.head_fc = Conv(dim, num_classes, 1, bias=True, generator=g)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        if tuple(x.shape[1:3]) != (self.image_size, self.image_size):
            raise ValueError(f"the finetuner's ViT is built for {self.image_size}x"
                             f"{self.image_size} inputs (config image_size), got "
                             f"{tuple(x.shape[1:3])}")
        tokens = self.encoder(x, dt)  # (B, N, D): the patch tokens
        grid = tokens.reshape(tokens.shape[0], self.grid, self.grid, tokens.shape[-1])
        size = (self.image_size, self.image_size)
        if self.head_kind == "decoder":
            out = self.head(grid, dt)
        elif self.head_kind == "mlp":
            out = self.head_fc2(torch.relu(self.head_fc1(resize_bilinear(grid, size), dt)), dt)
        else:
            out = self.head_fc(resize_bilinear(grid, size), dt)
        return out.float()
