"""SNUNet-CD with the Ensemble Channel Attention Module (ECAM); counterpart of
``kurosiwo_tpu/models/snunet.py::SNUNetECAM`` (the reference's released best
checkpoint model): a siamese nested-UNet encoder shared by both frames, a
dense UNet++ decoder fusing the two frames' features at every node, ECAM
over the four x0_j maps and a 1x1 head. Module names are the flax ones
(``conv0_0`` ... ``conv0_4``, ``UpN_M.up``, ``ca``, ``ca1``,
``conv_final``; in a block ``conv1``, ``bn1``, ``conv2``, ``bn2``), so the
bridge (``convert.py``) is a path join.

The JAX block sums part-convolutions over its dense skips so that it never
materializes their concatenation on the TPU; here one convolution runs over
the concatenation, the same function with the sums in another order. Its
BatchNorms are the port's pair-sum BatchNorm (``ops/batchnorm.py``, kernel
B3); the JAX package uses flax's autodiff BatchNorm there only to fit the
TPU's memory (``snunet.py:52-56``).

With ``remat`` (the factory turns it on at batch >= 64, as JAX's does) the
encoder blocks are checkpointed one by one, and the decoder columns
``col1`` ... ``col4`` and the ECAM head as wholes (``snunet.py:393-400``);
``save_bn_stats`` keeps each BatchNorm's batch statistics across the
recompute (``ops/remat.py``). The JAX package's phase-space variants
(``snunet_phase``, ``snunet_dts_up``) are exact TPU reparameterizations of
the same function and are not ported (ROADMAP.md, "Not to port").
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.batchnorm import BatchNorm
from ..ops.nn import ChannelAttention, Conv, ConvTranspose2x, max_pool
from ..ops.remat import remat


class ConvBlockNested(nn.Module):
    """2 x (conv3x3 + BN) with a residual from the first conv's output
    before its BN; with ``pre_pool`` the 2x2 max-pool of the input runs
    inside the block (so remat keeps only the pre-pool skip feature)."""

    def __init__(self, cin: int, mid: int, out: int, pre_pool: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.pre_pool = pre_pool
        self.conv1 = Conv(cin, mid, 3, padding=1, bias=True, generator=generator)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, out, 3, padding=1, bias=True, generator=generator)
        self.bn2 = BatchNorm(out)

    def forward(self, parts: tuple, dtype: torch.dtype) -> torch.Tensor:
        if self.pre_pool:
            parts = tuple(max_pool(p, 2, 2) for p in parts)
        x = torch.cat([p.to(dtype) for p in parts], dim=-1) if len(parts) > 1 else parts[0]
        x = self.conv1(x, dtype)
        identity = x
        x = torch.relu(self.bn1(x, dtype))
        x = self.bn2(self.conv2(x, dtype), dtype)
        return torch.relu(x + identity)


class SNUNetECAM(nn.Module):
    """``forward(xa, xb)``: two NHWC frames in, (B, H, W, num_classes) f32
    logits out; ``dtype`` overrides the compute dtype per call (the f32
    twin). H and W must be multiples of 16."""

    def __init__(self, in_channels: int, num_classes: int, base_channel: int = 32,
                 remat: bool = False, save_bn_stats: bool = True,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.save_bn_stats = save_bn_stats
        g = generator
        n1 = base_channel
        f = [n1, n1 * 2, n1 * 4, n1 * 8, n1 * 16]
        self.conv0_0 = ConvBlockNested(in_channels, f[0], f[0], generator=g)
        self.conv1_0 = ConvBlockNested(f[0], f[1], f[1], pre_pool=True, generator=g)
        self.conv2_0 = ConvBlockNested(f[1], f[2], f[2], pre_pool=True, generator=g)
        self.conv3_0 = ConvBlockNested(f[2], f[3], f[3], pre_pool=True, generator=g)
        self.conv4_0 = ConvBlockNested(f[3], f[4], f[4], pre_pool=True, generator=g)
        # node x_i_j takes both frames' x_i_0, the column's earlier x_i_k and
        # x_(i+1)_(j-1) upsampled at its own width: (j + 1) * f[i] + f[i + 1]
        for j in range(1, 5):
            for i in range(5 - j):
                self.add_module(f"conv{i}_{j}", ConvBlockNested((j + 3) * f[i], f[i], f[i],
                                                                generator=g))
                self.add_module(f"Up{i + 1}_{j - 1}", ConvTranspose2x(f[i + 1], f[i + 1],
                                                                      generator=g))
        self.ca1 = ChannelAttention(f[0], ratio=16 // 4, generator=g)
        self.ca = ChannelAttention(4 * f[0], ratio=16, generator=g)
        self.conv_final = Conv(4 * f[0], num_classes, 1, bias=True, generator=g)

    def _run(self, fn, *args):
        if self.remat and self.training:
            return remat(fn, *args, save_bn_stats=self.save_bn_stats)
        return fn(*args)

    def forward(self, xa: torch.Tensor, xb: torch.Tensor, dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        dt = dtype or self.dtype

        def block(name):
            mod = getattr(self, name)
            return lambda x: mod((x,), dt)

        def node(i, j, *parts):
            up = getattr(self, f"Up{i + 1}_{j - 1}")(parts[-1], dt)
            return getattr(self, f"conv{i}_{j}")(parts[:-1] + (up,), dt)

        # shared-weight encoder on both frames; frame B goes one level deeper
        x0_0a = self._run(block("conv0_0"), xa)
        x1_0a = self._run(block("conv1_0"), x0_0a)
        x2_0a = self._run(block("conv2_0"), x1_0a)
        x3_0a = self._run(block("conv3_0"), x2_0a)
        x0_0b = self._run(block("conv0_0"), xb)
        x1_0b = self._run(block("conv1_0"), x0_0b)
        x2_0b = self._run(block("conv2_0"), x1_0b)
        x3_0b = self._run(block("conv3_0"), x2_0b)
        x4_0b = self._run(block("conv4_0"), x3_0b)

        def col1(x0_0a, x0_0b, x1_0a, x1_0b, x2_0a, x2_0b, x3_0a, x3_0b, x4_0b):
            return (node(0, 1, x0_0a, x0_0b, x1_0b), node(1, 1, x1_0a, x1_0b, x2_0b),
                    node(2, 1, x2_0a, x2_0b, x3_0b), node(3, 1, x3_0a, x3_0b, x4_0b))

        def col2(x0_0a, x0_0b, x1_0a, x1_0b, x2_0a, x2_0b, x0_1, x1_1, x2_1, x3_1):
            return (node(0, 2, x0_0a, x0_0b, x0_1, x1_1), node(1, 2, x1_0a, x1_0b, x1_1, x2_1),
                    node(2, 2, x2_0a, x2_0b, x2_1, x3_1))

        def col3(x0_0a, x0_0b, x1_0a, x1_0b, x0_1, x0_2, x1_1, x1_2, x2_2):
            return (node(0, 3, x0_0a, x0_0b, x0_1, x0_2, x1_2),
                    node(1, 3, x1_0a, x1_0b, x1_1, x1_2, x2_2))

        def col4(x0_0a, x0_0b, x0_1, x0_2, x0_3, x1_3):
            return node(0, 4, x0_0a, x0_0b, x0_1, x0_2, x0_3, x1_3)

        def ecam_head(x0_1, x0_2, x0_3, x0_4):
            out = torch.cat([x0_1, x0_2, x0_3, x0_4], dim=-1)
            intra = x0_1 + x0_2 + x0_3 + x0_4
            ca1 = self.ca1(intra, dt)
            ca = self.ca(out, dt)
            out = ca * (out + ca1.repeat(1, 1, 1, 4))
            return self.conv_final(out, dt).float()

        x0_1, x1_1, x2_1, x3_1 = self._run(col1, x0_0a, x0_0b, x1_0a, x1_0b, x2_0a, x2_0b,
                                           x3_0a, x3_0b, x4_0b)
        x0_2, x1_2, x2_2 = self._run(col2, x0_0a, x0_0b, x1_0a, x1_0b, x2_0a, x2_0b, x0_1, x1_1,
                                     x2_1, x3_1)
        x0_3, x1_3 = self._run(col3, x0_0a, x0_0b, x1_0a, x1_0b, x0_1, x0_2, x1_1, x1_2, x2_2)
        x0_4 = self._run(col4, x0_0a, x0_0b, x0_1, x0_2, x0_3, x1_3)
        return self._run(ecam_head, x0_1, x0_2, x0_3, x0_4)
