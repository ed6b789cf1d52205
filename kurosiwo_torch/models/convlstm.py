"""Encoder-decoder ConvLSTM for N-to-1 recurrent segmentation; counterpart of
``kurosiwo_tpu/models/convlstm.py`` (the reference's
``models/convlstm.py:57-227``).

The JAX module's dataflow, kept here:
  * the decoder cells take zero inputs of ``input_channels`` and are seeded
    with the reversed encoder states (h3, h2, h1);
  * the reference's ``transconv_1d``/``transconv_2d`` outputs are overwritten
    before use, so they are not built, and the parameter tree is JAX's;
  * only the last step of ``clstm_3d`` reaches ``transconv_3d``, and
    ``clstm_3d`` is seeded with h1, so the output is a function of
    ``conv_1e``, ``clstm_1e``, ``clstm_3d`` and ``transconv_3d`` alone. The
    other stages (``conv_2e``, ``clstm_2e``, ``conv_3e``, ``clstm_3e`` and
    the decoder cells they seed, ``clstm_1d``, ``clstm_2d``) reach nothing:
    XLA drops them from the JAX step, and they are not computed here. Their
    parameters exist and take zero gradients, as in JAX;
  * softmax over the classes, in f32, INSIDE the model: the trainer's cross
    entropy then treats these probabilities as logits.

A cell's gates are one conv of [x, h] (gate order i, f, g, o) and a
GroupNorm of 4F / 32 groups. A zero operand (the decoder's inputs, a first
step's hidden state) adds nothing to the conv, so its taps are left out of
the product: the same sums, and the same zero gradient for their weights.
The T frames are a Python loop (unrolled, as in JAX), in the compute dtype
on f32 parameters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import Conv, GroupNorm, TorchConvTranspose
from ..parallel.mesh import full_param


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class CLSTMCell(nn.Module):
    """ConvLSTM cell: the gates from one ``filter_size`` conv of [x, h] and a
    GroupNorm over 4F channels, flax names ``conv`` and ``norm``."""

    def __init__(self, input_channels: int, num_features: int, filter_size: int = 5,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_channels, self.num_features = input_channels, num_features
        self.conv = Conv(input_channels + num_features, 4 * num_features, filter_size,
                         padding=(filter_size - 1) // 2, bias=True, generator=generator)
        self.norm = GroupNorm(4 * num_features, 4 * num_features // 32)

    def _gates(self, x: torch.Tensor | None, h: torch.Tensor | None,
               dtype: torch.dtype) -> torch.Tensor:
        w, cin = full_param(self.conv, "weight"), self.input_channels
        if x is None:  # zero inputs: only the hidden state's taps
            inp, w = h, w[:, cin:]
        elif h is None:  # zero hidden state: only the inputs' taps
            inp, w = x, w[:, :cin]
        else:
            inp = torch.cat([x.to(dtype), h.to(dtype)], dim=-1)
        y = F.conv2d(inp.to(dtype).permute(0, 3, 1, 2), w.to(dtype), padding=self.conv.padding)
        return self.norm(y.permute(0, 2, 3, 1) + self.conv.bias.to(dtype), dtype)

    def forward(self, inputs: torch.Tensor | None, hidden: tuple | None, seq_len: int,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """``inputs`` (T, B, H, W, C) or None (zeros), ``hidden`` (h, c) or
        None (zeros). Returns the (h, c) of the last step, the only output
        the model reads (the JAX cell also returns each step's h)."""
        hx, cx = hidden if hidden is not None else (None, None)
        for t in range(seq_len):
            i, f, g, o = self._gates(None if inputs is None else inputs[t], hx, dtype).chunk(4, -1)
            ig = torch.sigmoid(i) * torch.tanh(g)
            cx = ig if cx is None else torch.sigmoid(f) * cx + ig
            hx = torch.sigmoid(o) * torch.tanh(cx)
        return hx, cx


class ConvLSTM(nn.Module):
    """3-stage strided-conv + CLSTM encoder, 3-stage CLSTM decoder seeded with
    the reversed encoder states, a 4x4/s2 transposed conv; input (B, T, H,
    W, C) NHWC frames, output (B, H, W, num_classes) f32 probabilities of
    the last step."""

    def __init__(self, in_channels: int, num_classes: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        self.conv_1e = Conv(in_channels, 16, 3, stride=2, padding=1, bias=True, generator=g)
        self.clstm_1e = CLSTMCell(16, 64, generator=g)
        self.conv_2e = Conv(64, 64, 3, stride=2, padding=1, bias=True, generator=g)
        self.clstm_2e = CLSTMCell(64, 96, generator=g)
        self.conv_3e = Conv(96, 96, 3, stride=2, padding=1, bias=True, generator=g)
        self.clstm_3e = CLSTMCell(96, 96, generator=g)
        self.clstm_1d = CLSTMCell(96, 96, generator=g)
        self.clstm_2d = CLSTMCell(96, 96, generator=g)
        self.clstm_3d = CLSTMCell(96, 64, generator=g)
        self.transconv_3d = TorchConvTranspose(64, num_classes, 4, 2, 1, generator=g)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        dt = dtype or self.dtype
        x = x.transpose(0, 1)  # time-major (T, B, H, W, C)
        t, b = x.shape[:2]

        def per_frame(v, conv):
            out = conv(v.reshape((t * b,) + v.shape[2:]), dt)
            return _lrelu(out).reshape((t, b) + out.shape[1:])

        h1 = self.clstm_1e(per_frame(x, self.conv_1e), None, t, dt)
        # stages 2e and 3e feed only clstm_2d and clstm_1d, whose outputs the
        # model discards: the output does not depend on them
        last, _ = self.clstm_3d(None, h1, t, dt)
        out = _lrelu(self.transconv_3d(last, dt))
        return torch.softmax(out.float(), dim=-1)
