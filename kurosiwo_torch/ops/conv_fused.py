"""Forward 3x3 convolution with a bias (+ ReLU) epilogue for small channel
counts, through the hand-written kernel ``csrc/conv3x3.cu`` (B8, the second
epilogue of B6's implicit GEMM).

Counterpart of ``kurosiwo_tpu/ops/pallas_conv.py::conv3x3_fused``
(``_conv_kernel``): y = [relu](conv3x3_SAME(x, w) + b) in x's dtype, the
bias added in f32. Like the TPU kernel it is wired into no model: no path of
the port launches it; ``chip_smoke.py`` holds it against its plain version
at the UNet's 224^2 x 16 and 112^2 x 32 decoder shapes.

Layouts: x (B, H, W, Cin), w (3, 3, Cin, Cout), b (Cout,). The wrapper takes
the plain version for a CPU tensor; for a CUDA tensor it launches the kernel
or raises. ``conv3x3_fused.launches`` counts kernel wrapper calls.
"""

from __future__ import annotations

import torch

from .. import kernels
from .conv_bn import (CONV3X3_KERNELS, check_conv3x3, check_cuda, conv3x3_plain_f32,
                      conv3x3_plan, lib)


def conv3x3_fused_plain(x, w, b, relu: bool = True):
    """The TPU kernel's arithmetic: the conv in f32, plus the f32 bias,
    [ReLU], rounded to x's dtype."""
    y = conv3x3_plain_f32(x, w) + b.float()
    return (torch.relu(y) if relu else y).to(x.dtype)


def conv3x3_fused(x, w, b, relu: bool = True):
    """[relu](conv3x3 SAME stride 1 (x, w) + b), (B, H, W, Cout) in x's
    dtype; any Cin and Cout."""
    check_conv3x3(x, w, "conv3x3_fused")
    cout = w.shape[-1]
    if b.shape != (cout,):
        raise ValueError(f"conv3x3_fused: bias must be ({cout},), got {tuple(b.shape)}")
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, b, relu)
    check_cuda("conv3x3_fused", x.dtype, x.device, x=x, w=w)
    bias = b.float().contiguous()
    check_cuda("conv3x3_fused", torch.float32, x.device, b=bias)
    bsz, h, wd, cin = x.shape
    plan = conv3x3_plan(x.dtype, bsz * h * wd, cin, cout, "bias")
    y = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    k = lib()
    err = k.ks_conv3x3_bias_act(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                bsz * h * wd, h, wd, cin, cout, int(relu),
                                int(x.dtype == torch.bfloat16), CONV3X3_KERNELS[plan.kernel],
                                kernels.stream_ptr(x))
    kernels.check(k, err, "conv3x3_fused launch")
    conv3x3_fused.launches += 1
    return y


conv3x3_fused.launches = 0
