"""The launch plans of the 3x3 conv kernels (``conv_bn.conv3x3_plan`` for B6,
``conv_dw.conv3x3_dw_plan`` for B7, and B8's kind here;
test_torch_conv_fused_plan.py holds the rest of B8's plan): pure functions
of dtype and shape that the wrappers pass to csrc/conv3x3.cu and
csrc/conv_dw.cu, so the
CPU can pin which kernel each call takes, how B6's statistics partials are
sized and how B7 splits K. The routed shapes come from the UNet-ResNet18 of
the b128 train step itself (its ConvBNAct layers with both routes on).
"""

import pytest
import torch

from kurosiwo_torch import bench
from kurosiwo_torch.models.factory import initialize_segmentation_model
from kurosiwo_torch.ops import conv_bn, conv_dw, conv_fused
from kurosiwo_torch.ops.conv_dw import DwPlan
from kurosiwo_torch.ops.nn import ConvBNAct

BF16, F32 = torch.bfloat16, torch.float32
BATCH = 128


def routed_calls(batch: int = BATCH, size: int = 224):
    """(B6 shapes, B7 shapes) of one routed train step, (B, H, W, Cin, Cout)
    each, in the order the forward meets them: the input shape of every
    ConvBNAct (one eval forward of a batch of 1, scaled to ``batch``), then
    the route the layer takes in training at that batch."""
    cfg = dict(bench.build_config("unet", batch), conv_bn_kernel=True, dw_kernel=True)
    model = initialize_segmentation_model(cfg, bench.MODEL_CONFIG, device="cpu", seed=0)
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append((m, args[0].shape)))
             for m in model.modules() if isinstance(m, ConvBNAct)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, size, size, 6), F32)
    for h in hooks:
        h.remove()
    b6, b7 = [], []
    for m, (_, h, w, cin) in seen:
        shape = (batch, h, w, cin, m.Conv_0.weight.shape[0])
        if m.conv_bn_kernel:
            b6.append(shape)
        elif m._takes_dw_route(torch.empty((batch, h, w, cin), device="meta"), BF16):
            b7.append(shape)
    return b6, b7


@pytest.fixture(scope="module")
def routed():
    return routed_calls()


def test_the_routed_step_has_8_b6_and_5_b7_calls(routed):
    b6, b7 = routed
    assert sorted(b6) == sorted([(BATCH, 14, 14, 256, 256)] * 4 + [(BATCH, 7, 7, 512, 512)] * 3
                                + [(BATCH, 14, 14, 768, 256)])
    assert sorted(b7) == sorted([(BATCH, 28, 28, 128, 128)] * 4 + [(BATCH, 28, 28, 384, 128)])


def test_every_routed_bf16_call_takes_the_wgmma_kernels(routed):
    b6, b7 = routed
    for b, h, w, cin, cout in b6:
        plan = conv_bn.conv3x3_plan(BF16, b * h * w, cin, cout)
        assert plan.kernel == "wgmma", (b, h, w, cin, cout, plan)
        assert plan.tiles == -(-b * h * w // 192)
        # the grid gives each of the 132 SMs a block
        assert plan.tiles * (cout // 128) >= conv_bn.SMS
    for b, h, w, cin, cout in b7:
        assert conv_dw.conv3x3_dw_plan(BF16, b * h * w, cin, cout).kernel == "wgmma"


def test_f32_and_the_prologue_do_not_take_the_wgmma_kernel(routed):
    b6, _ = routed
    for b, h, w, cin, cout in b6:
        m = b * h * w
        assert conv_bn.conv3x3_plan(F32, m, cin, cout) == conv_bn.ConvPlan("simt", -(-m // 64))
        assert conv_bn.conv3x3_plan(BF16, m, cin, cout, "prologue") == \
            conv_bn.ConvPlan("mma_sync", -(-m // 128))


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("shape,bf16_kernel", [((128, 224, 224, 16, 16), "slab"),
                                               ((128, 112, 112, 32, 32), "slab"),
                                               ((2, 14, 14, 256, 256), "mma_sync")])
def test_b8_never_takes_the_wgmma_kernel(shape, bf16_kernel, dtype):
    """B8 has its own plan (conv_fused.conv3x3_fused_plan) and never takes
    B6's wgmma_conv3x3: bf16 at the small channel counts takes the slab
    kernel, B6's channels the mma.sync kernel, f32 the CUDA-core kernel,
    each off the mma.sync and simt kernels in their pixel tiles."""
    b, h, w, cin, cout = shape
    plan = conv_fused.conv3x3_fused_plan(dtype, b, h, w, cin, cout, True)
    kernel = bf16_kernel if dtype == BF16 else "simt"
    assert plan.kernel == kernel != "wgmma"
    if kernel != "slab":
        assert plan.grid == -(-b * h * w // conv_bn.PIXEL_TILE[kernel])


@pytest.mark.parametrize("cin,cout,kernel", [(64, 128, "wgmma"), (256, 384, "wgmma"),
                                             (24, 40, "mma_sync"), (256, 200, "mma_sync"),
                                             (96, 128, "mma_sync")])
def test_b6_bf16_kernel_by_channels(cin, cout, kernel):
    """The wgmma kernel takes Cin % 64 == 0 and Cout % 128 == 0; other bf16
    channel counts stay on the mma.sync kernel."""
    assert conv_bn.conv3x3_plan(BF16, 1000, cin, cout).kernel == kernel


@pytest.mark.parametrize("m,cout", [(BATCH * 196, 256), (BATCH * 49, 512), (48 * 196, 256),
                                    (BATCH * 49, 256), (147, 256), (1, 128)])
def test_b6_pixel_tile_and_partials(m, cout):
    """The wgmma kernel owns 192 pixels a block at every shape (rows past m
    read as 0 and are neither stored nor summed); the statistics partials
    are (tiles, 2, Cout)."""
    plan = conv_bn.conv3x3_plan(BF16, m, 256, cout)
    assert plan.kernel == "wgmma" and conv_bn.PIXEL_TILE["wgmma"] == 192
    assert plan.tiles == -(-m // 192)


def test_b6_rejects_an_unknown_epilogue():
    with pytest.raises(ValueError, match="epilogue"):
        conv_bn.conv3x3_plan(BF16, 100, 64, 128, "gelu")


@pytest.mark.parametrize("b,h,w,cin,cout", [(BATCH, 28, 28, 128, 128),
                                            (BATCH, 28, 28, 384, 128), (2, 9, 11, 128, 128),
                                            (1, 9, 7, 24, 16), (4, 8, 8, 64, 128),
                                            (3, 6, 5, 200, 72), (16, 56, 56, 64, 64)])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_b7_splits_cover_k_in_whole_chunks(b, h, w, cin, cout, dtype):
    p = b * h * w
    plan = conv_dw.conv3x3_dw_plan(dtype, p, cin, cout)
    assert plan.kernel == ("wgmma" if dtype == BF16 else "simt")
    assert plan.step == (64 if dtype == BF16 else 16)
    # every slice is whole chunks (so whole wgmma k16 steps, and a TMA box
    # never reaches into the next slice), and the slices cover K once
    assert plan.slice % plan.step == 0 and plan.slice % 16 == 0
    assert plan.splits >= 1 and plan.splits * plan.slice >= p > (plan.splits - 1) * plan.slice


def test_b7_routed_splits_fill_the_card(routed):
    """One tap's 128 x 128 (Cin x Cout) a block: 9 a slice at 128 -> 128, 27
    at 384 -> 128; 14 slices each make waves of one block an SM with less
    than one SM in twenty idle."""
    _, b7 = routed
    want = {128: DwPlan("wgmma", 64, 14, 7168, 9), 384: DwPlan("wgmma", 64, 14, 7168, 27)}
    for b, h, w, cin, cout in b7:
        plan = conv_dw.conv3x3_dw_plan(BF16, b * h * w, cin, cout)
        assert plan == want[cin]
        blocks = plan.splits * plan.tiles
        assert blocks >= 0.95 * -(-blocks // conv_dw.SMS) * conv_dw.SMS


def test_b7_f32_split_is_the_cuda_core_kernels_own():
    """f32 keeps the split its CUDA-core kernel had: about two 64 x 64 tiles'
    blocks on each SM, at least 4 chunks of 16 pixels a slice."""
    assert conv_dw.conv3x3_dw_plan(F32, BATCH * 784, 128, 128) == DwPlan("simt", 16, 8, 12544, 36)
    assert conv_dw.conv3x3_dw_plan(F32, BATCH * 784, 384, 128) == DwPlan("simt", 16, 3, 33456, 108)
    assert conv_dw.conv3x3_dw_plan(F32, 63, 24, 16) == DwPlan("simt", 16, 1, 64, 9)


@pytest.mark.parametrize("cin,cout,tiles", [(128, 128, 9), (384, 128, 27), (64, 128, 9),
                                            (24, 16, 9), (200, 72, 18), (128, 256, 18)])
def test_b7_wgmma_blocks_cover_taps_and_channels(cin, cout, tiles):
    """A slice's blocks: the 9 taps times 128-channel tiles of Cin and of
    Cout (channels past Cin or Cout read as 0)."""
    assert conv_dw.conv3x3_dw_plan(BF16, 1000, cin, cout).tiles == tiles
