"""The fused ConvBlock's launch shape and its CUDA-only limit, on the CPU.

conv_block_layout mirrors csrc/conv_block.cu's tiling (the CUDA tests hold
it to the C functions on the card); conv_block_refusal binds CUDA tensors
only, so a CPU call takes conv_block_plain at any width; conv_block_plain
keeps float64 operands in float64 (the kernel's precision reference).
Pure torch: no JAX, no model.
"""

import pytest
import torch

from dhg_torch.kernels import fused_conv_block as fc
from dhg_torch.kernels.build import MAX_SMEM


def _ops(b, t, cin, co, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    c2 = co // 2
    shapes = [(3, cin, co), (co,), (3, cin, c2), (c2,), (3, c2, co), (co,), (co, co), (co,),
              (b, c2), (b, c2), (b, co), (b, co), (b, co), (b, co)]
    ops = [0.1 * torch.randn(*s, generator=g, dtype=dtype) for s in shapes]
    return torch.randn(b, t, cin, generator=g, dtype=dtype), ops


# The six training-path blocks at channels 128: (Cin, Co, threads, ring
# slots, shared memory bytes).
TRAIN_LAYOUTS = [(128, 128, 256, 3, 106_144), (128, 192, 512, 4, 179_040), (192, 256, 512, 3, 202_848),
                 (384, 256, 512, 2, 208_032), (256, 192, 512, 4, 199_584), (192, 128, 256, 2, 106_144)]


@pytest.mark.parametrize("cin,co,threads,slots,smem", TRAIN_LAYOUTS)
def test_conv_block_layout_at_training_widths(cin, co, threads, slots, smem):
    assert fc.conv_block_layout(cin, co) == (62, threads, slots, smem)
    assert smem <= MAX_SMEM and fc.conv_block_refusal(cin, co) is None


def test_refusal_binds_cuda_only():
    x, ops = _ops(2, 5, 1024, 512)
    assert "1024" in fc.conv_block_refusal(1024, 512)
    torch.testing.assert_close(fc.fused_conv_block(x, *ops), fc.conv_block_plain(x, *ops),
                               rtol=0, atol=0)


def test_plain_keeps_float64():
    x, ops = _ops(2, 9, 8, 16, torch.float64, seed=1)
    out = fc.conv_block_plain(x, *ops)
    assert out.dtype == torch.float64
    f32 = fc.conv_block_plain(x.float(), *[o.float() for o in ops])
    torch.testing.assert_close(out.float(), f32, rtol=1e-5, atol=1e-5)
