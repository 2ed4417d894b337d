"""The fused ConvBlock: the wrapper, its plain version, its launch count, and
the autograd.Function the train step uses.

fused_conv_block
    Replaces dhg/kernels/fused_conv_block.py::fused_conv_block: one ConvBlock
    per batch row in float32, the output cast to x's type —
      skip = k3(x); h = FiLM1(k3(SiLU x)); h = FiLM2(k3(SiLU h));
      h = FiLM3(Dense(SiLU h)); out = h + skip.
    On CUDA tensors it runs csrc/conv_block.cu: one CTA per (row, 62-row T
    tile), every product over 64 rows with the 2-row halo in shared memory,
    f32-accurate on the tensor cores (3xTF32: each f32 operand split into a
    TF32 high part and remainder, three products summed in f32), the weights
    streamed through a shared-memory ring that every warp reads; see the
    source's note for what bounds it. conv_block_layout mirrors its launch
    shape; conv_block_refusal names a width it cannot take (CUDA only).
conv_block_plain
    dhg's conv_block_ref in PyTorch: each k3 'same' conv is three shifted
    products, all in float32 (float64 for float64 operands).
ConvBlockFn
    Forward through fused_conv_block; backward recomputes conv_block_plain,
    as dhg's conv_block_fused_op custom_vjp does.

Operands, in dhg's layout: x [B, T, Cin] (bfloat16 or float32); wskip
[3, Cin, Co], bskip [Co]; w1 [3, Cin, Co/2], b1 [Co/2]; w2 [3, Co/2, Co],
b2 [Co]; wfc [Co, Co] (in, out), bfc [Co]; FiLM g1, be1 [B or 1, Co/2] and
g2, be2, g3, be3 [B or 1, Co]. Weights and FiLM are float32; a batch-1 FiLM
(the sampler's hoisted coefficients) is expanded to [B, C].

The wrapper takes the plain version only for CPU tensors; a CUDA tensor gets
the kernel or an exception. `launches` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dhg_torch.kernels.build import MAX_SMEM

launches = {"fused_conv_block": 0}
F32 = torch.float32
NAMES = ("wskip", "bskip", "w1", "b1", "w2", "b2", "wfc", "bfc",
         "g1", "be1", "g2", "be2", "g3", "be3")


def reset_launch_count() -> None:
    launches["fused_conv_block"] = 0


# csrc/conv_block.cu's tiling: output rows a CTA, rows of x and h1 held,
# rows of every product, weight rows a ring slot, most ring slots, bytes of
# the load plan, and the shared memory of a CTA when two share an SM.
TILE, X_ROWS, H1_ROWS, ROWS, SLOT_ROWS, MAX_SLOTS, PLAN_BYTES = 62, 68, 66, 64, 32, 4, 64
HALF_SMEM = 115712


def _ld(c: int) -> int:
    """Row stride (floats) of an activation buffer c wide (ld_act)."""
    return -(-c // 32) * 32 + 4


def _smem(cin: int, co: int, slots: int) -> int:
    wn = 4 if co <= 128 else 8  # warps along the columns
    slot = SLOT_ROWS * (8 * wn * min(4, -(-co // (8 * wn))) + 8)
    x = max(X_ROWS * _ld(cin), ROWS * _ld(co))
    return 4 * (x + H1_ROWS * _ld(co // 2) + slots * slot) + PLAN_BYTES


def conv_block_layout(cin: int, co: int) -> tuple[int, int, int, int]:
    """(output rows a CTA, threads a CTA, weight ring slots, shared memory
    bytes of a CTA) of csrc/conv_block.cu (dhg_conv_block_tile / threads /
    slots / smem_bytes): 256 threads where Co <= 128, else 512. A CTA holds x's tile in f32 (68 rows, later SiLU(h2)),
    SiLU(h1) (66 rows), the most ring slots of 32 weight rows, 4 down to 2,
    that fit, and the load plan: in HALF_SMEM where Co <= 128 and 2 slots
    fit there (two CTAs an SM), else in MAX_SMEM; 2 where none does
    (conv_block_refusal names it)."""
    threads = 256 if co <= 128 else 512
    cap = HALF_SMEM if threads == 256 and _smem(cin, co, 2) <= HALF_SMEM else MAX_SMEM
    slots = next((s for s in range(MAX_SLOTS, 2, -1) if _smem(cin, co, s) <= cap), 2)
    return TILE, threads, slots, _smem(cin, co, slots)


def conv_block_refusal(cin: int, co: int) -> str | None:
    """Why csrc/conv_block.cu cannot take these widths, or None."""
    smem = conv_block_layout(cin, co)[3]
    if smem > MAX_SMEM:
        return (f"widths Cin {cin}, Co {co} need {smem} bytes of shared memory a CTA, "
                f"over {MAX_SMEM}")
    return None


def conv_block_plain(x, wskip, bskip, w1, b1, w2, b2, wfc, bfc, g1, be1, g2, be2, g3, be3):
    """dhg's conv_block_ref: the whole block in float32 (float64 for float64
    operands, a reference for the kernel's precision), cast to x's dtype."""

    def conv3(h, w, bias):
        hp = F.pad(h, (0, 0, 1, 1))
        return (torch.matmul(hp[:, :-2], w[0]) + torch.matmul(hp[:, 1:-1], w[1])
                + torch.matmul(hp[:, 2:], w[2]) + bias)

    def film(h, g, be):
        return h * g[:, None, :] + be[:, None, :]

    xf = x.to(torch.promote_types(x.dtype, F32))
    skip = conv3(xf, wskip, bskip)
    h = film(conv3(F.silu(xf), w1, b1), g1, be1)
    h = film(conv3(F.silu(h), w2, b2), g2, be2)
    h = film(torch.matmul(F.silu(h), wfc) + bfc, g3, be3)
    return (h + skip).to(x.dtype)


def _check(x, ops):
    def need(cond, msg):
        if not cond:
            raise ValueError(f"fused_conv_block: {msg}")

    need(x.dim() == 3, f"x: expected [B, T, Cin], got {tuple(x.shape)}")
    need(x.dtype in (torch.bfloat16, F32), f"x: expected bfloat16 or float32, got {x.dtype}")
    need(x.device.type in ("cpu", "cuda"), f"x: unsupported device {x.device}")
    need(x.is_contiguous(), "x: must be contiguous")
    need(len(ops) == len(NAMES), f"expected {len(NAMES)} operands, got {len(ops)}")
    b, _, cin = x.shape
    co = ops[0].shape[-1]
    need(cin % 4 == 0 and co % 8 == 0, f"widths Cin {cin}, Co {co}: need 4 | Cin and 8 | Co")
    c2 = co // 2
    shapes = [(3, cin, co), (co,), (3, cin, c2), (c2,), (3, c2, co), (co,), (co, co), (co,)]
    for name, t, shape in zip(NAMES, ops, shapes):
        need(tuple(t.shape) == shape, f"{name}: shape {tuple(t.shape)} != {shape}")
    for name, t, c in zip(NAMES[8:], ops[8:], (c2, c2, co, co, co, co)):
        need(t.dim() == 2 and t.shape[0] in (1, b) and t.shape[1] == c,
             f"{name}: shape {tuple(t.shape)}, expected [{b} or 1, {c}]")
    for name, t in zip(NAMES, ops):
        need(t.dtype == F32, f"{name}: expected float32, got {t.dtype}")
        need(t.device == x.device, f"{name}: on {t.device}, x on {x.device}")


def fused_conv_block(x, *ops):
    """One ConvBlock: x [B, T, Cin] -> [B, T, Co] in x's dtype."""
    _check(x, ops)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ops)):
        raise RuntimeError("fused_conv_block is forward-only; use ConvBlockFn.apply for gradients")
    if x.device.type == "cpu":
        return conv_block_plain(x, *ops)
    from dhg_torch.kernels.build import check_rc, load

    b, t, cin = x.shape
    co = ops[0].shape[-1]
    reason = conv_block_refusal(cin, co)
    if reason:
        raise ValueError(f"fused_conv_block: {reason}")
    lib = load()
    ops = [o.contiguous() for o in ops[:8]] + [o.expand(b, -1).contiguous() for o in ops[8:]]
    # The kernel reads every operand in 16-byte runs.
    x, *ops = [a.clone() if a.data_ptr() % 16 else a for a in (x, *ops)]
    out = torch.empty((b, t, co), dtype=x.dtype, device=x.device)
    skip = torch.empty((b, t, co), dtype=F32, device=x.device)  # the skip conv's f32 sum
    ptrs = (ctypes.c_void_p * len(ops))(*[o.data_ptr() for o in ops])
    rc = lib.dhg_fused_conv_block(
        x.data_ptr(), ptrs, skip.data_ptr(), out.data_ptr(), b, t, cin, co,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_rc(lib, rc, "fused_conv_block")
    launches["fused_conv_block"] += 1
    return out


class ConvBlockFn(torch.autograd.Function):
    """Kernel forward; backward through conv_block_plain."""

    @staticmethod
    def forward(ctx, x, *ops):
        ctx.save_for_backward(x, *ops)
        return fused_conv_block(x, *ops)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            out = conv_block_plain(*leaves)
            return torch.autograd.grad(out, leaves, grad)
