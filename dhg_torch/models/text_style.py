"""Text-style conditioning encoder (port of dhg/models/text_style.py).

  style [B, 14, 1280] -> reshape_up(5) -> [B, 70, 256] -> FFN -> LN -> affine1
  text  [B, L] -> Embedding(73, d_model) -> LN -> affine2
  cross-attention text -> style (8 heads, unmasked) + residual -> affine3(LN)
  FFN (hidden 2*d_model) -> affine4(LN)

`pre` is the sigma-independent half (run once per sampler call), `tail` the
sigma-dependent half (run per noise level). The style dropout(0.3) of
training is the identity here: the port runs in eval only.
"""

from __future__ import annotations

import torch
from torch import nn

from dhg_torch.data.tokenizer import VOCAB_SIZE
from dhg_torch.ops.attention import MultiHeadAttention
from dhg_torch.ops.basic import FFN, AffineTransformLayer, layer_norm, reshape_up

STYLE_WIDTH = 1280 // 5  # reshape_up(5) of the [B, 14, 1280] style features


class TextStyleEncoder(nn.Module):
    def __init__(self, d_model: int, d_ff: int, sigma_dim: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.style_ffn = FFN(STYLE_WIDTH, d_ff, d_model, dtype)
        self.emb = nn.Embedding(VOCAB_SIZE, d_model)
        self.text_ffn = FFN(d_model, d_model * 2, d_model, dtype)
        self.mha = MultiHeadAttention(d_model, 8, dtype)
        for i in (1, 2, 3, 4):
            self.add_module(f"affine{i}", AffineTransformLayer(sigma_dim, d_model, dtype))

    def pre(self, text: torch.Tensor, style: torch.Tensor):
        """(text_pre [B, L, d], style_pre [B, 70, d])."""
        style = layer_norm(self.style_ffn(reshape_up(style, 5)), self.dtype)
        h = self.emb(text)
        if self.dtype is not None:
            h = h.to(self.dtype)
        return layer_norm(h, self.dtype), style

    def tail(self, text_pre, style_pre, sigma_emb) -> torch.Tensor:
        style = self.affine1(style_pre, sigma_emb)
        h = self.affine2(text_pre, sigma_emb)
        attn = self.mha(h, style, style)
        h = self.affine3(layer_norm(h + attn, self.dtype), sigma_emb)
        h = self.text_ffn(h)
        return self.affine4(layer_norm(h, self.dtype), sigma_emb)

    def forward(self, text, style, sigma_emb) -> torch.Tensor:
        return self.tail(*self.pre(text, style), sigma_emb)
