"""Transformer encoder layer with text cross-attention and stroke
self-attention (port of dhg/models/encoder_layer.py).

`text_kv` is the x_t-independent half (text projection, LN, affine0, PE,
the cross-attention K/V heads); `attend` is the x_t-dependent half. PE goes
on Q and K only: V carries no position. Dropout (the model's drop_rate) acts
on the three sublayer outputs under train(), as in dhg.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dhg_torch.ops.attention import MultiHeadAttention, pos_embeddings
from dhg_torch.ops.basic import FFN, AffineTransformLayer, CastCache, Linear, dropout, layer_norm


class EncoderLayer(CastCache, nn.Module):
    def __init__(
        self,
        d_out: int,
        num_heads: int,
        d_inp: int,
        sigma_dim: int,
        pos_factor: float = 1.0,
        dtype=None,
        drop_rate: float = 0.0,
    ):
        super().__init__()
        self.d_out, self.num_heads, self.pos_factor, self.dtype = d_out, num_heads, pos_factor, dtype
        self.text_dense = Linear(d_inp, d_out)
        self.ffn = FFN(d_out, d_out * 2, d_out, dtype)
        self.mha = MultiHeadAttention(d_out, num_heads, dtype)
        self.mha2 = MultiHeadAttention(d_out, num_heads, dtype)
        for i in range(4):
            self.add_module(f"affine{i}", AffineTransformLayer(sigma_dim, d_out, dtype))
        self.drop = nn.Dropout(drop_rate)

    def text_kv(self, text: torch.Tensor, sigma_emb: torch.Tensor):
        """Conditioning memory [B, L, d_inp] -> cross-attention (K, V) [B,H,L,hd]."""
        text = self.text_dense(F.silu(text), self.dtype)
        text = self.affine0(layer_norm(text, self.dtype), sigma_emb)
        pe = pos_embeddings(text.shape[1], self.d_out, 1.0, text.dtype, text.device)
        return self.mha.kv(text + pe, text)

    def film_coeffs(self, sigma_emb: torch.Tensor):
        """(gamma, beta) for the three x_t-side affines."""
        return (
            self.affine1.coefficients(sigma_emb),
            self.affine2.coefficients(sigma_emb),
            self.affine3.coefficients(sigma_emb),
        )

    def attend(self, x, kv, sigma_emb, text_mask, coeffs=None) -> torch.Tensor:
        """Cross-attention, self-attention, FFN — each with LN and FiLM."""
        if coeffs is None:
            coeffs = self.film_coeffs(sigma_emb)
        c1, c2, c3 = coeffs
        film = AffineTransformLayer.apply_coeffs
        kh, vh = kv
        dt = self.dtype
        pe = pos_embeddings(x.shape[1], self.d_out, self.pos_factor, x.dtype, x.device)

        x2 = self.mha.attend_kv(x + pe, kh, vh, text_mask)
        x2 = film(layer_norm(dropout(self.drop, x2), dt), c1) + x

        x2_pe = x2 + pe
        x3 = self.mha2(x2_pe, x2_pe, x2)
        x3 = film(layer_norm(x2 + dropout(self.drop, x3), dt), c2)

        x4 = dropout(self.drop, self.ffn(x3)) + x3
        return film(layer_norm(x4, dt), c3)

    def forward(self, x, text, sigma_emb, text_mask) -> torch.Tensor:
        return self.attend(x, self.text_kv(text, sigma_emb), sigma_emb, text_mask)
