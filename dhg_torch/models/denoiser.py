"""The denoiser: a 1-D conv U-Net with text/style cross-attention (port of
dhg/models/denoiser.py), channel-last [B, T, C]:

  input Dense(2 -> c1) -> enc1 ConvBlock(c1)                      [B, T,   c1]
  pool -> enc2 ConvBlock(c2) -> enc3 EncoderLayer(3 heads, pf 4)  [B, T/2, c2]
  pool -> enc4 ConvBlock(c3) -> enc5 EncoderLayer(4 heads, pf 2)  [B, T/4, c3]
  pool -> Dense(c3 -> 2*c2) -> N x EncoderLayer(6 heads)          [B, T/8, 2*c2]
  up + skip_conv3(h3) -> dec3; up + skip_conv2(h2) -> dec2; up + skip_conv1(h1) -> dec1
  heads: Dense(c1 -> 2) noise, Dense(c1 -> 1) + sigmoid pen lifts, both float32

Parameters are float32; `dtype=torch.bfloat16` is the compute type of the
sampler and of the training config. With precomputed kvs/films in bf16 (the
sampler's context) the bottleneck and enc3/enc5 go through the hand-written
kernels under the same gates as dhg, with CUDA in place of the TPU
(kernels/runtime.py); under train() with live dropout they stay off. With
DHG_FUSED_T4=1 the same context sends the whole T/4..T/8 region (enc4 to
dec3) to one fused_unet_t4 launch instead, as dhg's _denoise_fused_t4. The
training forward is `forward` under train(): dropout (drop_rate and the
style dropout 0.3) is live, and attention and ConvBlocks take their kernels
when DHG_FUSED_ATTENTION / DHG_FUSED_CONVBLOCK are set.
"""

from __future__ import annotations

import torch
from torch import nn

from dhg_torch import resolve_device
from dhg_torch.kernels.fused_bottleneck import (bottleneck_tiles, encoder_layer_tiles,
                                                 fused_bottleneck, fused_encoder_layer,
                                                 fused_unet_t4)
from dhg_torch.kernels.runtime import fused_bottleneck_mode, fused_t4_mode
from dhg_torch.models.encoder_layer import EncoderLayer
from dhg_torch.models.text_style import TextStyleEncoder
from dhg_torch.ops.attention import pos_embeddings
from dhg_torch.ops.basic import FFN, CastCache, Linear, create_padding_mask
from dhg_torch.ops.conv import ConvBlock, Conv3, avg_pool_1d, upsample_nearest_1d

BF16 = torch.bfloat16


def _film_operand(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).reshape(-1).contiguous()


def _encoder_layer_ops(layer: EncoderLayer, kv, film3) -> list[torch.Tensor]:
    """The 24 kernel operands of one EncoderLayer (dhg's _PER_LAYER order)."""
    kh, vh = kv
    ops = [kh.to(BF16).contiguous(), vh.to(BF16).contiguous()]
    for lin in (layer.mha.wq, layer.mha.dense, layer.mha2.wq, layer.mha2.wk,
                layer.mha2.wv, layer.mha2.dense, layer.ffn[1], layer.ffn[3]):
        ops += lin.cast(BF16)
    for gamma, beta in film3:
        ops += [_film_operand(gamma), _film_operand(beta)]
    return ops


def _scheduled_linears(layer: EncoderLayer) -> tuple[Linear, ...]:
    """A layer's Dense layers in the order the bottleneck kernel multiplies
    them (kernels/fused_bottleneck.py SCHEDULE): wq, wo, wv2, wq2, wk2, wo2,
    fc1, fc2."""
    return (layer.mha.wq, layer.mha.dense, layer.mha2.wv, layer.mha2.wq, layer.mha2.wk,
            layer.mha2.dense, layer.ffn[1], layer.ffn[3])


def _mask_bias(text_mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, 1, L] padding mask -> the kernels' additive bias [B, 1, L], bf16."""
    return (text_mask * -1e9).to(BF16)[:, 0].contiguous()


def encoder_layer_operands(layer: EncoderLayer, x, kv, film3, text_mask):
    """(x, pe, neg, layer_ops) for fused_encoder_layer."""
    pe = pos_embeddings(x.shape[1], layer.d_out, layer.pos_factor, BF16, x.device)[0]
    return (x.to(BF16).contiguous(), pe.contiguous(), _mask_bias(text_mask),
            _encoder_layer_ops(layer, kv, film3))


class DiffusionModel(CastCache, nn.Module):
    def __init__(self, num_layers=2, c1=128, c2=192, c3=256, drop_rate=0.0, dtype=None):
        super().__init__()
        self.num_layers, self.c1, self.c2, self.c3 = num_layers, c1, c2, c3
        self.drop_rate, self.dtype = drop_rate, dtype
        sd = c1 // 4  # sigma embedding width
        d = c2 * 2  # bottleneck / conditioning width

        self.sigma_ffn = FFN(1, 2048, sd, dtype)
        self.text_style_model = TextStyleEncoder(d, c2 * 4, sd, dtype)
        self.input_dense = Linear(2, c1)
        dr = drop_rate
        self.enc1 = ConvBlock(c1, c1, sd, dtype, dr)
        self.enc2 = ConvBlock(c1, c2, sd, dtype, dr)
        self.enc3 = EncoderLayer(c2, 3, d, sd, pos_factor=4.0, dtype=dtype, drop_rate=dr)
        self.enc4 = ConvBlock(c2, c3, sd, dtype, dr)
        self.enc5 = EncoderLayer(c3, 4, d, sd, pos_factor=2.0, dtype=dtype, drop_rate=dr)
        self.att_dense = Linear(c3, d)
        self.att_layers = nn.ModuleList(
            EncoderLayer(d, 6, d, sd, dtype=dtype, drop_rate=dr) for _ in range(num_layers)
        )
        self.skip_conv1 = Conv3(c1, c2)
        self.skip_conv2 = Conv3(c2, c3)
        self.skip_conv3 = Conv3(c3, d)
        self.dec3 = ConvBlock(d, c3, sd, dtype, dr)
        self.dec2 = ConvBlock(c3, c2, sd, dtype, dr)
        self.dec1 = ConvBlock(c2, c1, sd, dtype, dr)
        self.output_dense = Linear(c1, 2)
        self.pen_lifts_dense = nn.Sequential(Linear(c1, 1), nn.Sigmoid())

    # -- conditioning (x_t-independent) ----------------------------------------

    def embed_sigma(self, sigma: torch.Tensor) -> torch.Tensor:
        """[B, 1] sqrt(alpha_bar) -> [B, c1 // 4]."""
        return self.sigma_ffn(sigma)

    def encode_cond(self, text, style, sigma_emb) -> torch.Tensor:
        """[B, L] tokens + [B, 14, 1280] style -> [B, L, 2*c2] memory."""
        return self.text_style_model(text, style, sigma_emb)

    def encode_cond_pre(self, text, style):
        return self.text_style_model.pre(text, style)

    def encode_cond_tail(self, pre, sigma_emb) -> torch.Tensor:
        return self.text_style_model.tail(*pre, sigma_emb)

    def precompute_cross_kv(self, cond, sigma_emb):
        """(K, V) of every cross-attention: (enc3, enc5, att_layers...)."""
        layers = (self.enc3, self.enc5, *self.att_layers)
        return tuple(layer.text_kv(cond, sigma_emb) for layer in layers)

    def precompute_film(self, sigma_emb):
        """FiLM (gamma, beta) of every x_t-side affine."""
        conv_blocks = (self.enc1, self.enc2, self.enc4, self.dec3, self.dec2, self.dec1)
        attn_layers = (self.enc3, self.enc5, *self.att_layers)
        return {
            "conv": tuple(b.film_coeffs(sigma_emb) for b in conv_blocks),
            "attn": tuple(layer.film_coeffs(sigma_emb) for layer in attn_layers),
        }

    # -- the U-Net -------------------------------------------------------------

    def _sampler_context(self, kvs, films) -> bool:
        """The kernels apply on the sampler path only: bf16 compute,
        precomputed kvs + films with the batch-1 FiLM broadcast, no active
        dropout."""
        return (
            self.num_layers > 0
            and kvs is not None
            and films is not None
            and self.dtype == BF16
            and (self.drop_rate == 0.0 or not self.training)
            and films["attn"][0][0][0].shape[0] == 1
        )

    def _can_fuse_bottleneck(self, kvs, films, device) -> bool:
        """The sampler context; "auto" also requires d = 384."""
        mode = fused_bottleneck_mode(device)
        if mode == "off" or (mode == "auto" and self.c2 * 2 != 384):
            return False
        return self._sampler_context(kvs, films)

    def _can_fuse_t4(self, kvs, films, device) -> bool:
        """DHG_FUSED_T4=1 in the sampler context (dhg's gate, without its
        unreachable "auto" branch)."""
        return fused_t4_mode(device) == "on" and self._sampler_context(kvs, films)

    @staticmethod
    def encoder_layer_tiles(layer: EncoderLayer) -> torch.Tensor:
        """fused_encoder_layer's tiled copy of one layer's bf16 weights, made
        once per weight set and kept in the layer's cast cache."""
        linears = _scheduled_linears(layer)

        def kernel_tiles(dtype):
            return encoder_layer_tiles([lin.cast(dtype)[0] for lin in linears])

        return layer._cached(BF16, kernel_tiles, params=[lin.weight for lin in linears])

    def _fused_layer(self, layer, x, kv, film3, text_mask):
        return fused_encoder_layer(
            *encoder_layer_operands(layer, x, kv, film3, text_mask), layer.num_heads,
            tiles=self.encoder_layer_tiles(layer),
        )

    def bottleneck_operands(self, x, kvs, films, text_mask):
        """(x, att_w, att_b, pe, neg, layer_ops) for fused_bottleneck."""
        aw, ab = self.att_dense.cast(BF16)
        pe = pos_embeddings(x.shape[1], self.c2 * 2, 1.0, BF16, x.device)[0].contiguous()
        ops = []
        for i, layer in enumerate(self.att_layers):
            ops += _encoder_layer_ops(layer, kvs[2 + i], films["attn"][2 + i])
        return x.to(BF16).contiguous(), aw, ab, pe, _mask_bias(text_mask), ops

    def _bottleneck_linears(self) -> list[Linear]:
        return [self.att_dense] + [lin for layer in self.att_layers
                                   for lin in _scheduled_linears(layer)]

    def _tiles(self, dtype):
        weights = [lin.cast(dtype)[0] for lin in self._bottleneck_linears()]
        return bottleneck_tiles(weights, self.att_layers[0].num_heads)

    def bottleneck_tiles(self) -> torch.Tensor:
        """fused_bottleneck's tiled copy of the bf16 weights, made once per
        weight set (the sampler calls the kernel 60 times with the same)."""
        return self._cached(BF16, self._tiles,
                            params=[lin.weight for lin in self._bottleneck_linears()])

    def _fused_bottleneck(self, x, kvs, films, text_mask):
        return fused_bottleneck(
            *self.bottleneck_operands(x, kvs, films, text_mask),
            self.num_layers, self.att_layers[0].num_heads, tiles=self.bottleneck_tiles(),
        )

    def t4_operands(self, x4, kvs, films, text_mask):
        """fused_unet_t4's operands for the pooled h2 `x4` [B, T/4, c2], in
        dhg's order: x, neg, pe4, pe8, att_w, att_b, skip3_w, skip3_b, then
        enc4, enc5, dec3 and the attention layers' operand lists."""
        cf, af = films["conv"], films["attn"]
        t4, d = x4.shape[1], self.c2 * 2

        def conv_ops(block, film3):
            ops = [*block.conv_skip.gemm_rows(BF16), *block.conv1.gemm_rows(BF16),
                   *block.conv2.gemm_rows(BF16), *block.fc.cast(BF16)]
            return ops + [_film_operand(c) for pair in film3 for c in pair]

        att_ops = []
        for i, layer in enumerate(self.att_layers):
            att_ops += _encoder_layer_ops(layer, kvs[2 + i], af[2 + i])
        return (
            x4.to(BF16).contiguous(), _mask_bias(text_mask),
            pos_embeddings(t4, self.c3, 2.0, BF16, x4.device)[0].contiguous(),
            pos_embeddings(t4 // 2, d, 1.0, BF16, x4.device)[0].contiguous(),
            *self.att_dense.cast(BF16), *self.skip_conv3.gemm_rows(BF16),
            conv_ops(self.enc4, cf[2]), _encoder_layer_ops(self.enc5, kvs[1], af[1]),
            conv_ops(self.dec3, cf[3]), att_ops,
        )

    def _t4_modules(self) -> list[nn.Module]:
        """The region's weighted modules in fused_unet_t4's order
        (kernels/fused_bottleneck.py t4_weights)."""
        def block(b):
            return [b.conv_skip, b.conv1, b.conv2, b.fc]

        return (block(self.enc4) + list(_scheduled_linears(self.enc5)) + [self.att_dense]
                + [lin for layer in self.att_layers for lin in _scheduled_linears(layer)]
                + [self.skip_conv3] + block(self.dec3))

    def t4_tiles(self) -> torch.Tensor:
        """fused_unet_t4's tiled copy of the region's bf16 weights, made once
        per weight set."""
        mods = self._t4_modules()

        def t4_kernel_tiles(dtype):
            return encoder_layer_tiles([m.gemm_rows(dtype)[0] if isinstance(m, Conv3)
                                        else m.cast(dtype)[0] for m in mods])

        return self._cached(BF16, t4_kernel_tiles, params=[m.weight for m in mods])

    def _denoise_fused_t4(self, strokes, text_mask, kvs, films):
        """denoise() with the whole T/4..T/8 region in one fused_unet_t4
        launch (dhg's _denoise_fused_t4): enc1-enc3 (enc3 through its plain
        attend, as in dhg) before it, dec2-dec1 and the heads after it."""
        cf, af = films["conv"], films["attn"]
        x = self.input_dense(strokes, self.dtype)
        h1 = self.enc1(x, None, coeffs=cf[0])
        h2 = self.enc2(avg_pool_1d(h1), None, coeffs=cf[1])
        h2 = self.enc3.attend(h2, kvs[0], None, text_mask, af[0])
        x = fused_unet_t4(*self.t4_operands(avg_pool_1d(h2), kvs, films, text_mask),
                          self.num_layers, self.att_layers[0].num_heads, self.enc5.num_heads,
                          tiles=self.t4_tiles())
        return self._decode_tail(x, h1, h2, cf)

    def encode_unet(self, strokes, cond, sigma_emb, text_mask, kvs=None, films=None):
        """x_t -> (h1 [B,T,c1], h2 [B,T/2,c2], h3 [B,T/4,c3])."""
        cf = films["conv"] if films is not None else (None,) * 6
        x = self.input_dense(strokes, self.dtype)
        h1 = self.enc1(x, sigma_emb, coeffs=cf[0])
        h2 = self.enc2(avg_pool_1d(h1), sigma_emb, coeffs=cf[1])
        h2 = self._encode_enc3(h2, cond, sigma_emb, text_mask, kvs, films)
        return h1, h2, self._encode_t4(avg_pool_1d(h2), cond, sigma_emb, text_mask, kvs, films)

    def _encode_enc3(self, h2, cond, sigma_emb, text_mask, kvs, films):
        """enc3 on enc2's output, through fused_encoder_layer where it applies."""
        af = films["attn"] if films is not None else (None,) * (2 + self.num_layers)
        kv3 = kvs[0] if kvs is not None else self.enc3.text_kv(cond, sigma_emb)
        if self._fuse_enc(h2, kvs, films):
            return self._fused_layer(self.enc3, h2, kv3, af[0], text_mask)
        return self.enc3.attend(h2, kv3, sigma_emb, text_mask, af[0])

    def _fuse_enc(self, x, kvs, films) -> bool:
        """enc3/enc5 through fused_encoder_layer: the bottleneck's gate and
        dhg's 8 <= B <= 128."""
        return self._can_fuse_bottleneck(kvs, films, x.device) and 8 <= x.shape[0] <= 128

    def _encode_t4(self, x4, cond, sigma_emb, text_mask, kvs, films):
        """enc4 and enc5 on the pooled h2: -> h3 [B, T/4, c3]."""
        cf = films["conv"] if films is not None else (None,) * 6
        af = films["attn"] if films is not None else (None,) * (2 + self.num_layers)
        h3 = self.enc4(x4, sigma_emb, coeffs=cf[2])
        kv5 = kvs[1] if kvs is not None else self.enc5.text_kv(cond, sigma_emb)
        if self._fuse_enc(x4, kvs, films):
            return self._fused_layer(self.enc5, h3, kv5, af[1], text_mask)
        return self.enc5.attend(h3, kv5, sigma_emb, text_mask, af[1])

    def _decode_t4(self, h3, cond, sigma_emb, text_mask, kvs, films):
        """pool, the bottleneck, upsample + skip_conv3(h3) and dec3: -> dec3's
        output [B, T/4, c3]."""
        cf = films["conv"] if films is not None else (None,) * 6
        x = self._bottleneck(avg_pool_1d(h3), cond, sigma_emb, text_mask, kvs, films)
        return self.dec3(upsample_nearest_1d(x) + self.skip_conv3(h3, self.dtype), sigma_emb,
                         coeffs=cf[3])

    def _bottleneck(self, x, cond, sigma_emb, text_mask, kvs, films):
        """att_dense and the att_layers stack at T/8, through fused_bottleneck
        where it applies: [B, T/8, c3] -> [B, T/8, 2 c2]."""
        if self._can_fuse_bottleneck(kvs, films, x.device):
            return self._fused_bottleneck(x, kvs, films, text_mask)
        af = films["attn"] if films is not None else (None,) * (2 + self.num_layers)
        x = self.att_dense(x, self.dtype)
        for i, layer in enumerate(self.att_layers):
            kv = kvs[2 + i] if kvs is not None else layer.text_kv(cond, sigma_emb)
            x = layer.attend(x, kv, sigma_emb, text_mask, af[2 + i])
        return x

    def t4_region(self, x4, text_mask, kvs, films):
        """The default path (no DHG_FUSED_T4) over the region fused_unet_t4
        computes: pooled h2 [B, T/4, c2] -> dec3's output, in the sampler's
        context. The same calls denoise() makes, factored out for timing."""
        h3 = self._encode_t4(x4, None, None, text_mask, kvs, films)
        return self._decode_t4(h3, None, None, text_mask, kvs, films)

    def decode_unet(self, feats, cond, sigma_emb, text_mask, kvs=None, films=None):
        """Bottleneck + decoder: (h1, h2, h3) -> (eps [B,T,2], pen [B,T]), float32."""
        cf = films["conv"] if films is not None else (None,) * 6
        h1, h2, h3 = feats
        x = self._decode_t4(h3, cond, sigma_emb, text_mask, kvs, films)
        return self._decode_tail(x, h1, h2, cf, sigma_emb)

    def _decode_tail(self, x, h1, h2, cf, sigma_emb=None):
        """dec2, dec1 and the heads from dec3's output: (eps, pen), float32."""
        dt = self.dtype
        x = self.dec2(upsample_nearest_1d(x) + self.skip_conv2(h2, dt), sigma_emb, coeffs=cf[4])
        x = self.dec1(upsample_nearest_1d(x) + self.skip_conv1(h1, dt), sigma_emb, coeffs=cf[5])
        eps = self.output_dense(x, dt)
        pen = torch.sigmoid(self.pen_lifts_dense[0](x, dt))[..., 0]
        return eps.float(), pen.float()

    def denoise(self, strokes, cond, sigma_emb, text_mask, kvs=None, films=None):
        if self._can_fuse_t4(kvs, films, strokes.device):
            return self._denoise_fused_t4(strokes, text_mask, kvs, films)
        feats = self.encode_unet(strokes, cond, sigma_emb, text_mask, kvs, films)
        return self.decode_unet(feats, cond, sigma_emb, text_mask, kvs, films)

    def forward(self, strokes, text, sigma, style):
        """strokes [B,T,2] (T % 8 == 0), text [B,L], sigma [B,1], style [B,14,1280]."""
        sigma_emb = self.embed_sigma(sigma)
        text_mask = create_padding_mask(text)
        cond = self.encode_cond(text, style, sigma_emb)
        return self.denoise(strokes, cond, sigma_emb, text_mask)

    # -- construction ----------------------------------------------------------

    @staticmethod
    def from_config(training_args: dict, dtype=None, device="cuda", seed: int = 0):
        """The reference channel plan (c1 = channels, c2 = 3/2 c1, c3 = 2 c1)
        with deterministic random weights from `seed`."""
        dev = resolve_device(device)
        ch = training_args.get("channels", 128)
        model = DiffusionModel(
            num_layers=training_args.get("att_layers_num", 2),
            c1=ch, c2=ch * 3 // 2, c3=ch * 2,
            drop_rate=training_args.get("dropout", 0.0) or 0.0,
            dtype=dtype,
        )
        init_weights(model, torch.Generator().manual_seed(seed))
        return model.to(dev).eval()

    @staticmethod
    def load(path, dtype=None, use_ema=True, device="cuda"):
        """A model from a `{meta, state_dict}` .pth: dhg's export, or the
        port's own `model_final` / `checkpoint_<N>` (its EMA weights when it
        carries them and use_ema)."""
        from dhg_torch.weights import config_from_state_dict, load_checkpoint

        dev = resolve_device(device)
        _, sd = load_checkpoint(path, use_ema=use_ema)
        cfg = config_from_state_dict(sd)
        model = DiffusionModel(cfg["att_layers_num"], cfg["channels"], cfg["channels"] * 3 // 2,
                               cfg["channels"] * 2, dtype=dtype)
        model.load_state_dict(sd, strict=True)
        return model.to(dev).eval()


# dhg's FiLM beta bias bound is 1/sqrt(32) at every width (dhg/ops/basic.py
# SIGMA_EMB_DIM): the canonical sigma embedding's width, c1 // 4 at c1 = 128.
FILM_BETA_BIAS_FAN_IN = 32


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """dhg's init (dhg/ops/init.py, torch's defaults) from one generator, in
    module order: weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), biases the
    same with the layer's fan_in, but FiLM gamma biases 1 and FiLM beta
    biases at fan_in FILM_BETA_BIAS_FAN_IN; embeddings N(0, 1)."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator))
        elif isinstance(mod, (nn.Linear, nn.Conv1d)):
            fan_in = mod.weight[0].numel()
            bias_fan_in = FILM_BETA_BIAS_FAN_IN if name.endswith("beta_emb") else fan_in
            for p, f in ((mod.weight, fan_in), (mod.bias, bias_fan_in)):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * (1.0 / f ** 0.5))
            if name.endswith("gamma_emb"):
                mod.bias.fill_(1.0)
