"""The line sampler and the `infer` CLI (port of dhg/inference.py).

    python -m dhg_torch.inference --prompt="Hello" --source=<style.png> \
        --experiment_path=<run dir> [--output=result] [--format=png|svg] \
        [--device=cpu]

`generate` / `sample_lines` follow dhg's _sample_jit, by default in its
"compact" hoist:
  * sigma embeddings and every FiLM coefficient are computed at batch 1 for
    all noise levels before the loop;
  * the text-style encoder's `pre` runs once and its `tail` once per level,
    before the loop;
  * each step rebuilds the cross-attention K/V from its level's memory and
    runs the U-Net; the x carry and the heads are float32;
  * guidance runs a second U-Net pass against the null text, which keeps
    token 0 open (all-padding text would mask every key).
hoist="full" computes every level's K/V before the loop instead, and
encoder_reuse=k runs the encoder half every k-th step on the full hoist.
The loop runs under torch.inference_mode().

`infer` is dhg's front end: the run dir's checkpoint (model_final, then
model_last, then the highest checkpoint_<N>) loaded in float32 as dhg's
`infer` does (no bf16 kernel is on this path), a style vector from a PNG
through the frozen StyleExtractor, the sampler, and a PNG or SVG of the
strokes. Images are PNG only (dhg_torch.data.images).
"""

from __future__ import annotations

import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from dhg_torch import resolve_device
from dhg_torch.core.sampling import (diffusion_sample, diffusion_sample_encoder_reuse,
                                     infer_seq_len, per_sample_noise_streams)
from dhg_torch.core.schedule import N_STEPS, get_alpha_set, get_beta_set
from dhg_torch.data.tokenizer import Tokenizer
from dhg_torch.ops.basic import create_padding_mask
from dhg_torch.utils.vis import compose_lines, save_strokes


def wrap_text(text: str, width: int) -> list[str]:
    """Greedy word-boundary wrap of a paragraph into lines of <= width chars.

    Words longer than width are hard-split; runs of whitespace collapse at
    break points (textwrap semantics). Explicit newlines force line breaks,
    and blank input lines survive as "" entries: they become blank page
    lines under compose_lines (paragraph gaps).
    """
    import textwrap

    if width < 1:
        raise ValueError(f"wrap width must be >= 1, got {width}")
    out: list[str] = []
    for raw in text.splitlines() or [""]:
        if not raw.strip():
            out.append("")
            continue
        out.extend(
            textwrap.wrap(raw, width=width, break_long_words=True, break_on_hyphens=False)
        )
    return out


@lru_cache(maxsize=None)
def beta_table(n_steps: int, schedule: str, device: str) -> torch.Tensor:
    """The beta table for (n_steps, schedule) on `device`, built once: the
    canonical table at N_STEPS (whatever the schedule), else its strided or
    halved coarsening. Callers must not modify it. A CUDA graph's capture
    takes it from here: a host-to-device copy may not run while a stream
    captures."""
    from dhg_torch.core.schedule import halved_beta_set, strided_beta_set

    if n_steps == N_STEPS:
        table = get_beta_set()
    elif schedule == "halved":
        table = halved_beta_set(n_steps)
    elif schedule == "strided":
        table = strided_beta_set(n_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return table.to(device)


def _check_model_device(model, device: torch.device) -> None:
    p = next(model.parameters())
    if p.device.type != device.type or (
        device.index is not None and p.device.index != device.index
    ):
        raise ValueError(f"model is on {p.device}, sampling was asked on {device}")


def generate(
    model,
    text,  # [B, L] token ids
    style,  # [B, 14, 1280]
    generator: torch.Generator | None = None,
    seq_len: int | None = None,
    diffusion_mode: str = "new",
    guidance_scale: float | None = None,
    n_steps: int | None = None,
    schedule: str = "strided",
    temperature: float | None = None,
    x_init: torch.Tensor | None = None,
    noises: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
    sample_seeds: list[int] | None = None,
    mesh=None,
    hoist: str | None = None,
    encoder_reuse: int | None = None,
) -> torch.Tensor:
    """Sample stroke sequences [B, seq_len, 3] (float32) for tokenized prompts.

    diffusion_mode: "new" (the reference default) | "standard" (DDPM) |
    "ddim"; any other string runs "new", as in the reference.
    guidance_scale: eps = eps_null + g (eps_text - eps_null); None or 1 skips
    the null branch. n_steps / schedule: a "strided" or "halved" sub-schedule
    of the canonical 60 levels. temperature scales x_T and all injected
    noise. Randomness comes from `generator` (on `device`), from pre-drawn
    `x_init` [B,T,2] and `noises` [n,B,T,2] (see diffusion_sample), or from
    `sample_seeds`, one int per row: each row draws its own stream
    (per_sample_noise_streams), so its strokes do not depend on the rows
    it is batched with. sample_seeds excludes the other two.
    mesh: a parallel.mesh.Mesh; the batch is split over its data group and
    the rows gathered back in order, so every rank returns what one process
    returns. Every rank draws the whole batch's x_T and noise (pass a
    generator seeded alike everywhere) and keeps its rows. The model holds
    whole weights on every rank: the sampler's kernels need whole heads,
    so the sampler's mesh takes the data axis only.

    hoist: "compact" (None, the default, as in dhg) rebuilds each step's
    cross-attention K/V from the hoisted conditioning memory inside the
    loop; "full" computes every level's K/V (and the null branch's under
    guidance) before the loop, ~2,432 bf16 values per text token per level
    at the canonical widths (B = 256, 50 tokens: ~3.7 GB). Full builds them
    with the very calls compact makes in its loop, one precompute_cross_kv
    a level, so the two give the same strokes bit for bit. dhg's
    DHG_COND_CHUNK and DHG_SCAN_UNROLL are XLA scheduling knobs over the
    same math; the port has no counterpart.

    encoder_reuse=k > 1: the U-Net's encoder half runs every k-th step and
    the decoder reuses its skip features in between
    (core/sampling.py::diffusion_sample_encoder_reuse, on the full hoist;
    experimental: k = 2 drifts past the 1e-3 bar on trained weights and
    k >= 3 diverges). None or k <= 1 is the normal sampler. It excludes
    guidance, as in dhg. dhg's reuse path ignores temperature and per-row
    keys without a word; here it refuses them. Explicit x_init / noises
    are taken.
    """
    dev = resolve_device(device)
    _check_model_device(model, dev)
    if guidance_scale is not None and float(guidance_scale) == 1.0:
        guidance_scale = None
    temperature = 1.0 if temperature is None else float(temperature)
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    hoist = "compact" if hoist is None else hoist
    if hoist not in ("compact", "full"):
        raise ValueError(f"hoist must be 'compact' or 'full', got {hoist!r}")
    if encoder_reuse is not None and encoder_reuse > 1:
        if guidance_scale is not None:
            raise ValueError("encoder_reuse and guidance_scale are mutually exclusive")
        if temperature != 1.0 or sample_seeds is not None:
            raise ValueError("encoder_reuse takes neither a temperature nor sample_seeds "
                             "(dhg's reuse sampler has neither)")
    else:
        encoder_reuse = None
    beta_set = beta_table(N_STEPS if n_steps is None else int(n_steps), schedule, str(dev))
    if not isinstance(text, torch.Tensor):
        text = np.asarray(text)
    text = torch.as_tensor(text, dtype=torch.long, device=dev)
    style = torch.as_tensor(style, dtype=torch.float32, device=dev)
    if seq_len is None:
        seq_len = infer_seq_len(int((text != 0).sum(dim=1).max()))
    if seq_len % 8 != 0:
        raise ValueError(f"seq_len must be a multiple of 8, got {seq_len}")
    if sample_seeds is not None:
        if generator is not None or x_init is not None or noises is not None:
            raise ValueError("sample_seeds excludes generator, x_init and noises")
        if len(sample_seeds) != text.shape[0]:
            raise ValueError(f"{len(sample_seeds)} sample_seeds for a batch of {text.shape[0]}")
        x_init, noises = per_sample_noise_streams(sample_seeds, beta_set.shape[0], seq_len, dev)
    if mesh is not None and mesh.data_group is not None:
        return _generate_split(mesh, model, text, style, generator, seq_len, diffusion_mode,
                               guidance_scale, n_steps, schedule, temperature, x_init, noises,
                               beta_set.shape[0], dev, hoist, encoder_reuse)

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        return _sample(model, text, style, generator, seq_len, beta_set, diffusion_mode,
                       guidance_scale, temperature, x_init, noises, dev, hoist, encoder_reuse)


def _generate_split(mesh, model, text, style, generator, seq_len, mode, guidance_scale, n_steps,
                    schedule, temperature, x_init, noises, n, dev, hoist, encoder_reuse):
    """generate over the mesh's data group: this rank's rows of the whole
    batch's draws, then an all-gather of the rows in order."""
    from dhg_torch.parallel.sharding import all_gather_dim, is_sharded

    if is_sharded(model):
        raise ValueError("the sampler's mesh takes the data axis only: give generate a model "
                         "with whole weights")
    b = text.shape[0]
    if b < mesh.data_size:
        raise ValueError(f"a batch of {b} does not split over {mesh.data_size} data ranks")
    if x_init is None:
        # The draws diffusion_sample makes from `generator`, in its order:
        # x_T, then one normal a step unless the mode is DDIM.
        shape = (b, seq_len, 2)
        x_init = torch.randn(shape, generator=generator, device=dev)
        noises = (torch.zeros((n,) + shape, device=dev) if mode == "ddim" else torch.stack(
            [torch.randn(shape, generator=generator, device=dev) for _ in range(n)]))
    sizes = [len(c) for c in torch.arange(b).tensor_split(mesh.data_size)]
    lo = sum(sizes[:mesh.data_index])
    rows = slice(lo, lo + sizes[mesh.data_index])
    local = generate(model, text[rows], style[rows], seq_len=seq_len, diffusion_mode=mode,
                     guidance_scale=guidance_scale, n_steps=n_steps, schedule=schedule,
                     temperature=temperature, x_init=x_init[rows], noises=noises[:, rows],
                     device=dev, hoist=hoist, encoder_reuse=encoder_reuse)
    return all_gather_dim(local, 0, mesh.data_group, sizes)


def _sample(model, text, style, generator, seq_len, beta_set, mode, guidance_scale,
            temperature, x_init, noises, dev, hoist="compact", encoder_reuse=None):
    alpha_set = get_alpha_set(beta_set)
    n = beta_set.shape[0]
    # Reverse schedule order: loop step t uses schedule index n-1-t. sigma is
    # the same for every row, so its embedding and the FiLM coefficients are
    # computed at batch 1 and broadcast.
    sig_rev = torch.sqrt(alpha_set).flip(0)[:, None]  # [n, 1]
    sigma_embs = [model.embed_sigma(sig_rev[t:t + 1]) for t in range(n)]
    films = [model.precompute_film(se) for se in sigma_embs]

    def encode_all(t_ids, s):
        pre = model.encode_cond_pre(t_ids, s)
        return [model.encode_cond_tail(pre, se) for se in sigma_embs]

    full = hoist == "full" or encoder_reuse is not None  # reuse runs on the full hoist, as dhg's

    def kv_of(cond_all):
        """Step t's cross-attention K/V: every level's before the loop (full
        hoist), else rebuilt in the loop from the level's memory (compact)."""
        if not full:
            return lambda t: model.precompute_cross_kv(cond_all[t], sigma_embs[t])
        kv_all = [model.precompute_cross_kv(c, se) for c, se in zip(cond_all, sigma_embs)]
        return lambda t: kv_all[t]

    text_kv = kv_of(encode_all(text, style))
    text_mask = create_padding_mask(text)
    if encoder_reuse is not None:
        return diffusion_sample_encoder_reuse(
            lambda x, t: model.encode_unet(x, None, None, text_mask, kvs=text_kv(t),
                                           films=films[t]),
            lambda feats, t: model.decode_unet(feats, None, None, text_mask, kvs=text_kv(t),
                                               films=films[t]),
            text.shape[0], seq_len, beta_set, mode=mode, reuse_every=int(encoder_reuse),
            generator=generator, x_init=x_init, noises=noises, device=dev,
        )
    guided = guidance_scale is not None
    if guided:
        null_text = torch.zeros_like(text)
        null_text[:, 0] = 1
        null_kv = kv_of(encode_all(null_text, torch.zeros_like(style)))
        null_mask = create_padding_mask(null_text)

    def denoise(x, sigma, t):
        eps_c, pen = model.denoise(x, None, None, text_mask, kvs=text_kv(t), films=films[t])
        if not guided:
            return eps_c, pen
        eps_u, _ = model.denoise(x, None, None, null_mask, kvs=null_kv(t), films=films[t])
        return eps_u + guidance_scale * (eps_c - eps_u), pen

    return diffusion_sample(
        denoise, text.shape[0], seq_len, beta_set, mode=mode, generator=generator,
        x_init=x_init, noises=noises, temperature=temperature, device=dev,
    )


def sample_lines(
    model,
    prompts: list[str],
    style,  # [1 or B, 14, 1280]
    generator: torch.Generator | None = None,
    max_text_len: int = 50,
    diffusion_mode: str = "new",
    guidance_scale: float | None = None,
    n_steps: int | None = None,
    schedule: str = "strided",
    temperature: float | None = None,
    device: str | torch.device = "cuda",
    encoder_reuse: int | None = None,
    mesh=None,
) -> list[np.ndarray]:
    """Sample many prompts in one padded batch; each returned [T_i, 3] array
    is trimmed to its own 16 * len(tokens) length. encoder_reuse and mesh
    go to generate."""
    text = Tokenizer().encode_batch(prompts, max_text_len)
    style = torch.as_tensor(style, dtype=torch.float32)
    if style.shape[0] == 1 and len(prompts) > 1:
        style = style.expand(len(prompts), *style.shape[1:])
    lengths = [len(p) + 1 for p in prompts]  # + EOS
    out = generate(
        model, text, style, generator, seq_len=infer_seq_len(max(lengths)),
        diffusion_mode=diffusion_mode, guidance_scale=guidance_scale, n_steps=n_steps,
        schedule=schedule, temperature=temperature, device=device,
        encoder_reuse=encoder_reuse, mesh=mesh,
    )
    arr = out.cpu().numpy()
    return [arr[i, : infer_seq_len(l)] for i, l in enumerate(lengths)]


_style_extractors: dict = {}  # (weights_path, strict, device) -> StyleExtractor


def style_from_image(source, img_height: int = 96, style_weights=None, strict: bool = False,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Read a writer-style PNG and extract its [1, 14, 1280] style vector
    (float32, on `device`).

    style_weights: dhg's flat MobileNetV2 .npz; None resolves to the repo
    default <repo>/data/mobilenetv2_tv.npz. A missing file warns loudly
    (random trunk); strict=True raises instead. The extractor is built once
    per (style_weights, strict, device) and reused."""
    from dhg_torch.data.images import read_img
    from dhg_torch.models.style_extractor import init_style_extractor

    dev = resolve_device(device)
    key = (None if style_weights is None else str(style_weights), bool(strict), str(dev))
    if key not in _style_extractors:
        _style_extractors[key] = init_style_extractor(style_weights, strict=strict, device=dev)
    img = torch.from_numpy(read_img(source, img_height).astype(np.float32))[None].to(dev)
    with torch.inference_mode():
        return _style_extractors[key](img)


def infer(
    prompt: str | None = None,
    source: str | None = None,
    config_path: str | None = None,
    checkpoint_path: str | None = None,
    experiment_path: str | None = None,
    output: str = "result",
    diffusion_mode: str | None = None,
    seed: int = 0,
    show: bool = False,
    guidance_scale: float | None = None,
    style_weights: str | None = None,
    strict_style: bool = False,
    n_steps: int | None = None,
    use_ema: bool = True,
    schedule: str | None = None,
    prompts_file: str | None = None,
    format: str = "png",
    temperature: float | None = None,
    source2: str | None = None,
    style_mix: float | None = None,
    wrap: int | None = None,
    line_gap: float | None = None,
    align: str = "left",
    device: str = "cuda",
) -> np.ndarray | list[np.ndarray]:
    """End-to-end inference, with dhg's arguments and defaults (plus
    `device`); returns the [T, 3] stroke array, or one per line with
    prompts_file.

    The model loads in float32 (dhg's `infer` passes no dtype). Config and
    checkpoint come from experiment_path (config.yml; model_final, then
    model_last, then the highest checkpoint_<N>) unless given. format "png"
    (render_strokes) or "svg". prompts_file: one prompt per line, sampled in
    one padded batch, saved as <output>_000, <output>_001, ... wrap=N:
    word-wrap the prompt into lines of <= N characters, sample them in one
    batch and compose one page (line_gap, align). A distilled student
    (config training_args.distilled_steps) defaults to its own grid:
    n_steps = distilled_steps, schedule "halved", mode "ddim"; explicit
    flags win. source2 / style_mix: the style becomes (1 - mix) * style
    (source) + mix * style(source2), mix 0.5 by default. style_weights falls
    back to the config's dataset_args.style_weights, then the repo default.
    Randomness is a torch.Generator seeded with `seed` on `device`.
    """
    from dhg_torch.checkpoint import resolve_run_paths
    from dhg_torch.config import DLConfig
    from dhg_torch.models.denoiser import DiffusionModel

    config_path, checkpoint_path = resolve_run_paths(experiment_path, config_path,
                                                     checkpoint_path)
    dev = resolve_device(device)
    model = DiffusionModel.load(checkpoint_path, dtype=None, use_ema=use_ema, device=dev)
    cfg = DLConfig.load(config_path)
    if style_weights is None:
        style_weights = cfg.dataset_args.style_weights

    distilled = cfg.training_args.distilled_steps
    if distilled:
        n_steps = int(distilled) if n_steps is None else n_steps
        schedule = "halved" if schedule is None else schedule
        diffusion_mode = "ddim" if diffusion_mode is None else diffusion_mode
    diffusion_mode = diffusion_mode or "new"
    schedule = schedule or "strided"

    if (prompt is None) == (prompts_file is None):
        raise ValueError("provide exactly one of prompt or prompts_file")
    if source is None:
        raise ValueError("source (writer-style image) is required")
    if style_mix is not None and source2 is None:
        raise ValueError("style_mix requires source2 (a second style image)")

    style = style_from_image(source, style_weights=style_weights, strict=strict_style, device=dev)
    if source2 is not None:
        mix = 0.5 if style_mix is None else float(style_mix)
        style2 = style_from_image(source2, style_weights=style_weights, strict=strict_style,
                                  device=dev)
        style = (1.0 - mix) * style + mix * style2

    gen = torch.Generator(device=dev).manual_seed(int(seed))
    sampling = dict(diffusion_mode=diffusion_mode, guidance_scale=guidance_scale,
                    n_steps=n_steps, schedule=schedule, temperature=temperature, device=dev)
    max_text_len = int(cfg.dataset_args.max_text_len or 50)

    if wrap is not None:
        if prompts_file is not None:
            raise ValueError("wrap applies to a single --prompt, not prompts_file")
        wrap = int(wrap)
        if wrap + 1 > max_text_len:
            raise ValueError(
                f"wrap={wrap} + EOS exceeds the model's max_text_len="
                f"{max_text_len}; use wrap <= {max_text_len - 1}"
            )
        wrapped = wrap_text(prompt, wrap)
        to_sample = [ln for ln in wrapped if ln]
        if not to_sample:
            raise ValueError("prompt has no printable content to wrap")
        sampled = iter(sample_lines(model, to_sample, style, gen, max_text_len=max_text_len,
                                    **sampling))
        page = compose_lines([next(sampled) if ln else None for ln in wrapped],
                             line_gap=line_gap, align=align)
        save_strokes(page, output, fmt=format, show_output=show)
        return page

    if prompts_file is not None:
        prompts = [ln for ln in Path(prompts_file).read_text().splitlines() if ln.strip()]
        if not prompts:
            raise ValueError(f"no prompts in {prompts_file}")
        lines = sample_lines(model, prompts, style, gen, max_text_len=max_text_len, **sampling)
        for i, arr in enumerate(lines):
            save_strokes(arr, f"{output}_{i:03d}", fmt=format, show_output=show)
        return lines

    encoded = Tokenizer().encode(prompt)
    text = np.asarray([encoded], np.int64)
    strokes = generate(model, text, style, gen, seq_len=infer_seq_len(len(encoded)), **sampling)
    result = strokes[0].cpu().numpy()
    save_strokes(result, output, fmt=format, show_output=show)
    return result


def main(argv=None):
    """The CLI: --key=value arguments of `infer`; returns its strokes."""
    from dhg_torch.config import parse_cli_kwargs

    return infer(**parse_cli_kwargs(argv if argv is not None else sys.argv[1:],
                                    help_text=__doc__))


if __name__ == "__main__":
    main()
