"""Train a writer-discriminative MobileNetV2 style trunk (port of
dhg/tools/train_style_trunk.py).

    python -m dhg_torch.tools.train_style_trunk [--steps=600] [--writers=128]
        [--per_writer=16] [--batch=64] [--width=384] [--lr=3e-4] [--seed=0]
        [--log_every=50] [--out=data/style_trunk_synth.npz] [--tree=<IAM tree>]
        [--device=cpu]

The trunk (the StyleExtractor's MobileNetV2, flax's random init from
--seed) and a linear head learn writer identity by softmax cross-entropy:
the head averages the 14 width bins, L2-normalises (+1e-6), scales by 16
and applies a Linear. Adam under a linear warm-up over 50 steps and a
cosine decay to 0 at --steps, gradients clipped to global norm 5 (dhg's
optax chain: train.Optimizer, train.warmup_cosine_decay; like optax the
schedule refuses --steps <= 50). BatchNorm stays in eval mode on its fixed
statistics while conv kernels and BN affines train: the network inference
runs. The image set is uploaded once as uint8 and indexed on the device;
batch indices are uniform draws with replacement from a device generator
seeded --seed (dhg's draws come from jax.random: the same distribution,
other indices). float32, TF32 off.

Training data: render_line_fast's pseudo-handwriting lines, one bundle of
parameters per writer (writer ids from 100, disjoint from eval_style_gap's
benchmark writers 0-7); or, with --tree, an IAM-shaped tree's line images
read through data/images.read_img, writer = form, 64 forms held out. The
trunk is saved in dhg's flat .npz layout (weights.flat_from_style_state_dict),
a `style_weights` file for dhg and for the port. Without --tree the trained
trunk is then scored on eval_style_gap's 8-writer benchmark (other writers,
other renderer).

Prints dhg's progress lines and results, the result dict carrying dhg's
keys plus `backend`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch import nn

from dhg_torch.tools.common import backend, tool_device

STYLE_H = 96
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "data" / "style_trunk_synth.npz"
WARMUP_STEPS = 50
CLIP_NORM = 5.0
# cv2.polylines(..., thickness=t, lineType=LINE_AA) inks about as a round pen
# of radius t - 0.3 with a one-pixel ramp: fitted on 48 lines of writers
# 100-123 against cv2 4.x (ink coverage within 5%, >= 98% of pixels on the
# same side of grey 128; tests/test_torch_port_style_trunk.py holds it).
CV2_AA_RADIUS_OFFSET = -0.3


def writer_bundle(writer_id: int) -> dict:
    """Same parameter space as eval_style_gap._writer_params."""
    rng = np.random.default_rng(1000 + writer_id)
    return {
        "slant": float(rng.uniform(-0.45, 0.45)),
        "thickness": float(rng.uniform(0.8, 3.2)),
        "x_height": float(rng.uniform(14.0, 34.0)),
        "spacing": float(rng.uniform(8.0, 22.0)),
        "jitter": float(rng.uniform(0.02, 0.35)),
        "loopiness": float(rng.uniform(0.5, 2.0)),
    }


def render_line_fast(writer_id: int, text_seed: int, width: int = 384) -> np.ndarray:
    """Pseudo-handwriting line [STYLE_H, width] uint8: dhg's glyph stream
    and integer vertices, inked by utils/vis.segments_aa in place of
    cv2.polylines (the card's machine has no cv2) at cv2's line width.

    The writer parameters mean what they mean in eval_style_gap.render_line;
    the glyph geometry differs, so retrieval on that renderer's benchmark
    measures writer-style transfer, not renderer memorisation."""
    from dhg_torch.utils.vis import segments_aa

    p = writer_bundle(writer_id)
    rng = np.random.default_rng(90_000 + text_seed)
    img = np.full((STYLE_H, width), 255, np.uint8)
    baseline = STYLE_H * 0.62
    x_pen = 10.0
    thickness = max(1, int(round(p["thickness"])))
    starts, ends = [], []
    while x_pen < width - 20:
        n_arcs = int(rng.integers(2, 5))
        t = np.linspace(0, 1, 16)
        pts = []
        cx, cy = 0.0, 0.0
        for _ in range(n_arcs):
            amp = rng.uniform(0.3, 1.0) * p["loopiness"]
            phase = rng.uniform(0, 2 * np.pi)
            dx = rng.uniform(0.2, 0.7)
            x_arc = cx + t * dx
            y_arc = cy + amp * np.sin(2 * np.pi * t * rng.uniform(0.5, 1.5) + phase) * 0.5
            pts.append(np.stack([x_arc, y_arc], 1))
            cx, cy = x_arc[-1], y_arc[-1]
        curve = np.concatenate(pts, 0)
        gx = curve[:, 0] * p["x_height"]
        gy = curve[:, 1] * p["x_height"]
        gy = gy + rng.normal(0, p["jitter"] * p["x_height"], gy.shape)
        gx = gx + p["slant"] * gy
        px = (x_pen + gx).astype(np.int32)
        py = (baseline - gy).astype(np.int32)
        poly = np.stack([px, py], 1)
        starts.append(poly[:-1])
        ends.append(poly[1:])
        x_pen += p["spacing"] + p["x_height"] * 0.4
    segments_aa(img, np.concatenate(starts), np.concatenate(ends),
                thickness + CV2_AA_RADIUS_OFFSET)
    return img


def build_training_set(n_writers: int, per_writer: int, width: int, writer_offset: int = 100):
    """[N, H, W] uint8 images + int32 labels; writers disjoint from the
    eval benchmark (ids 0-7 in eval_style_gap). Rendered on up to 8 threads
    (numpy releases the GIL in its array work); each image depends on its
    writer and text seed only."""
    jobs = [(writer_offset + w, (w + writer_offset) * 977 + k)
            for w in range(n_writers) for k in range(per_writer)]
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        imgs = list(pool.map(lambda job: render_line_fast(*job, width), jobs))
    labels = [w for w in range(n_writers) for _ in range(per_writer)]
    return np.stack(imgs), np.asarray(labels, np.int32)


def build_tree_training_set(tree_root: str, n_forms: int = 512, width: int = 384,
                            min_lines: int = 3, holdout_forms: int = 64, seed: int = 0):
    """Training set from an IAM-shaped tree: writer = FORM. Line images are
    read through the dataset's own read_img (crop + resize to height 96),
    then right-padded with white or randomly cropped to a fixed width.

    Returns (imgs u8 [N,96,width], labels i32 [N], holdout_imgs,
    holdout_labels) with the holdout forms DISJOINT from training."""
    from collections import defaultdict

    from dhg_torch.data.images import read_img

    rng = np.random.RandomState(seed)
    by_form: dict[str, list] = defaultdict(list)
    for p in sorted(Path(tree_root, "lineImages").rglob("*.tif")):
        by_form[p.name.rsplit("-", 1)[0]].append(p)
    forms = [f for f, ps in sorted(by_form.items()) if len(ps) >= min_lines]
    rng.shuffle(forms)
    train_forms = forms[:n_forms]
    hold_forms = forms[n_forms: n_forms + holdout_forms]

    def load_set(form_list):
        imgs, labels = [], []
        for li, form in enumerate(form_list):
            for p in by_form[form]:
                img = read_img(p, 96)
                w = img.shape[1]
                if w < width:
                    img = np.pad(img, ((0, 0), (0, width - w)), constant_values=255)
                else:
                    lo = rng.randint(0, w - width + 1)
                    img = img[:, lo: lo + width]
                imgs.append(img.astype(np.uint8))
                labels.append(li)
        return np.stack(imgs), np.asarray(labels, np.int32)

    return (*load_set(train_forms), *load_set(hold_forms))


class Head(nn.Module):
    """[B, 14, 1280] features -> [B, n_classes] logits: mean over the width
    bins, L2 normalisation (+1e-6), x16, a Linear (flax Dense's init:
    lecun_normal weight, zero bias)."""

    def __init__(self, n_classes: int, dim: int = 1280):
        super().__init__()
        self.cls = nn.Linear(dim, n_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = feats.mean(dim=1)
        h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-6)
        return self.cls(h * 16.0)


class TrunkClassifier(nn.Module):
    """The StyleExtractor and its head; BatchNorm stays in eval mode."""

    def __init__(self, extractor: nn.Module, head: Head):
        super().__init__()
        self.extractor, self.head = extractor, head

    def train(self, mode: bool = True):
        # The trunk is trained as inference runs it: BatchNorm on its fixed
        # running statistics (batch statistics would move them).
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.extractor(x))


def make_classifier(n_classes: int, seed: int, device) -> TrunkClassifier:
    """A random trunk (flax's init from `seed`) and head, every parameter
    trainable (BN affines included), buffers fixed."""
    from dhg_torch.models.mobilenetv2 import lecun_init
    from dhg_torch.models.style_extractor import random_style_extractor

    gen = torch.Generator().manual_seed(seed)
    extractor = random_style_extractor(gen)
    with torch.random.fork_rng(devices=[]):  # torch's own init draws from the global stream
        head = Head(n_classes)
    lecun_init(head, gen)
    net = TrunkClassifier(extractor, head).to(device).eval()
    return net.requires_grad_(True)


def make_optimizer(net: nn.Module, lr: float, steps: int):
    """dhg's chain(clip_by_global_norm(5), adam(warmup_cosine_decay(0, lr,
    50, steps)))."""
    from dhg_torch.train import Optimizer, warmup_cosine_decay

    return Optimizer(net, "adam", warmup_cosine_decay(0.0, lr, WARMUP_STEPS, steps),
                     clip=CLIP_NORM, clip_mode="norm")


def train_step(net: TrunkClassifier, opt, x: torch.Tensor, y: torch.Tensor):
    """One update on the float32 images x [B, H, W] and labels y [B]:
    (cross-entropy, batch accuracy) before it, as device scalars."""
    logits = net(x)
    ce = nn.functional.cross_entropy(logits, y.long())
    acc = (logits.argmax(-1) == y).float().mean()
    grads = torch.autograd.grad(ce, opt.params)
    opt.step(list(grads))
    return ce.detach(), acc


def train(steps: int = 600, writers: int = 128, per_writer: int = 16, batch: int = 64,
          width: int = 384, lr: float = 3e-4, seed: int = 0, out: str | None = None,
          log_every: int = 50, tree: str | None = None, device: str | torch.device = "cuda",
          stats: dict | None = None) -> dict:
    """Build the training set, train, save; `stats` (if given) receives the
    wall seconds of the set's build and of the steps, and steps/s."""
    from dhg_torch import resolve_device
    from dhg_torch.tools.eval_style_gap import _retrieval_metrics, style_vectors
    from dhg_torch.weights import flat_from_style_state_dict

    dev = resolve_device(device)
    stats = {} if stats is None else stats
    t0 = time.time()
    holdout = None
    if tree:
        imgs, labels, h_imgs, h_labels = build_tree_training_set(
            tree, n_forms=writers, width=width, seed=seed)
        writers = int(labels.max()) + 1
        holdout = (h_imgs, h_labels)
    else:
        imgs, labels = build_training_set(writers, per_writer, width)
    stats["build_s"] = time.time() - t0
    print(f"training set: {imgs.shape} ({imgs.nbytes / 1e6:.0f} MB), "
          f"{writers} writers, built in {time.time() - t0:.1f}s", flush=True)

    if dev.type == "cuda":  # float32 products, as init_style_extractor keeps them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    net = make_classifier(writers, seed, dev)
    opt = make_optimizer(net, lr, steps)
    imgs_dev = torch.from_numpy(imgs).to(dev)  # [N, H, W] uint8, one upload
    labels_dev = torch.from_numpy(labels.astype(np.int64)).to(dev)
    gen = torch.Generator(dev).manual_seed(seed)

    ce = acc = torch.zeros(())
    t0 = time.time()
    for i in range(steps):
        idx = torch.randint(0, imgs_dev.shape[0], (batch,), generator=gen, device=dev)
        ce, acc = train_step(net, opt, imgs_dev[idx].float(), labels_dev[idx])
        if (i + 1) % log_every == 0 or i == 0:
            print(f"step {i + 1}/{steps} | ce {float(ce):.3f} | "
                  f"batch acc {float(acc):.3f} | {time.time() - t0:.1f}s", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats["train_s"] = time.time() - t0
    stats["steps_per_sec"] = steps / max(stats["train_s"], 1e-9)

    out_path = Path(out if out is not None else DEFAULT_OUT)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **flat_from_style_state_dict(net.extractor.state_dict()))
    print(f"saved trained trunk -> {out_path} ({out_path.stat().st_size / 1e6:.1f} MB)")
    res = {"out": str(out_path), "final_ce": float(ce), "final_acc": float(acc),
           "backend": backend(dev)}
    if holdout is not None:
        h_imgs, h_labels = holdout
        res["holdout_retrieval"] = _retrieval_metrics(style_vectors(net.extractor, h_imgs),
                                                      np.asarray(h_labels))
        print("holdout (unseen forms, same tree):", json.dumps(res["holdout_retrieval"]))
    return res


def evaluate(weights: str | None, device: str | torch.device = "cuda") -> dict:
    """Retrieval on eval_style_gap's 8-writer benchmark (disjoint writers AND a
    different renderer) with the trunk in `weights` (None: the repo default)."""
    from dhg_torch.tools import eval_style_gap as gap

    imgs, labels = gap.benchmark_lines(gap.BENCHMARK_WRITERS, gap.BENCHMARK_LINES,
                                       gap.BENCHMARK_WIDTH)
    return gap._retrieval_metrics(
        gap.style_vectors(gap.quiet_extractor(weights, device=device), imgs), labels)


def main(argv=None) -> dict:
    from dhg_torch.config import parse_cli_kwargs

    kw = parse_cli_kwargs(argv if argv is not None else sys.argv[1:], help_text=__doc__)
    dev = tool_device(kw)
    ints = {k: int(kw[k]) for k in ("steps", "writers", "per_writer", "batch", "width", "seed",
                                    "log_every") if k in kw}
    tree = str(kw["tree"]) if kw.get("tree") else None
    out = str(kw["out"]) if kw.get("out") else None
    res = train(out=out, lr=float(kw.get("lr", 3e-4)), tree=tree, device=dev, **ints)
    report = {"train": res}
    if tree is None:
        print("== held-out retrieval (8 benchmark writers, other renderer) ==")
        report["trained"] = evaluate(res["out"], dev)
        print("  trained trunk:", json.dumps(report["trained"]))
        print("(dhg's records: random trunk 45.8%, raw pixels 47.9% — PERFORMANCE.md)")
    return report


if __name__ == "__main__":
    main()
