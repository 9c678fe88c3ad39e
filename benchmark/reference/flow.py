"""The plain reference of what the timed paths produce, in plain PyTorch and
NumPy on the benchmark's own inputs, importing nothing of the program.

- :func:`train_steps` follows the first optimizer steps of the training
  recipe: the loader's epoch order, the step generator's draws (crop
  offsets and flips where the recipe augments, the mask toggle's coin
  where it toggles, the flow-matching time, the dropout seeds, in that
  order), the straight-line conditional flow-matching loss (the mask as a
  fourth input channel where the recipe conditions on one), the gradient
  and Adam's update. It runs the batch in blocks of rows, so it fits beside
  nothing else on the card.
- :func:`translate` is the served path: tiles of a fixed size and overlap,
  the Euler integration of the velocity from the source at t=0 to t=1, the
  feather-blended stitch and the 8-bit output.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..inputs import decode_png, read_split
from .common import Ctx, rounding

_TRAIN_STREAM = 0


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step ``step`` of a run seeded ``seed``."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + _TRAIN_STREAM * 0xBF58476D1CE4E5B9 + int(step)) % 2**64
    return torch.Generator().manual_seed(mixed)


def epoch_order(n: int, data_seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng(int(data_seed) + int(epoch)).permutation(n)


def crop_flip(x: torch.Tensor, crop: int, g: torch.Generator) -> tuple:
    """The shared random crop and flips of one batch: (index rows, index cols)
    of (B, H, W, C) images, drawing tops, lefts, horizontal then vertical flips."""
    b, h, w = x.shape[:3]
    tops = torch.randint(0, max(h - crop, 0) + 1, (b,), generator=g)
    lefts = torch.randint(0, max(w - crop, 0) + 1, (b,), generator=g)
    flip_h = torch.rand((b,), generator=g) < 0.5
    flip_v = torch.rand((b,), generator=g) < 0.5
    ar = torch.arange(crop)
    rows = tops[:, None] + torch.where(flip_v[:, None], crop - 1 - ar, ar)
    cols = lefts[:, None] + torch.where(flip_h[:, None], crop - 1 - ar, ar)
    return rows, cols


def load_batch(root: Path, pairs: list, idx: np.ndarray) -> tuple:
    """uint8 (B, H, W, 3) sources and targets, and where the tree has masks
    their (B, H, W) 0/1 masks (gray values above 1 are 1)."""
    fields = [np.stack([decode_png(root / "train" / pairs[i][0]) for i in idx]),
              np.stack([decode_png(root / "train" / pairs[i][1]) for i in idx])]
    if len(pairs[0]) > 2:
        fields.append(np.stack([(decode_png(root / "train" / pairs[i][2])[..., 0] > 1) for i in idx]))
    return tuple(fields)


def train_steps(net, weights: dict, tree: Path, recipe: dict, seed: int, steps: int, device,
                precision: str = "float32", rows_per_block: int = 8) -> dict:
    """``steps`` optimizer steps of ``recipe`` from ``weights`` on ``net``
    (the configuration's reference net on ``device``), in ``precision``. A
    recipe whose ``dropout`` is null trains at rate 0 and draws no seeds.

    Returns the loss of each step, the first step's gradient as Adam gets it
    and the parameters' change over all of them, each leaf's norm by name."""
    net.load_state_dict(weights)
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = recipe["optimizer"]
    beta1, beta2 = opt["betas"]
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    pairs = read_split(tree, "train")
    batch, crop, rate = int(recipe["batch_size"]), int(recipe["image_size"]), float(recipe["dropout"] or 0.0)
    order = epoch_order(len(pairs), seed, 0)
    cast = rounding(precision)
    losses, grad1 = [], None
    augment, toggle = bool(recipe.get("augment", True)), float(recipe.get("toggle_prob", 0.0))
    for step in range(steps):
        idx = order[step * batch:(step + 1) * batch]
        fields = load_batch(tree, pairs, idx)
        g = step_generator(seed, step)
        rows = cols = None
        if augment:
            rows, cols = crop_flip(torch.from_numpy(fields[0]), crop, g)
        zero_mask = toggle > 0 and bool(torch.rand((), generator=g) < toggle)
        t = torch.rand((batch,), generator=g)
        seeds = [int(torch.randint(0, 2**32, (1,), dtype=torch.int64, generator=g))
                 for _ in (net.dropout_layers if recipe["dropout"] is not None else ())]
        b_idx = torch.arange(batch)[:, None, None]

        def prep(u8):
            x = torch.from_numpy(u8)
            if rows is not None:
                x = x[b_idx, rows[:, :, None], cols[:, None, :]]
            return (x.to(torch.float32) / 127.5 - 1.0).permute(0, 3, 1, 2).to(device)

        x0, x1 = prep(fields[0]), prep(fields[1])
        mask = None
        if len(fields) > 2:
            mask = torch.from_numpy(fields[2]).to(torch.float32)[:, None].to(device)
            if rows is not None:
                raise ValueError("the masked recipes do not augment")
            if zero_mask:
                mask = torch.zeros_like(mask)
        t_dev = t.to(device)
        for p in params.values():
            p.grad = None
        loss = 0.0
        for r0 in range(0, batch, rows_per_block):
            sl = slice(r0, r0 + rows_per_block)
            tb = t_dev[sl].reshape(-1, 1, 1, 1)
            xt = (1.0 - tb) * x0[sl] + tb * x1[sl]
            ctx = Ctx(cast=cast, rate=rate, seeds=seeds if rate > 0 else None, batch_offset=r0)
            vt = net(t_dev[sl], xt if mask is None else torch.cat([xt, mask[sl]], dim=1), ctx)
            part = torch.mean((vt - (x1[sl] - x0[sl])) ** 2) * (xt.shape[0] / batch)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            n = step + 1
            # the gradient as Adam gets it: with torch's (coupled) weight decay, plus wd · p
            grads = {k: p.grad + opt["weight_decay"] * p if opt["weight_decay"] else p.grad for k, p in params.items()}
            if grad1 is None:
                grad1 = {k: float(g.norm()) for k, g in grads.items()}
            for k, p in params.items():
                grad = grads[k]
                m[k].mul_(beta1).add_(grad, alpha=1 - beta1)
                v[k].mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
                denom = (v[k].sqrt() / (1 - beta2 ** n) ** 0.5).add_(opt["eps"])
                p.addcdiv_(m[k], denom, value=-opt["lr"] / (1 - beta1 ** n))
    change = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    for p in params.values():
        p.grad = None
    return {"losses": losses, "grad1": grad1, "change": change}


def tile_starts(length: int, tile: int, stride: int) -> list[int]:
    if length <= tile:
        return [0]
    starts = list(range(0, length - tile + 1, stride))
    if starts[-1] != length - tile:
        starts.append(length - tile)
    return starts


def tiles_of(h: int, w: int, tile: int, overlap: int) -> int:
    """How many tiles a region of h × w pixels is cut into."""
    stride = tile - overlap
    return len(tile_starts(max(h, tile), tile, stride)) * len(tile_starts(max(w, tile), tile, stride))


def feather(tile: int, overlap: int) -> np.ndarray:
    ramp = np.ones(tile, np.float32)
    for i in range(min(overlap, tile // 2)):
        ramp[i] = ramp[tile - 1 - i] = (i + 1) / (overlap + 1)
    return (ramp[:, None] * ramp[None, :])[..., None]


def euler_evaluations(num_steps: int) -> int:
    """Velocity evaluations of a fixed-step Euler solve over ``num_steps`` points of [0, 1]."""
    return max(int(num_steps) - 1, 0)


@torch.no_grad()
def translate(net, image: np.ndarray, serve: dict, device, precision: str = "float32",
              rows_per_block: Optional[int] = None) -> np.ndarray:
    """(H, W, 3) uint8 → the served (H, W, 3) uint8 image."""
    tile, overlap = int(serve["tile"]), int(serve["overlap"])
    rows_per_block = rows_per_block or int(serve["wsi_batch"])
    ctx = Ctx(cast=rounding(precision))
    x = np.asarray(image, np.float32) / 127.5 - 1.0
    h, w, _ = x.shape
    if h < tile or w < tile:
        x = np.pad(x, ((0, max(0, tile - h)), (0, max(0, tile - w)), (0, 0)), mode="reflect")
    hp, wp, _ = x.shape
    coords = [(y, z) for y in tile_starts(hp, tile, tile - overlap) for z in tile_starts(wp, tile, tile - overlap)]
    weights = feather(tile, overlap)
    out = np.zeros((hp, wp, 3), np.float32)
    wsum = np.zeros((hp, wp, 1), np.float32)
    n_int = euler_evaluations(int(serve["num_steps"]))
    dt = 1.0 / n_int if n_int else 0.0
    for i in range(0, len(coords), rows_per_block):
        chunk = coords[i:i + rows_per_block]
        xb = torch.from_numpy(np.stack([x[y:y + tile, z:z + tile] for y, z in chunk])).permute(0, 3, 1, 2).to(device)
        for k in range(n_int):
            t = torch.full((xb.shape[0],), k * dt, dtype=torch.float32, device=device)
            xb = xb + dt * net(t, xb, ctx)
        gen = xb.permute(0, 2, 3, 1).cpu().numpy()
        for (y, z), g in zip(chunk, gen):
            out[y:y + tile, z:z + tile] += g * weights
            wsum[y:y + tile, z:z + tile] += weights
    img01 = np.clip(((out / wsum)[:h, :w] + 1.0) * 0.5, 0.0, 1.0)
    return (img01 * 255).astype(np.uint8)
