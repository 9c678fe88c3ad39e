#!/usr/bin/env python3
"""Drive the PyTorch port (``stain2stain_tpu_torch``) end to end on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit and no result line):

1. Device: the card's name and power limit, the torch and CUDA versions.
2. Build: every CUDA kernel of the port from ``stain2stain_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once), with ptxas' report.
3. K1-fwd (``csrc/attention_fwd.cu``) against its plain PyTorch version on
   the card at the serving shapes, with the stated tolerances; times of the
   kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only, never used by the port) beside the bound computed from
   the shape.
4. K1-bwd (``csrc/attention_bwd.cu``) against its plain version (the
   explicit backward, itself checked against torch autograd through the
   plain forward) at the training shapes; times of the kernel, the plain
   version and the backward of ``scaled_dot_product_attention`` (yardstick
   only) beside the bound.
5. The serving path at full width: ``configs/`` composed through the port's
   config code, the flagship UNet (``model=conditional_flow_matching``, about
   71 M parameters) from a fixed seed with every parameter jittered (ADM
   zero-inits the output convs, which would make ``generate`` the identity
   and hide a faulty kernel), ``TranslationServer`` (tile 256, overlap 32,
   batch 16, euler with 2 steps) behind ``serve_forever`` on 127.0.0.1, a
   few PNG requests over HTTP, then one tile batch through the config's own
   dopri5 solver. The launch counts are zeroed just before and read just
   after: K1 must have launched once per velocity evaluation.
6. One f32 UNet forward on the card (TF32 off) against the same weights
   through the plain path on the CPU.
7. The training path at full width: ``train(cfg)`` of
   ``stain2stain_tpu_torch.train`` in process on
   ``experiment=quality_synthetic_256`` (flagship UNet, batch 32 at 256 px,
   bf16-mixed) cut to 256 training tiles and one epoch: 8 optimizer steps,
   validation, checkpoints, test from the best checkpoint. The launch counts
   are zeroed just before and read just after: K1-bwd must have launched once
   per backward pass, K1-fwd once per net forward.
8. One f32 train step of the flagship (batch 2, 256 px, dropout 0) on the
   card with TF32 off against the same step through the plain path on the
   CPU: loss and every parameter gradient.
9. A ``kernels`` JSON line, the card line, and ``{"ok": true, "device": ...}``
   as the last line.

It exits non-zero, printing no result, when no CUDA card is present or when
the port's package is not beside it.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores (the K1 kernel keeps f32 products for f32
# inputs), HBM3 bandwidth. The exponential rate comes from the card itself:
# 16 MUFU ex2 results per clock per SM at the card's maximum SM clock.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
MUFU_EX2_PER_CLK_PER_SM = 16

TOL = {"float32": 5e-5, "bfloat16": 8e-3}  # max abs error vs the plain version
UNET_REL_TOL = 2e-4  # f32 card vs CPU, TF32 off: summation order only
# K1-bwd: max abs error over dq, dk, dv as a multiple of max|ref|. f32: the
# sums over T keys and queries run in another order (measured ~2e-6); bf16:
# the outputs are rounded to bf16, whose ulp is 2^-7 of the value, so up to
# about 0.4 % of max|ref| plus the f32 summation order.
BWD_REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# flagship f32 gradients, card (TF32 off) vs CPU, as a multiple of the
# largest |gradient|: summation order over batch x 65536 pixels per weight
GRAD_REL_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Median per-call milliseconds, each call bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(bh: int, t: int, d: int, dtype: str, exp_per_s: float) -> dict:
    elem = 2 if dtype == "bfloat16" else 4
    bytes_ms = 4 * bh * t * d * elem / PEAK_BYTES_PER_S * 1e3  # q, k, v read, o written
    flop_ms = 4 * bh * t * t * d / PEAK_FLOPS[dtype] * 1e3  # q·kᵀ and p·v
    exp_ms = bh * t * t / exp_per_s * 1e3  # one exponential per logit
    ops_ms = max(flop_ms, exp_ms)
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "flop_ms": flop_ms,
        "exp_ms": exp_ms,
    }


def phase_kernels(exp_per_s: float) -> dict:
    import torch
    import torch.nn.functional as F

    from stain2stain_tpu_torch.ops.attention import fused_attention, fused_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("K1: TF32 off for matmul and cuDNN (the plain f32 version runs in full f32)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        (256, 1024, 32, "float32", "256-px serving shape, f32 (the config's dtype: the main path)"),
        (256, 1024, 32, "bfloat16", "256-px serving shape, bf16"),
        (64, 4096, 32, "bfloat16", "512-px mid block, bf16"),
        (16, 1000, 32, "float32", "ragged T, f32"),
        (16, 1000, 32, "bfloat16", "ragged T, bf16"),
    ]
    results = []
    for bh, t, d, dtype, what in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen).to(dt) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out = fused_attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = fused_attention_reference(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
        ms = cuda_ms(lambda: fused_attention(q, k, v, scale), repeats=20)
        plain_ms = cuda_ms(lambda: fused_attention_reference(q, k, v, scale), repeats=5)
        # (1, BH, T, d): the 4-D layout SDPA's fused backends take
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale), repeats=20
        )
        row = dict(bh=bh, t=t, d=d, dtype=dtype, what=what, max_abs_err=err, tol=TOL[dtype],
                   ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   **attention_bound(bh, t, d, dtype, exp_per_s))
        log("K1 " + json.dumps(row))
        results.append(row)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return {"cases": results}


def attention_bwd_bound(bh: int, t: int, d: int, dtype: str, exp_per_s: float) -> dict:
    elem = 2 if dtype == "bfloat16" else 4
    bytes_ms = 8 * bh * t * d * elem / PEAK_BYTES_PER_S * 1e3  # q, k, v, o, do read; dq, dk, dv written
    flop_ms = 10 * bh * t * t * d / PEAK_FLOPS[dtype] * 1e3  # s, dv, dp, dq, dk products
    exp_ms = bh * t * t / exp_per_s * 1e3  # one exponential per p
    ops_ms = max(flop_ms, exp_ms)
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "flop_ms": flop_ms,
        "exp_ms": exp_ms,
    }


def phase_k1_bwd(exp_per_s: float) -> dict:
    import torch
    import torch.nn.functional as F

    from stain2stain_tpu_torch.ops.attention import (
        fused_attention_backward,
        fused_attention_backward_reference,
        fused_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("K1-bwd: TF32 off for matmul and cuDNN (the plain f32 version runs in full f32)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        (512, 1024, 32, "bfloat16", "256-px training shape (batch 32, 16 heads), bf16: the main path"),
        (512, 1024, 32, "float32", "256-px training shape, f32"),
        (64, 4096, 32, "bfloat16", "512-px mid block at batch 4, bf16"),
        (16, 1000, 32, "float32", "ragged T, f32"),
        (16, 1000, 32, "bfloat16", "ragged T, bf16"),
    ]
    results = []
    for bh, t, d, dtype, what in cases:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen).to(dt) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o = fused_attention_reference(q, k, v, scale)
        got = fused_attention_backward(q, k, v, o, do, scale)
        torch.cuda.synchronize()
        ref = fused_attention_backward_reference(q, k, v, o, do, scale)
        ref_max = max(r.float().abs().max().item() for r in ref)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        # the plain version against torch autograd through the plain forward
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(fused_attention_reference(*leaves, scale), leaves, do)
        auto_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(auto, ref))
        del leaves, auto
        tol = BWD_REL_TOL[dtype] * ref_max
        ok = all(bool(torch.isfinite(g).all()) for g in got) and err <= tol and auto_err <= tol
        ms = cuda_ms(lambda: fused_attention_backward(q, k, v, o, do, scale), repeats=10)
        plain_ms = cuda_ms(lambda: fused_attention_backward_reference(q, k, v, o, do, scale), repeats=3, warmup=1)
        # (1, BH, T, d): the 4-D layout SDPA's fused backends take
        q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(out4, (q4, k4, v4), do[None], retain_graph=True), repeats=10
        )
        row = dict(bh=bh, t=t, d=d, dtype=dtype, what=what, max_abs_err=err, autograd_vs_plain=auto_err,
                   ref_max_abs=ref_max, tol=tol, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   **attention_bwd_bound(bh, t, d, dtype, exp_per_s))
        log("K1-bwd " + json.dumps(row))
        results.append(row)
        del q, k, v, do, o, got, ref, q4, k4, v4, out4
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"K1-bwd disagrees with its plain version: {bad}")
    return {"cases": results}


def _test_image(h: int, w: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [128 + 90 * np.sin(xx / 37.0 + c) * np.cos(yy / 23.0 - c) for c in range(3)], axis=-1
    )
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _png(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def phase_slice(card: str) -> tuple[dict, object]:
    import numpy as np
    import torch
    from PIL import Image

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.server import TranslationServer, serve_forever
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule
    from stain2stain_tpu_torch.wsi import tile_starts

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for serving:
    torch.backends.cudnn.allow_tf32 = True  # f32 matmul, TF32 cuDNN convs
    cfg = compose(REPO / "configs", "infer.yaml", ["model=conditional_flow_matching"])
    torch.manual_seed(0)
    net = instantiate(cfg.model.net, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, device=p.device, generator=gen))
    n_params = sum(p.numel() for p in net.parameters())
    log(f"slice: flagship UNet {n_params} parameters on {card}, every parameter jittered (std 0.02)")

    evals = [0]
    net.register_forward_hook(lambda *_: evals.__setitem__(0, evals[0] + 1))
    task = ConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    tile, overlap, batch = 256, 32, 16

    # ---- the main path: counts zeroed just before, read just after --------
    fused_attention.launches = 0
    evals[0] = 0
    t0 = time.perf_counter()
    server = TranslationServer(task, num_steps=2, tile=tile, overlap=overlap, batch=batch)
    warm_s = time.perf_counter() - t0
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(server, "127.0.0.1", 0, ready), daemon=True)
    thread.start()
    requests = []
    try:
        if not ready.wait(30):
            raise RuntimeError("server did not bind")
        base = f"http://127.0.0.1:{server.bound_port}"
        for h, w in [(1000, 900), (256, 256), (700, 520), (1000, 900)]:
            img = _test_image(h, w, seed=h * w)
            body = _png(img)
            n_tiles = len(tile_starts(max(h, tile), tile, tile - overlap)) * len(
                tile_starts(max(w, tile), tile, tile - overlap)
            )
            req = urllib.request.Request(
                f"{base}/translate", data=body, headers={"Content-Type": "image/png"}
            )
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, payload = resp.status, resp.read()
            latency = time.perf_counter() - t1
            out = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
            if status != 200 or out.shape != img.shape:
                raise AssertionError(f"bad response {status} {out.shape} for {img.shape}")
            requests.append(dict(card=card, h=h, w=w, tiles=n_tiles, batches=math.ceil(n_tiles / batch),
                                 latency_s=latency, tiles_per_s=n_tiles / latency,
                                 mean_abs_change=float(np.abs(out.astype(np.float32) - img).mean())))
            log("request " + json.dumps(requests[-1]))
        info = json.loads(urllib.request.urlopen(f"{base}/info", timeout=60).read())
        # finiteness of the float output, in process (a PNG cannot show a NaN)
        direct = server.translate(_test_image(300, 280, seed=5))
        if direct.shape != (300, 280, 3) or not np.isfinite(direct).all():
            raise AssertionError("translate returned a non-finite or misshapen image")
    finally:
        if server.httpd is not None:
            server.httpd.shutdown()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")

    # the config's own solver (dopri5, atol/rtol 1e-4) on one tile batch
    dopri_task = ConditionalFlowMatchingModule(net=net, solver=instantiate(cfg.model.solver))
    src = torch.from_numpy(
        np.stack([_test_image(tile, tile, seed=100 + i) for i in range(batch)]).astype(np.float32) / 127.5 - 1.0
    ).cuda()
    before = evals[0]
    t2 = time.perf_counter()
    x1 = dopri_task.generate(src, num_steps=100)
    torch.cuda.synchronize()
    dopri_s = time.perf_counter() - t2
    dopri_evals = evals[0] - before
    launches, total_evals = fused_attention.launches, evals[0]
    # ---- end of the main path ---------------------------------------------
    if not torch.isfinite(x1).all() or x1.shape != src.shape:
        raise AssertionError("dopri5 generate returned a non-finite or misshapen batch")
    log(f"dopri5: {dopri_evals} velocity evaluations on a batch of {batch} tiles in {dopri_s:.3f} s")
    if launches == 0 or launches != total_evals:
        raise AssertionError(f"K1 launches {launches} != velocity evaluations {total_evals}")
    tiles = sum(r["tiles"] for r in requests)
    seconds = sum(r["latency_s"] for r in requests)
    summary = dict(
        card=card, n_params=n_params, warmup_s=warm_s, requests=len(requests), tiles=tiles,
        tiles_per_s=tiles / seconds, latency_s=[r["latency_s"] for r in requests],
        velocity_evals=total_evals, k1_launches=launches, dopri5_evals=dopri_evals,
        dopri5_s=dopri_s, requests_served=info["requests_served"],
    )
    log("slice " + json.dumps(summary))
    if min(r["mean_abs_change"] for r in requests) < 1.0:
        raise AssertionError("the translated images equal their inputs: the velocity is zero")
    return summary, net


def phase_unet_parity(net) -> dict:
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = compose(REPO / "configs", "infer.yaml", ["model=conditional_flow_matching"])
    cpu_net = instantiate(cfg.model.net, device="cpu").eval()
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    net.eval()
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32))
    t = torch.tensor([0.37])
    before = fused_attention.launches
    with torch.inference_mode():
        got = net(t.cuda(), x.cuda()).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = cpu_net(t, x)
        cpu_s = time.perf_counter() - t0
    if fused_attention.launches != before + 1:
        raise AssertionError("the card forward did not go through K1")
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    row = dict(max_abs_err=err, ref_max_abs=ref.abs().max().item(), tol=UNET_REL_TOL * scale,
               cpu_forward_s=cpu_s, ok=err <= UNET_REL_TOL * scale)
    log("unet-parity " + json.dumps(row))
    if not row["ok"] or not torch.isfinite(got).all():
        raise AssertionError(f"f32 UNet on the card disagrees with the CPU plain path: {row}")
    return row


def step_clock():
    """A training callback (instantiated from the config by ``_target_``) that
    records the device-synchronized end time and loss of every optimizer step,
    and counts the net's forward calls through a hook installed at fit start."""
    import torch

    from stain2stain_tpu_torch.training import Callback

    class StepClock(Callback):
        def __init__(self):
            self.ends, self.losses, self.forwards, self.t0 = [], [], [0], None

        def on_fit_start(self, trainer, task):
            task.net.register_forward_hook(lambda *_: self.forwards.__setitem__(0, self.forwards[0] + 1))

        def on_train_epoch_start(self, trainer, task):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, trainer, task, metrics):
            self.losses.append(float(metrics["loss"]))  # synchronizes
            self.ends.append(time.perf_counter())

    return StepClock()


TRAIN_OVERRIDES = [
    "experiment=quality_synthetic_256",
    "trainer.accelerator=gpu",
    "data.n_train=256",
    "data.n_val=32",
    "data.n_test=32",
    "trainer.max_epochs=1",
    "trainer.check_val_every_n_epoch=1",
    "test=true",
]


def phase_train(card: str, work: Path) -> dict:
    """The training path at full width through ``stain2stain_tpu_torch.train``."""
    import torch

    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.ops.attention import fused_attention, fused_attention_backward
    from stain2stain_tpu_torch.train import train

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for training:
    torch.backends.cudnn.allow_tf32 = True  # f32 matmul, TF32 cuDNN convs (bf16 here anyway)
    overrides = TRAIN_OVERRIDES + [f"data.data_dir={work / 'data'}"]
    cfg = compose(REPO / "configs", "train.yaml", overrides)
    cfg["runtime"] = {"output_dir": str(work / "out"), "cwd": str(work)}
    cfg["extras"]["print_config"] = False
    log("train: " + " ".join(overrides))

    cfg["callbacks"]["step_clock"] = {"_target_": "__main__.step_clock"}
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts zeroed just before, read just after --------
    fused_attention.launches = 0
    fused_attention_backward.launches = 0
    t0 = time.perf_counter()
    metrics, objects = train(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = fused_attention.launches, fused_attention_backward.launches
    # ---- end of the main path -----------------------------------------------
    clock = objects["callbacks"][-1]
    trainer = objects["trainer"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(clock.losses)
    durations = [b - a for a, b in zip([clock.t0] + clock.ends[:-1], clock.ends)]
    steady = durations[2:8]
    step_ms = statistics.median(steady) * 1e3 if steady else float("nan")
    batch = int(cfg["data"]["batch_size"])
    ckpt = trainer.checkpoint_callback
    summary = dict(
        card=card, steps=steps, global_step=trainer.global_step, batch=batch,
        step_ms_median_3_8=step_ms, step_ms=[d * 1e3 for d in durations], tiles_per_s=batch / (step_ms / 1e3),
        peak_mem_gib=peak_gib, wall_s=wall_s, losses=clock.losses, forwards=clock.forwards[0],
        k1_fwd_launches=fwd_launches, k1_bwd_launches=bwd_launches,
        val_loss=metrics.get("val/loss"), test_loss=metrics.get("test/loss"),
        best=Path(ckpt.best_model_path).name if ckpt and ckpt.best_model_path else None,
        n_params=sum(p.numel() for p in objects["model"].net.parameters()),
        dtype=str(objects["model"].net.dtype),
    )
    log("train " + json.dumps(summary))
    finite = all(math.isfinite(x) for x in clock.losses + [summary["val_loss"] or math.nan, summary["test_loss"] or math.nan])
    if steps != 8 or not finite:
        raise AssertionError(f"training did not run 8 finite steps with finite val/test losses: {summary}")
    if not summary["best"] or not (Path(ckpt.last_model_path) / "state.pt").is_file():
        raise AssertionError("training wrote no best or last checkpoint")
    if bwd_launches == 0 or bwd_launches != steps:
        raise AssertionError(f"K1-bwd launches {bwd_launches} != backward passes {steps}")
    if fwd_launches == 0 or fwd_launches != clock.forwards[0]:
        raise AssertionError(f"K1-fwd launches {fwd_launches} != net forward calls {clock.forwards[0]}")
    return summary


def phase_grad_parity() -> dict:
    """One f32 train step of the flagship on the card vs the CPU plain path."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention_backward
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("grad-parity: TF32 off for matmul and cuDNN")
    cfg = compose(REPO / "configs", "train.yaml", ["model.net.dropout=0.0"])
    torch.manual_seed(0)
    nets = {dev: instantiate(cfg.model.net, device=dev) for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():  # jitter every parameter: ADM zero-inits the output convs
        for p in nets["cpu"].parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    rng = np.random.default_rng(4)
    batch = tuple(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8) for _ in range(2))
    t = torch.tensor([0.3, 0.8])
    out = {}
    for dev, net in nets.items():
        task = ConditionalFlowMatchingModule(net=net, device=dev)
        prepared = task.prepare_batch(batch, train=False)
        t0 = time.perf_counter()
        loss, _ = task.loss_and_metrics(prepared, train=True, t=t)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (loss.item(), {n: p.grad.detach().cpu() for n, p in net.named_parameters()},
                    time.perf_counter() - t0)
    (loss_gpu, g_gpu, gpu_s), (loss_cpu, g_cpu, cpu_s) = out["cuda"], out["cpu"]
    ref_max = max(g.abs().max().item() for g in g_cpu.values())
    err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    worst = max(g_cpu, key=lambda n: (g_gpu[n] - g_cpu[n]).abs().max().item())
    row = dict(loss_card=loss_gpu, loss_cpu=loss_cpu, max_abs_grad_err=err, worst_param=worst,
               ref_max_abs_grad=ref_max, tol=GRAD_REL_TOL * ref_max, card_step_s=gpu_s, cpu_step_s=cpu_s,
               k1_bwd_launches=fused_attention_backward.launches)
    row["ok"] = (err <= row["tol"] and abs(loss_gpu - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu))
                 and all(torch.isfinite(g).all() for g in g_gpu.values()))
    log("grad-parity " + json.dumps(row))
    if not row["ok"]:
        raise AssertionError(f"f32 flagship gradients on the card disagree with the CPU plain path: {row}")
    return row


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def phase_profile(net, card: str) -> dict:
    """Where the time of one tile batch goes (``--profile`` only).

    ``torch.profiler`` over three 2-step euler generate calls on a batch of 16
    256-px tiles (the server's shape): device time by kernel, the device's
    busy share of the wall time, and the host's share of a whole request.
    """
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stain2stain_tpu_torch.ops.image import denormalize_np, normalize_uint8_np
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule
    from stain2stain_tpu_torch.wsi import make_tiled_generator, translate_large_image

    torch.backends.cudnn.allow_tf32 = True  # the serving defaults again
    torch.backends.cuda.matmul.allow_tf32 = False
    task = ConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    gen = make_tiled_generator(task, num_steps=2)
    batch = np.stack([_test_image(256, 256, seed=200 + i) for i in range(16)]).astype(np.float32) / 127.5 - 1.0
    gen(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            gen(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies); the aten ops that launch them
    # would count the same time twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    rows = [dict(kernel=e.key[:90], device_ms=_device_us(e) / 1e3 / 3, calls=e.count / 3,
                 share=_device_us(e) / busy_us if busy_us else 0.0) for e in top]
    for r in rows:
        log("profile-kernel " + json.dumps(r))

    # host vs device for a whole request: time inside generate vs the request
    spent = [0.0]

    def timed(b):
        t = time.perf_counter()
        out = gen(b)
        spent[0] += time.perf_counter() - t
        return out

    t1 = time.perf_counter()
    out01 = denormalize_np(translate_large_image(
        timed, normalize_uint8_np(_test_image(1000, 900, seed=7)), tile=256, overlap=32, batch_size=16
    ))
    request_s = time.perf_counter() - t1
    if not np.isfinite(out01).all():
        raise AssertionError("profiled request returned non-finite pixels")
    result = dict(card=card, per_batch_wall_ms=wall_us / 1e3 / 3, per_batch_device_busy_ms=busy_us / 1e3 / 3,
               device_idle_share=max(0.0, 1.0 - busy_us / wall_us) if wall_us else None,
               request_s=request_s, request_generate_s=spent[0],
               request_host_share=1.0 - spent[0] / request_s)
    log("profile " + json.dumps(result))
    return result


def _train_kernel_category(name: str) -> str:
    """A device kernel's layer, from its name."""
    if "attention_" in name:
        return "attention kernels K1-fwd/K1-bwd"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "cuDNN layout transposes"
    if any(s in name for s in ("xmma", "gemm", "conv", "wgrad", "dgrad", "cutlass", "cudnn")):
        return "convolutions and matmuls"
    if "<int" in name:
        return "int32 elementwise (dropout hash)"
    if "reduce_kernel" in name:
        return "reductions (norm statistics, sums)"
    if "copy" in name or "Cat" in name:
        return "copies and casts"
    return "other elementwise"


def phase_profile_train(card: str) -> dict:
    """Where the time of one train step goes (``--profile`` only).

    The flagship task at batch 32, 256 px, bf16-mixed, through the trainer's
    own step (augmentation, loss, backward, Adam), under ``torch.profiler``
    for three steps after two warm-up steps: device time by kernel, the
    device's busy share of the wall time, and the attention kernels' share.
    """
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.training import Trainer

    torch.backends.cudnn.allow_tf32 = True  # torch's defaults for training
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = compose(REPO / "configs", "train.yaml", ["experiment=quality_synthetic_256", "trainer.accelerator=gpu"])
    torch.manual_seed(0)
    task = instantiate(cfg.model, net=instantiate(cfg.model.net, device="cuda"), device="cuda")
    trainer = Trainer(accelerator="gpu", precision="bf16-mixed", logger=False)
    trainer._prepare_task(task)
    trainer._init_state(task)
    rng = np.random.default_rng(0)
    batch = tuple(torch.from_numpy(rng.integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)).cuda() for _ in range(2))
    augment = {"crop_size": 256, "hflip": True, "vflip": True}
    for _ in range(2):
        trainer._train_step(task, batch, augment)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._train_step(task, batch, augment)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    rows = [dict(kernel=e.key[:90], device_ms=_device_us(e) / 1e3 / steps, calls=e.count / steps,
                 share=_device_us(e) / busy_us) for e in top]
    for r in rows:
        log("profile-train-kernel " + json.dumps(r))
    shares: dict[str, float] = {}
    for e in kernels:
        category = _train_kernel_category(e.key)
        shares[category] = shares.get(category, 0.0) + _device_us(e) / busy_us
    result = dict(card=card, steps=steps, per_step_wall_ms=wall_us / 1e3 / steps,
                  per_step_device_busy_ms=busy_us / 1e3 / steps,
                  device_idle_share=max(0.0, 1.0 - busy_us / wall_us),
                  shares_of_busy_time=dict(sorted(shares.items(), key=lambda kv: -kv[1])))
    log("profile-train " + json.dumps(result))
    return result


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one tile batch, one request and train steps (where the time goes)")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "stain2stain_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the stain2stain_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("PROJECT_ROOT", str(REPO))
    started = time.perf_counter()

    # 1. device
    card = nvidia_smi("name,power.limit")
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    exp_per_s = props.multi_processor_count * MUFU_EX2_PER_CLK_PER_SM * max_clock_mhz * 1e6
    log(f"device: {card}; {props.multi_processor_count} SMs, max SM clock {max_clock_mhz} MHz; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    # 2. build
    from stain2stain_tpu_torch import _build

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"ptxas {src}: {line.strip()}")
    log(f"build: {build_s:.3f} s for {len(_build.SOURCES)} source(s)")

    # 3-4. K1-fwd and K1-bwd against their plain versions
    k1 = phase_kernels(exp_per_s)
    k1_bwd = phase_k1_bwd(exp_per_s)

    # 5. the serving path at full width
    summary, net = phase_slice(card)

    # 6. kernel path vs plain path, end to end
    parity = phase_unet_parity(net)
    if args.profile:
        phase_profile(net, card)
    del net
    torch.cuda.empty_cache()

    # 7. the training path at full width, its files in a gitignored scratch dir
    (REPO / "scratch").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_", dir=REPO / "scratch") as work:
        train_summary = phase_train(card, Path(work))
    torch.cuda.empty_cache()

    # 8. f32 gradients, card vs CPU
    grad = phase_grad_parity()
    if args.profile:
        torch.cuda.empty_cache()
        phase_profile_train(card)

    # 9. result lines
    def row(name, source, replaces, case, launches, by_path, passed):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "shape": [case["bh"], case["t"], case["d"]],
            "dtype": case["dtype"],
            "passed": passed,
        }

    # each kernel's first case is the shape and dtype its main path runs
    kernels = [
        row("attention_fwd (K1-fwd)", "stain2stain_tpu_torch/csrc/attention_fwd.cu",
            "stain2stain_tpu/ops/pallas_attention.py:64", k1["cases"][0], summary["k1_launches"],
            {"serve": summary["k1_launches"], "train": train_summary["k1_fwd_launches"]},
            all(c["ok"] for c in k1["cases"]) and parity["ok"]),
        row("attention_bwd (K1-bwd)", "stain2stain_tpu_torch/csrc/attention_bwd.cu",
            "stain2stain_tpu/ops/pallas_attention.py:78", k1_bwd["cases"][0], train_summary["k1_bwd_launches"],
            {"train": train_summary["k1_bwd_launches"]},
            all(c["ok"] for c in k1_bwd["cases"]) and grad["ok"]),
    ]
    log(f"total: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
