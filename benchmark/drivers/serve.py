"""The serving driver: the program's HTTP server under a closed loop of clients.

Set-up builds the task from the configuration with the program's config
code, puts the benchmark's weights into its net, builds the program's
``TranslationServer`` (which warms itself on a full tile batch), serves it
with ``serve_forever`` on ``127.0.0.1`` at a free port, encodes the regions
and posts one of them. The window is the clients' (:mod:`..clients`, another
process): ``clients`` of them each post a region and wait for the reply,
for ``--seconds``; the requests still in flight at its end are waited for.
A forward hook of the benchmark on the net counts the tile rows it is
given. With ``--trace 1`` the profiler covers ``trace_seconds`` of the
window from ``trace_after_s`` on, and on until at least 10 traced requests
have ended, the count the span readers need; the clients keep posting until
it stops, past ``--seconds`` only where the host is too slow for that count.

After the window the server stops, the program's state is freed and the
plain reference that the configuration names translates a sample of the
answered regions drawn from the seed, the largest among them.
"""

from __future__ import annotations

import gc
import multiprocessing
import threading
import time
import urllib.request
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .. import clients, inputs, spans, trace, work
from ..core import Check, Record

TRACE_LEAST_REQUESTS = 10  # traced requests the span readers need (lock_wait_ms.serve reads from 10)
TRACE_MOST_S = 120.0  # the longest the trace waits for them past trace_seconds


def run(record: Record, root: Path, device: str, seconds: float, t_start: float,
        patch: Optional[Callable] = None) -> None:
    """Drive the cell; fills ``record``. ``patch(server)``, if given, runs on
    the built server (the tests break the timed path with it)."""
    import torch

    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.server import TranslationServer, serve_forever
    from stain2stain_tpu_torch.utils.utils import instantiate_task

    from ..reference import flow

    cell, seed = record.cell, record.seed
    traffic, serve, net_cfg, ref = cell.traffic, cell.config["serve"], cell.config["net"], cell.reference
    cfg = compose(root / "configs", "infer.yaml", list(serve["overrides"]))
    task = instantiate_task(cfg["model"], device=device)
    names_shapes = [(k, tuple(p.shape)) for k, p in task.net.named_parameters()]
    if sorted(names_shapes) != sorted((k, tuple(p.shape)) for k, p in ref.build(net_cfg, "meta").named_parameters()):
        raise ValueError("the program's net and the reference's have different parameters")
    weights = inputs.make_weights(names_shapes, seed, device, ref.zeroed)
    with torch.no_grad():
        for k, p in task.net.named_parameters():
            p.copy_(weights[k])
    del weights
    rows = [0, 0]  # velocity evaluations, tile rows

    def count(module, args):
        rows[0] += 1
        rows[1] += int(args[1].shape[0])

    task.net.register_forward_pre_hook(count)
    server = TranslationServer(task, num_steps=int(serve["num_steps"]), tile=int(serve["tile"]),
                               overlap=int(serve["overlap"]), batch=int(serve["wsi_batch"]))
    if patch is not None:
        patch(server)
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(server, "127.0.0.1", 0, ready), daemon=True)
    thread.start()
    if not ready.wait(60):
        raise RuntimeError("the server did not bind")
    url = f"http://127.0.0.1:{server.bound_port}/translate"

    sizes = inputs.region_sizes(traffic)
    rng = np.random.default_rng(seed)
    images = [inputs.region_image(h, w, rng) for h, w in sizes]
    bodies = [inputs.encode_png(img) for img in images]
    schedule = inputs.region_schedule(traffic, seed, int(traffic["blocks"]))
    with urllib.request.urlopen(urllib.request.Request(url, data=bodies[0], headers={
            "Content-Type": "image/png"}), timeout=600) as resp:
        resp.read()

    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=clients.closed_loop, args=(url, bodies, schedule, int(traffic["clients"]), seconds,
                                                           child_conn, record.traced))
    rows[0] = rows[1] = 0
    proc.start()
    child_conn.close()
    try:
        if not conn.poll(120) or conn.recv()[0] != "started":
            raise RuntimeError("the clients did not start")
        traced = None
        if record.traced:
            time.sleep(float(traffic["trace_after_s"]))
            sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
            sync()
            prof = trace.profiler()
            prof.start()
            t0 = time.monotonic()
            time.sleep(float(traffic["trace_seconds"]))
            end_by = time.monotonic() + TRACE_MOST_S
            while time.monotonic() < end_by:
                ended = spans.finished_roots("serve.request")
                if ended is None or ended >= TRACE_LEAST_REQUESTS:
                    break
                time.sleep(0.05)
            sync()
            traced = (prof, time.monotonic() - t0)
            prof.stop()
            conn.send(("release",))
        if not conn.poll(seconds + 900):
            raise RuntimeError("the clients did not report")
        out = conn.recv()[1]
    finally:
        conn.close()
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
        server.httpd.shutdown()
        thread.join(timeout=60)
    evaluations, tile_rows = rows
    served = server.requests_served

    tile, overlap = int(serve["tile"]), int(serve["overlap"])
    reqs = out["requests"]
    done = [r for r in reqs if r["status"] == 200 and r["end"] <= out["start"] + seconds]
    record.window_s = seconds
    record.attempted = len(reqs)
    record.failed = sum(r["status"] != 200 for r in reqs)
    # a failed request misses every latency limit: it counts as infinitely late
    lat = sorted(r["end"] - r["sent"] if r["status"] == 200 else float("inf") for r in reqs)
    mpx = sum(sizes[r["region"]][0] * sizes[r["region"]][1] for r in done) / 1e6
    record.end_to_end.update(serve_mpix_per_s=mpx / seconds, setup_s=out["start"] - t_start)
    p90 = percentile(lat, 0.9) if len(lat) >= 10 else float("inf")
    if p90 < float("inf"):
        record.end_to_end["serve_latency_p90_ms"] = p90 * 1e3
    else:
        record.note(f"{record.failed} of {len(reqs)} requests failed: no latency percentile")
    real_tiles = sum(flow.tiles_of(*sizes[r["region"]], tile, overlap) for r in reqs)
    real_done = sum(flow.tiles_of(*sizes[r["region"]], tile, overlap) for r in done)
    record.counts.update(requests=len(reqs), answered_in_window=len(done), requests_served=served,
                         real_tiles=real_tiles, real_tiles_in_window=real_done, evaluations=evaluations,
                         tile_rows=tile_rows, latencies_s=len(lat),
                         evaluations_per_tile=flow.euler_evaluations(int(serve["num_steps"])))
    record.note(f"requests {len(reqs)} answered in window {len(done)} latency median "
                f"{percentile(lat, 0.5) if lat else float('nan')} s; velocity evaluations {evaluations}, "
                f"tile rows {tile_rows}, real tiles {real_tiles}")
    if device == "cuda":
        record.memory_peak_bytes = int(torch.cuda.max_memory_reserved())
    if traced is not None:
        record.trace = trace.reduce(*traced)
    record.work.update(precision=serve["precision"], forward_flops_per_tile=work.forward_flops(ref, net_cfg, tile))

    # ---- after the window: the program's state goes, the reference translates a sample
    del server, task, thread
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    answered = [r for r in reqs if r["status"] == 200]
    sample = pick_sample(answered, sizes, int(traffic["check_sample"]), seed)
    net = ref.build(net_cfg, device=device)
    net.load_state_dict(inputs.make_weights(names_shapes, seed, device, ref.zeroed))
    gaps = [pixel_gaps(inputs.decode_png(r["body"]), flow.translate(net, images[r["region"]], serve, device))
            for r in sample]
    compare_pixels(record, gaps, cell.config["limits"])


def percentile(values: list, q: float) -> float:
    """The ``q`` quantile of sorted ``values`` by linear interpolation between order statistics."""
    pos = q * (len(values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def pick_sample(answered: list, sizes: list, k: int, seed: int) -> list:
    """The largest answered region and ``k - 1`` more drawn from ``seed``."""
    if not answered:
        return []
    largest = max(range(len(answered)), key=lambda i: sizes[answered[i]["region"]][0] * sizes[answered[i]["region"]][1])
    rest = [i for i in range(len(answered)) if i != largest]
    drawn = np.random.default_rng(seed + 1).permutation(rest)[: max(k - 1, 0)]
    return [answered[largest]] + [answered[int(i)] for i in drawn]


def pixel_gaps(served: np.ndarray, ref: np.ndarray) -> dict:
    if served.shape != ref.shape:
        return {"mean": float("inf"), "max": float("inf"), "pixels": 0}
    diff = np.abs(served.astype(np.int16) - ref.astype(np.int16))
    return {"mean": float(diff.mean()), "max": float(diff.max()), "pixels": int(diff.size)}


def compare_pixels(record: Record, gaps: list, limits: dict) -> None:
    if not gaps:
        record.checks.append(Check("pixel_mean_gap", float("inf"), limits["pixel_mean_gap"]))
        return
    pixels = sum(g["pixels"] for g in gaps)
    mean = sum(g["mean"] * g["pixels"] for g in gaps) / pixels if pixels else float("inf")
    record.note(f"pixel gaps of {len(gaps)} regions: mean {mean!r} max {max(g['max'] for g in gaps)!r}")
    record.checks += [Check("pixel_mean_gap", mean, limits["pixel_mean_gap"]),
                      Check("pixel_max_gap", max(g["max"] for g in gaps), limits["pixel_max_gap"]),
                      Check("failed_requests", float(record.failed), 0.0)]
