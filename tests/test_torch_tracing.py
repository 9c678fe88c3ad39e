"""The port's spans (``stain2stain_tpu_torch.utils.tracing``), on the CPU at
tiny sizes: the root decision, nesting and ids, the profiler's clock and
event kind, the trainer's and the server's trees, and the benchmark's
span readers on tiny traced runs of their drivers. The test marked ``chip``
checks on the card that no span reaches the device side of the trace."""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stain2stain_tpu_torch.config import compose, instantiate
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.server import TranslationServer
from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule
from stain2stain_tpu_torch.training import Callback
from stain2stain_tpu_torch.utils import tracing
from stain2stain_tpu_torch.utils.seed import seed_everything
from stain2stain_tpu_torch.utils.utils import instantiate_task
from stain2stain_tpu_torch.wsi import tile_starts

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

SERVE_READERS = ["lock_wait_ms.serve", "lock_idle_share.serve", "lock_host_share.serve", "tile_fill.serve"]
TRAIN_READERS = ["data_share.train", "data_share.train_f32"]
STEP_CHILDREN = ["train.data_wait", "train.prepare", "train.forward_backward", "train.optimizer"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ------------------------------------------------------------------ the module


def test_no_profiler_records_nothing():
    with _cpu_profile():
        pass  # a session with no root: spans() is empty after it
    with tracing.root("r") as r:
        r.set(step=1)
        with tracing.span("c"):
            pass
    with tracing.span("orphan"):
        pass
    assert tracing.spans() == []


def test_nesting_ids_attributes_and_threads():
    with _cpu_profile():
        with tracing.span("outside"):  # outside any root: nothing
            pass
        with tracing.root("r", step=3) as r:
            with tracing.span("a", tiles=2):
                with tracing.root("joined") as inner:  # a root inside an open tree joins it
                    inner.set(pixels=5)
                    with tracing.span("b"):
                        pass
            with tracing.span("c"):
                pass
        with tracing.root("dropped") as d:
            with tracing.span("x"):
                pass
            d.drop()
    got = _by_name(tracing.spans())
    assert sorted(got) == ["a", "b", "c", "r"]
    (r,), (a,), (b,), (c,) = got["r"], got["a"], got["b"], got["c"]
    assert r.parent is None and r.root == r.id
    assert a.parent == r.id and c.parent == r.id and b.parent == a.id
    assert {a.root, b.root, c.root} == {r.id}
    assert len({r.id, a.id, b.id, c.id}) == 4
    assert r.attrs == {"step": 3, "pixels": 5} and a.attrs == {"tiles": 2}
    assert {s.thread for s in (r, a, b, c)} == {threading.get_ident()}
    assert r.start_ns <= a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns <= c.end_ns <= r.end_ns


def test_root_begun_before_the_profiler_stays_untraced_whole():
    began, release = threading.Event(), threading.Event()

    def early():
        with tracing.root("early"):
            began.set()
            release.wait(10)
            with tracing.span("early.child"):
                with tracing.root("early.inner"):  # joins the untraced tree: nothing
                    pass

    thread = threading.Thread(target=early)
    thread.start()
    assert began.wait(10)
    with _cpu_profile():
        release.set()
        thread.join(10)
        with tracing.root("late"):
            pass
    assert not thread.is_alive()
    assert [s.name for s in tracing.spans()] == ["late"]


def test_only_the_latest_session():
    with _cpu_profile():
        with tracing.root("first"):
            pass
    with _cpu_profile():
        with tracing.root("second"):
            pass
    with tracing.root("after"):  # no profiler: untraced
        pass
    assert [s.name for s in tracing.spans()] == ["second"]


def _clock_offsets_ns() -> list:
    """One profiled root and child: each span's event kind and its start and end
    offsets from the profiler's event of its name."""
    with _cpu_profile() as prof:
        with tracing.root("clock.root"):
            with tracing.span("clock.child"):
                torch.ones(64).sum()
    spans = {s.name: s for s in tracing.spans()}
    start = prof.profiler.kineto_results.trace_start_ns()
    events = [e for e in prof.events() if e.name in spans]
    assert sorted(e.name for e in events) == ["clock.child", "clock.root"]
    out = []
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU and not e.is_user_annotation
        s = spans[e.name]
        out += [start + e.time_range.start * 1000 - s.start_ns, start + e.time_range.end * 1000 - s.end_ns]
    return out


def test_spans_are_cpu_events_on_the_profiler_clock():
    # another clock would be off by far more than 50 us in every session; a
    # descheduled thread between a stamp and its event can be off in one
    worst = [max(abs(d) for d in _clock_offsets_ns()) for _ in range(3)]
    assert min(worst) < 50_000, worst


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    import collections

    with _cpu_profile():
        monkeypatch.setattr(tracing, "CAPACITY", 5)
        monkeypatch.setattr(tracing, "_finished", collections.deque(maxlen=5))
        for _ in range(3):
            with tracing.root("r"):
                with tracing.span("c"):
                    pass
    assert len(tracing.spans()) == 5 and tracing.dropped() == 1


def test_threads_keep_their_trees_apart():
    """More threads than cores, a short switch interval: every tree whole and in its thread."""
    threads, roots, children = 32, 20, 3
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(roots):
                with tracing.root("t.root", step=k * roots + i):
                    for _ in range(children):
                        with tracing.span("t.child"):
                            pass

        with _cpu_profile():
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = tracing.spans()
    tops = {s.id: s for s in spans if s.parent is None}
    assert len(tops) == threads * roots
    assert sorted(s.attrs["step"] for s in tops.values()) == list(range(threads * roots))
    assert len(spans) == threads * roots * (1 + children)
    for s in spans:
        assert s.root in tops and s.thread == tops[s.root].thread
        assert s.parent is None or s.parent == s.root


# ------------------------------------------------------------------ the trainer


class _Losses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, task, metrics):
        self.losses.append(float(metrics["loss"]))


def _tiny_fit(tmp_path: Path, profiled: bool) -> list:
    cfg = compose(REPO_ROOT / "configs", "train.yaml", [
        "experiment=smoke_synthetic", "trainer=cpu", f"data.data_dir={tmp_path}/synthetic", "data.n_train=8",
        "data.n_val=4", "data.image_size=16", "data.tile_size=32", "data.num_workers=1", "model.net.dim=[3,16,16]",
        "model.net.dropout=0.1", "trainer.max_epochs=1", "trainer.log_every_n_steps=2", "logger=null",
    ])
    cfg["runtime"] = {"output_dir": str(tmp_path / "out"), "cwd": str(tmp_path)}
    seed_everything(7)
    datamodule = instantiate(cfg["data"])
    losses = _Losses()
    trainer = instantiate(cfg["trainer"], callbacks=[losses], logger=None)
    task = instantiate_task(cfg["model"], device=trainer.device)
    if profiled:
        with _cpu_profile():
            trainer.fit(task, datamodule)
    else:
        trainer.fit(task, datamodule)
    return losses.losses


def test_fit_under_a_profiler_traces_every_step_and_draws_the_same(tmp_path):
    plain = _tiny_fit(tmp_path, profiled=False)
    profiled = _tiny_fit(tmp_path, profiled=True)
    assert profiled == plain and len(plain) == 2  # one epoch of 2 batches, bit for bit
    spans = tracing.spans()
    named = _by_name(spans)
    steps = sorted(named["train.step"], key=lambda s: s.attrs["step"])
    assert [s.attrs["step"] for s in steps] == [0, 1]
    for step in steps:
        kids = [s for s in spans if s.parent == step.id]
        want = STEP_CHILDREN + (["train.log"] if step.attrs["step"] == 1 else [])
        assert [k.name for k in sorted(kids, key=lambda k: k.start_ns)] == want
        assert all(step.start_ns <= k.start_ns <= k.end_ns <= step.end_ns for k in kids)
    assert len(named["train.epoch_end"]) == 1 and len(named["train.validate"]) == 1
    assert all(s.parent is None for s in named["train.epoch_end"] + named["train.validate"])


# ------------------------------------------------------------------ the server


def test_translate_is_one_request_tree(tmp_path):
    torch.manual_seed(0)
    net = UNetModel(dim=(3, 16, 16), num_channels=8, num_res_blocks=1, channel_mult=(1, 2),
                    attention_resolutions="", num_heads=1, device="cpu")
    server = TranslationServer(ConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler")),
                               num_steps=2, tile=16, overlap=4, batch=4)
    h, w = 16 + 12, 16 + 2 * 12  # 2 × 3 tiles at stride 12
    img = np.random.default_rng(3).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    with _cpu_profile():
        out = server.translate(img)
    assert out.shape == (h, w, 3)
    spans = tracing.spans()
    (request,) = [s for s in spans if s.parent is None]
    assert request.name == "serve.request" and request.attrs == {"pixels": h * w}
    assert all(s.root == request.id for s in spans)
    named = _by_name(spans)
    top = sorted((s for s in spans if s.parent == request.id), key=lambda s: s.start_ns)
    assert [s.name for s in top] == ["serve.normalize", "serve.lock_wait", "serve.locked", "serve.denormalize"]
    (locked,) = named["serve.locked"]
    assert locked.attrs == {"served": 0}  # the requests the lock served before this one
    batches = named["wsi.batch"]
    assert all(b.parent == locked.id and b.attrs["slots"] == 4 for b in batches)
    assert sum(b.attrs["tiles"] for b in batches) == len(tile_starts(h, 16, 12)) * len(tile_starts(w, 16, 12)) == 6
    for b in batches:
        kids = sorted((s for s in spans if s.parent == b.id), key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["wsi.gather", "wsi.h2d", "wsi.generate", "wsi.d2h", "wsi.stitch"]


# ------------------------------------------------------------------ the readers


def _reader(name):
    from benchmark.core import metric_reader

    return metric_reader(REPO_ROOT, name)


@pytest.mark.parametrize("name", SERVE_READERS + TRAIN_READERS)
def test_reader_finds_nothing_in_an_empty_record(name):
    from benchmark.core import Record
    from benchmark.tests import tiny

    cell = tiny.cell("serve.cfm-unet-256" if name.endswith(".serve") else "train.cfm-unet-256")
    assert _reader(name)(Record(cell=cell, seed=1, traced=True)) is None


def _driven(workload, seconds, serve=None, **traffic):
    from benchmark import core
    from benchmark.tests import tiny

    cell = tiny.cell(workload)
    cell.traffic.update(traffic)
    cell.config.get("serve", {}).update(serve or {})
    record = core.Record(cell=cell, seed=2**31 + 11, traced=True)
    core.driver(cell.traffic["kind"]).run(record, tiny.ROOT, "cpu", seconds, time.monotonic())
    return record


def test_serve_readers_on_a_traced_tiny_run():
    # one-tile regions and two-slot batches: at least 10 requests in the traced 2.5 s on a loaded CPU
    record = _driven("serve.cfm-unet-256", 3.0, serve={"wsi_batch": 2}, max_px=32, trace_after_s=0.2,
                     trace_seconds=2.5)
    values = {name: _reader(name)(record) for name in SERVE_READERS}
    assert all(v is not None for v in values.values()), values
    assert values["lock_wait_ms.serve"] >= 0
    for name in SERVE_READERS[1:]:
        assert 0 <= values[name] <= 100, values
    assert values["tile_fill.serve"] > 0


def test_train_readers_on_a_traced_tiny_run():
    record = _driven("train.cfm-unet-256", 0.1, warm_steps=1, trace_steps=2)
    for name in TRAIN_READERS:
        assert 0 < _reader(name)(record) < 100


# ------------------------------------------------------------------ the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _device_busy_us(prof) -> float:
    from benchmark.trace import reduce

    return reduce(prof, 1.0).busy_s * 1e6


@pytest.mark.chip
def test_no_span_reaches_the_device_side_of_the_trace(card):
    """A profiled flagship train step and a serve batch: no CUDA event
    carries a span's name, and the device's busy time matches the same work
    profiled with its spans off (inside a root begun before the profiler)
    within 1 %."""
    from torch.autograd import DeviceType

    cfg = compose(REPO_ROOT / "configs", "infer.yaml", [])
    torch.manual_seed(0)
    task = instantiate_task(cfg["model"], device=card)
    net = task.net
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    x = torch.rand(8, 256, 256, 3, device=card) * 2 - 1  # NHWC, as the tasks feed the net
    t = torch.rand(8, device=card)
    server = TranslationServer(task, num_steps=2, tile=256, overlap=32, batch=16)
    img = np.random.default_rng(0).integers(0, 256, size=(700, 700, 3), dtype=np.uint8)

    def work():
        with tracing.root("train.step"):
            with tracing.span("train.forward_backward"):
                net(t, x).square().mean().backward()
            with tracing.span("train.optimizer"):
                opt.step()
                opt.zero_grad(set_to_none=True)
        server.translate(img)
        torch.cuda.synchronize()

    def run(traced: bool):
        with contextlib.nullcontext() if traced else tracing.root("spans.off"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                work()
        return prof

    work()
    busy: dict = {}
    for traced in (False, True, True, False):
        prof = run(traced)
        names = {s.name for s in tracing.spans()}
        if traced:
            assert {"train.step", "train.forward_backward", "serve.request", "wsi.batch", "wsi.h2d"} <= names
            on_device = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA} & names
            assert not on_device, on_device
        else:
            assert not names
        busy.setdefault(traced, []).append(_device_busy_us(prof))
    plain, spanned = min(busy[False]), min(busy[True])
    assert abs(spanned - plain) <= 0.01 * plain, busy
