"""The reduction of a ``torch.profiler`` trace of a sub-window to what the
per-layer readers need: the union of the device's kernel intervals (busy
time, each moment counted once however many kernels overlap it), the device
time of each kernel category, the kernels that took most time and the
longest idle gaps with the host operation that ran across each."""

from __future__ import annotations

from dataclasses import dataclass, field

# torch's own norm kernels
_NORM_KERNELS = ("GroupNorm", "RowwiseMoments", "ComputeFusedParams", "ComputeInternalGradients",
                 "ComputeBackwardFusedParams", "GammaBetaBackward", "batch_norm", "BatchNorm", "bn_fw", "bn_bw")


def category(name: str) -> str:
    """A device kernel's layer, from its name."""
    if any(s in name for s in ("conv3x3_fwd_kernel", "prologue_grad", "conv3x3_wgrad_kernel", "wgrad_reduce")):
        return "fused conv K2-K5"
    if "attention_fwd" in name:
        return "attention forward K1-fwd"
    if "attention_bwd" in name:
        return "attention backward K1-bwd"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "cuDNN layout transposes"
    if any(s in name for s in _NORM_KERNELS):
        return "GroupNorm / BatchNorm kernels"
    if any(s in name for s in ("xmma", "gemm", "conv", "wgrad", "dgrad", "cutlass", "cudnn")):
        return "convolutions and matmuls"
    if "<int" in name:
        return "int32 elementwise (dropout hash)"
    if "reduce_kernel" in name:
        return "reductions (norm statistics, sums)"
    if "copy" in name or "Cat" in name or "Memcpy" in name or "Memset" in name:
        return "copies and casts"
    return "other elementwise"


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


@dataclass
class Trace:
    """A traced sub-window, times in seconds."""

    window_s: float
    busy_s: float
    by_category: dict = field(default_factory=dict)
    by_kernel: dict = field(default_factory=dict)
    gaps: list = field(default_factory=list)

    def breakdown(self) -> dict:
        """The ten kernels that took most device time and the ten longest idle
        gaps, names cut to 160 characters."""
        ops = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in ops], "idle_gaps": [[k[:160], v] for k, v in self.gaps[:10]]}


def _device_events(prof):
    from torch.autograd import DeviceType

    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            yield e


def reduce(prof, window_s: float) -> Trace:
    """The :class:`Trace` of a finished profiler whose window lasted ``window_s`` by the host's clock."""
    from torch.autograd import DeviceType

    kernels = list(_device_events(prof))
    intervals = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in kernels]
    busy = union(intervals)
    by_cat: dict = {}
    by_kernel: dict = {}
    for e, (a, b) in zip(kernels, intervals):
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + (b - a)
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (b - a)
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])), key=lambda g: g[0] - g[1])[:10]
    host = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name) for e in prof.events()
            if e.device_type == DeviceType.CPU]
    named = []
    for a, b in gaps:
        covering = [(end - start, name) for start, end, name in host if start <= a and end >= b]
        if covering:
            label = min(covering)[1]
        else:
            overlap = [(min(end, b) - max(start, a), name) for start, end, name in host if start < b and end > a]
            label = max(overlap)[1] if overlap else "host work outside any recorded operation"
        named.append([label, b - a])
    return Trace(window_s=window_s, busy_s=sum(b - a for a, b in busy), by_category=by_cat, by_kernel=by_kernel,
                 gaps=named)


def profiler():
    """A profiler of the host and the card, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
