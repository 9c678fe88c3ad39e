"""matmul_roofline.train_dit: DiT-XL/2's dense layers against their roofline,
in %: the least time of their work in the traced steps (3 × (one forward's
FLOPs − its attention FLOPs) a tile, counted from the configuration's shapes,
times the traced tiles, at the bfloat16 peak: the forward, the input gradient
and the weight gradient of every dense layer and of the patch embedding) over
the device time of the matrix-multiply kernels.

The kernels are read by name from the trace (``record.trace.by_kernel``), not
by its categories: cuBLAS's H100 GEMMs are named ``nvjet_*`` on CUDA 12.8
(which no category pattern matches) or ``sm90_xmma_gemm_*`` /
``*cutlass*gemm*`` on other versions, and a split-K GEMM adds a
``splitKreduce`` pass. A kernel whose name holds one of ``MATMUL_NAMES`` and
none of ``HAND_WRITTEN`` counts."""

from benchmark.work import PEAK_FLOPS, attention_work

MATMUL_NAMES = ("nvjet", "gemm", "xmma", "cutlass", "splitKreduce")
HAND_WRITTEN = ("attention_fwd", "attention_bwd", "conv3x3", "prologue_grad", "wgrad_reduce", "hash_dropout")


def matmul_device_s(trace) -> float:
    return sum(s for name, s in trace.by_kernel.items()
               if any(k in name for k in MATMUL_NAMES) and not any(k in name for k in HAND_WRITTEN))


def read(record):
    t, c, w = record.trace, record.counts, record.work
    if t is None or not c.get("traced_steps") or not w.get("forward_flops_per_tile"):
        return None
    device_s = matmul_device_s(t)
    if device_s <= 0:
        record.note("matmul_roofline.train_dit left out: no matrix-multiply kernel in the trace")
        return None
    attention = sum(attention_work(heads, tokens, d, w["precision"], False)[0] for heads, tokens, d in w["attention"])
    tiles = c["traced_steps"] * c["batch"]
    least = 3 * (w["forward_flops_per_tile"] - attention) * tiles / PEAK_FLOPS[w["precision"]]
    return 100.0 * least / device_s
