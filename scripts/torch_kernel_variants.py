#!/usr/bin/env python3
"""The design choices of the f32 attention forward (K1-fwd f32), of the f32
attention backward (K1-bwd f32) and of the prologue gradient (K4), each timed
against the kernel as the port runs it.

Builds ``stain2stain_tpu_torch/csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu`` and ``csrc/prologue_grad.cu`` whole and with one
choice undone (edits of a copy of the source; the script stops if an edit no
longer applies), and times every build in turns, whole first, then each
variant, then the same in reverse, as queued device time
(``chip_smoke.cuda_queued_ms``). Every build but ``no_second_pass``,
``one_term_tf32`` and ``chain_sums`` computes the same function and is
checked against the plain version.

K1-fwd f32 (the serving shape (BH 256, T 1024, d 32) and d 16):

- ``rows_4``: 4 query rows a thread (64-row blocks) instead of 8;
- ``ex2_approx_ftz``: the bare ``ex2.approx.ftz`` instead of ``exp2f``;
- ``q_rows_in_order``: q's rows staged in order, not permuted;
- ``two_barriers``: a block barrier instead of ``__syncwarp`` before p·v;
- ``s_unroll_8``: the s loop unrolled fully instead of by 2;
- ``pv_unroll_4``: the p·v loop unrolled by 4 instead of 8.

K1-bwd f32 with the forward's lse (the 256-px training shape (BH 512, T 1024,
d 32) and the 512-px f32 one (96, 4096, 32)):

- ``one_term_tf32``: big·big only, 1xTF32 (fails the f32 budget: timing
  only; the small halves are still staged);
- ``split_at_use``: the staged tiles split where each warp loads a B
  fragment, not once where they land (no small tiles in shared memory), at
  d 16 and 32 as at d 64;
- ``cvt_rna``: the split by the ``cvt.rna.tf32.f32`` instruction instead of
  integer operations;
- ``chain_sums``: the three products of each mma triple summed into the
  accumulator itself, not into a fresh partial added in f32 (the tensor
  cores' sums then drift past the f32 budget at T 4096: timing only);
- ``pair_partials``: q·kᵀ-type products sum two slices of d (6 mma's) into
  each fresh partial instead of one (half the f32 adds);
- ``columns_16``: a warp's column step takes 16 rows of the staged tile
  instead of 8 (more products in flight, more registers);
- ``three_blocks``: launch bounds that ask for 3 blocks an SM (at most 168
  registers) at d 16 and 32.

K4 (flagship shapes from the first level to the 32² one):

- ``register_loads``: each step's x and dn loaded into registers, no
  ``cp.async`` staging (and no 32 KB of shared memory);
- ``serial_second_pass``: the slices' partials added by one thread per
  (image, channel), as a sequential loop;
- ``no_second_pass``: the second launch left out (wrong sums: timing only);
- ``waves_8``: slices cut for 8 waves instead of 16 (the same kernel);
- ``torch_add``: one ``torch.add`` of two bf16 tensors into a third, K4's
  bytes without its math, as the yardstick of the card's stream rate.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/torch_kernel_variants.py [k1_fwd] [k1_bwd] [k4]

(all three without arguments). Prints one JSON line per (kernel, shape,
build, turn).
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

K1 = "attention_fwd.cu"
K1_BWD = "attention_bwd.cu"
K4 = "prologue_grad.cu"
_AFTER_INCLUDES = '#include "attention_common.cuh"\n'  # the copy's own definitions go after it

_CVT_RNA = _AFTER_INCLUDES + '''
__device__ __forceinline__ uint32_t tf32_cvt(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void split_tf32_cvt(float x, uint32_t& big, uint32_t& small) {
  big = tf32_cvt(x);
  small = tf32_cvt(x - __uint_as_float(big));
}
#define split_tf32 split_tf32_cvt
'''

_ONE_TERM = _AFTER_INCLUDES + '''
__device__ __forceinline__ void mma1_tf32(float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&)[4],
                                          uint32_t b_big0, uint32_t b_big1, uint32_t, uint32_t) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  s2s_mma::mma_tf32(part, a_big, b_big0, b_big1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += part[e];
}
#define mma3_tf32 mma1_tf32
'''

_PAIR_PARTIAL = '''      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s2s_mma::mma_tf32(part, as[h], fb[2 * h], fb[2 * h + 1]);
        s2s_mma::mma_tf32(part, ab[h], fs[2 * h], fs[2 * h + 1]);
        s2s_mma::mma_tf32(part, ab[h], fb[2 * h], fb[2 * h + 1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += part[e];
'''

_CHAIN_SUMS = _AFTER_INCLUDES + '''
__device__ __forceinline__ void mma3_chain(float (&d)[4], const uint32_t (&a_big)[4], const uint32_t (&a_small)[4],
                                           uint32_t b_big0, uint32_t b_big1, uint32_t b_small0, uint32_t b_small1) {
  s2s_mma::mma_tf32(d, a_small, b_big0, b_big1);
  s2s_mma::mma_tf32(d, a_big, b_small0, b_small1);
  s2s_mma::mma_tf32(d, a_big, b_big0, b_big1);
}
#define mma3_tf32 mma3_chain
'''

_SERIAL_PASS = '''__global__ void __launch_bounds__(256)
prologue_grad_reduce(const float* __restrict__ partial, float* __restrict__ sums, int B, int C, int slices) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C;
  const int c = i - b * C;
  float ts = 0.f, tt = 0.f;
  for (int s = 0; s < slices; ++s) {
    ts += partial[(static_cast<int64_t>(b) * slices + s) * C + c];
    tt += partial[(static_cast<int64_t>(B + b) * slices + s) * C + c];
  }
  sums[i] = ts;
  sums[B * C + i] = tt;
}

'''

_REGISTER_LOADS = '''  const int p_end = min(HW, (sl + 1) * slice_px);
  with_kind(pro, [&](auto kind) {
    for (int p0 = sl * slice_px + lane; p0 < p_end; p0 += kStep) {
      uint4 xr[kUnroll], dr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kLanes;
        xr[u] = dr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (p < p_end) {
          const int64_t off = (static_cast<int64_t>(b) * HW + p) * C + c;
          xr[u] = __ldg(reinterpret_cast<const uint4*>(x + off));
          dr[u] = __ldg(reinterpret_cast<const uint4*>(dn + off));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + u * kLanes;
        const uint32_t pix = static_cast<uint32_t>(b * HW + p);
        const uint4 out = grad8(kind, xr[u], dr[u], pro, sc, sh,
                                pix * static_cast<uint32_t>(C) + static_cast<uint32_t>(c), sum_scale, sum_shift);
        if (p < p_end) *reinterpret_cast<uint4*>(dx + static_cast<int64_t>(pix) * C + c) = out;
      }
    }
  });

'''

# (source, build): edits, each (old, new) or (start marker, end marker, new) for a region
BUILDS = {
    (K1, "whole"): [],
    (K1, "rows_4"): [("constexpr int kF32RowsPerThread = D == 64 ? 4 : 8;", "constexpr int kF32RowsPerThread = 4;")],
    (K1, "ex2_approx_ftz"): [
        ("template <int D>\n__global__ void __launch_bounds__(kF32Threads, 2)",
         "__device__ __forceinline__ float ex2_ftz(float x) {\n  float y;\n"
         '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;\n}\n\n'
         "template <int D>\n__global__ void __launch_bounds__(kF32Threads, 2)"),
        ("const float alpha = exp2f(m[r] - m_new);", "const float alpha = ex2_ftz(m[r] - m_new);"),
        ("s[r][i] = exp2f(s[r][i] - m_new);", "s[r][i] = ex2_ftz(s[r][i] - m_new);"),
    ],
    (K1, "q_rows_in_order"): [("qs + q_slot<D>(r) * L::kRow", "qs + r * L::kRow"),
                              ("(qs + (r * 16 + g) * L::kRow + col)", "(qs + (R * g + r) * L::kRow + col)")],
    (K1, "two_barriers"): [("    __syncwarp();\n", "    __syncthreads();\n")],
    (K1, "s_unroll_8"): [("#pragma unroll 2\n    for (int col = 0;", "#pragma unroll\n    for (int col = 0;")],
    (K1, "pv_unroll_4"): [("#pragma unroll 8\n    for (int key = 0;", "#pragma unroll 4\n    for (int key = 0;")],
    (K1_BWD, "whole"): [],
    (K1_BWD, "one_term_tf32"): [(_AFTER_INCLUDES, _ONE_TERM)],
    (K1_BWD, "split_at_use"): [("static constexpr bool kSplitStaged = D <= 32;",
                                "static constexpr bool kSplitStaged = false;")],
    (K1_BWD, "cvt_rna"): [(_AFTER_INCLUDES, _CVT_RNA)],
    (K1_BWD, "chain_sums"): [(_AFTER_INCLUDES, _CHAIN_SUMS)],
    (K1_BWD, "pair_partials"): [
        ("      for (int h = 0; h < 2; ++h) mma3_tf32(s[n], ab[h], as[h], fb[2 * h], fb[2 * h + 1], fs[2 * h], "
         "fs[2 * h + 1]);\n", _PAIR_PARTIAL),
    ],
    (K1_BWD, "columns_16"): [("constexpr int kColTiles = 1;", "constexpr int kColTiles = 2;")],
    (K1_BWD, "three_blocks"): [
        ("__global__ void __launch_bounds__(kThreads)\nattention_bwd_dkdv_tf32_kernel",
         "__global__ void __launch_bounds__(kThreads, D == 64 ? 1 : 3)\nattention_bwd_dkdv_tf32_kernel"),
        ("__global__ void __launch_bounds__(kThreads)\nattention_bwd_dq_tf32_kernel",
         "__global__ void __launch_bounds__(kThreads, D == 64 ? 1 : 3)\nattention_bwd_dq_tf32_kernel"),
    ],
    (K4, "whole"): [],
    (K4, "register_loads"): [
        ("  __shared__ __align__(16) uint4 buf[2][kLoads][kThreads];  // 32 KB: two steps of x and dn\n", ""),
        ("  const int p_end = min(HW, (sl + 1) * slice_px);\n", "  // the warp's 4 pixel lanes", _REGISTER_LOADS),
    ],
    (K4, "serial_second_pass"): [
        ("constexpr int kRedCh = 32;", "}  // namespace", _SERIAL_PASS),
        ("  prologue_grad_reduce<<<2 * B * (C / kRedCh), 32 * kRedWarps, 0, s>>>(",
         "  prologue_grad_reduce<<<(B * C + 255) / 256, 256, 0, s>>>("),
    ],
    (K4, "no_second_pass"): [("  prologue_grad_reduce<<<2 * B * (C / kRedCh)", "  return static_cast<int>(cudaGetLastError());",
                              "")],
}


def _edit(src: str, edit, what: str) -> str:
    if len(edit) == 2:
        old, new = edit
        if src.count(old) != 1:
            raise SystemExit(f"{what}: the edit no longer applies at {old!r}")
        return src.replace(old, new)
    start, end, new = edit
    if src.count(start) != 1 or src.count(end) != 1 or src.index(start) > src.index(end):
        raise SystemExit(f"{what}: the region {start!r} .. {end!r} is no longer in the source")
    return src[:src.index(start)] + new + src[src.index(end):]


def build(work: Path, sources) -> dict:
    """One library per build of ``sources``, all nvcc's at once; the edits must all apply."""
    from stain2stain_tpu_torch import _build

    procs = {}
    for (source, name), edits in BUILDS.items():
        if source not in sources:
            continue
        src = (_build.CSRC / source).read_text()
        for edit in edits:
            src = _edit(src, edit, f"{source} build {name!r}")
        path = work / f"{Path(source).stem}-{name}"
        path.with_suffix(".cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(path.with_suffix(".so")),
               str(path.with_suffix(".cu"))]
        procs[(source, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                                 path)
    libs = {}
    for key, (proc, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {key}:\n{out}")
        libs[key] = (ctypes.CDLL(str(path.with_suffix(".so"))), ptxas_report(out))
    return libs


def ptxas_report(out: str) -> dict:
    """{kernel: "registers/spill-store bytes"} from ptxas' report, each kernel
    named by its function and its mangled template arguments."""
    import re

    report, name = {}, None
    for line in out.splitlines():
        found = re.search(r"entry function '(\S+)'", line)
        if found:
            mangled = found.group(1)
            # Itanium mangling: <length><name>, the length's digits maybe glued to a hash's
            for m in re.finditer(r"\d+", mangled):
                idents = [mangled[m.end():m.end() + int(m.group()[i:])] for i in range(len(m.group()))]
                ident = next((x for x in idents if x.endswith("_kernel") and x[0].isalpha()), None)
                if ident:
                    args = re.match(r"I\w*?E", mangled[m.end() + len(ident):])
                    name = ident + (args.group() if args else "")
                    break
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            report[name] = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            report[name] = f"{regs.group(1)}/{report.get(name, '?')}"
    return report


def in_turns(names):
    return list(names) + list(names)[::-1]


def time_k1(libs: dict, card: str) -> None:
    import torch

    import chip_smoke
    from stain2stain_tpu_torch.ops.attention import fused_attention_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    builds = [name for source, name in BUILDS if source == K1]
    for bh, t, d in ((256, 1024, 32), (256, 1024, 16)):
        q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        ref = fused_attention_reference(q, k, v, scale)
        out = torch.empty_like(q)
        for turn, name in enumerate(in_turns(builds)):
            lib, registers = libs[(K1, name)]
            fn = lib.s2s_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]

            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, bh, t, d, 0, scale,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"K1 build {name}: launch failed with CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            row = dict(card=card, kernel="K1-fwd f32", shape=[bh, t, d], build=name, turn=turn,
                       registers=registers, max_abs_err=err, ok=err <= chip_smoke.TOL["float32"],
                       queued_ms=chip_smoke.cuda_queued_ms(call))
            print("variants " + json.dumps(row), flush=True)


def time_k1_bwd(libs: dict, card: str) -> None:
    import torch

    import chip_smoke
    from stain2stain_tpu_torch.ops.attention import fused_attention, fused_attention_backward_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    builds = [name for source, name in BUILDS if source == K1_BWD]
    for bh, t, d in ((512, 1024, 32), (96, 4096, 32)):
        q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        o, lse = fused_attention(q, k, v, scale, return_lse=True)  # as training hands them over
        ref = fused_attention_backward_reference(q, k, v, o, do, scale)
        tol = chip_smoke.BWD_REL_TOL["float32"] * max(float(r.abs().max()) for r in ref)
        bound = chip_smoke.attention_bwd_bound(bh, t, d, "float32", 1.0)
        grads = [torch.empty_like(q) for _ in range(3)]
        stats = torch.empty(bh, math.ceil(t / 64) * 64, 2, device="cuda")

        def caller(name):
            fn = libs[(K1_BWD, name)][0].s2s_attention_bwd
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]

            def call():
                rc = fn(*(x.data_ptr() for x in (q, k, v, o, do, lse, *grads, stats)), bh, t, d, 0, scale,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"K1-bwd build {name}: launch failed with CUDA error {rc}")

            return call

        for turn, name in enumerate(in_turns(builds)):
            registers = {k: v for k, v in libs[(K1_BWD, name)][1].items() if "tf32" in k}
            call = caller(name)
            call()
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(grads, ref))
            row = dict(card=card, kernel="K1-bwd f32", shape=[bh, t, d], build=name, turn=turn,
                       registers=registers, max_abs_err=err, tol=tol,
                       ok=err <= tol or name in ("one_term_tf32", "chain_sums"),
                       bound_ms=bound["bound_ms"], tf32x3_bound_ms=bound["tf32x3_bound_ms"],
                       queued_ms=chip_smoke.cuda_queued_ms(call, calls=10))
            print("variants " + json.dumps(row), flush=True)
        # where the whole kernel's time goes: device ms of each of its launches
        print("variants-passes " + json.dumps(dict(card=card, shape=[bh, t, d], **kernel_ms(caller("whole")))),
              flush=True)
        del q, k, v, do, o, lse, ref, grads, stats
        torch.cuda.empty_cache()


def kernel_ms(call, calls: int = 5) -> dict:
    """Device ms a call of each kernel ``call`` launches, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return {e.key[:70]: chip_smoke._device_us(e) / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and chip_smoke._device_us(e) > 0}


def time_k4(libs: dict, card: str) -> None:
    import torch

    import chip_smoke
    from stain2stain_tpu_torch.ops import conv

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    builds = [name for source, name in BUILDS if source == K4] + ["waves_8", "torch_add"]
    shapes = ((32, 256, 256, 128), (32, 256, 256, 256), (32, 128, 128, 256), (32, 64, 64, 256), (32, 32, 32, 512),
              (32, 32, 32, 1024))
    for b, h, w, c in shapes:
        gen = torch.Generator(device="cuda").manual_seed(5)
        x, dn = (torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16() for _ in range(2))
        kw = dict(scale=1 + 0.2 * torch.randn(b, c, device="cuda", generator=gen),
                  shift=0.2 * torch.randn(b, c, device="cuda", generator=gen), act="silu", dropout_rate=0.1,
                  seed=1234567)
        ref = conv.prologue_grad_reference(x, dn, **kw)
        pro, _keep = conv._prologue_args(x, kw["scale"], kw["shift"], "silu", 0.1, kw["seed"], "variants")
        dx, sums = torch.empty_like(x), torch.empty(2, b, c, device="cuda")
        bound = chip_smoke.conv_bound("K4", b, h, w, c, c, 1.0)["bytes_ms"]
        for turn, name in enumerate(in_turns(builds)):
            registers = None
            if name == "torch_add":
                def call():
                    torch.add(x, dn, out=dx)
            else:
                waves = conv._K4_WAVES
                try:
                    conv._K4_WAVES = 8 if name == "waves_8" else waves
                    slice_px, slices = conv.prologue_grad_geometry(b, h * w, c, sms)
                finally:
                    conv._K4_WAVES = waves
                lib, registers = libs[(K4, "whole" if name == "waves_8" else name)]
                fn = lib.s2s_prologue_grad
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + conv._PROLOGUE_ARGTYPES + [ctypes.c_void_p]
                partial = torch.empty(2, b, slices, c, device="cuda")

                def call():
                    rc = fn(x.data_ptr(), dn.data_ptr(), dx.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                            b, h * w, c, slice_px, *pro, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"K4 build {name}: launch failed with CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            row = dict(card=card, kernel="K4", shape=[b, h, w, c], build=name, turn=turn, registers=registers,
                       bound_ms=bound, queued_ms=chip_smoke.cuda_queued_ms(call))
            if name not in ("torch_add", "no_second_pass"):
                errs = [float((g.float() - r.float()).abs().max() / r.float().abs().max())
                        for g, r in zip((dx, sums[0], sums[1]), ref)]
                row["rel_err"] = errs
                row["ok"] = errs[0] <= chip_smoke.CONV_REL_TOL["bf16"] and max(errs[1:]) <= chip_smoke.CONV_REL_TOL["f32"]
            print("variants " + json.dumps(row), flush=True)
        del x, dn, dx, sums
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain f32 attention in full f32
    timers = {"k1_fwd": (K1, time_k1), "k1_bwd": (K1_BWD, time_k1_bwd), "k4": (K4, time_k4)}
    chosen = sys.argv[1:] or list(timers)
    if any(name not in timers for name in chosen):
        print(f"torch_kernel_variants: choose from {list(timers)}", file=sys.stderr)
        return 2
    card = chip_smoke.nvidia_smi("name,power.limit")
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as work:
        libs = build(Path(work), {timers[name][0] for name in chosen})
        for name in chosen:
            timers[name][1](libs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
