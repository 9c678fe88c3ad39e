#!/usr/bin/env python3
"""Where the fused conv's weight-gradient kernel (K5) spends its time, on the card.

Builds ``stain2stain_tpu_torch/csrc/conv3x3_wgrad.cu`` whole and with parts
taken out, and times each build at flagship shapes with CUDA events, with
the full prologue (affine, SiLU, dropout) and with the identity one:

- ``whole``: the kernel as the port runs it (also checked against its plain
  version);
- ``no_products``: the wgmma calls removed;
- ``no_copies``: the TMA loads after the first tiles, and the waits for
  them, removed (the tiles are stale);
- ``prologue_only``: both removed.

Only ``whole`` computes the right result. A part's cost is what its removal
saves; when the parts add up to the whole, they do not overlap. Run from the
repository root on a machine with the card and ``nvcc``:

    python3 scripts/torch_wgrad_parts.py [B H W C D ...]

(default: the flagship's first level, 32 256 256 128 128, and its lowest,
32 32 32 1024 512). Prints one JSON line per (shape, build, prologue).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = "conv3x3_wgrad.cu"
PRODUCTS = [(
    "wgmma_m64n64k16<1, 1>(acc[dx], da, desc_sw128(gs + ((r + 2 - dy) * kGW + 2 - dx) * 128));",
    "(void)da;",
)]
COPIES = [
    ("    mbar_wait(gbar + j % 2, (j / 2) & 1);", "    if (j < 2) mbar_wait(gbar + j % 2, (j / 2) & 1);"),
    ("    load_x(j + 2);", ""),
    ("    if (next) mbar_wait(xbar + (j + 1) % 3,", "    if (next && j < 1) mbar_wait(xbar + (j + 1) % 3,"),
    ("    load_g(j + 2);\n  }", "  }"),
]
BUILDS = {"whole": [], "no_products": PRODUCTS, "no_copies": COPIES, "prologue_only": PRODUCTS + COPIES}


def build(work: Path) -> dict:
    """One library per build, all nvcc's at once; the edits must all apply."""
    from stain2stain_tpu_torch import _build

    text = (_build.CSRC / SOURCE).read_text()
    procs = {}
    for name, edits in BUILDS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{SOURCE} changed: the edit of build {name!r} no longer applies at {old!r}")
            src = src.replace(old, new)
        (work / f"{name}.cu").write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(work / f"{name}.so"),
               str(work / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on build {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(work / f"{name}.so"))
    return libs


def main(argv: list[str]) -> int:
    import torch

    import chip_smoke
    from stain2stain_tpu_torch.ops import conv

    if not torch.cuda.is_available():
        print("torch_wgrad_parts: no CUDA device is available", file=sys.stderr)
        return 2
    nums = [int(a) for a in argv]
    if len(nums) % 5:
        raise SystemExit("shapes are groups of five numbers: B H W C D")
    shapes = [nums[i:i + 5] for i in range(0, len(nums), 5)] or [[32, 256, 256, 128, 128], [32, 32, 32, 1024, 512]]
    card = chip_smoke.nvidia_smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory(prefix="wgrad_parts_") as work:
        libs = build(Path(work))
        for b, h, w, c, d in shapes:
            gen = torch.Generator(device="cuda").manual_seed(5)
            x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
            dy = torch.randn(b, h, w, d, device="cuda", generator=gen).bfloat16()
            full = dict(scale=1 + 0.2 * torch.randn(b, c, device="cuda", generator=gen),
                        shift=0.2 * torch.randn(b, c, device="cuda", generator=gen), act="silu",
                        dropout_rate=0.1, seed=1234567)
            splits, scratch = conv.wgrad_geometry(b, h, w, c, d, sms)
            partial = torch.empty(scratch, device="cuda")
            dw = torch.empty(3, 3, c, d, device="cuda")
            dbias = torch.empty(d, device="cuda")
            for prologue, kw in (("full", full), ("identity", {})):
                pro, _keep = conv._prologue_args(x, kw.get("scale"), kw.get("shift"), kw.get("act"),
                                                 kw.get("dropout_rate", 0.0), kw.get("seed"), "wgrad_parts")
                for name, lib in libs.items():
                    fn = lib.s2s_conv3x3_wgrad
                    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + conv._PROLOGUE_ARGTYPES + [ctypes.c_void_p]

                    def call():
                        rc = fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(), dbias.data_ptr(),
                                b, h, w, c, d, splits, *pro, torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"build {name}: launch failed with CUDA error {rc}")

                    call()
                    torch.cuda.synchronize()
                    row = dict(card=card, shape=[b, h, w, c, d], build=name, prologue=prologue, splits=splits,
                               ms=chip_smoke.cuda_ms(call, repeats=10))
                    if name == "whole":
                        ref_dw, ref_db = conv.conv3x3_weight_grad_reference(x, dy, **kw)
                        row["rel_err"] = max(float((got - ref).abs().max() / ref.abs().max())
                                             for got, ref in ((dw, ref_dw), (dbias, ref_db)))
                    print("wgrad-parts " + json.dumps(row), flush=True)
            del x, dy, partial, dw, dbias
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
