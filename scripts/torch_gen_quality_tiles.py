#!/usr/bin/env python
"""Write the on-disk 256-px PNG tile tree of ``experiment=quality_real_256``
with the PyTorch port (counterpart of ``scripts/gen_quality_tiles.py``).

The tree is the one ``experiment=quality_synthetic_256`` generates: the
port's ``data.synthetic.generate_paired_dataset`` with ``deterministic=True``
(noise-free pairs, the target an exact function of the source), the same
counts and seed, byte for byte the files of the JAX package's generator.
``experiment=quality_real_256`` then reads it through the plain
``PairedDataModule``: CSV metadata, decode, device cache, train.

Usage:
    python scripts/torch_gen_quality_tiles.py [out_dir] [--n-train N] [--n-val N]
                                              [--n-test N] [--size PX] [--seed S]

Defaults: 512/32/32 pairs, 256 px, seed 0, written under the gitignored
``scratch/quality_real_256_tiles``. A tree that already has its
``metadata.csv`` is left as it is.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

DEFAULT_OUT = REPO_ROOT / "scratch" / "quality_real_256_tiles"


def write_tree(out_dir: str | Path, n_train: int = 512, n_val: int = 32, n_test: int = 32, size: int = 256,
               seed: int = 0) -> Path:
    """The tree under ``out_dir`` (written unless its ``metadata.csv`` exists); returns its root."""
    from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset

    root = Path(out_dir)
    if (root / "metadata.csv").exists():
        print(f"# {root} already has metadata.csv — leaving as-is")
        return root
    generate_paired_dataset(root, n_train=n_train, n_val=n_val, n_test=n_test, size=size, seed=seed,
                            deterministic=True)
    pngs = list(root.rglob("*.png"))
    mb = sum(p.stat().st_size for p in pngs) / 1e6
    print(f"# wrote {len(pngs)} PNGs ({mb:.0f} MB) + metadata.csv under {root}")
    return root


def main(argv: list[str] | None = None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", nargs="?", default=str(DEFAULT_OUT))
    parser.add_argument("--n-train", type=int, default=512)
    parser.add_argument("--n-val", type=int, default=32)
    parser.add_argument("--n-test", type=int, default=32)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    return write_tree(args.out_dir, args.n_train, args.n_val, args.n_test, args.size, args.seed)


if __name__ == "__main__":
    main()
