"""Dataset sanity-check CLI (counterpart of ``src/data_sanity.py``).

    python -m stain2stain_tpu_torch.data_sanity data.data_dir=<tiles> \
        [data=paired_data_mask_he_amyloid] [data.csv_file_name=metadata.csv]

Reads the tree's metadata CSV and prints a JSON report with the JAX
package's keys: per-split row counts, the ``*_filepath`` columns, missing
files per column, a histogram of tile shapes (the first 64 files, read by
:func:`.data.native.probe`) and the errors and warnings. Exits 1 when the
report holds an error (no CSV, no ``split`` column, a missing file), 0
otherwise. It touches no device.
"""

from __future__ import annotations

import csv
import json
import os
from collections import Counter
from pathlib import Path

from .config import Config, config_main
from .data import native

REPO_ROOT = Path(__file__).resolve().parent.parent


def check_csv_dataset(data_cfg: Config, max_probe: int = 64) -> dict:
    """The report of the CSV tree ``data_cfg.data_dir`` (JAX ``check_csv_dataset``)."""
    data_dir = Path(str(data_cfg["data_dir"]))
    csv_path = data_dir / str(data_cfg.get("csv_file_name", "metadata.csv"))
    report: dict = {"csv": str(csv_path), "errors": [], "warnings": []}
    if not csv_path.exists():
        report["errors"].append(f"metadata CSV not found: {csv_path}")
        return report
    with open(csv_path, newline="") as fh:
        reader = csv.DictReader(fh)
        columns = list(reader.fieldnames or [])
        rows = list(reader)
    report["columns"] = columns
    report["rows"] = len(rows)
    if "split" not in columns:
        report["errors"].append("missing required 'split' column")
        return report
    report["split_counts"] = dict(Counter(row["split"] for row in rows).most_common())

    file_columns = [c for c in columns if c.endswith("_filepath")]
    report["file_columns"] = file_columns
    missing: Counter = Counter()
    shapes: Counter = Counter()
    probed = 0
    for row in rows:
        split_dir = data_dir / str(row["split"])
        for col in file_columns:
            if row.get(col) in (None, ""):  # an empty cell: pandas' NaN
                continue
            path = split_dir / str(row[col])
            if not path.exists():
                missing[col] += 1
            elif probed < max_probe:
                dims = native.probe(path)
                if dims is None:
                    report["warnings"].append(f"undecodable: {path}")
                    continue
                shapes[dims] += 1
                probed += 1
    report["missing_files"] = dict(missing)
    report["shape_histogram"] = {f"{h}x{w}": n for (h, w), n in shapes.items()}
    if missing:
        report["errors"].append(f"{sum(missing.values())} referenced files missing")
    if len(shapes) > 1:
        report["warnings"].append("inconsistent tile shapes across dataset")
    return report


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> dict:
    report = check_csv_dataset(cfg["data"])
    print(json.dumps(report, indent=2, default=str))
    if report.get("errors"):
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()
