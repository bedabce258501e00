"""Print the ``results.json`` of every run under a directory as one table.

Counterpart of ``scripts/read_all_metrics.py`` (the reference's).

    python -m fourdgs_tpu_torch.scripts.read_all_metrics output/
"""

from __future__ import annotations

import glob
import json
import sys


def main(root: str = "output") -> None:
    rows = []
    for path in sorted(glob.glob(f"{root}/**/results.json", recursive=True)):
        with open(path) as f:
            data = json.load(f)
        for method, vals in data.items():
            rows.append((path.replace("/results.json", ""), method, vals))
    if not rows:
        print("no results.json found")
        return
    keys = [k for k in rows[0][2] if rows[0][2][k] is not None]
    print(f"{'run':40s} {'method':12s} " + " ".join(f"{k:>9s}" for k in keys))
    for run, method, vals in rows:
        print(f"{run:40s} {method:12s} " + " ".join(f"{vals[k]:9.4f}" for k in keys))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "output")
