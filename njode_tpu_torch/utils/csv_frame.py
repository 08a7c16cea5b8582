"""Tables on disk in the layout of ``pandas.DataFrame.to_csv``.

The JAX package writes its registries and metric files with pandas; the
port writes and reads the same files with the ``csv`` module, so either
package can read what the other wrote: an unnamed index column first,
minimal quoting, ``\\n`` line ends, NaN as an empty field."""

from __future__ import annotations

import csv
import math
import os


def _cell(v):
    if isinstance(v, float) and math.isnan(v):
        return ""
    return v


def write_frame(path, columns, rows):
    """Write ``rows`` (lists in ``columns`` order) with a 0-based index."""
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(columns))
        for i, row in enumerate(rows):
            w.writerow([i] + [_cell(v) for v in row])
    os.replace(tmp, path)


def read_frame(path):
    """Return ``(columns, rows)``; cells stay strings, the index is dropped."""
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r)
        rows = [row[1:] for row in r if row]
    return header[1:], rows


def to_float(s: str) -> float:
    return float("nan") if s == "" else float(s)
