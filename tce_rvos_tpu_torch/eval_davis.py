"""Offline Ref-DAVIS17 scoring (the port's copy of ``tce_rvos_tpu/eval_davis.py``;
parity with reference eval_davis.py): J&F for each annotator directory that
the davis inference protocol writes, the global and per-sequence CSVs, the
summary tables, and the mean over the 4 annotators as
scripts/dist_test_davis.sh:25-33 takes it.

    python -m tce_rvos_tpu_torch.eval_davis --davis_path <DAVIS 2017 root> \\
        --results_path <output_dir>/valid  [--set val] [--task unsupervised]

The CSVs are those of the JAX command line, byte for byte (the columns, the
``%.5f`` format, an empty field for NaN), written with the ``csv`` module:
the port does not use pandas. A results directory that already holds both
CSVs is read back instead of scored again. Numpy, scipy and PIL only; the
scoring runs on the host.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

GLOBAL_COLUMNS = ("J&F-Mean", "J-Mean", "J-Recall", "J-Decay", "F-Mean", "F-Recall", "F-Decay")

Table = Dict[str, list]  # column -> values, in column order


def _field(v) -> str:
    """One CSV field as pandas' ``to_csv(float_format="%.5f")`` writes it."""
    if isinstance(v, str):
        return v
    v = float(v)
    return "" if math.isnan(v) else "%.5f" % v


def write_csv(path: str, table: Table) -> None:
    rows = zip(*table.values())
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(table.keys())
        w.writerows([_field(v) for v in row] for row in rows)


def read_csv(path: str) -> Table:
    """A CSV that ``write_csv`` wrote: the ``Sequence`` column as strings,
    the others as floats (an empty field as NaN)."""
    with open(path, newline="") as fh:
        header, *rows = list(csv.reader(fh))
    cols = {k: [r[i] for r in rows] for i, k in enumerate(header)}
    return {k: v if k == "Sequence" else [float(x) if x else math.nan for x in v]
            for k, v in cols.items()}


def format_table(table: Table) -> str:
    """The table as text, columns right-aligned, floats at 6 decimals."""
    cells = {k: [k] + [v if isinstance(v, str) else "%.6f" % v for v in vals]
             for k, vals in table.items()}
    widths = {k: max(len(c) for c in col) for k, col in cells.items()}
    n = len(next(iter(cells.values())))
    return "\n".join(" ".join(cells[k][i].rjust(widths[k]) for k in cells) for i in range(n))


def evaluate_results_dir(davis_path: str, results_path: str, subset: str = "val",
                         task: str = "unsupervised") -> Tuple[Table, Table]:
    from tce_rvos_tpu_torch.eval.davis_eval import evaluate_davis

    csv_g = os.path.join(results_path, f"global_results-{subset}.csv")
    csv_seq = os.path.join(results_path, f"per-sequence_results-{subset}.csv")
    if os.path.exists(csv_g) and os.path.exists(csv_seq):
        print("Using precomputed results...")
        return read_csv(csv_g), read_csv(csv_seq)

    res = evaluate_davis(davis_path, results_path, subset, task)
    s = res["summary"]
    table_g = {c: [s[c]] for c in GLOBAL_COLUMNS}
    write_csv(csv_g, table_g)

    seq_names = list(res["J"]["M_per_object"].keys())
    table_seq = {
        "Sequence": seq_names,
        "J-Mean": [res["J"]["M_per_object"][k] for k in seq_names],
        "F-Mean": [res["F"]["M_per_object"][k] for k in seq_names],
    }
    write_csv(csv_seq, table_seq)
    return table_g, table_seq


def main(argv=None) -> List[float]:
    """The command line; returns each annotator's J&F mean."""
    t0 = time.time()
    p = argparse.ArgumentParser()
    p.add_argument("--davis_path", required=True)
    p.add_argument("--set", dest="subset", default="val")
    p.add_argument("--task", default="unsupervised",
                   choices=["semi-supervised", "unsupervised"])
    p.add_argument("--results_path", required=True,
                   help="either one annotator dir or a parent containing anno_0..anno_3")
    args, _ = p.parse_known_args(argv)

    anno_dirs = [
        os.path.join(args.results_path, d)
        for d in sorted(os.listdir(args.results_path))
        if d.startswith("anno_")
    ] or [args.results_path]

    jf_means = []
    for d in anno_dirs:
        table_g, _ = evaluate_results_dir(args.davis_path, d, args.subset, args.task)
        print(f"--------- Global results for {d} ---------")
        print(format_table(table_g))
        jf_means.append(float(table_g["J&F-Mean"][0]))
    if len(jf_means) > 1:
        print(f"\nMean J&F over {len(jf_means)} annotators: {np.mean(jf_means):.5f}")
    sys.stdout.write(f"\nTotal time: {time.time() - t0}\n")
    return jf_means


if __name__ == "__main__":
    main()
