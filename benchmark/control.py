"""Readings from which the limits of ``correct`` are set: for each seed,
one run of the cell (short window, at the cell's own load) gives the port's
numbers, and the control, the reference one precision below the
configuration's (float8 products), put in the port's place gives its own;
a training cell also gives a planted fault (half the frames left out).
The benchmark's own runs never run this. On a CUDA device:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 8

prints one JSON line per seed and a summary line (the port's largest and
the control's smallest reading of each number)."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--float32", action="store_true",
                    help="the look of PERF.md: the cell with the port and the reference in "
                         "float32, TF32 off")
    args = ap.parse_args(argv)
    bench_run.environment()

    import torch

    from harness import check, core

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = core.load_cell(args.workload)
    if args.float32:
        cell.config["compute_dtype"] = "float32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = core.runner(cell)(cell, seed, args.seconds, False, "cuda", t0, control=True)
        row = {"seed": seed, "program": res["numbers"],
               **{k: res[k] for k in ("control", "half_frames") if k in res},
               "correct": check.judge(res["numbers"], cell.limits)[0],
               "e2e": res["e2e"], "notes": res.get("notes", {}),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del res
        check.release("cuda")
    summary = {"workload": args.workload, "seeds": len(rows)}
    for kind, pick in (("program", max), ("control", min), ("half_frames", min)):
        if kind in rows[0]:
            summary[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
