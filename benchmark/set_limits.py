"""Sets a cell's limits of ``correct`` from ``benchmark/control.py``'s
readings (the lines of one or more of its runs) and writes
``benchmark/limits/<cell>.json`` with them:

    python3 benchmark/set_limits.py <control.py output> <cell> [<run.py output> ...]

For each number the lower reading is the port's largest over the seeds of
the control's runs and of any ``run.py`` result lines given (sound runs
all); a lower reading of 0 counts as float32's eps. The upper is the
smallest of the control's, where that is three times the lower or more,
and in training of a planted fault's: half the frames, ten times the lower
or more; an unchanged state, which reads 1 on the change and gradient
numbers, three times; a matcher that picks the costliest query, which
reads 1 on the matcher's own regret, ten times; a loss altered where it is
made, to 1.5 times itself, which reads 0.5 on the first step's loss, ten
times; an upper that is not a number (half the frames gives outputs of
another shape) sets none. A number with an upper reading is compared, at
lower^0.4 * upper^0.6: between the two, with more room above the lower
than below the upper. The rest are readings only. The file also says
whether the control fails on every seed that reads every compared number."""

import json
import math
import sys

import numpy as np

UNCHANGED = {"change_gap", "change_gap_median", "grad_gap", "grad_gap_median"}
WRONG_PICK = {"matcher_regret"}
ALTERED_LOSS = {"loss1_gap": 0.5}  # the step's loss made 1.5 times what it is
EPS = float(np.finfo(np.float32).eps)


def limits_of(rows, extra=()):
    limits, readings = {}, {}
    sound = [r["program"] for r in rows] + list(extra)
    keys = dict.fromkeys(k for r in sound for k in r)
    for k in keys:
        port = [r[k] for r in sound if k in r]
        lower = max(port)
        lo, found = max(lower, EPS), {}
        ctrl = [r["control"][k] for r in rows if k in r["control"]]
        if ctrl and 3 * lo <= min(ctrl) < math.inf:
            found["control"] = min(ctrl)
        half = [r["half_frames"][k] for r in rows if k in r.get("half_frames", {})]
        if half and 10 * lo <= min(half) < math.inf:  # a shape apart sets no upper end
            found["half_frames"] = min(half)
        if k in UNCHANGED and 1.0 >= 3 * lo:
            found["state_unchanged"] = 1.0
        if k in WRONG_PICK and 1.0 >= 10 * lo:
            found["costliest_pick"] = 1.0
        if k in ALTERED_LOSS and ALTERED_LOSS[k] >= 10 * lo:
            found["loss_altered"] = ALTERED_LOSS[k]
        readings[k] = {"lower": lower, "control_smallest": min(ctrl) if ctrl else None,
                       "runs": len(port), "port_median": sorted(port)[len(port) // 2]}
        if half:
            readings[k]["half_frames_smallest"] = min(half)
        if found:
            src = min(found, key=found.get)
            limits[k] = float("%.3g" % (lo ** 0.4 * found[src] ** 0.6))
            readings[k].update(upper=found[src], upper_from=src, limit=limits[k])
        else:
            readings[k]["limit"] = None
    return limits, readings


def result_readings(path):
    """The readings of each ``run.py`` result line in ``path``."""
    out = []
    for line in open(path):
        if line.startswith("{"):
            out.append(json.loads(line)["notes"]["readings"])
    return out


def main(path: str, cell: str, runs=()) -> dict:
    rows = [json.loads(line) for line in open(path) if line.startswith('{"seed"')]
    extra = [r for p in runs for r in result_readings(p)]
    limits, readings = limits_of(rows, extra)
    judged = [r for r in rows if all(k in r["control"] for k in limits)]
    doc = {"limits": limits, "readings": readings,
           "control_fails_every_seed": all(any(r["control"][k] > v for k, v in limits.items())
                                           for r in judged),
           "control_seeds_judged": [r["seed"] for r in judged],
           "seeds": [r["seed"] for r in rows], "runs": [str(p) for p in runs],
           "how": " ".join(__doc__.split("\n\n")[2].split())}
    with open(f"benchmark/limits/{cell}.json", "w") as f:
        json.dump(doc, f, indent=1)
    return doc


if __name__ == "__main__":
    out = main(sys.argv[1], sys.argv[2], sys.argv[3:])
    print(json.dumps({"cell": sys.argv[2], "limits": out["limits"],
                      "control_fails_every_seed": out["control_fails_every_seed"]}))
