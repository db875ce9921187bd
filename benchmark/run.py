"""Runs one cell of the benchmark of ``tce_rvos_tpu_torch`` once, on the
CUDA device of this machine, and prints one JSON line last on standard
output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs
the same window with spans and a profiled sub-window and reports its
per-layer metrics. Every cell, configuration, mix and metric is found by
its name in ``BENCHMARK.json`` (``benchmark/configs``, ``benchmark/traffic``,
``benchmark/metrics``, ``benchmark/limits``). The run fails, printing no
result, without a CUDA device, and if JAX or the JAX package was loaded.
Caches (the kernels' build, torch extensions, Triton) stay in ``build/``
inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def environment() -> None:
    """Fixed cache directories inside the checkout, no network, no cached
    tokenizer (the port then takes its hash fallback, as the reference
    does), and no JAX or TensorFlow behind ``transformers``."""
    cache = ROOT / "build" / "bench_cache"
    hf = cache / "hf"
    hf.mkdir(parents=True, exist_ok=True)
    os.environ.update({
        "HF_HOME": str(hf), "HF_HUB_CACHE": str(hf), "TRANSFORMERS_CACHE": str(hf),
        "HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1",
        "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0", "USE_TORCH": "1",
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "TRITON_CACHE_DIR": str(cache / "triton"),
    })
    for p in (ROOT / "benchmark", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    from harness import core

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: int(w["chips"]) for w in manifest["workloads"]}.get(args.workload, 1)
    cell = core.load_cell(args.workload, manifest)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    res = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = core.forbidden_modules()
    if bad:
        print("loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, (value, limit) in res["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
