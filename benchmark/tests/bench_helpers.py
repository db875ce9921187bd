"""Helpers of the benchmark's CPU tests: the names in ``BENCHMARK.json``,
its cells cut to a size the CPU runs in seconds (widths cut, frames small,
float32), and the import paths of a run."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "benchmark", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from harness import core  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["name"] for c in MANIFEST["configs"]]
CELLS = [w["name"] for w in MANIFEST["workloads"]]

TINY_MODEL = dict(enc_layers=1, dec_layers=2, dim_feedforward=64, hidden_dim=64, mask_dim=16,
                  text_encoder_layers=1, text_encoder_hidden=64, text_encoder_heads=2,
                  text_encoder_intermediate=128, compute_dtype="float32")
TINY_SERVE = dict(frame_hw=[48, 80], pool_frames=8, t_bucket=2, window=2,
                  engine={"size": 64, "max_size": 112, "pad_mult": 32}, profile_seconds=0.5)
TINY_TRAIN = dict(frames=2, frame_hw=[64, 96], pool_batches=4, profile_steps=1)


def tiny_frames(mix: dict):
    """(frames, expressions) of a serving mix's tiny requests, at the tiny
    ``t_bucket`` and ``window``: whole videos one frame past a bucket and
    a whole bucket, windowed one window and two; one expression, and three
    where the mix sends several."""
    if mix["whole_video"]:
        frames = [TINY_SERVE["t_bucket"] + 1, 2 * TINY_SERVE["t_bucket"]]
    else:
        frames = [TINY_SERVE["window"], 2 * TINY_SERVE["window"]]
    return frames, [1, 3] if max(mix["expressions"]) > 1 else [1]


def config(name: str) -> dict:
    """The file of the configuration ``name`` of ``BENCHMARK.json``."""
    conf = {c["name"]: c for c in MANIFEST["configs"]}[name]
    return json.loads((ROOT / conf["file"]).read_text())


def tiny_config(name: str) -> dict:
    """The configuration ``name`` at the tiny widths."""
    return {**config(name), **TINY_MODEL}


def tiny_cell(name: str) -> core.Cell:
    cell = copy.deepcopy(core.load_cell(name))
    cell.config.update(TINY_MODEL)
    if cell.mix["kind"] == "serve":
        cell.mix["frames"], cell.mix["expressions"] = tiny_frames(cell.mix)
        cell.mix.update(copy.deepcopy(TINY_SERVE))
        cell.mix["repeat"] = 1
        cell.mix["check"] = {"requests": 2, "expressions": 2}
    else:
        cell.mix.update(copy.deepcopy(TINY_TRAIN))
    return cell


SMALL_SERVE = dict(frame_hw=[48, 80], pool_frames=8, t_bucket=2, window=2,
                   engine={"size": 64, "max_size": 112, "pad_mult": 32}, profile_seconds=0.5)


def small_cell(name: str) -> core.Cell:
    """The cell at its own widths and depth, with small frames, few
    requests and float32 (the CPU's), for the checks of ``correct``."""
    cell = copy.deepcopy(core.load_cell(name))
    cell.config["compute_dtype"] = "float32"
    if cell.mix["kind"] == "serve":
        cell.mix.update(copy.deepcopy(SMALL_SERVE))
        cell.mix["frames"], cell.mix["expressions"] = [3, 4], [1, 3]
        cell.mix["repeat"] = 1
        cell.mix["check"] = {"requests": 2, "expressions": 2}
    else:
        cell.mix.update(copy.deepcopy(TINY_TRAIN))
    return cell
