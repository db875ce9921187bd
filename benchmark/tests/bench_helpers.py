"""Helpers of the benchmark's CPU tests: its cells cut to a size the CPU
runs in seconds (widths cut, frames small, float32), and the import paths
of a run."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "benchmark", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from harness import core  # noqa: E402

TINY_MODEL = dict(enc_layers=1, dec_layers=2, dim_feedforward=64, hidden_dim=64, mask_dim=16,
                  text_encoder_layers=1, text_encoder_hidden=64, text_encoder_heads=2,
                  text_encoder_intermediate=128, compute_dtype="float32")
TINY_SERVE = dict(frame_hw=[48, 80], pool_frames=8, t_bucket=2, window=2,
                  engine={"size": 64, "max_size": 112, "pad_mult": 32}, profile_seconds=0.5)
TINY_FRAMES = {"ytvos_whole": ([3, 4], [1, 3]), "clip_e1": ([2, 4], [1])}
TINY_TRAIN = dict(frames=2, frame_hw=[64, 96], pool_batches=4, profile_steps=1)


def tiny_cell(name: str) -> core.Cell:
    cell = copy.deepcopy(core.load_cell(name))
    cell.config.update(TINY_MODEL)
    traffic = name.split(".", 1)[1]
    if cell.mix["kind"] == "serve":
        cell.mix.update(copy.deepcopy(TINY_SERVE))
        cell.mix["frames"], cell.mix["expressions"] = TINY_FRAMES[traffic]
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
