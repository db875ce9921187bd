"""``train.main`` in two processes over gloo on the CPU
(``parallel/dryrun.py::run_processes``; the ranks run
tests/torch_dist_cases.py's ``train_main_cases``): an epoch, a resume from
the checkpoint rank 0 wrote, and ``--ckpt_backend orbax``."""

import json
import os

import numpy as np
import torch

from tce_rvos_tpu_torch.parallel import dryrun
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import write_ytvos_tree

TRAIN_FLAGS = ["--dataset_file", "ytvos", "--binary", "--masks", "--num_frames", "2",
               "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "64", "--nheads", "2",
               "--dim_feedforward", "32", "--max_size", "96", "--num_workers", "1",
               "--lr_drop", "1", "--device", "cpu"]


def test_train_main_at_world_2_trains_checkpoints_and_resumes(tmp_path):
    """``train.main`` in two processes: 12 samples, so 6 steps an epoch at
    one clip a rank; rank 0 alone writes log.txt and the checkpoints; both
    ranks resume from them and stay replicas; ``--ckpt_backend orbax``
    keeps one step."""
    import torch_dist_cases

    tree = write_ytvos_tree(str(tmp_path / "tree"), n_frames=6, second_object=True)
    out = str(tmp_path / "out")
    argv = TRAIN_FLAGS + ["--ytvos_path", tree]
    ranks = dryrun.run_processes(2, torch_dist_cases.train_main_cases, (argv, out))
    assert [r["first"]["step"] for r in ranks] == [6, 6]
    assert [r["resumed"]["step"] for r in ranks] == [12, 12]
    assert ranks[0]["orbax"]["dirs"] == ["6"] == ranks[1]["orbax"]["dirs"]
    for run in ("first", "resumed", "orbax"):
        for name, p in ranks[0][run]["params"].items():
            assert torch.equal(ranks[1][run]["params"][name], p), (run, name)
    with open(os.path.join(out, "log.txt")) as fh:
        logs = [json.loads(line) for line in fh]
    assert [x["epoch"] for x in logs] == [0, 1]  # one line an epoch: rank 0's
    assert all(np.isfinite(x["train_loss"]) for x in logs)
    assert sorted(os.listdir(out)) == ["checkpoint", "checkpoint0000", "checkpoint0001",
                                       "log.txt"]
