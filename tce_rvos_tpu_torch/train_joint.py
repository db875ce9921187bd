"""Joint ref-datasets pretraining entry (the port's copy of
``tce_rvos_tpu/train_joint.py``; parity with reference main_joint.py:28-215):
forces ``--dataset_file joint`` (RefCOCO, RefCOCO+ and RefCOCOg
pseudo-videos, plus Ref-YouTube-VOS unless ``--pretrain_coco``) and
``--binary``, then runs ``train.main``.

    python -m tce_rvos_tpu_torch.train_joint --coco_path data/coco \\
        --ytvos_path data/Refer_YouTube_VOS/rvos --with_box_refine --f_token 8 \\
        --qtrans [--compute_dtype bfloat16] [--device cpu]

The reference's e-mail hook (``util.send_mail``, a module it does not ship)
is ``notify``, which prints.
"""

from __future__ import annotations

import sys


def notify(msg: str):  # the reference's e-mail hook, made harmless
    print(f"[notify] {msg}")


def joint_argv(argv) -> list:
    """``argv`` without any ``--dataset_file <name>``, with
    ``--dataset_file joint`` and ``--binary``."""
    argv = list(argv)
    while "--dataset_file" in argv:
        i = argv.index("--dataset_file")
        del argv[i: i + 2]
    argv += ["--dataset_file", "joint"]
    if "--binary" not in argv:
        argv.append("--binary")
    return argv


def main(argv=None):
    """Runs ``train.main`` on the joint dataset; returns its ``TrainState``."""
    from tce_rvos_tpu_torch.train import main as train_main

    state = train_main(joint_argv(sys.argv[1:] if argv is None else argv))
    notify("joint pretraining finished")
    return state


if __name__ == "__main__":
    main()
