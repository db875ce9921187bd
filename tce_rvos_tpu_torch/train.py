"""Training entry point of the port (counterpart of ``tce_rvos_tpu/train.py``;
parity with reference main.py:30-307).

    python -m tce_rvos_tpu_torch.train --dataset_file ytvos \\
        --ytvos_path data/Refer_YouTube_VOS/rvos --binary --with_box_refine \\
        --f_token 8 --qtrans [--compute_dtype bfloat16] [--device cpu]
    python -m tce_rvos_tpu_torch.train --eval --dataset_file jhmdb \\
        --jhmdb_path data/jhmdb_sentences --binary ... [--resume <checkpoint>]

Flow, in the JAX package's order: parse the flags -> configs -> the model
from ``--seed`` -> optional pretrained weights (class heads dropped,
tools/load_pretrained_weights.py:3-11) -> dataset, sampler and prefetching
loader (padded sizes bucketed) -> optimizer and train step -> resume ->
per-epoch loop with the keep_fps meta refresh (main.py:225-249), a
checkpoint after every epoch and one JSON line per epoch in ``log.txt``
(main.py:292-294). Training runs on ytvos, davis, mevis, refcoco(+/g)
and ``joint`` (``train_joint.py``).

``--eval`` (main.py:150-176) scores the val split instead: ``run_eval``
gives JHMDB its mask mAP / P@K / IoU and RefCOCO(+/g) P@{1,5,10} with the
COCO box (and, with ``--masks``, mask) mAP; ytvos, davis and mevis are
scored from mask dumps (``python -m tce_rvos_tpu_torch.infer``, then
``eval_davis`` for davis).

The model runs on ``--device`` (``cuda`` by default, which raises without
a GPU). ``--dataset_file a2d`` also scores the val split after every epoch
(main.py:283-285).

Several processes (data parallelism, ``parallel/mesh.py``): start one
process a rank with the launcher's environment, e.g.

    torchrun --nproc_per_node 4 -m tce_rvos_tpu_torch.train ...

(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL on ``cuda``, one GPU a rank; gloo with ``--device
cpu``. Each rank trains on its sampler's share of every global batch of
``batch_size`` x ranks clips and evaluates its share of the val split;
rank 0 prints, logs and writes the checkpoints.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import time

import torch


def run_eval(args, model_cfg, data_cfg, model):
    """Eval-only dispatch (reference main.py:150-176) with ``model`` on its
    device: A2D/JHMDB get the mask mAP + P@K protocol, RefCOCO(+/g) get
    P@{1,5,10} and the class-agnostic COCO box mAP (and the mask mAP with
    ``--masks``). ytvos/davis/mevis are server-scored mask dumps: use
    ``tce_rvos_tpu_torch.infer`` for those (as the reference uses
    inference_*.py). ``--resume`` loads a checkpoint directory or a
    reference ``.pth`` over the model; ``--compute_dtype`` casts the
    weights and the video."""
    from tce_rvos_tpu_torch import engine
    from tce_rvos_tpu_torch.data.loader import PrefetchLoader, ShardedSampler
    from tce_rvos_tpu_torch.data.refexp import REFEXP_NAMES
    from tce_rvos_tpu_torch.data.registry import build_dataset, collate_batch
    from tce_rvos_tpu_torch.utils.precision import resolve_dtype

    if args.dataset_file not in ("a2d", "jhmdb", *REFEXP_NAMES):
        raise ValueError(
            f"--eval has no metric protocol for {args.dataset_file!r}; "
            "use `python -m tce_rvos_tpu_torch.infer` (ytvos/davis/mevis dump masks)"
        )
    if args.resume:
        from tce_rvos_tpu_torch.models.text_encoder import require_real_tokenizer
        from tce_rvos_tpu_torch.utils.native_ckpt import load_any_checkpoint

        require_real_tokenizer("--resume checkpoint")
        # a checkpoint directory or a reference torch .pth / URL
        state_dict, _, _ = load_any_checkpoint(args.resume, model.state_dict())
        model.load_state_dict(state_dict)
    model.to(dtype=resolve_dtype(model_cfg.compute_dtype)).eval()
    dataset_val = build_dataset(args.dataset_file, "val", data_cfg, model_cfg)

    sampler = ShardedSampler(len(dataset_val), shuffle=False)
    loader = PrefetchLoader(dataset_val, sampler, args.batch_size, collate_batch,
                            num_workers=args.num_workers, drop_last=False)
    fwd = engine.model_forward(model, model_cfg.compute_dtype)
    if args.dataset_file in ("a2d", "jhmdb"):
        return engine.evaluate_a2d(fwd, loader, args.threshold)
    return engine.evaluate_coco_pretrain(
        fwd, loader, dataset_val.gt_boxes_by_image(), dataset_val.coco_gt_by_image(),
        masks=args.masks)


def evaluate_during_training(args, model_cfg, dataset_val, model):
    """A2D's evaluation of the val split after an epoch (the JAX
    ``train.py`` scores it with the training weights): ``model`` in eval
    mode, or an eval-mode copy cast to ``--compute_dtype`` when that is
    not float32 (the master weights stay float32)."""
    import copy

    from tce_rvos_tpu_torch import engine
    from tce_rvos_tpu_torch.data.loader import PrefetchLoader, ShardedSampler
    from tce_rvos_tpu_torch.data.registry import collate_batch
    from tce_rvos_tpu_torch.utils.precision import resolve_dtype

    dtype = resolve_dtype(model_cfg.compute_dtype)
    if dtype != torch.float32:
        model = copy.deepcopy(model).to(dtype=dtype)
    loader = PrefetchLoader(dataset_val, ShardedSampler(len(dataset_val), shuffle=False),
                            args.batch_size, collate_batch, num_workers=args.num_workers,
                            drop_last=False)
    return engine.evaluate_a2d(engine.model_forward(model.eval(), model_cfg.compute_dtype),
                               loader, args.threshold)


def restore_train_state(state, resume_path, ckpt_manager, steps_per_epoch):
    """Resume semantics (reference main.py:180-211): restore the model's
    weights (+ the optimizer state when the checkpoint carries one) and
    return ``(state, start_epoch)``. A checkpoint WITHOUT optimizer state (a
    reference-format torch .pth file or URL, or a save made without one)
    gets only the schedules' counter fast-forwarded to ``start_epoch *
    steps_per_epoch`` (``seed_schedule_step``): the reference restores its
    lr_scheduler on resume, so MultiStep ``lr_drop`` boundaries count from
    epoch 0, never from the resume point. Optimizer state written under the
    other ``--flat_opt`` value, or over another flat layout, is refused
    with a ``ValueError`` that names the flag."""
    from tce_rvos_tpu_torch.parallel.train_step import seed_schedule_step
    from tce_rvos_tpu_torch.utils.native_ckpt import load_any_checkpoint

    if ckpt_manager is not None:
        state_dict, opt_state, meta = ckpt_manager.restore()
    else:
        state_dict, opt_state, meta = load_any_checkpoint(resume_path, state.model.state_dict())
    state.model.load_state_dict(state_dict)
    start_epoch = meta.get("epoch", -1) + 1
    if opt_state is None:
        state = seed_schedule_step(state, start_epoch * steps_per_epoch)
    else:
        state.optimizer.load_state_dict(opt_state)
        state.step = int(meta.get("step", 0))
    return state, start_epoch


def main(argv=None):
    """The training command line; returns the final ``TrainState``, or with
    ``--eval`` the metric dict. ``--trace_dir`` runs it under
    ``utils/profiling.trace``."""
    import argparse

    from tce_rvos_tpu_torch import cli

    # reference pattern: the opts parser is help-less and used via parents
    # (main.py:303); the child parser provides -h/--help
    parser = argparse.ArgumentParser("tce_rvos_tpu_torch training", parents=[cli.get_args_parser()])
    parser.add_argument("--trace_dir", default="",
                        help="run the job under the profiler with the program's spans and "
                             "counters on, and write trace.json and spans.json there "
                             "(rank<k>/ below it in a world of several processes; the "
                             "records stay in memory until the job ends: for short jobs)")
    args = parser.parse_args(argv)
    if not args.trace_dir:
        return _main(args)
    from tce_rvos_tpu_torch.utils import profiling

    trace_dir = args.trace_dir
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        trace_dir = os.path.join(trace_dir, f"rank{os.environ.get('RANK', '0')}")
    with profiling.trace(trace_dir):
        return _main(args)


def _main(args):
    from tce_rvos_tpu_torch import cli

    model_cfg = cli.model_config_from_args(args)
    train_cfg = cli.train_config_from_args(args)
    data_cfg = cli.data_config_from_args(args)

    from tce_rvos_tpu_torch.data.loader import NodeShardedSampler, PrefetchLoader, ShardedSampler
    from tce_rvos_tpu_torch.data.registry import build_dataset, collate_batch
    from tce_rvos_tpu_torch.engine import train_one_epoch
    from tce_rvos_tpu_torch.models.build import build_model
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.parallel.train_step import create_train_state, make_train_step
    from tce_rvos_tpu_torch.parallel.collectives import is_main_process
    from tce_rvos_tpu_torch.parallel.mesh import init_distributed, replicate
    from tce_rvos_tpu_torch.utils import native_ckpt
    from tce_rvos_tpu_torch.utils.device import resolve_device

    init_distributed(args.device)
    device = resolve_device(args.device)
    log = print if is_main_process() else (lambda *a, **k: None)
    log(args)

    # ---- model: the seed's init on the CPU, then the device ----
    model = build_model(model_cfg, device="cpu", seed=train_cfg.seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"number of params: {n_params}")

    if args.pretrained_weights:
        from tce_rvos_tpu_torch.models.text_encoder import require_real_tokenizer
        from tce_rvos_tpu_torch.utils.checkpoint import (
            convert_state_dict,
            drop_class_heads,
            load_torch_file,
        )

        require_real_tokenizer("--pretrained_weights")
        sd = drop_class_heads(load_torch_file(args.pretrained_weights), model_cfg.dec_layers)
        sd, _, _ = convert_state_dict(sd, model.state_dict())
        model.load_state_dict(sd)
    replicate(model.to(device))

    # ---- eval-only mode (reference main.py:150-176) ----
    if args.eval:
        stats = run_eval(args, model_cfg, data_cfg, model)
        log(json.dumps(stats, default=float))
        if args.output_dir and is_main_process():
            os.makedirs(args.output_dir, exist_ok=True)
            with open(os.path.join(args.output_dir, "log.txt"), "a") as fh:
                fh.write(json.dumps(stats, default=float) + "\n")
        return stats

    # ---- data ----
    # bucket the padded (H, W): the train pipeline samples short sides
    # 288-512, and a few padded shapes keep the allocator's and the
    # libraries' per-shape choices few
    collate = functools.partial(
        collate_batch, hw_buckets=tuple(range(128, data_cfg.max_size + 64, 64))
    )
    sampler_cls = NodeShardedSampler if data_cfg.cache_mode else ShardedSampler
    dataset_train = build_dataset(args.dataset_file, "train", data_cfg, model_cfg)

    def make_loader():
        sampler = sampler_cls(len(dataset_train), shuffle=True, seed=train_cfg.seed)
        return sampler, PrefetchLoader(dataset_train, sampler, train_cfg.batch_size, collate,
                                       num_workers=args.num_workers)

    sampler, loader = make_loader()

    # ---- optimizer / step ----
    steps_per_epoch = max(len(loader), 1)
    state = create_train_state(model, train_cfg, steps_per_epoch)
    # --compute_dtype bfloat16: f32 master weights, bf16 forward/backward
    step_fn = make_train_step(criterion_from_configs(model_cfg, train_cfg),
                              model_cfg.compute_dtype)

    ckpt_manager = None
    if args.ckpt_backend == "orbax":
        ckpt_manager = native_ckpt.CheckpointManager(
            os.path.join(args.output_dir, "orbax"), max_to_keep=args.ckpt_keep)

    start_epoch = args.start_epoch
    if args.resume:
        state, start_epoch = restore_train_state(state, args.resume, ckpt_manager,
                                                 steps_per_epoch)

    # per-epoch A2D evaluation (reference main.py:283-285)
    evaluate = None
    if args.dataset_file == "a2d":
        dataset_val = build_dataset("a2d", "val", data_cfg, model_cfg)
        evaluate = functools.partial(evaluate_during_training, args, model_cfg, dataset_val)

    output_dir = args.output_dir
    os.makedirs(output_dir, exist_ok=True)
    log("Start training")
    start_time = time.time()
    for epoch in range(start_epoch, train_cfg.epochs):
        if data_cfg.keep_fps and hasattr(dataset_train, "refresh_metas"):
            dataset_train.refresh_metas()
            sampler, loader = make_loader()
        sampler.set_epoch(epoch)
        state, train_stats = train_one_epoch(state, step_fn, loader, epoch)

        weights, opt_state = state.model.state_dict(), state.optimizer.state_dict()
        if ckpt_manager is not None:
            ckpt_manager.save(state.step, weights, opt_state,
                              meta={"epoch": epoch, "step": state.step})
        else:
            for name in ("checkpoint", f"checkpoint{epoch:04}"):
                native_ckpt.save_checkpoint(os.path.join(output_dir, name), weights, opt_state,
                                            epoch, state.step)

        log_stats = {
            **{f"train_{k}": v for k, v in train_stats.items()},
            "epoch": epoch,
            "n_parameters": int(n_params),
        }
        if evaluate is not None:
            log_stats.update(evaluate(state.model))
        if is_main_process():
            with open(os.path.join(output_dir, "log.txt"), "a") as fh:
                fh.write(json.dumps(log_stats) + "\n")

    if ckpt_manager is not None:
        ckpt_manager.wait()
        ckpt_manager.close()
    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    log(f"Training time {total}")
    return state


if __name__ == "__main__":
    main()
