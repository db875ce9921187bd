"""Training entry point of the port (counterpart of ``tce_rvos_tpu/train.py``;
parity with reference main.py:30-307).

    python -m tce_rvos_tpu_torch.train --dataset_file ytvos \\
        --ytvos_path data/Refer_YouTube_VOS/rvos --binary --with_box_refine \\
        --f_token 8 --qtrans [--compute_dtype bfloat16] [--device cpu]

Flow, in the JAX package's order: parse the flags -> configs -> the model
from ``--seed`` -> optional pretrained weights (class heads dropped,
tools/load_pretrained_weights.py:3-11) -> dataset, sampler and prefetching
loader (padded sizes bucketed) -> optimizer and train step -> resume ->
per-epoch loop with the keep_fps meta refresh (main.py:225-249), a
checkpoint after every epoch and one JSON line per epoch in ``log.txt``
(main.py:292-294).

The model runs on ``--device`` (``cuda`` by default, which raises without
a GPU). ``--eval`` raises: evaluation is not ported yet. Data parallelism
is not ported yet either.
"""

from __future__ import annotations

import datetime
import functools
import json
import os
import time


def restore_train_state(state, resume_path, ckpt_manager, steps_per_epoch):
    """Resume semantics (reference main.py:180-211): restore the model's
    weights (+ the optimizer state when the checkpoint carries one) and
    return ``(state, start_epoch)``. A checkpoint WITHOUT optimizer state (a
    reference-format torch .pth file or URL, or a save made without one)
    gets only the schedules' counter fast-forwarded to ``start_epoch *
    steps_per_epoch`` (``seed_schedule_step``): the reference restores its
    lr_scheduler on resume, so MultiStep ``lr_drop`` boundaries count from
    epoch 0, never from the resume point."""
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
    """The training command line; returns the final ``TrainState``."""
    import argparse

    from tce_rvos_tpu_torch import cli

    # reference pattern: the opts parser is help-less and used via parents
    # (main.py:303); the child parser provides -h/--help
    parser = argparse.ArgumentParser("tce_rvos_tpu_torch training", parents=[cli.get_args_parser()])
    args = parser.parse_args(argv)
    if args.eval:
        raise NotImplementedError(
            "--eval: evaluation is not ported to tce_rvos_tpu_torch yet; the ytvos, davis "
            "and mevis protocols are `python -m tce_rvos_tpu_torch.infer`")

    model_cfg = cli.model_config_from_args(args)
    train_cfg = cli.train_config_from_args(args)
    data_cfg = cli.data_config_from_args(args)

    from tce_rvos_tpu_torch.data.loader import NodeShardedSampler, PrefetchLoader, ShardedSampler
    from tce_rvos_tpu_torch.data.registry import build_dataset, collate_batch
    from tce_rvos_tpu_torch.engine import train_one_epoch
    from tce_rvos_tpu_torch.models.build import build_model
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.parallel.train_step import create_train_state, make_train_step
    from tce_rvos_tpu_torch.utils import native_ckpt
    from tce_rvos_tpu_torch.utils.device import process_rank, resolve_device

    device = resolve_device(args.device)
    print(args)

    # ---- model: the seed's init on the CPU, then the device ----
    model = build_model(model_cfg, device="cpu", seed=train_cfg.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"number of params: {n_params}")

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
    model.to(device)

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

    output_dir = args.output_dir
    os.makedirs(output_dir, exist_ok=True)
    print("Start training")
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
        if process_rank() == 0:
            with open(os.path.join(output_dir, "log.txt"), "a") as fh:
                fh.write(json.dumps(log_stats) + "\n")

    if ckpt_manager is not None:
        ckpt_manager.wait()
        ckpt_manager.close()
    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    print(f"Training time {total}")
    return state


if __name__ == "__main__":
    main()
