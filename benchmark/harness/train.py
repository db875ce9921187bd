"""A training cell: the port's trainer, ``engine.train_one_epoch`` over
``parallel/train_step.make_train_step`` and ``create_train_state`` (the
default flat AdamW), fed the mix's batches in ``collate_batch``'s format
from the host; the step moves each to the device itself.

Set-up builds the one train state, drives it through the first
``check_steps`` steps by the window's own call (``train_one_epoch`` over
a loader of one batch each, so each step's loss is its own), reads each
parameter's first gradient as the optimizer took it (its first moment
after one step over 1 - beta1: the clipped gradient) and each parameter's
change after the last of them, and hands the same state to the window."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from . import check, matching
from .context import Context
from .dropout import seeded_dropout
from .trace import Spans, Trace, profiler, sync
from .traffic import rng, train_batches
from reference import criterion as reference_criterion
from reference.matcher import match_costs


def _configs(cfg: Dict):
    from tce_rvos_tpu_torch.config import ModelConfig, TrainConfig

    def pick(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in src.items() if k in names})

    return pick(ModelConfig, cfg), pick(TrainConfig, cfg.get("train", {}))


def first_gradients(state) -> Dict[str, float]:
    """Each parameter's first gradient as the optimizer took it, by name,
    from the optimizer's first moment after its first step."""
    opt = state.optimizer
    names = dict((id(p), n) for n, p in state.model.named_parameters())
    if hasattr(opt, "layout"):  # the flat AdamW: moments in the layout's order
        lay = opt.layout
        return {n: float(torch.linalg.vector_norm(
                    opt.mu[o - lay.frozen_len:o - lay.frozen_len + sz].double()))
                / (1 - check.ADAM_B1)
                for n, o, sz in zip(lay.names, lay.offsets, lay.sizes)}
    return {names[id(p)]: float(torch.linalg.vector_norm(s["exp_avg"].double()))
            / (1 - check.ADAM_B1) for p, s in opt.state.items()}


def judged(cfg: Dict, sd, batches, device, seed: int, calls, side: Dict):
    """The readings of the side in the program's place (``side``, its
    matcher's ``calls``) against the reference that follows its picks:
    (numbers, notes, the reference's dropout calls)."""
    own = matching.own_regrets(calls, match_costs)
    ref, regrets, drops, out1 = check.follow_side(cfg, sd, batches, device, seed, calls)
    numbers, notes = check.train_numbers(side, ref)
    numbers.update(out1, matcher_regret=max(own), match_regret=max(regrets),
                   match_regret1=max(regrets[:len(regrets) // len(batches)]))
    return numbers, notes, drops


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False) -> Dict:
    from tce_rvos_tpu_torch.engine import train_one_epoch
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import create_train_state, make_train_step

    from . import weights

    cfg, mix = cell.config, cell.mix
    mcfg, tcfg = _configs(cfg)
    phases = {"imports": time.perf_counter() - t_start}
    pool = train_batches(mix, seed, device)
    order = [int(k) for k in rng(seed, 7).permutation(len(pool))]
    phases["inputs"] = time.perf_counter() - t_start
    sd, n_params = weights.state_dict(cfg, seed, device)
    phases["weights"] = time.perf_counter() - t_start
    with torch.device(device):
        model = ReferFormer(mcfg)
    model.load_state_dict(sd, strict=True)
    state = create_train_state(model, tcfg, steps_per_epoch=int(mix["steps_per_epoch"]))
    step = make_train_step(criterion_from_configs(mcfg, tcfg), mcfg.compute_dtype)
    quiet = 10**9  # the logger's print interval: only its first and last lines
    phases["train_state"] = time.perf_counter() - t_start

    n_check = int(mix["check_steps"])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, terms, grads = [], [], None
    from tce_rvos_tpu_torch.models import criterion as port_criterion

    with seeded_dropout(seed) as drops, matching.record(port_criterion) as calls:
        for k in range(n_check):
            state, stats = train_one_epoch(state, step, [pool[order[k]]], 0, print_freq=quiet)
            losses.append(float(stats["loss"]))
            terms.append({k: float(v) for k, v in stats.items() if k.startswith("loss_")})
            if k == 0:
                grads = first_gradients(state)
    change = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
              for n, p in model.named_parameters()}
    del start
    sync(device)
    setup_s = time.perf_counter() - t_start

    spans = Spans(device) if trace else None
    step_fn = spans.wrap("step", step, lambda *a: 1) if trace else step
    prof = profiler(device) if trace else None
    prof_steps = int(mix["profile_steps"])
    fed = [n_check]
    marks: Dict[str, float] = {}

    def loader():
        while fed[0] == n_check or time.perf_counter() - t0 < seconds:
            k = fed[0] - n_check
            if prof is not None and k == prof_steps and "prof" not in marks:
                sync(device)
                marks["prof"] = time.perf_counter() - t0
                prof.__exit__(None, None, None)
            yield pool[order[fed[0] % len(pool)]]
            fed[0] += 1

    if prof is not None:  # its start-up stays out of the window
        prof.__enter__()
        sync(device)
    t0 = time.perf_counter()
    state, _ = train_one_epoch(state, step_fn, loader(), 1, print_freq=quiet)
    sync(device)
    window_s = time.perf_counter() - t0
    steps = fed[0] - n_check
    if prof is not None and "prof" not in marks:
        marks["prof"] = window_s
        prof.__exit__(None, None, None)
        prof_steps = steps
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    out = {"e2e": {"train_step_ms": window_s / steps * 1e3, "setup_s": setup_s},
           "attempted": steps + n_check, "failed": 0, "peak": peak, "window_s": window_s,
           "context": None}
    if trace:
        tokens = [int(pool[order[k % len(pool)]]["text_attn_mask"].sum(-1).max())
                  for k in range(n_check, n_check + steps)]
        out["context"] = Context(cell=cell, kind="train", window_s=window_s, steps=steps,
                                 spans=spans.read(), trace=Trace(prof, marks["prof"]),
                                 profiled_steps=prof_steps, params=n_params, tokens=tokens,
                                 hw=tuple(mix["frame_hw"]))
    del state, model, step, step_fn
    check.release(device)
    batches = [pool[order[k]] for k in range(n_check)]
    numbers, notes, ref_drops = judged(
        cfg, sd, batches, device, seed, calls,
        {"losses": losses, "terms": terms, "grads": grads, "change": change})
    del calls
    if drops != ref_drops:  # the reference did not draw the port's masks
        numbers[check.BROKEN] = float(abs(drops[0] - ref_drops[0]))
    notes["dropout_calls"] = drops[0]
    notes["setup_phases_s"] = phases
    out["numbers"], out["notes"] = numbers, notes
    if control:  # the reference one precision below, and a planted fault, in the port's place
        check.release(device)
        for name, kw in (("control", {"control": True}), ("half_frames", {"fault": "half"})):
            with seeded_dropout(seed), matching.record(reference_criterion) as side_calls:
                got = check.follow(cfg, sd, batches, device, **kw)
            out[name] = judged(cfg, sd, batches, device, seed, side_calls,
                               {"losses": got[0], "grads": got[1], "change": got[2],
                                "terms": got[3]})[0]
    return out

