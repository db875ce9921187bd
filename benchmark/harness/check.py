"""What decides ``correct``: the plain reference (``benchmark/reference``)
run over what the timed path produced, once the window has closed and the
port's state is freed, and the numbers compared with the cell's limits
(``benchmark/limits/<cell>.json``).

The reference computes in the precision the configuration states, with
the port's mixed-precision rules: in bfloat16, the weights and the video
cast to bfloat16 (serving), or float32 master weights cast to bfloat16
inside the loss and float32 losses (training); float32 products, where a
float32 configuration asks for them, without TF32. A float32 reference
cannot judge a bfloat16 run of this model at random weights: its mask
logits run to hundreds, the matcher's five queries sit near ties, and one
bfloat16 step already moves the first gradients of the trunk 20-40% from
float32's, as far as the float8 control moves them (PERF.md).

Serving: for a sample of the answers the window finished (expressions of
requests of its first cycle, drawn from the seed, the longest request
always among them), the reference re-derives the engine's input (resize,
normalise, pad, the window or whole-video bucket) from the same host
frames and captions, runs the model one expression at a time, and each
output the engine returned is compared by its relative RMS gap,
||port - reference|| / ||reference||, the widest over the sample.

Training: the reference follows the port's first three steps from the same
weights and batches and gives each step's loss, each parameter's first
clipped gradient and each parameter's change over the three steps; the
port's come from its own state (see ``train.py``). The first step's
forward outputs are compared as the two matchers were given them, and the
port's matcher by itself (``matching.py``).

The control, which has to come out not correct, is the reference computed
one precision below the configuration's bfloat16: its matrix products and
convolutions take float8 (e4m3, one scale a tensor) inputs and weights, the
rest as the reference.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

import reference
from reference import train as reference_train
from reference.text_encoder import tokenize

from .counts import model_size

OUTPUT_KEYS = ("pred_logits", "pred_boxes", "pred_masks", "reference_points")
GAP_NAMES = {"pred_logits": "logits_gap", "pred_boxes": "boxes_gap",
             "pred_masks": "masks_gap", "reference_points": "refpts_gap"}
# a number that can only mean the check itself went wrong: never correct
BROKEN = "check_broken"
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ADAM_B1 = 0.9


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# the control: float8 inputs and weights of every product
# ---------------------------------------------------------------------------

class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 at one scale a tensor; the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = amax / 448.0
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


@contextlib.contextmanager
def fp8_products():
    """``F.linear`` and the convolutions take float8-rounded operands."""
    saved = (F.linear, F.conv2d, F.conv3d)

    def linear(x, w, b=None):
        return saved[0](fp8(x), fp8(w), b)

    def conv2d(x, w, b=None, *args, **kw):
        return saved[1](fp8(x), fp8(w), b, *args, **kw)

    def conv3d(x, w, b=None, *args, **kw):
        return saved[2](fp8(x), fp8(w), b, *args, **kw)

    F.linear, F.conv2d, F.conv3d = linear, conv2d, conv3d
    try:
        yield
    finally:
        F.linear, F.conv2d, F.conv3d = saved


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def windows(t_total: int, mix: Mapping) -> List[Tuple[List[int], int]]:
    """(frame indices of each clip, its core frames): the protocol's
    windows of ``window`` frames with ``f_extra`` context frames a side
    (clamped, padded by repeating the last), or the whole video rounded up
    to a multiple of ``t_bucket``."""
    fx = int(mix["f_extra"])
    if mix["whole_video"]:
        tb = int(mix["t_bucket"])
        win = max(-(-t_total // tb) * tb, tb)
    else:
        win = int(mix["window"])
    out = []
    for start in range(0, t_total, win):
        core = list(range(start, min(start + win, t_total)))
        ext = ([max(core[0] - k, 0) for k in range(fx, 0, -1)] + core
               + [min(core[-1] + k, t_total - 1) for k in range(1, fx + 1)])
        ext += ext[-1:] * (win + 2 * fx - len(ext))
        out.append((ext, len(core)))
    return out


def model_input(frames: Sequence[np.ndarray], eng: Mapping, device):
    """video [1, t, Hp, Wp, 3] f32 (resized bilinear, align_corners=False,
    normalised, zero-padded to multiples of ``pad_mult``), mask True on
    padding, (h, w) before padding."""
    h, w = frames[0].shape[:2]
    oh, ow = model_size((h, w), int(eng["size"]), int(eng["max_size"]))
    x = torch.as_tensor(np.stack(frames)).to(device).permute(0, 3, 1, 2)
    if (oh, ow) != (h, w):
        x = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]
    x = (x - mean) / std
    pad = int(eng["pad_mult"])
    hp, wp = -(-oh // pad) * pad, -(-ow // pad) * pad
    video = torch.zeros((1, len(frames), hp, wp, 3), device=device)
    video[0, :, :oh, :ow] = x.permute(0, 2, 3, 1)
    mask = torch.ones((1, len(frames), hp, wp), dtype=torch.bool, device=device)
    mask[0, :, :oh, :ow] = False
    return video, mask, (oh, ow)


def compute_dtype(cfg: Mapping) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]


class ServeReference:
    """The reference model in the configuration's precision (or, as the
    control, with float8 products) answering one expression of a request."""

    def __init__(self, cfg: Mapping, sd: Mapping, device, control: bool = False):
        self.dtype = compute_dtype(cfg)
        self.model = reference.build(cfg, device)
        self.model.load_state_dict(sd, strict=True)
        self.model = self.model.to(self.dtype)
        self.control = control
        self.device = device

    @torch.no_grad()
    def answers(self, frames: Sequence[np.ndarray], caps: Sequence[str], mix: Mapping
                ) -> List[Dict[str, np.ndarray]]:
        """Each caption's outputs over the video's frames (numpy f32)."""
        acc = [{k: [] for k in OUTPUT_KEYS} for _ in caps]
        ctx = fp8_products() if self.control else contextlib.nullcontext()
        dtype = self.dtype
        with exact_float32(), ctx:
            for ext, n_core in windows(len(frames), mix):
                video, mask, (oh, ow) = model_input([frames[i] for i in ext], mix["engine"],
                                                    self.device)
                sizes = torch.tensor([[oh, ow]], device=self.device)
                feats = self.model(video.to(dtype), mask, backbone_only=True)
                sl = slice(int(mix["f_extra"]), int(mix["f_extra"]) + n_core)
                for a, cap in zip(acc, caps):
                    ids, attn = (torch.as_tensor(x).long().to(self.device) for x in tokenize([cap]))
                    out = self.model(None, mask, ids, attn, sizes, precomputed_feats=feats)
                    for k in OUTPUT_KEYS:
                        a[k].append(out[k][0, sl].float().cpu().numpy())
        return [{k: np.concatenate(v) for k, v in a.items()} for a in acc]


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def reference_answers(picks: Mapping[int, Sequence[int]], answer: Callable) -> Dict:
    """{(request index, expression): outputs} of ``answer(request, [expressions])``."""
    out = {}
    for r, es in sorted(picks.items()):
        for e, a in zip(es, answer(r, list(es))):
            out[(r, e)] = a
    return out


def flip_share(got: np.ndarray, want: np.ndarray) -> float:
    """The share of mask logits on the other side of 0 than the reference's:
    the pixels whose mask decision differs."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    return float(np.mean((got > 0) != (want > 0)))


def serve_numbers(kept: Mapping, want: Mapping) -> Dict[str, float]:
    """Over the sampled answers, the port's (or the control's) ``kept``
    against the reference's ``want`` (both {(request index, expression):
    outputs}): the widest relative gap of each output and the widest share
    of mask decisions that differ (``mask_flips``)."""
    gaps = {GAP_NAMES[k]: 0.0 for k in OUTPUT_KEYS}
    gaps["mask_flips"] = 0.0
    for key, ref in want.items():
        for k in OUTPUT_KEYS:
            gaps[GAP_NAMES[k]] = max(gaps[GAP_NAMES[k]], rel_gap(kept[key][k], ref[k]))
        gaps["mask_flips"] = max(gaps["mask_flips"],
                                 flip_share(kept[key]["pred_masks"], ref["pred_masks"]))
    return gaps


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def half_frames(batch: Mapping) -> Dict:
    """A fault: the batch's first half of the frames, the rest left out."""
    t = max(1, batch["video"].shape[1] // 2)
    out = {k: (v[:, :t] if k in ("video", "video_mask") else v) for k, v in batch.items()}
    out["targets"] = {k: (v if k == "labels" and v.ndim < 2 else v[:, :t])
                      for k, v in batch["targets"].items()}
    return out


def follow(cfg: Mapping, sd: Mapping, batches: List[Mapping], device, control: bool = False,
           fault: str = "") -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """The reference's three steps (or the control's): losses, first
    clipped gradient norms and change norms by parameter. ``fault="half"``
    plants step 3's fault of a batch half left out."""
    model = reference.build(cfg, device)
    model.load_state_dict(sd, strict=True)
    mcfg, tcfg = reference.model_config(cfg), reference.train_config(cfg)
    if fault == "half":
        batches = [half_frames(b) for b in batches]
    dtype = compute_dtype(cfg)

    def forward(m, video, kwargs):
        """The port's mixed precision: the float32 masters cast inside the
        loss, the video too; the outputs go back to float32 for the
        criterion."""
        if dtype == torch.float32 and not control:
            return m(video, **kwargs)
        cast = torch.bfloat16 if control else dtype
        tensors = {k: v.to(cast) if v.is_floating_point() else v
                   for k, v in (*m.named_parameters(), *m.named_buffers())}
        with fp8_products() if control else contextlib.nullcontext():
            return functional_call(m, tensors, (video.to(cast),), kwargs)

    with exact_float32():
        return reference_train.follow_steps(model, mcfg, tcfg, batches, forward)


def follow_side(cfg: Mapping, sd: Mapping, batches: List[Mapping], device, seed: int,
                calls: List):
    """The reference's steps following the matcher's picks (``calls``,
    ``matching.record``'s) of the side it judges, with the seeded dropout
    masks: (readings, regrets of the picks on the reference's own costs,
    dropout calls, the first step's output gaps)."""
    from reference import criterion as reference_criterion
    from reference.matcher import match_costs

    from .dropout import seeded_dropout
    from .matching import follow as follow_picks

    with seeded_dropout(seed) as drops, \
            follow_picks(reference_criterion, match_costs, calls) as (regrets, own):
        ref = follow(cfg, sd, batches, device)
    return ref, regrets, drops, step1_output_gaps(calls, own, len(batches))


# the matcher's arguments that are the forward's outputs
MATCHED_OUTPUTS = {1: "out1_logits_gap", 2: "out1_boxes_gap", 3: "out1_masks_gap"}


def step1_output_gaps(got: List, want: List, steps: int) -> Dict[str, float]:
    """The first step's forward outputs as the matcher was given them (the
    class logits, boxes and mask logits of each decoder layer, float32),
    the side's ``got`` against the reference's ``want`` (``matching.Call``s):
    the widest relative RMS gap of each over the layers."""
    k = len(want) // steps
    gaps = dict.fromkeys(MATCHED_OUTPUTS.values(), 0.0)
    for a, b in zip(got[:k], want[:k]):
        for i, name in MATCHED_OUTPUTS.items():
            gaps[name] = max(gaps[name], rel_gap(a.args[i].float().cpu().numpy(),
                                                 b.args[i].float().cpu().numpy()))
    return gaps


def leaf_gaps(got: Mapping[str, float], want: Mapping[str, float], keep: Sequence[str]
              ) -> Dict[str, float]:
    """Each leaf's gap between the port's and the reference's norm, against
    the larger of the reference's norm of that leaf and of the median leaf."""
    med = float(np.median([want[k] for k in keep]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep}


MASK_FOCAL = "loss_mask"  # the focal mask terms, loss_mask and loss_mask_<i>


def without_mask_focal(terms: Mapping[str, float]) -> float:
    """A step's loss without its focal mask terms, the ones that sum the
    focal loss of every mask logit; at random weights those logits run to
    hundreds, where one bfloat16 step is 0.5 and moves the term by some
    tenths of a percent."""
    return sum(v for k, v in terms.items() if k.split("_")[:2] != MASK_FOCAL.split("_"))


TERM_GROUPS = ("ce", "bbox", "giou", "mask", "dice")


def term_gap(got: Mapping[str, float], want: Mapping[str, float], group: str) -> float:
    """The relative gap of one kind of loss term summed over the decoder
    layers (``loss_<group>`` and ``loss_<group>_<i>``)."""
    def total(t):
        return sum(v for k, v in t.items() if k.split("_")[1] == group)
    return abs(total(got) - total(want)) / max(abs(total(want)), 1e-30)


def train_numbers(port: Mapping, ref: Tuple) -> Tuple[Dict[str, float], Dict]:
    """(numbers, notes), the port's (or the control's) readings against the
    reference's: ``loss1_gap`` the relative gap of the first step's loss
    (the forward before any update) and ``loss1_wo_mask_focal_gap`` that of
    it without the focal mask terms, ``loss_gap`` the widest over the
    steps; ``grad_gap`` / ``grad_gap_median`` the widest and the median
    leaf gap of the first gradient; ``change_gap`` / ``change_gap_median``
    those of the change over the steps. Leaves whose reference gradient is
    under a thousandth of the median leaf's (zero in exact arithmetic, such
    as a key bias under softmax) are left out by that rule."""
    losses, grads, change, terms = ref
    rel = [abs(a - b) / abs(b) for a, b in zip(port["losses"], losses)]
    smooth = [without_mask_focal(t) for t in (port["terms"][0], terms[0])]
    med = float(np.median(list(grads.values())))
    keep = [k for k in grads if grads[k] >= 1e-3 * med]
    g, c = leaf_gaps(port["grads"], grads, keep), leaf_gaps(port["change"], change, keep)
    numbers = {"loss1_gap": rel[0], "loss1_wo_mask_focal_gap": abs(smooth[0] - smooth[1]) / smooth[1],
               **{f"loss1_{g}_gap": term_gap(port["terms"][0], terms[0], g) for g in TERM_GROUPS},
               "loss_gap": max(rel),
               "grad_gap": max(g.values()), "grad_gap_median": float(np.median(list(g.values()))),
               "change_gap": max(c.values()),
               "change_gap_median": float(np.median(list(c.values())))}
    notes = {"left_out": sorted(set(grads) - set(keep)), "grad_leaf": max(g, key=g.get),
             "change_leaf": max(c, key=c.get), "losses": list(port["losses"]),
             "ref_losses": list(losses)}
    return numbers, notes


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict]:
    """(every compared number within its limit, {name: [number, limit]});
    the limits name the numbers compared, a missing number is not correct,
    and so is ``BROKEN``. The rest are readings only."""
    shown = {k: [numbers.get(k), limits[k]] for k in sorted(limits)}
    if BROKEN in numbers:
        shown[BROKEN] = [numbers[BROKEN], 0.0]
    ok = all(v is not None and np.isfinite(v) and v <= lim for v, lim in shown.values())
    return ok, shown


def release(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

