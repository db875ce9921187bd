"""Train and evaluation loops (counterpart of ``tce_rvos_tpu/engine.py``;
parity with reference engine.py).

  * ``train_one_epoch``: one train step per batch, the loss dict logged
    through ``MetricLogger``, and a stop on a non-finite loss.
  * ``model_forward``: the evaluators' forward, a plain function (no
    compile step): a batch's model inputs on the model's device, the video
    cast to the compute dtype, under ``torch.inference_mode``.
  * ``evaluate_a2d`` (engine.py:295-357, A2D/JHMDB): the device
    postprocess, the host postprocess with RLE encoding, then mAP and
    P@K/IoU against the untransformed ground truth.
  * ``evaluate_coco_pretrain`` (engine.py:98-161, RefCOCO/+/g): P@{1,5,10}
    and the class-agnostic COCO box (and, with ``masks``, mask) mAP.
  * ``evaluate_yvos`` (engine.py:164-286): the train-set mask-quality probe.

In a ``torch.distributed`` world of several processes the step's metrics
are already the global batch's (``parallel/train_step.py``), and each
process evaluates its shard of the loader: ``evaluate_a2d`` and
``evaluate_coco_pretrain`` merge the processes' per-sample records (masks
as RLE, JSON over a uint8 all-gather,
``parallel/collectives.py::merge_in_sample_order``) before scoring, so
every process returns the metrics of the whole set, those one process
would compute; ``evaluate_yvos`` averages its own shard, as the JAX one
does.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tce_rvos_tpu_torch.parallel.collectives import merge_in_sample_order, process_count
from tce_rvos_tpu_torch.utils import profiling
from tce_rvos_tpu_torch.utils.logging import MetricLogger, SmoothedValue


def train_one_epoch(
    state,
    step_fn: Callable,
    loader,
    epoch: int,
    print_freq: int = 10,
    max_steps: Optional[int] = None,
):
    """Runs ``step_fn(state, batch)`` (``parallel/train_step.py``) over
    ``loader`` with the model in train mode (dropout on). Returns the state
    and the epoch's global averages of the metrics (in a process group,
    of the global batch's losses, which the step sums over the ranks;
    every rank logs the same values, rank 0 prints them). A loss that is not
    finite prints the metrics and stops training (exit code 1). The
    averages include the logger's seconds per step (``time``) and, of them,
    the wait for the next batch (``data``)."""
    state.model.train()
    logger = MetricLogger()
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"

    for step, batch in enumerate(logger.log_every(loader, print_freq, header)):
        if max_steps is not None and step >= max_steps:
            break
        batch = {k: v for k, v in batch.items() if k != "image_ids"}
        state, metrics = step_fn(state, batch)
        with profiling.span("tce.train.read_metrics", 1):  # waits for the step's device work
            host: Dict[str, float] = {k: float(v) for k, v in metrics.items()}
        loss = host.pop("loss")
        if not math.isfinite(loss):
            print(f"Loss is {loss}, stopping training")
            print(host)
            sys.exit(1)
        logger.update(loss=loss, **host)

    stats = {k: m.global_avg for k, m in logger.meters.items()}
    stats.update(time=logger.iter_time.global_avg, data=logger.data_time.global_avg)
    return state, stats


MODEL_INPUTS = ("video", "video_mask", "text_ids", "text_attn_mask", "sizes")


def model_forward(model: torch.nn.Module, compute_dtype: str = "float32") -> Callable:
    """``fwd(batch, valid_indices=False) -> outputs`` for ``model`` (in eval
    mode, already in ``compute_dtype``): the batch's model inputs (numpy, as
    ``collate_batch`` gives them) copied to the model's device, the video
    cast to ``compute_dtype``, the forward under ``torch.inference_mode``.
    ``valid_indices=True`` passes the batch's annotated-frame indices
    (A2D/JHMDB: one frame per clip from the transformer on)."""
    from tce_rvos_tpu_torch.utils.precision import resolve_dtype

    device = next(model.parameters()).device
    dtype = resolve_dtype(compute_dtype)

    def tensor(x):
        t = torch.as_tensor(np.asarray(x))
        return (t if t.is_floating_point() or t.dtype == torch.bool else t.long()).to(device)

    @torch.inference_mode()
    def fwd(batch, valid_indices: bool = False):
        video, mask, ids, attn, sizes = (tensor(batch[k]) for k in MODEL_INPUTS)
        extra = {"valid_indices": tensor(batch["valid_indices"])} if valid_indices else {}
        return model(video.to(dtype), mask, ids, attn, sizes, **extra)

    return fwd


def evaluate_yvos(fwd: Callable, loader, max_batches: Optional[int] = None) -> Dict[str, float]:
    """Train-set mask-quality probe (parity with reference
    engine.py:164-286 evaluate_yvos): run the model on training clips,
    select the best query by mean class score, report dice/focal of its
    masks against GT. A sanity metric, not a benchmark."""
    from tce_rvos_tpu_torch.models.segmentation import dice_loss, sigmoid_focal_loss

    logger = MetricLogger()
    dices, focals = [], []
    for bi, batch in enumerate(logger.log_every(loader, 10, "YVOS probe:")):
        if max_batches is not None and bi >= max_batches:
            break
        outputs = fwd(batch)
        logits = outputs["pred_logits"].float().cpu().numpy()  # [b, t, q, K]
        masks = outputs["pred_masks"].float().cpu().numpy()    # [b, t, q, h, w]
        scores = 1 / (1 + np.exp(-logits))
        best_q = scores.mean(axis=1).max(axis=-1).argmax(axis=-1)  # [b]
        b = masks.shape[0]
        sel = masks[np.arange(b), :, best_q]  # [b, t, h, w]
        gt = batch["targets"]["masks"][:, :, 2::4, 2::4]
        sel_f = torch.from_numpy(np.ascontiguousarray(sel.reshape(b, -1)))
        gt_f = torch.from_numpy(np.ascontiguousarray(gt.reshape(b, -1), np.float32))
        dices.append(float(dice_loss(sel_f, gt_f, b)))
        focals.append(float(sigmoid_focal_loss(sel_f, gt_f, b)))
    out = {"dice_loss": float(np.mean(dices)), "focal_loss": float(np.mean(focals))}
    print(out)
    return out


def _jsonable_prediction(pred: Dict) -> Dict:
    """A postprocessed prediction for the JSON gather: arrays as lists with
    their dtype, masks as RLE (a binary mask stack is large, its counts
    strings are compact)."""
    from tce_rvos_tpu_torch.utils import rle as rle_util

    out = {k: [np.asarray(pred[k]).tolist(), np.asarray(pred[k]).dtype.str]
           for k in ("scores", "boxes")}
    if "masks" in pred:
        out["rle_masks"] = [rle_util.encode(m.squeeze())
                            for m in np.asarray(pred["masks"]).astype(np.uint8)]
    return out


def _prediction_from_json(d: Dict) -> Dict:
    out = {k: np.asarray(v, np.dtype(dtype)) for k, (v, dtype) in
           ((k, d[k]) for k in ("scores", "boxes"))}
    if "rle_masks" in d:
        out["rle_masks"] = d["rle_masks"]
    return out


def evaluate_coco_pretrain(
    fwd: Callable,
    loader,
    gt_boxes_by_image: Dict,
    coco_gt_by_image: Optional[Dict] = None,
    masks: bool = False,
) -> Dict:
    """COCO-pretrain eval (parity with reference engine.py:98-161): run the
    bbox postprocessor and score P@{1,5,10} via RefExpEvaluator plus,
    when ``coco_gt_by_image`` annotations are supplied, the class-agnostic
    COCO box mAP the reference gets from CocoEvaluator (engine.py:143-157).
    With ``masks=True`` the segm postprocessor runs too and the evaluator
    additionally scores mask mAP (``coco_eval_masks``, engine.py:154-157);
    GT annotations must then carry ``segmentation`` RLEs
    (``data/refexp.py::coco_gt_by_image`` provides them)."""
    from tce_rvos_tpu_torch.eval.coco_eval import CocoEvaluator
    from tce_rvos_tpu_torch.eval.refexp_eval import RefExpEvaluator
    from tce_rvos_tpu_torch.models import postprocessors

    iou_types = ("bbox", "segm") if masks else ("bbox",)
    evaluator = RefExpEvaluator(gt_boxes_by_image)
    coco_evaluator = (CocoEvaluator(coco_gt_by_image, iou_types=iou_types)
                      if coco_gt_by_image is not None else None)
    logger = MetricLogger()
    records = []  # [image_id, prediction] in the loader's order (several processes)
    for batch in logger.log_every(loader, 10, "Test:"):
        outputs = fwd(batch)
        orig_sizes = np.asarray(batch["orig_sizes"])
        results = postprocessors.coco_postprocess_bbox(outputs, orig_sizes)
        if masks:
            results = postprocessors.coco_postprocess_segm(
                results, outputs, orig_sizes, np.asarray(batch["sizes"]))
        res = {
            batch["image_ids"][i]: {
                "scores": r["scores"],
                "boxes": r["boxes"],
                **({"masks": r["masks"]} if masks else {}),
            }
            for i, r in enumerate(results)
        }
        if process_count() > 1:
            records.extend([k, _jsonable_prediction(v)] for k, v in res.items())
            continue
        evaluator.update(res)
        if coco_evaluator is not None:
            coco_evaluator.update(res)
    if process_count() > 1:  # every process's shard, in one process's order
        for k, v in merge_in_sample_order(records):
            res = {k: _prediction_from_json(v)}
            evaluator.update(res)
            if coco_evaluator is not None:
                coco_evaluator.update(res)
    stats = evaluator.summarize()
    if coco_evaluator is not None:
        stats["coco_eval_bbox"] = coco_evaluator.stats("bbox")
        if masks:
            stats["coco_eval_masks"] = coco_evaluator.stats("segm")
    return stats


def evaluate_a2d(fwd: Callable, loader, threshold: float = 0.5) -> Dict[str, float]:
    """A2D/JHMDB evaluation: ``fwd`` (``model_forward``) on batches with
    ``valid_indices``, ``image_ids``, ``orig_sizes``, ``sizes`` and the
    untransformed ``orig_masks``; the device postprocess, the host one
    (nearest resize to the original size, RLE), then mAP@[0.5:0.95],
    AP50/75, P@{0.5..0.9}, overall and mean IoU. ``threshold`` is the
    JAX package's argument, which its postprocess does not read either
    (masks binarise at sigmoid 0.5)."""
    from tce_rvos_tpu_torch.eval import a2d_eval
    from tce_rvos_tpu_torch.models import postprocessors
    from tce_rvos_tpu_torch.utils import rle as rle_util

    logger = MetricLogger()
    samples = []  # [image_id, ground truth RLE, its predictions], in the loader's order
    for batch in logger.log_every(loader, 10, "Test:"):
        outputs = fwd(batch, valid_indices=True)
        dev = postprocessors.a2d_device_postprocess(outputs)
        preds = postprocessors.a2d_host_postprocess(dev, batch["sizes"], batch["orig_sizes"])
        for i, p in enumerate(preds):
            image_id = batch["image_ids"][i]
            # GT at ORIGINAL resolution (the loader's untransformed
            # 'orig_masks'): predictions are resized to orig_size by the
            # postprocessor (reference engine.py:332-345 reads GT from the
            # annotation json at original resolution)
            gt = rle_util.encode((batch["orig_masks"][i][0] > 0.5).astype(np.uint8))
            samples.append([image_id, gt, [{"image_id": image_id, "score": float(score),
                                            "rle": rle}
                                           for score, rle in zip(p["scores"], p["rle_masks"])]])

    if process_count() > 1:  # every process's shard, in one process's order
        samples = merge_in_sample_order(samples)
    gt_by_image = {image_id: gt for image_id, gt, _ in samples}
    predictions = [p for _, _, preds in samples for p in preds]
    metrics = a2d_eval.calculate_map(gt_by_image, predictions)
    p_at_k, overall_iou, mean_iou = a2d_eval.calculate_precision_at_k_and_iou_metrics(
        gt_by_image, predictions)
    metrics.update({f"P@{k}": v for k, v in zip((0.5, 0.6, 0.7, 0.8, 0.9), p_at_k)})
    metrics["overall_iou"] = overall_iou
    metrics["mean_iou"] = mean_iou
    print(metrics)
    return metrics
