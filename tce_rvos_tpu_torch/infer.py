"""Inference engine of the port (counterpart of ``tce_rvos_tpu/infer.py``):
``InferenceEngine`` with ``preprocess``, ``run_window``, ``run_video`` and
the serving path ``run_video_batch``, plus ``select_query`` and
``masks_to_original``.

The serving path runs the text-independent backbone once per clip window,
then the text-conditioned trunk with the expressions stacked on the batch
axis (``exp_batch`` at a time, the last chunk padded up to a power of two).
Unlike the JAX engine there is no compile per shape, and no memory envelope
caps ``exp_batch`` yet: the caller's value is taken as given.

Not ported yet: the ytvos / davis / mevis protocols (``run_ytvos``,
``run_davis``, ``run_mevis``) with the context frames (``f_extra``) and
whole-video windows they use, the per-device fan-out (``make_engines`` /
``_fanout``) and ``save_visualization``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.models.text_encoder import tokenize
from tce_rvos_tpu_torch.utils.device import resolve_device
from tce_rvos_tpu_torch.utils.precision import resolve_dtype

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
OUTPUT_KEYS = ("pred_logits", "pred_masks", "pred_boxes", "reference_points",
               "inter_samples")


def get_size_with_aspect_ratio(
    image_size: Tuple[int, int], size: int, max_size: Optional[int] = None
) -> Tuple[int, int]:
    """(h, w) -> target (h, w): short side ``size``, long side at most
    ``max_size`` (the torchvision/DETR convention)."""
    h, w = image_size
    if max_size is not None:
        min_original = float(min(h, w))
        max_original = float(max(h, w))
        if max_original / min_original * size > max_size:
            size = int(round(max_size * min_original / max_original))
    if (h <= w and h == size) or (w <= h and w == size):
        return h, w
    if h < w:
        return size, int(size * w / h)
    return int(size * h / w), size


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class InferenceEngine:
    """Holds the model on one device (``cuda`` unless ``device="cpu"``) in
    the configured compute dtype. ``state_dict`` is in the reference torch
    layout (``utils/convert.py`` makes one from JAX variables) and loads
    strictly."""

    def __init__(
        self,
        cfg: ModelConfig,
        state_dict: Mapping[str, torch.Tensor],
        device: Optional[Union[str, torch.device]] = None,
        size: int = 360,
        max_size: int = 640,
        pad_mult: int = 64,
        window: Optional[int] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(cfg.compute_dtype)
        model = ReferFormer(cfg)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.size = size
        self.max_size = max_size
        self.pad_mult = pad_mult
        self.window = window or cfg.num_frames
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)[:, None, None]
        self._std = torch.tensor(IMAGENET_STD, device=self.device)[:, None, None]

    # ------------------------------------------------------------------
    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    def _text(self, ids: np.ndarray, attn: np.ndarray):
        return self._tensor(ids).long(), self._tensor(attn).long()

    def preprocess(self, frames: List[np.ndarray]):
        """Resize (short side ``size``, long side <= ``max_size``; bilinear,
        align_corners=False), normalise, pad to the ``pad_mult`` bucket.
        Returns (video [1, t, Hp, Wp, 3] f32, mask [1, t, Hp, Wp] True on
        padding, (oh, ow)) on the engine's device."""
        h, w = frames[0].shape[:2]
        oh, ow = get_size_with_aspect_ratio((h, w), self.size, self.max_size)
        x = self._tensor(np.stack([np.asarray(f, np.float32) for f in frames]))
        x = x.permute(0, 3, 1, 2)  # [t, 3, h, w]
        if (oh, ow) != (h, w):
            x = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False)
        x = (x - self._mean) / self._std
        hp, wp = _pad_to(oh, self.pad_mult), _pad_to(ow, self.pad_mult)
        t = len(frames)
        video = torch.zeros((1, t, hp, wp, 3), dtype=torch.float32, device=self.device)
        video[0, :, :oh, :ow] = x.permute(0, 2, 3, 1)
        mask = torch.ones((1, t, hp, wp), dtype=torch.bool, device=self.device)
        mask[0, :, :oh, :ow] = False
        return video, mask, (oh, ow)

    @torch.inference_mode()
    def run_window(self, video, mask, text_ids, text_attn, model_size) -> Dict[str, torch.Tensor]:
        """Full forward of one padded clip -> the output tensors."""
        ids, attn = self._text(text_ids, text_attn)
        sizes = torch.tensor([model_size], dtype=torch.long, device=self.device)
        out = self.model(video.to(self.dtype), mask, ids, attn, sizes)
        return {k: out[k] for k in OUTPUT_KEYS}

    @torch.inference_mode()
    def backbone(self, video, mask) -> List[torch.Tensor]:
        """Text-independent half: the feature pyramid of one clip window."""
        return self.model(video.to(self.dtype), mask, backbone_only=True)

    @torch.inference_mode()
    def trunk(self, feats, mask, text_ids, text_attn, sizes) -> Dict[str, torch.Tensor]:
        """Text-conditioned half over precomputed features; the text batch
        E tiles the video axis inside the model."""
        ids, attn = self._text(text_ids, text_attn)
        out = self.model(None, mask, ids, attn, sizes, precomputed_feats=feats)
        return {k: out[k] for k in OUTPUT_KEYS}

    def _window_indices(self, t_total: int):
        """(frame indices of each ``window``-frame clip, the last one padded
        by repeating its last frame; number of real frames)."""
        for start in range(0, t_total, self.window):
            core = list(range(start, min(start + self.window, t_total)))
            yield core + core[-1:] * (self.window - len(core)), len(core)

    def run_video(self, frames: List[np.ndarray], caption: str) -> Dict[str, np.ndarray]:
        """Serial path: one expression, the full model per window."""
        text_ids, text_attn = tokenize([caption])
        acc: Dict[str, List[np.ndarray]] = {k: [] for k in OUTPUT_KEYS}
        model_size = None
        for ext, n_core in self._window_indices(len(frames)):
            video, mask, model_size = self.preprocess([frames[i] for i in ext])
            out = self.run_window(video, mask, text_ids, text_attn, model_size)
            sl = slice(0, n_core)
            for k in OUTPUT_KEYS:
                if k == "inter_samples":  # [l, t, q, 30, 2] -> last layer
                    acc[k].append(_numpy(out[k][-1][sl]))
                else:
                    acc[k].append(_numpy(out[k][0, sl]))
        return {**{k: np.concatenate(v) for k, v in acc.items()}, "model_size": model_size}

    def run_video_batch(
        self,
        frames: List[np.ndarray],
        captions: Sequence[str],
        exp_batch: int = 8,
    ) -> List[Dict[str, np.ndarray]]:
        """Serving path for a video with E expressions; one
        ``run_video``-format dict per caption."""
        n_exp = len(captions)
        exp_batch = max(1, exp_batch)
        text_ids, text_attn = tokenize([str(c) for c in captions])
        chunks: List[Tuple[int, int, int]] = []  # (offset, n_real, n_padded)
        off = 0
        while off < n_exp:
            n = min(exp_batch, n_exp - off)
            npad = 1
            while npad < n:
                npad *= 2
            chunks.append((off, n, npad))
            off += n

        acc = [{k: [] for k in OUTPUT_KEYS} for _ in range(n_exp)]
        model_size = None
        for ext, n_core in self._window_indices(len(frames)):
            video, mask, model_size = self.preprocess([frames[i] for i in ext])
            sizes = torch.tensor([model_size], dtype=torch.long, device=self.device)
            feats = self.backbone(video, mask)
            sl = slice(0, n_core)
            for c_off, n_real, n_pad in chunks:
                ids = text_ids[c_off : c_off + n_real]
                attn = text_attn[c_off : c_off + n_real]
                if n_pad != n_real:  # pad rows are duplicates, discarded
                    ids = np.concatenate([ids, np.repeat(ids[:1], n_pad - n_real, 0)])
                    attn = np.concatenate([attn, np.repeat(attn[:1], n_pad - n_real, 0)])
                out = self.trunk(feats, mask, ids, attn, sizes)
                host = {k: _numpy(out[k]) for k in OUTPUT_KEYS}
                samples = host["inter_samples"][-1]
                samples = samples.reshape((n_pad, self.window) + samples.shape[1:])
                for e in range(n_real):
                    a = acc[c_off + e]
                    for k in OUTPUT_KEYS[:-1]:
                        a[k].append(host[k][e, sl])
                    a["inter_samples"].append(samples[e, sl])
        return [
            {**{k: np.concatenate(a[k]) for k in OUTPUT_KEYS}, "model_size": model_size}
            for a in acc
        ]


def select_query(pred_logits: np.ndarray) -> int:
    """One query for the whole video: sigmoid -> mean over frames -> max
    over classes -> argmax over queries."""
    scores = 1.0 / (1.0 + np.exp(-pred_logits))  # [T, q, K]
    return int(scores.mean(axis=0).max(axis=-1).argmax())


def masks_to_original(
    mask_logits: np.ndarray,
    model_size: Tuple[int, int],
    orig_size: Tuple[int, int],
    device: Optional[Union[str, torch.device]] = None,
) -> np.ndarray:
    """[T, h, w] stride-4 logits -> sigmoid scores at the original
    resolution (crop the padding, bilinear with align_corners=False)."""
    dev = resolve_device(device)
    mh, mw = model_size
    h4, w4 = -(-mh // 4), -(-mw // 4)
    x = torch.as_tensor(np.asarray(mask_logits, np.float32)).to(dev)
    up = F.interpolate(x[:, None, :h4, :w4], size=(int(orig_size[0]), int(orig_size[1])),
                       mode="bilinear", align_corners=False)
    return _numpy(torch.sigmoid(up[:, 0]))
