"""Inference of the port (counterpart of ``tce_rvos_tpu/infer.py``): the
engine, the Ref-YouTube-VOS / Ref-DAVIS17 / MeViS protocols and the
command line.

``InferenceEngine`` holds the model on one device. Its serving path
``run_video_batch`` runs the text-independent backbone once per clip
window, then the text-conditioned trunk with the expressions stacked on the
batch axis (``exp_batch`` at a time, the last chunk padded up to a power of
two). ``trunk_frame_envelope`` caps the expressions x frames of one trunk
dispatch by a peak-memory fit made on an H100. On a CUDA device a trunk
dispatch small enough that issuing its launches takes the host longer than
the device takes to run them (``graph_gate``) is replayed from CUDA graphs
captured once for its shape (``TrunkGraphs``), and so is a backbone
dispatch of a small window (``backbone_graph_gate``, ``BackboneGraphs``);
every other dispatch, and every CPU one, runs eagerly. Windows are ``window``
frames with ``f_extra`` context frames on both sides (clamped at the
video's ends, their outputs dropped), or, with ``whole_video``, the whole
video rounded up to a multiple of ``t_bucket`` frames by repeating the
last one.

The protocols, as in the JAX package:
  * ytvos: the valid split minus the test split's videos; per expression
    one query for the whole video (``select_query``), masks upsampled to
    the original size, thresholded, binary PNGs under
    ``<out>/<split>/<video>/<exp_id>/``; whole-video windows by default;
    ``visualize`` adds overlays under ``<out>/<split>_vis/``;
  * davis: expressions in groups of 4 annotators, objects merged per
    annotator by argmax over [0.1 background, object scores], palette PNGs
    under ``<out>/<split>/anno_<k>/<video>/`` named after the frames;
  * mevis: the ytvos windowed protocol over the MeViS split (the fixed
    body, not the reference's broken one).

Videos go round-robin over one engine per GPU (``make_engines``,
``_fanout``), each worker thread under its engine's device.

    python -m tce_rvos_tpu_torch.infer --dataset_file ytvos \\
        --ytvos_path data/Refer_YouTube_VOS/rvos --resume ckpt.pth \\
        --binary --with_box_refine --f_token 8 --qtrans [--device cpu]
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
import warnings
import zlib
from typing import (Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
import torch.nn.functional as F

from tce_rvos_tpu_torch.config import ModelConfig
from tce_rvos_tpu_torch.models.referformer import ReferFormer
from tce_rvos_tpu_torch.models.text_encoder import tokenize
from tce_rvos_tpu_torch.utils import profiling
from tce_rvos_tpu_torch.utils.device import resolve_device
from tce_rvos_tpu_torch.utils.precision import resolve_dtype

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
OUTPUT_KEYS = ("pred_logits", "pred_masks", "pred_boxes", "reference_points",
               "inter_samples")


def davis_palette() -> List[int]:
    """The standard VOC/DAVIS 256-colour palette."""
    palette = []
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= (c & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        palette += [r, g, b]
    return palette


def _load_frame(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


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


# the most bytes the staging buffer holds: a longer window goes up in chunks
STAGE_CAP_BYTES = 1 << 30


class _HostStage:
    """Uploads to ``device`` through one reused host buffer of ``dtype``,
    pinned for a CUDA device and grow-only (a power of two of elements,
    under a cap if one is given, unless one request is larger); copies out
    of it are asynchronous from pinned memory, and a CUDA event recorded
    after the last one guards the buffer against the next writes. Callers
    hold ``lock``, so that calls from several threads take turns."""

    dtype = torch.float32

    def __init__(self, device: torch.device):
        self.device = device
        self.pin = device.type == "cuda"
        self.buf: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None
        self.lock = threading.Lock()

    def _wait(self) -> bool:
        """Waits for the last copy out of the buffer; whether it was still
        in flight."""
        if self.event is None or self.event.query():
            return False
        self.event.synchronize()
        return True

    def _host(self, n: int, cap: Optional[int] = None) -> Tuple[torch.Tensor, bool]:
        """The buffer's first ``n`` elements, and whether it was allocated
        or grown for them."""
        grown = self.buf is None or self.buf.numel() < n
        if grown:
            size = _pow2_ceil(n) if cap is None else min(_pow2_ceil(n), max(n, cap))
            self.buf = torch.empty(size, dtype=self.dtype, pin_memory=self.pin)
        return self.buf[:n], grown

    def _send(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst`` <- ``src``, a view of the buffer."""
        dst.copy_(src, non_blocking=self.pin)
        if self.pin:
            if self.event is None:
                self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.device))


class FrameStage(_HostStage):
    """A window's frames to the device through the stage's f32 buffer, at
    most ``STAGE_CAP_BYTES`` unless one frame is larger. Each frame is
    copied once into its row (torch's copy, multi-threaded, converting to
    f32 as ``np.asarray(f, np.float32)`` does), then the rows go up in one
    copy. A window over the cap goes in chunks of the cap, each under its
    own ``.stack`` and ``.h2d`` spans. Counters: ``engine.pinned_frames``
    (frames staged), ``engine.pinned_waits`` (the last upload still in
    flight when the buffer was needed again), ``engine.pinned_allocs``
    (allocations and growths of the buffer). One per engine."""

    def upload(self, frames: Sequence[np.ndarray]) -> torch.Tensor:
        """[t, h, w, c] f32 on the device, the frames' values bitwise."""
        src = [np.asarray(f) for f in frames]
        shape = src[0].shape
        if any(a.shape != shape for a in src):
            raise ValueError(f"frames of one window differ in shape: {[a.shape for a in src]}")
        frame_bytes = 4 * int(np.prod(shape))
        chunk = max(1, STAGE_CAP_BYTES // frame_bytes)
        out = torch.empty((len(src),) + shape, dtype=torch.float32, device=self.device)
        with self.lock:
            for s in range(0, len(src), chunk):
                part = src[s:s + chunk]
                with profiling.span("tce.engine.preprocess.stack", len(part)):
                    if self._wait():
                        profiling.count("engine.pinned_waits")
                    rows, grown = self._host(len(part) * int(np.prod(shape)),
                                             STAGE_CAP_BYTES // 4)
                    if grown:
                        profiling.count("engine.pinned_allocs")
                    rows = rows.view(len(part), *shape)
                    for row, a in zip(rows, part):
                        if min(a.strides, default=0) < 0:  # torch takes no negative stride
                            a = np.ascontiguousarray(a)
                        row.copy_(torch.from_numpy(a))
                    profiling.count("engine.pinned_frames", len(part))
                with profiling.span("tce.engine.preprocess.h2d", len(part)):
                    self._send(out[s:s + len(part)], rows)
        return out


class IntStage(_HostStage):
    """The small integer inputs of a dispatch (token ids, attention masks,
    the clip's size) to the device as one int64 vector, through the
    stage's int64 buffer in one copy, without waiting for the stream. One
    per engine."""

    dtype = torch.int64

    def upload(self, arrays: Sequence[np.ndarray], out: torch.Tensor) -> torch.Tensor:
        """The arrays' values, flattened and joined in order, into the
        int64 vector ``out`` of as many elements."""
        parts = [np.asarray(a).reshape(-1) for a in arrays]
        n = sum(p.size for p in parts)
        if out.numel() != n:
            raise ValueError(f"{n} values for {out.numel()} elements")
        with self.lock:
            self._wait()
            flat, _ = self._host(n)
            host = flat.numpy()
            off = 0
            for p in parts:
                host[off:off + p.size] = p
                off += p.size
            self._send(out, flat)
        return out


# ---------------------------------------------------------------------------
# the trunk's memory envelope: how many (expression x frame) frames one
# text-conditioned trunk dispatch may hold.
#
# Peak memory of one trunk forward (torch.cuda.max_memory_allocated, the
# weights and the window's backbone features resident) on an H100 80GB HBM3
# at 384x640, fitted per compute dtype over (E, T) points with E x T from 5
# to 160 by chip_smoke.py's envelope phase (PERF.md):
#     bf16: peak_gib ~= 0.4401 + 0.18243 * (E * T), largest residual 0.1800
#     f32:  peak_gib ~= 0.7314 + 0.35083 * (E * T), largest residual 0.3102
# The base below adds the largest residual, the slope is rounded up.
# Activations scale with the padded pixel count, so other buckets scale the
# slope by (h * w) / (384 * 640).
# The line holds only while no activation grows faster than E x T. The
# FPN's V-L self-attention over a clip's T x 240 pixels (at 384x640) and
# LastLayerAsToken's over its T x 60 coarsest tokens (f_token < 0) have
# logits quadratic in T: at T = 160 one expression's V-L logits and
# probabilities would take 88 GiB. ``layers.MultiheadAttention`` computes
# them in chunks of at most ``ATTN_LOGITS_CHUNK`` logits, which keeps the
# peak linear in E x T.
# The line is the eager forward's. What an engine keeps for the CUDA graphs
# of its small dispatches (``TrunkGraphs``, ``BackboneGraphs``: static inputs
# and outputs, the pools) lies outside it, in the 1 - _MEMORY_SAFETY of the
# card the cap leaves free (chip_smoke.py's envelope phase holds it there).
# ---------------------------------------------------------------------------

_ENVELOPE_GIB = {  # compute dtype -> (base, per frame at 384x640)
    "bfloat16": (0.62, 0.183),
    "float32": (1.04, 0.352),
}
_MEMORY_SAFETY = 0.85
_CPU_MEMORY_GIB = 16.0  # stated default for the CPU: caps no small test shape


def trunk_frame_envelope(
    hw: Tuple[int, int] = (384, 640),
    compute_dtype: str = "bfloat16",
    memory_gib: Optional[float] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> int:
    """The most E*T frames one trunk dispatch may take at the padded size
    ``hw``. ``memory_gib`` defaults to the CUDA device's total memory, or
    ``_CPU_MEMORY_GIB`` on the CPU."""
    if memory_gib is None:
        dev = torch.device("cpu" if device is None else device)
        memory_gib = (torch.cuda.get_device_properties(dev).total_memory / 2**30
                      if dev.type == "cuda" else _CPU_MEMORY_GIB)
    base, per_frame = _ENVELOPE_GIB[compute_dtype]
    scale = (hw[0] * hw[1]) / (384.0 * 640.0)
    return max(1, int((memory_gib * _MEMORY_SAFETY - base) / (per_frame * scale)))


# ---------------------------------------------------------------------------
# the trunk from CUDA graphs.
#
# A trunk dispatch issues some 1,500 launches. At small E x T the host takes
# longer to issue them than the device takes to run them, and the device
# waits between launches; a CUDA graph of the dispatch issues them all in a
# few graph launches. GRAPH_MAX_EXPFRAMES: the largest dispatch, in
# expression-frames of bf16 features at 384x640, whose eager host time
# still exceeded its device time on an H100 80GB HBM3 at 700 W (PERF.md
# gives the readings): E x T = 20 took the host 74.5 ms to issue and the
# device 49.5 ms to run from its graphs; at 24, 49.5 and 65.7 ms. A bucket
# of another size counts in proportion to its pixels, wider features in
# proportion to their bytes: the graphs keep their captures' working set
# in their pool for the engine's life, which must fit in the share of the
# card the trunk's memory envelope leaves free (counted in f32's bytes, two
# shapes of 5 and 20 expression-frames kept 12.2 GiB, over it).
# GRAPH_KEYS: the most dispatch shapes an engine keeps captured, the least
# recently used dropped first; eight kept 6.4 GiB in bf16 and 6.5 GiB in
# f32, with 11.9 GiB free beside the envelope (chip_smoke.py's envelope
# phase holds it).
# ---------------------------------------------------------------------------

GRAPH_MAX_EXPFRAMES = 20
GRAPH_KEYS = 8


def graph_gate(e_pad: int, t_clip: int, hw: Tuple[int, int], dtype: torch.dtype,
               device: Union[str, torch.device]) -> bool:
    """Whether a trunk dispatch of ``e_pad`` expressions over ``t_clip``
    frames padded to ``hw``, its features in ``dtype``, replays from CUDA
    graphs: on a CUDA device, at most ``GRAPH_MAX_EXPFRAMES``
    expression-frames of bf16 features at 384x640 (another size in
    proportion to its pixels, another dtype to its bytes). Never on the
    CPU."""
    nbytes = e_pad * t_clip * hw[0] * hw[1] * torch.empty((), dtype=dtype).element_size()
    return torch.device(device).type == "cuda" and nbytes <= GRAPH_MAX_EXPFRAMES * 384 * 640 * 2


class _Graphed(NamedTuple):
    """One dispatch shape's capture: the static inputs (the feature
    pyramid, the mask and the integer vector of ``InferenceEngine._inputs``),
    the recording (``profiling.recording``: CUDA graphs between the model's
    span boundaries, its spans and counts) and the static outputs."""

    feats: List[torch.Tensor]
    mask: torch.Tensor
    ints: torch.Tensor
    steps: List[tuple]
    outputs: Dict[str, torch.Tensor]


class _ShapeGraphs:
    """What the trunk's and the backbone's graphs share: one capture per
    dispatch shape in ``entries``, at most ``keys`` of them, the least
    recently used dropped first; every graph in one memory pool of their
    own; the captures on a side stream; ``lock`` held by each dispatch."""

    keys: int

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)  # the captures'
        self.entries: "collections.OrderedDict[tuple, NamedTuple]" = collections.OrderedDict()
        self.lock = threading.Lock()

    def _keep(self, key: tuple, entry) -> None:
        self.entries[key] = entry
        if len(self.entries) > self.keys:
            self.entries.popitem(last=False)

    def _record(self, fn):
        """(the recording's steps, ``fn()``): ``fn`` run on the side stream
        while its work is captured into CUDA graphs cut at the model's
        spans (``profiling.recording``)."""
        graphs: List[torch.cuda.CUDAGraph] = []

        def begin():
            graphs.append(torch.cuda.CUDAGraph())
            graphs[-1].capture_begin(pool=self.pool, capture_error_mode="thread_local")

        def end():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # a stretch without work is an empty graph
                graphs[-1].capture_end()
            return graphs[-1]

        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            with profiling.recording(begin, end) as steps:
                out = fn()
        return steps, out


class TrunkGraphs(_ShapeGraphs):
    """An engine's trunk dispatches replayed from CUDA graphs, one capture
    per dispatch shape (the expressions, the caption length, the clip's
    frames and padded size, the feature pyramid's shapes and dtype), at
    most ``GRAPH_KEYS`` of them, every graph in one memory pool.

    A shape's first dispatch runs eagerly, which warms it, and returns its
    outputs; the trunk is then captured at that shape on a side stream, in
    segments cut at the model's spans (``profiling.recording``). Each later
    dispatch copies its inputs into the capture's static inputs, replays
    the segments in order on the current stream under their spans
    (``profiling.replay``: the stage spans and the MSDA launch counts read
    as an eager run's) and returns clones of the static outputs, which the
    next replay of any shape may overwrite. Counters:
    ``engine.trunk_graph_captures``, ``engine.trunk_graph_replays``."""

    keys = GRAPH_KEYS

    def run(self, engine: "InferenceEngine", feats, mask, text_ids, text_attn,
            size) -> Dict[str, torch.Tensor]:
        key = (np.shape(text_ids), tuple(mask.shape),
               tuple((tuple(f.shape), f.dtype) for f in feats))
        with self.lock:
            entry = self.entries.get(key)
            if entry is None:
                out = engine._trunk_eager(feats, mask, text_ids, text_attn, size)
                self._keep(key, self._capture(engine, feats, mask, np.shape(text_ids)))
                profiling.count("engine.trunk_graph_captures")
                return out
            self.entries.move_to_end(key)
            for dst, src in zip(entry.feats, feats):
                dst.copy_(src)
            entry.mask.copy_(mask)
            engine._inputs(text_ids, text_attn, size, entry.ints)
            profiling.replay(entry.steps, torch.cuda.CUDAGraph.replay)
            profiling.count("engine.trunk_graph_replays")
            return {k: v.clone() for k, v in entry.outputs.items()}

    def _capture(self, engine: "InferenceEngine", feats, mask, text_shape) -> _Graphed:
        # zeros: valid token ids and mask values, though the capture reads none
        static_feats = [torch.zeros_like(f) for f in feats]
        static_mask = torch.zeros_like(mask)
        ints = torch.zeros(2 * int(np.prod(text_shape)) + 2, dtype=torch.int64,
                           device=self.device)
        steps, out = self._record(lambda: engine.model(
            None, static_mask, *_int_views(ints, text_shape), precomputed_feats=static_feats))
        return _Graphed(static_feats, static_mask, ints, steps,
                        {k: out[k] for k in OUTPUT_KEYS})


# ---------------------------------------------------------------------------
# the backbone from CUDA graphs.
#
# A backbone dispatch issues some 500 (ResNet-50) to 1,500 (Swin-L)
# launches; on a short window the device waits between them. Probed on an
# H100 80GB HBM3 at 700 W at 384x640 in bf16 (PERF.md), the eager dispatch's
# host time against its replay's device time, ms, at T = 5 / 8 / 10 / 16 /
# 20 frames:
#     ResNet-50:    5.2 / 7.7 / 7.5 / 10.9 / 9.1  against 3.5 / 5.3 / 6.2 / 9.7 / 11.9
#     Swin-L:       18.5 / 17.2 / 22.0 / 19.5 / 24.4  against 14.3 / 22.0 / 26.8 / 42.5 / 52.5
#     Video-Swin-B: 20.3 / 17.6 / 24.4 / 23.8 / 24.2  against 16.9 / 31.6 / 57.4 / 61.3 / 87.1
# BACKBONE_GRAPH_MAX_FRAMES: the largest window, in bf16 frames at 384x640,
# whose eager host time exceeded its replay's device time in every family:
# 5 (ResNet-50's alone pays to 16). Past it a replay frees little, and a
# capture keeps more: 0.23 / 0.71 / 0.74 GiB a shape at 5 frames, 0.34 /
# 1.05 / 1.53 at 8. BACKBONE_GRAPH_KEYS: the most window shapes an engine
# keeps captured; chip_smoke.py's envelope phase captures that many gated
# shapes on ResNet-50, Swin-L and Video-Swin-B and holds the most any of
# them keeps, with the trunk's eight shapes, within the share of the card
# the memory envelope leaves free (PERF.md). One bound for every family:
# the gate reads the window's bytes, not the backbone.
# ---------------------------------------------------------------------------

BACKBONE_GRAPH_MAX_FRAMES = 5
BACKBONE_GRAPH_KEYS = 4


def backbone_graph_gate(t: int, hw: Tuple[int, int], dtype: torch.dtype,
                        device: Union[str, torch.device]) -> bool:
    """Whether a backbone dispatch of ``t`` frames padded to ``hw``, cast to
    ``dtype``, replays from CUDA graphs: on a CUDA device, at most
    ``BACKBONE_GRAPH_MAX_FRAMES`` bf16 frames at 384x640 (another size in
    proportion to its pixels, another dtype to its bytes), whatever the
    backbone. Never on the CPU."""
    nbytes = t * hw[0] * hw[1] * torch.empty((), dtype=dtype).element_size()
    return (torch.device(device).type == "cuda"
            and nbytes <= BACKBONE_GRAPH_MAX_FRAMES * 384 * 640 * 2)


class _GraphedBackbone(NamedTuple):
    """One window shape's capture: the static inputs (the f32 video and
    its mask), the recording and the static feature maps."""

    video: torch.Tensor
    mask: torch.Tensor
    steps: List[tuple]
    feats: List[torch.Tensor]


class BackboneGraphs(_ShapeGraphs):
    """An engine's backbone dispatches replayed from CUDA graphs, as
    ``TrunkGraphs`` replays the trunk's: one capture per window shape (the
    video's and the mask's shapes; the engine's compute dtype is fixed),
    at most ``BACKBONE_GRAPH_KEYS`` of them, in a memory pool of their
    own. A
    shape's first dispatch runs eagerly and is then captured, cut at the
    model's spans; each later one copies the video and the mask into the
    static inputs, replays the segments under their spans (the backbone's
    and its stages' spans and the Swin token counts read as an eager
    run's) and returns clones of the static feature maps. Counters:
    ``engine.backbone_graph_captures``, ``engine.backbone_graph_replays``."""

    keys = BACKBONE_GRAPH_KEYS

    def run(self, engine: "InferenceEngine", video, mask) -> List[torch.Tensor]:
        key = (tuple(video.shape), tuple(mask.shape))
        with self.lock:
            entry = self.entries.get(key)
            if entry is None:
                out = engine._backbone_eager(video, mask)
                static_video, static_mask = torch.zeros_like(video), torch.zeros_like(mask)
                steps, feats = self._record(
                    lambda: engine._backbone_eager(static_video, static_mask))
                self._keep(key, _GraphedBackbone(static_video, static_mask, steps, feats))
                profiling.count("engine.backbone_graph_captures")
                return out
            self.entries.move_to_end(key)
            entry.video.copy_(video)
            entry.mask.copy_(mask)
            profiling.replay(entry.steps, torch.cuda.CUDAGraph.replay)
            profiling.count("engine.backbone_graph_replays")
            return [f.clone() for f in entry.feats]


def _int_views(flat: torch.Tensor, text_shape) -> Tuple[torch.Tensor, ...]:
    """(token ids [E, L], attention mask [E, L], sizes [1, 2]) in ``flat``."""
    n = int(np.prod(text_shape))
    return (flat[:n].view(*text_shape), flat[n:2 * n].view(*text_shape),
            flat[2 * n:].view(1, 2))


def _pow2_floor(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def _pow2_ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


class InferenceEngine:
    """Holds the model on one device (``cuda`` unless ``device="cpu"``) in
    the configured compute dtype. ``state_dict`` is in the reference torch
    layout (``utils/convert.py`` makes one from JAX variables,
    ``utils/checkpoint.py`` from a reference file) and loads strictly.
    ``t_bucket``: whole-video windows are rounded up to a multiple of it."""

    def __init__(
        self,
        cfg: ModelConfig,
        state_dict: Mapping[str, torch.Tensor],
        device: Optional[Union[str, torch.device]] = None,
        size: int = 360,
        max_size: int = 640,
        pad_mult: int = 64,
        window: Optional[int] = None,
        t_bucket: int = 8,
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
        self.t_bucket = t_bucket
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)[:, None, None]
        self._std = torch.tensor(IMAGENET_STD, device=self.device)[:, None, None]
        # the engine stages its frames through a buffer of its own (pinned
        # on CUDA); a CUDA engine replays small backbone and trunk dispatches
        self._stage = FrameStage(self.device)
        self._ints = IntStage(self.device)
        cuda = self.device.type == "cuda"
        self._backbone_graphs = BackboneGraphs(self.device) if cuda else None
        self._graphs = TrunkGraphs(self.device) if cuda else None

    # ------------------------------------------------------------------
    def _inputs(self, text_ids, text_attn, size, flat: Optional[torch.Tensor] = None):
        """(token ids [E, L], attention mask [E, L], sizes [1, 2]) as int64
        views of one vector on the device (``flat``, a capture's static
        inputs, if given), sent up through the engine's ``IntStage`` in one
        copy; ``size`` is the clip's unpadded (h, w)."""
        ids = np.asarray(text_ids)
        if flat is None:
            flat = torch.empty(2 * ids.size + 2, dtype=torch.int64, device=self.device)
        self._ints.upload([ids, text_attn, size], flat)
        return _int_views(flat, ids.shape)

    def on_device(self):
        """The context a thread serving this engine runs under: its CUDA
        device current (the kernels launch on the current device's stream)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def model_size(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        return get_size_with_aspect_ratio(hw, self.size, self.max_size)

    def preprocess(self, frames: List[np.ndarray]):
        """Resize (short side ``size``, long side <= ``max_size``; bilinear,
        align_corners=False), normalise, pad to the ``pad_mult`` bucket.
        Returns (video [1, t, Hp, Wp, 3] f32, mask [1, t, Hp, Wp] True on
        padding, (oh, ow)) on the engine's device. The frames go up
        through the engine's ``FrameStage``."""
        t = len(frames)
        with profiling.span("tce.engine.preprocess", t):
            h, w = frames[0].shape[:2]
            oh, ow = self.model_size((h, w))
            x = self._stage.upload(frames)
            with profiling.span("tce.engine.preprocess.resize", t):
                x = x.permute(0, 3, 1, 2)  # [t, 3, h, w]
                if (oh, ow) != (h, w):
                    x = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False)
                x = (x - self._mean) / self._std
                hp, wp = _pad_to(oh, self.pad_mult), _pad_to(ow, self.pad_mult)
                video = torch.zeros((1, t, hp, wp, 3), dtype=torch.float32, device=self.device)
                video[0, :, :oh, :ow] = x.permute(0, 2, 3, 1)
                mask = torch.ones((1, t, hp, wp), dtype=torch.bool, device=self.device)
                mask[0, :, :oh, :ow] = False
        return video, mask, (oh, ow)

    @torch.inference_mode()
    def run_window(self, video, mask, text_ids, text_attn, model_size) -> Dict[str, torch.Tensor]:
        """Full forward of one padded clip -> the output tensors."""
        out = self.model(video.to(self.dtype), mask,
                         *self._inputs(text_ids, text_attn, model_size))
        return {k: out[k] for k in OUTPUT_KEYS}

    @torch.inference_mode()
    def backbone(self, video, mask) -> List[torch.Tensor]:
        """Text-independent half: the feature pyramid of one clip window. A
        window that ``backbone_graph_gate`` passes replays from the
        engine's ``BackboneGraphs``; the others run eagerly
        (``engine.backbone_graph_eager``)."""
        t = video.shape[0] * video.shape[1]
        with profiling.span("tce.engine.backbone", video.shape[1]):
            if backbone_graph_gate(t, tuple(video.shape[2:4]), self.dtype, self.device):
                return self._backbone_graphs.run(self, video, mask)
            profiling.count("engine.backbone_graph_eager")
            return self._backbone_eager(video, mask)

    @torch.inference_mode()
    def _backbone_eager(self, video, mask) -> List[torch.Tensor]:
        """The backbone's dispatch run eagerly, outside its span: what a
        replay reproduces, and what a module's forward hooks see."""
        return self.model(video.to(self.dtype), mask, backbone_only=True)

    @torch.inference_mode()
    def trunk(self, feats, mask, text_ids, text_attn, size) -> Dict[str, torch.Tensor]:
        """Text-conditioned half over precomputed features; the text batch
        E tiles the video axis inside the model. ``size``: the clip's
        unpadded (h, w), as ``preprocess`` returns it. Its span's units are the
        expression-frames it computes, padding included. A dispatch that
        ``graph_gate`` passes replays from the engine's ``TrunkGraphs``; the
        others run eagerly (``engine.trunk_graph_eager``)."""
        e_pad, t_clip = len(text_ids), mask.shape[1]
        with profiling.span("tce.engine.trunk", e_pad * t_clip):
            if graph_gate(e_pad, t_clip, tuple(mask.shape[2:]), feats[0].dtype, self.device):
                return self._graphs.run(self, feats, mask, text_ids, text_attn, size)
            profiling.count("engine.trunk_graph_eager")
            return self._trunk_eager(feats, mask, text_ids, text_attn, size)

    @torch.inference_mode()
    def _trunk_eager(self, feats, mask, text_ids, text_attn, size) -> Dict[str, torch.Tensor]:
        """The trunk's dispatch run eagerly, outside its span: what a
        replay reproduces, and what a module's forward hooks see."""
        out = self.model(None, mask, *self._inputs(text_ids, text_attn, size),
                         precomputed_feats=feats)
        return {k: out[k] for k in OUTPUT_KEYS}

    def window_length(self, t_total: int, whole_video: bool = False) -> int:
        """Core frames of a window: ``window``, or the whole video rounded
        up to a multiple of ``t_bucket``."""
        if whole_video:
            return max(-(-t_total // self.t_bucket) * self.t_bucket, self.t_bucket)
        return self.window

    def windows(self, t_total: int, f_extra: int = 0,
                whole_video: bool = False) -> Iterator[Tuple[List[int], int]]:
        """(frame indices of each clip, its number of core frames). A clip
        is ``f_extra`` context frames, the core frames and ``f_extra`` more,
        clamped to the video, then padded to ``win + 2 * f_extra`` by
        repeating its last frame; outputs ``f_extra .. f_extra + n_core``
        are kept."""
        win = self.window_length(t_total, whole_video)
        for start in range(0, t_total, win):
            core = list(range(start, min(start + win, t_total)))
            ext = ([max(core[0] - k, 0) for k in range(f_extra, 0, -1)] + core
                   + [min(core[-1] + k, t_total - 1) for k in range(1, f_extra + 1)])
            ext += ext[-1:] * (win + 2 * f_extra - len(ext))
            yield ext, len(core)

    def run_video(self, frames: List[np.ndarray], caption: str, f_extra: int = 0,
                  whole_video: bool = False) -> Dict[str, np.ndarray]:
        """Serial path: one expression, the full model per window."""
        text_ids, text_attn = tokenize([caption])
        acc: Dict[str, List[np.ndarray]] = {k: [] for k in OUTPUT_KEYS}
        model_size = None
        for ext, n_core in self.windows(len(frames), f_extra, whole_video):
            video, mask, model_size = self.preprocess([frames[i] for i in ext])
            out = self.run_window(video, mask, text_ids, text_attn, model_size)
            sl = slice(f_extra, f_extra + n_core)
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
        f_extra: int = 0,
        whole_video: bool = False,
        exp_batch: int = 8,
    ) -> List[Dict[str, np.ndarray]]:
        """Serving path for a video with E expressions; one
        ``run_video``-format dict per caption. ``exp_batch`` is capped by
        ``trunk_frame_envelope`` at the padded size, floored to a power of
        two (the padded chunk width), in both window modes. Traced, the
        request's span counts its real expression-frames, and the counters
        ``engine.trunk_dispatches``, ``engine.trunk_expframes`` (computed,
        padded frames and expressions included) and
        ``engine.trunk_expframes_real`` (returned) its trunk work."""
        with profiling.span("tce.engine.request", len(frames) * len(captions)):
            return self._run_video_batch(frames, captions, f_extra, whole_video, exp_batch)

    def _run_video_batch(self, frames, captions, f_extra, whole_video, exp_batch):
        n_exp = len(captions)
        t_clip = self.window_length(len(frames), whole_video) + 2 * f_extra
        oh, ow = self.model_size(frames[0].shape[:2])
        bucket = (_pad_to(oh, self.pad_mult), _pad_to(ow, self.pad_mult))
        cap = trunk_frame_envelope(bucket, self.cfg.compute_dtype, device=self.device) // t_clip
        exp_batch = max(1, min(exp_batch, _pow2_floor(max(cap, 1))))
        text_ids, text_attn = tokenize([str(c) for c in captions])
        chunks: List[Tuple[int, int, int]] = []  # (offset, n_real, n_padded)
        for off in range(0, n_exp, exp_batch):
            n = min(exp_batch, n_exp - off)
            chunks.append((off, n, _pow2_ceil(n)))

        acc = [{k: [] for k in OUTPUT_KEYS} for _ in range(n_exp)]
        model_size = None
        for ext, n_core in self.windows(len(frames), f_extra, whole_video):
            video, mask, model_size = self.preprocess([frames[i] for i in ext])
            feats = self.backbone(video, mask)
            sl = slice(f_extra, f_extra + n_core)
            for c_off, n_real, n_pad in chunks:
                ids = text_ids[c_off : c_off + n_real]
                attn = text_attn[c_off : c_off + n_real]
                if n_pad != n_real:  # pad rows are duplicates, discarded
                    ids = np.concatenate([ids, np.repeat(ids[:1], n_pad - n_real, 0)])
                    attn = np.concatenate([attn, np.repeat(attn[:1], n_pad - n_real, 0)])
                out = self.trunk(feats, mask, ids, attn, model_size)
                profiling.count("engine.trunk_dispatches")
                profiling.count("engine.trunk_expframes", n_pad * t_clip)
                profiling.count("engine.trunk_expframes_real", n_real * n_core)
                with profiling.span("tce.engine.outputs", n_real * n_core):
                    host = {k: _numpy(out[k]) for k in OUTPUT_KEYS}
                samples = host["inter_samples"][-1]
                samples = samples.reshape((n_pad, t_clip) + samples.shape[1:])
                for e in range(n_real):
                    a = acc[c_off + e]
                    for k in OUTPUT_KEYS[:-1]:
                        a[k].append(host[k][e, sl])
                    a["inter_samples"].append(samples[e, sl])
        return [
            {**{k: np.concatenate(a[k]) for k in OUTPUT_KEYS}, "model_size": model_size}
            for a in acc
        ]


def make_engines(
    cfg: ModelConfig,
    state_dict: Mapping[str, torch.Tensor],
    num_devices: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    **engine_kw,
) -> List[InferenceEngine]:
    """One engine per GPU (``cuda:0``, ``cuda:1``, ...; at most
    ``num_devices``, 0 = all), or one on the named device. On the CPU,
    ``num_devices`` engines (at least one) share it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = devices[:num_devices] if num_devices else devices
    elif dev.type == "cuda":
        devices = [dev]
    else:
        devices = [dev] * max(1, num_devices)
    return [InferenceEngine(cfg, state_dict, device=d, **engine_kw) for d in devices]


def _fanout(engines: Sequence[InferenceEngine], jobs: Sequence, fn) -> None:
    """Round-robin ``jobs`` over the engines, one worker thread each, under
    its engine's device; the host work (decoding, PNG encoding) of one
    worker overlaps the device work of the others. The first error is
    raised in the caller."""
    if len(engines) == 1:
        with engines[0].on_device():
            for job in jobs:
                fn(engines[0], job)
        return
    import queue
    import threading

    q: "queue.Queue" = queue.Queue()
    for job in jobs:
        q.put(job)
    errors: List[BaseException] = []

    def worker(engine):
        with engine.on_device():
            while not errors:
                try:
                    job = q.get_nowait()
                except queue.Empty:
                    return
                try:
                    fn(engine, job)
                except BaseException as e:  # noqa: BLE001 - raised in the caller
                    errors.append(e)
                    return

    threads = [threading.Thread(target=worker, args=(e,), daemon=True) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _as_engines(engine) -> List[InferenceEngine]:
    return [engine] if isinstance(engine, InferenceEngine) else list(engine)


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


def save_visualization(
    frames: List[np.ndarray],       # raw RGB floats in [0, 1], original size
    frame_names: Sequence[str],
    scores: np.ndarray,             # [T, H, W] sigmoid mask scores
    boxes: np.ndarray,              # [T, 4] normalized cxcywh
    ref_points: np.ndarray,         # [T, 2] normalized (x, y)
    samples: np.ndarray,            # [T, S, 2] normalized sampling locations
    out_dir: str,
    color=(255, 144, 30),
    threshold: float = 0.5,
) -> None:
    """Qualitative overlay per frame: the mask blended in, the predicted
    box, the decoder's reference point as a cross and the top-30 deformable
    sampling locations as dots."""
    from PIL import Image, ImageDraw

    os.makedirs(out_dir, exist_ok=True)
    col = np.asarray(color, np.float32)
    for t, (frame, name) in enumerate(zip(frames, frame_names)):
        h, w = frame.shape[:2]
        img = (frame * 255).astype(np.uint8).copy()
        m = scores[t] > threshold
        img[m] = (0.5 * img[m] + 0.5 * col).astype(np.uint8)
        pil = Image.fromarray(img)
        draw = ImageDraw.Draw(pil)
        cx, cy, bw, bh = boxes[t]
        x0, y0 = (cx - bw / 2) * w, (cy - bh / 2) * h
        x1, y1 = (cx + bw / 2) * w, (cy + bh / 2) * h
        draw.rectangle((x0, y0, x1, y1), outline=tuple(color), width=2)
        rx, ry = ref_points[t][0] * w, ref_points[t][1] * h
        draw.line((rx - 10, ry, rx + 10, ry), fill=tuple(color), width=4)
        draw.line((rx, ry - 10, rx, ry + 10), fill=tuple(color), width=4)
        for sx, sy in samples[t]:
            px, py = sx * w, sy * h
            draw.ellipse((px - 2, py - 2, px + 2, py + 2), fill=tuple(color))
        pil.save(os.path.join(out_dir, name + ".png"))


# ---------------------------------------------------------------------------
# protocols
# ---------------------------------------------------------------------------


def ytvos_video_list(ytvos_path: str, split: str = "valid") -> Tuple[List[str], Dict]:
    """(the split's videos minus those the test split lists, sorted; the
    split's meta_expressions ``videos`` dict)."""
    meta_file = os.path.join(ytvos_path, "meta_expressions", split, "meta_expressions.json")
    with open(meta_file) as fh:
        data = json.load(fh)["videos"]
    test_meta = os.path.join(ytvos_path, "meta_expressions", "test", "meta_expressions.json")
    if os.path.exists(test_meta):
        with open(test_meta) as fh:
            test_videos = set(json.load(fh)["videos"].keys())
        videos = sorted(set(data.keys()) - test_videos)
    else:
        videos = sorted(data.keys())
    return videos, data


def _load_video(img_root: str, video: str, frame_names: Sequence[str]) -> List[np.ndarray]:
    return [_load_frame(os.path.join(img_root, video, f + ".jpg")) for f in frame_names]


def _caption(exp: str) -> str:
    return " ".join(exp.lower().split())


def _save_binary(scores: np.ndarray, frame_names: Sequence[str], save_dir: str,
                 threshold: float) -> None:
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    for i, name in enumerate(frame_names):
        m = (scores[i] > threshold).astype(np.uint8) * 255
        Image.fromarray(m).save(os.path.join(save_dir, name + ".png"))


def _query_scores(eng: InferenceEngine, out: Dict[str, np.ndarray], orig_hw) -> Tuple[int, np.ndarray]:
    """(the query chosen for the video, its scores at the original size)."""
    q = select_query(out["pred_logits"])
    return q, masks_to_original(out["pred_masks"][:, q], out["model_size"], orig_hw,
                                device=eng.device)


def run_ytvos(
    engine,
    ytvos_path: str,
    output_dir: str,
    split: str = "valid",
    threshold: float = 0.5,
    f_extra: int = 0,
    videos: Optional[Sequence[str]] = None,
    whole_video: bool = True,
    visualize: bool = False,
    exp_batch: int = 8,
):
    """Write per-frame binary PNGs to ``<out>/<split>/<video>/<exp_id>/``.
    ``whole_video`` (the default) runs each video in one window; False is
    the windowed protocol. ``engine`` is one engine or a list from
    ``make_engines``. ``visualize`` also writes overlays under
    ``<out>/<split>_vis/``, in a colour chosen by the expression id."""
    from tce_rvos_tpu_torch.tools.colormap import colormap

    engines = _as_engines(engine)
    video_list, data = ytvos_video_list(ytvos_path, split)
    if videos is not None:
        allowed = set(videos)
        video_list = [v for v in video_list if v in allowed]
    img_root = os.path.join(ytvos_path, split, "JPEGImages")
    save_root = os.path.join(output_dir, split)
    colors = colormap(rgb=True)
    t0 = time.time()
    n_frames = [0]

    def one_video(eng, video):
        frame_names = data[video]["frames"]
        frames = _load_video(img_root, video, frame_names)
        orig_hw = frames[0].shape[:2]
        exps = list(data[video]["expressions"].items())
        outs = eng.run_video_batch(frames, [_caption(d["exp"]) for _, d in exps],
                                   f_extra=f_extra, whole_video=whole_video,
                                   exp_batch=exp_batch)
        for (exp_id, _), out in zip(exps, outs):
            q, scores = _query_scores(eng, out, orig_hw)
            _save_binary(scores, frame_names, os.path.join(save_root, video, exp_id), threshold)
            if visualize:
                # crc32 rather than hash(): the same colour in every process
                ci = int(exp_id) if exp_id.isdigit() else zlib.crc32(exp_id.encode())
                save_visualization(
                    frames, frame_names, scores, out["pred_boxes"][:, q],
                    out["reference_points"][:, q], out["inter_samples"][:, q],
                    os.path.join(output_dir, f"{split}_vis", video, exp_id),
                    color=tuple(int(c) for c in colors[ci % len(colors)]),
                    threshold=threshold,
                )
            n_frames[0] += len(frame_names)

    _fanout(engines, video_list, one_video)
    print(f"Total inference time: {time.time() - t0:.4f} s ({n_frames[0]} frames)")


def run_davis(
    engine,
    davis_path: str,
    output_dir: str,
    split: str = "valid",
    threshold: float = 0.5,
    videos: Optional[Sequence[str]] = None,
    exp_batch: int = 8,
):
    """The 4-annotator protocol: per annotator, every object's expression,
    objects merged by argmax over [0.1 background, scores below the
    threshold set to 0], palette PNGs under
    ``<out>/<split>/anno_<k>/<video>/<frame>.png``."""
    from PIL import Image

    meta_file = os.path.join(davis_path, "meta_expressions", split, "meta_expressions.json")
    with open(meta_file) as fh:
        data = json.load(fh)["videos"]
    engines = _as_engines(engine)
    video_list = sorted(data.keys()) if videos is None else sorted(videos)
    img_root = os.path.join(davis_path, split, "JPEGImages")
    palette = davis_palette()
    t0 = time.time()

    def one_video(eng, video):
        frame_names = data[video]["frames"]
        frames = _load_video(img_root, video, frame_names)
        orig_hw = frames[0].shape[:2]
        expressions = data[video]["expressions"]
        exp_ids = sorted(expressions.keys(), key=int)
        num_obj = len(exp_ids) // 4
        # one batched pass over all num_obj x 4 annotator expressions
        outs = eng.run_video_batch(frames, [_caption(expressions[e]["exp"]) for e in exp_ids],
                                   exp_batch=exp_batch)
        for anno_id in range(4):
            anno = np.stack([_query_scores(eng, outs[obj_id * 4 + anno_id], orig_hw)[1]
                             for obj_id in range(num_obj)])  # [num_obj, T, H, W]
            anno[anno < threshold] = 0.0
            bg = np.full((1,) + anno.shape[1:], 0.1, anno.dtype)
            merged = np.argmax(np.concatenate([bg, anno]), axis=0).astype(np.uint8)
            save_dir = os.path.join(output_dir, split, f"anno_{anno_id}", video)
            os.makedirs(save_dir, exist_ok=True)
            for i in range(merged.shape[0]):
                img = Image.fromarray(merged[i])
                img.putpalette(palette)
                # named after the frame (the reference numbers them 00000, ...:
                # the same on the standard layout)
                img.save(os.path.join(save_dir, f"{frame_names[i]}.png"))

    _fanout(engines, video_list, one_video)
    print(f"Total inference time: {time.time() - t0:.4f} s")


def run_mevis(
    engine,
    mevis_path: str,
    output_dir: str,
    split: str = "valid",
    threshold: float = 0.5,
    videos: Optional[Sequence[str]] = None,
    exp_batch: int = 8,
):
    """MeViS inference with the ytvos windowed protocol: binary PNGs under
    ``<out>/<split>/<video>/<exp_id>/``."""
    meta_file = os.path.join(mevis_path, split, "meta_expressions.json")
    with open(meta_file) as fh:
        data = json.load(fh)["videos"]
    engines = _as_engines(engine)
    video_list = sorted(data.keys()) if videos is None else sorted(videos)
    img_root = os.path.join(mevis_path, split, "JPEGImages")
    t0 = time.time()

    def one_video(eng, video):
        frame_names = data[video]["frames"]
        frames = _load_video(img_root, video, frame_names)
        orig_hw = frames[0].shape[:2]
        exps = list(data[video]["expressions"].items())
        outs = eng.run_video_batch(frames, [_caption(d["exp"]) for _, d in exps],
                                   exp_batch=exp_batch)
        for (exp_id, _), out in zip(exps, outs):
            _, scores = _query_scores(eng, out, orig_hw)
            _save_binary(scores, frame_names, os.path.join(output_dir, split, video, exp_id),
                         threshold)

    _fanout(engines, video_list, one_video)
    print(f"Total inference time: {time.time() - t0:.4f} s")


def main(argv=None):
    """The inference command line (the JAX package's flags and defaults,
    plus ``--device`` and ``--trace_dir``)."""
    import argparse

    from tce_rvos_tpu_torch.cli import add_model_args

    p = argparse.ArgumentParser("tce_rvos_tpu_torch inference")
    add_model_args(p)
    p.add_argument("--dataset_file", default="ytvos", choices=["ytvos", "davis", "mevis"])
    p.add_argument("--ytvos_path", default="data/Refer_YouTube_VOS/rvos")
    p.add_argument("--davis_path", default="/data/davis17")
    p.add_argument("--mevis_path", default="data/MeViS")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--split", default="valid")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--resume", default="")
    p.add_argument("--window", type=int, default=0,
                   help="frames per clip window (0 = num_frames; davis default 32)")
    p.add_argument("--num_devices", "--ngpu", type=int, default=0, dest="num_devices",
                   help="GPUs to fan videos out over (0 = all)")
    p.add_argument("--visualize", action="store_true",
                   help="save qualitative overlays (mask/box/ref/sampling points)")
    p.add_argument("--exp_batch", type=int, default=8,
                   help="expressions batched per trunk forward (backbone runs "
                        "once per window either way); 1 disables batching")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--trace_dir", default="",
                   help="run the job under the profiler with the program's spans and "
                        "counters on, and write trace.json and spans.json there (the "
                        "records stay in memory until the job ends: for short jobs)")
    args = p.parse_args(argv)
    with profiling.trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext():
        _infer(args)


def _infer(args) -> None:
    from tce_rvos_tpu_torch.cli import model_config_from_args
    from tce_rvos_tpu_torch.models.build import build_model
    from tce_rvos_tpu_torch.models.text_encoder import require_real_tokenizer
    from tce_rvos_tpu_torch.utils.checkpoint import convert_state_dict, load_torch_file

    cfg = model_config_from_args(args)
    device = resolve_device(args.device)
    if args.resume:
        require_real_tokenizer("--resume checkpoint")
    # the model's own init from a fixed seed, then the checkpoint over it
    state_dict = build_model(cfg, device="cpu", seed=0).state_dict()
    if args.resume:
        state_dict, _, _ = convert_state_dict(load_torch_file(args.resume), state_dict)

    window = args.window or (32 if args.dataset_file == "davis" else cfg.num_frames)
    engines = make_engines(cfg, state_dict, args.num_devices, device=device, window=window)
    if args.dataset_file == "ytvos":
        run_ytvos(engines, args.ytvos_path, args.output_dir, args.split, args.threshold,
                  cfg.f_extra, visualize=args.visualize, exp_batch=args.exp_batch)
    elif args.dataset_file == "davis":
        run_davis(engines, args.davis_path, args.output_dir, args.split, args.threshold,
                  exp_batch=args.exp_batch)
    else:
        run_mevis(engines, args.mevis_path, args.output_dir, args.split, args.threshold,
                  exp_batch=args.exp_batch)


if __name__ == "__main__":
    main()
