"""The one traffic generator. A mix is a data file,
``benchmark/traffic/<mix>.json``; this reads it and, from the run's seed,
makes the inputs: a pool of frames, the captions and the order of the
mix's fixed multiset of request shapes (serving), or a pool of training
batches (training). Every seed gets the same multiset of shapes in another
order, so the draw changes the values and the order, not the work.

``kind`` names the mix's runner, the module ``benchmark/harness/<kind>.py``
(``serve``, ``train``), so a new kind of traffic comes as a new module.
Serving keys: ``frame_hw``, ``frames`` and ``expressions`` (the multiset is
their product, ``repeat`` times), ``caption_words``, ``pool_frames``,
``whole_video``, ``t_bucket``, ``window``, ``f_extra``, ``exp_batch``,
``engine`` (the engine's resize: ``size``, ``max_size``, ``pad_mult``),
``check`` (the sample compared with the reference), ``profile_seconds``.
Training keys: ``frames``, ``frame_hw``, ``batch``, ``caption_words``,
``pool_batches``, ``check_steps``, ``profile_steps``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence

import numpy as np
import torch

# captions are drawn from these words, a fixed number a caption, so that
# every caption has the same number of tokens whatever the seed
WORDS = (
    "the a person man woman child dog cat horse bird car bike boat ball "
    "left right front back near far big small white black brown red green "
    "blue yellow running walking riding jumping holding sitting standing "
    "playing turning moving carrying on in under behind beside with of "
    "street beach field road water grass snow wall table door window tree"
).split()


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed (any size of int)."""
    return np.random.default_rng([stream, seed % 2**63, seed // 2**63])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 2**62)))
    return g


def captions(r: np.random.Generator, n: int, words: int) -> List[str]:
    return [" ".join(r.choice(WORDS, size=words)) for _ in range(n)]


def frame_pool(seed: int, n: int, hw: Sequence[int], device) -> List[np.ndarray]:
    """``n`` smooth random RGB frames in [0, 1] (float32 [h, w, 3], on the
    host, as a decoder gives them), made on ``device`` in a few calls:
    each channel a sine of a random direction and phase, drifting from
    frame to frame, plus 5% noise."""
    g = torch_generator(seed, 1, device)
    h, w = hw
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :, None]
    abc = torch.rand(n, 3, 3, generator=g, device=device)
    noise = torch.rand(n, h, w, 3, generator=g, device=device)
    out = []
    for t in range(n):
        a, b, c = abc[t, :, 0], abc[t, :, 1], abc[t, :, 2]
        f = 0.5 + 0.5 * torch.sin((xx * a + yy * b) / 40.0 + t * 0.3 + c)
        out.append((f + 0.05 * noise[t]).clamp_(0, 1))
    host = torch.stack(out).cpu().numpy()
    return [host[t] for t in range(n)]


@dataclasses.dataclass
class Request:
    index: int
    frames: int          # T, the video's frames
    expressions: int     # E, its captions
    first: int           # its first frame in the pool (then cyclic)
    captions: List[str]


class ServeTraffic:
    """The closed loop's requests in order: cycles of the multiset, each a
    seeded permutation, over a seeded frame pool and captions."""

    def __init__(self, mix: Dict, seed: int, device):
        self.mix = mix
        self.seed = seed
        shapes = [(t, e) for t, e in itertools.product(mix["frames"], mix["expressions"])]
        self.shapes = shapes * int(mix.get("repeat", 1))
        self.pool = frame_pool(seed, int(mix["pool_frames"]), mix["frame_hw"], device)
        self._rng = rng(seed, 2)
        self._requests: List[Request] = []

    @property
    def cycle(self) -> int:
        return len(self.shapes)

    def request(self, i: int) -> Request:
        while len(self._requests) <= i:
            for k in self._rng.permutation(len(self.shapes)):
                t, e = self.shapes[k]
                self._requests.append(Request(
                    len(self._requests), t, e, int(self._rng.integers(0, len(self.pool))),
                    captions(self._rng, e, int(self.mix["caption_words"]))))
        return self._requests[i]

    def frames_of(self, req: Request) -> List[np.ndarray]:
        return [self.pool[(req.first + k) % len(self.pool)] for k in range(req.frames)]


def train_batches(mix: Dict, seed: int, device) -> List[Dict]:
    """``pool_batches`` distinct training batches in ``collate_batch``'s
    format, as numpy on the host: b clips of t frames of N(0, 1) pixels,
    one caption each, label 0, random cxcywh boxes, random binary masks,
    every frame valid (the recipe of the port's card smoke test). Made on
    ``device`` in bulk."""
    from reference.text_encoder import tokenize

    b, t = int(mix["batch"]), int(mix["frames"])
    h, w = mix["frame_hw"]
    n = int(mix["pool_batches"])
    g = torch_generator(seed, 3, device)
    video = torch.randn(n, b, t, h, w, 3, generator=g, device=device).cpu().numpy()
    masks = (torch.rand(n, b, t, h, w, generator=g, device=device) > 0.5).float().cpu().numpy()
    boxes = torch.rand(n, b, t, 4, generator=g, device=device).cpu().numpy()
    r = rng(seed, 4)
    out = []
    for i in range(n):
        ids, attn = tokenize(captions(r, b, int(mix["caption_words"])))
        out.append({"video": video[i], "video_mask": np.zeros((b, t, h, w), bool),
                    "text_ids": ids, "text_attn_mask": attn,
                    "sizes": np.asarray([[h, w]] * b, np.int32),
                    "targets": {"labels": np.zeros((b, t), np.int32), "boxes": boxes[i],
                                "masks": masks[i], "valid": np.ones((b, t), np.int32)}})
    return out
