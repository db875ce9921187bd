#!/usr/bin/env python3
"""The port's (``tce_rvos_tpu_torch``) correctness gate on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Every phase checks; nothing is caught and carried on from. The end-to-end
and per-layer performance of the port is measured by ``benchmark/``; this
script times only the kernels alone (the source of PERF.md's kernel table).

Phases:
  1. build   - compile every CUDA kernel from csrc/ (one nvcc per source,
               all started together), printing registers and spills;
  2. kernels - hold each kernel against its plain PyTorch version: the MSDA
               forward at the shapes the flagship serving path gives it,
               the MSDA backward (autograd through the plain version) at
               the training shapes (N = 5 frames; encoder Q = 5100, FTF
               Q = 8, decoder Q = 5 with 4-d refs), f32 and bf16, with
               out-of-range and pixel-centre taps; the 2D kernels' launch
               plan against its Python mirror; the 2D and 3D kernels on
               edge cases (a ragged query count, shuffled queries, far
               taps, x or y = -1, L = 3 and P = 2; in 3D also f_im = -1
               and N - 1, integer and halfway frames, frames past both
               ends, N = 1); each kernel's device time by graph replay and
               its bound; then the 2D and 3D kernels timed in turns against
               other builds of their entry points found in build/ab/
               (git-ignored), e.g. an earlier version's sources (phase_ab);
  3. path    - flagship model at full width (ResNet-50 + RoBERTa-base,
               f_token 8, IQT, box refine, binary) from seeded random
               weights; InferenceEngine.run_video_batch on a 10-frame
               360x640 video (two 5-frame windows) with E = 4 captions, in
               bf16 and f32; checks shapes, finiteness, boxes in [0, 1],
               12 MSDA kernel launches per trunk forward (the kernels the
               profiler saw run, a graph's replays among them, and the
               launch counters), the backbone replayed from its CUDA
               graphs at each window against the eager backbone (bitwise),
               expression isolation (bitwise), batched masks against serial
               run_video masks;
  4. parity  - one window, E = 1, f32 with TF32 off, GPU (kernel) against
               the same weights on the CPU (plain MSDA);
  5. train   - the flagship at full width and depth, b = 1, 5x384x640,
               random targets: train_one_epoch over 10 bf16 steps (f32
               master weights, dropout on); finite losses, a non-zero
               gradient on every trainable parameter, parameters moved,
               12 MSDA forward + 12 backward launches and one flat AdamW
               update launch per step (the default --flat_opt); the
               gradients of one f32 step with use_checkpoint (dropout off)
               held against one without (24 forward launches); bf16 steps
               with recomputation;
 5b. flat adamw - the fused flat AdamW's update kernel against its plain
               version, bitwise, at the flagship's 183,506,503 parameters
               (Adam steps 1 and 1000, the norm below and above the clip,
               weight decay 5e-4 and 0.1; the same gate refuses the kernel
               launched without decay or eps), its time by graph replay
               with its bound, the plain version's and torch.optim.AdamW's
               (fused, foreach; with the clip); the f32 step flat against
               --no-flat_opt (the loss bitwise equal, the largest parameter
               gap located); bf16 steps of both (one update launch a flat
               step, none a --no-flat_opt one);
  6. train parity - one f32 step (TF32 off, dropout off), GPU (kernels)
               against CPU (plain MSDA), full width on a 2x192x320 clip;
  7. 3D path - the temporal-MSDA flagship (``--msda_3d``: 3D MSDA in the
               encoder and decoder, 2D in FTF) from its own seeded weights
               (first, at two weight seeds, one f32 train step on the GPU
               and one on the CPU, each held against float64: the GPU no
               farther from it than the CPU's own f32 step plus the
               GPU-against-CPU limits):
               run_video_batch E = 4 in bf16 (8 3D + 4 2D forward launches
               per trunk forward, as phase 3 counts them; batched against
               serial masks printed as a reading, since the 3D op's time
               axis spans the expressions; where the encoder's taps land in
               time, a reading); one window at E = 2, f32, GPU against CPU;
               4 bf16 train steps (8 + 8 3D and 4 + 4 2D launches per step,
               a gradient on every parameter and on the temporal offset
               rows); one f32 train step GPU against CPU. The kernels phase
               holds the 3D forward at the serving shapes (N = 20 and 5) and
               the 3D backward at the training shapes (N = 5, and N = 10
               with taps crossing clips), with frames past both ends of the
               axis, exact-integer and halfway frames;
  8. protocols - the trunk's peak memory at (E, T) points per compute
               dtype, fitted and held under ``infer._ENVELOPE_GIB``, and the
               memory the backbone's and the trunk's CUDA graphs keep; on
               synthetic trees of
               720x1280 JPEG frames: ytvos whole-video in bf16 (PNGs bitwise
               the threshold of run_video_batch on the same engine, 12 2D
               forward launches per trunk forward, N = 160 at the 40-frame
               window; the kernels phase holds the 2D forward at N = 160
               too), davis through ``infer.main``, mevis, windowed f32 PNGs
               GPU against CPU, a ``--msda_3d`` windowed run, the launches
               of each;
  9. main    - ``train.main`` at full width and depth, bf16, on a
               synthetic 720x1280 Ref-YouTube-VOS train tree (2 videos x 10
               frames x 2 expressions = 8 samples an epoch; an object that
               leaves some frames): two epochs (12 + 12 MSDA launches per
               step); a resume from ``checkpoint/`` for a third (starts at
               epoch 2, parameters and AdamW state bitwise the saved ones,
               the schedule's LR); a resume from a reference-format
               ``.pth`` for a third (AdamW empty, the schedules
               fast-forwarded, then an epoch of steps);
               ``--msda_3d --batch_size 2`` for one epoch (8 + 8 3D and
               4 + 4 2D launches per step); frames with valid = 0 and
               resampled clips seen; the 2D kernels held against plain at
               the largest padded shape of the 2D runs (N = 5) and, with
               the 3D kernels, at that of the ``--msda_3d`` run (N = 10);
 10. eval    - evaluation at full width, bf16, on synthetic trees at the
               datasets' sizes: ``train.main --eval`` on JHMDB-Sentences
               (320x240 PNG frames, puppet_mask.mat; 12 2D forward
               launches a batch of N = 2 annotated frames; the metric keys
               and ranges; the ground truth against itself scores 1.0; an
               f32 GPU-against-CPU check on 2 samples) and on RefCOCO
               (640x480 JPEGs with polygons, ``--masks``; P@K and the COCO
               box and mask stats; the ground truth against itself scores
               1.0); ``eval_davis`` on phase 8's davis PNGs (J&F in [0, 1],
               1.0 for the annotations against themselves); one
               ``train_joint`` epoch (RefCOCO/+/g pseudo-videos and phase
               9's ytvos tree, batch 2) and one MeViS epoch (12 + 12 launches
               a step); the 2D forward held against plain at each
               evaluation's shape and both 2D kernels at train_joint's
               largest;
 11. backbones - the other backbone families at full width, from seeded
               random weights: the 2D forward kernel held against plain at
               the DC5 levels (48x80, 24x40, 24x40, 12x20: S = 6000) and
               at Video-Swin-B's serving shapes, the backward at its
               training shapes; the Video-Swin-B flagship
               (``--backbone video_swin_b_p4w7``) through phase 3's path in
               bf16 and f32 (24 MSDA forward launches per run_video_batch
               of two windows, exact expression isolation, batched against
               serial masks, bf16 under limits calibrated on an H100) and
               phase 4's f32 window GPU against CPU; a whole-video ytvos run
               through ``infer.main`` on one 18-frame 720x1280 video (one
               24-frame window: 8-frame windows, a temporal shift of 4),
               its backbone calls and its PNG tree; 4 bf16 train steps at
               b = 1, 5x384x640, without and 3 with recomputation (12 + 12
               and 24 + 12 launches a step), every backbone parameter with
               a gradient; one bf16 forward (a 5-frame window, E = 4:
               finite outputs, 12 launches, the backbone's replay bitwise
               its captured first dispatch) on Video-Swin-T and -S, Swin-L,
               ResNet-101, ResNet-50 with DC5 and X3D-M;
 12. options - the model options at full width: the LastLayerAsToken
               flagship (``--f_token -1``) through phase 3's path in bf16 (8
               launches a trunk forward, exact expression isolation,
               batched against serial within phase 3's limits) and f32 GPU
               against CPU; its whole-video windows at T = 40 and 160 (E =
               4, as many a dispatch as the memory envelope allows), each
               trunk's peak under ``infer._ENVELOPE_GIB``'s line; 4 bf16
               train steps (8 + 8 launches, every parameter learns);
               ``train.main`` on the 65-class ytvos objective (no
               ``--binary``; ``--masks --vis_loss --contrastive``) on phase
               9's tree, ``infer.main --resume`` on its weights, a
               ``--binary --pretrained_weights`` fine-tune that re-initialises
               only ``class_embed.*``, an epoch without ``--masks`` (no mask
               loss logged); ``--vlblock --no_rel_coord`` beside the
               flagship (the trunk at E = 1 and 4, 3 train steps); the 2D
               kernels held against plain at the runs' largest padded shape;
 13. dist    - the multi-process path and the host modules (run after 11):
               the C RLE built and taken by phase 10's JHMDB evaluation
               (``--batch_size 1``), bitwise equal to numpy on its masks,
               the metrics equal; two processes sharing the card over
               gloo, one f32 step (TF32 off, dropout off, ``--vis_loss
               --masks``) of the full-width flagship at 2 + 2 layers on one
               5x384x640 clip each, held against one process on both
               clips at the JAX package's DP tolerances, then the JHMDB
               evaluation merged from their shards equal to one process's
               metrics exactly; ``utils/profiling.trace`` around the
               one-process step; ``train.main`` at world 1 over NCCL
               through the launcher's environment (4 bf16 steps), its
               gradient all-reduce (one call on the flat AdamW's
               gradient buffer) and loss sum bitwise;
 14. sp      - the frame-sharded forward of one video
               (``parallel/mesh.py::shard_time_axis``): the dry run as a
               user runs it; two processes sharing the card over gloo, 5
               frames each of one 10x384x640 clip, the flagship at full
               width and depth, its ``--msda_3d`` variant, Video-Swin-B,
               X3D-M and ``valid_indices``: the gathered outputs against the
               one-process forward (f32 at ``SP_F32_TOL``; bf16 mask
               decisions within ``SP_BF16_LIMITS``), NCCL at world 1
               bitwise, each rank's launches. The kernels phase holds the
               3D forward at the sharded calls (Nq = 5 of N = 10, 20 of 40).

Then the card's name and power limit, and a JSON ``kernels`` line: each
kernel's errors, device time and bound by shape, and its launches by path.
The last line of standard output is the device JSON line. Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

FLAGSHIP_SHAPES = ((48, 80), (24, 40), (12, 20), (6, 10))  # 384x640 clip
M, D, L, P = 8, 32, 4, 4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12    # non-tensor-core float32 peak


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f} {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` launches, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, each replay timed with CUDA events (``cuda_ms``), divided
    by ``calls``. The host's share of a call (argument checks, ctypes) is
    left out, which at the small MSDA calls is most of ``cuda_ms``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, reps=reps, warmup=2) / calls
    del graph
    return ms


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from tce_rvos_tpu_torch.ops import _build, flat_adamw_cuda
    from tce_rvos_tpu_torch.ops.msda_cuda import SOURCES as MSDA_SOURCES

    SOURCES = (*MSDA_SOURCES, flat_adamw_cuda.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, all at once
        libs = list(pool.map(_build.build, SOURCES))
    secs = time.perf_counter() - t0
    for source, so in zip(SOURCES, libs):
        log_build("[build]", source, so)
    log(f"[build] seconds={secs:.3f}")


def log_build(tag: str, source, so) -> None:
    """The library a source was built into, and its kernels' registers,
    shared memory and spills (``-Xptxas -v``)."""
    log(f"{tag} {source} -> {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"{tag}   {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def pixel_grid(shapes=FLAGSHIP_SHAPES):
    """The encoder's reference points: every pixel centre of every level,
    in the order of the flattened value, as (x, y) in [0, 1]; [S, 2]."""
    import torch

    return torch.cat([torch.stack(torch.meshgrid((torch.arange(w) + 0.5) / w,
                                                 (torch.arange(h) + 0.5) / h,
                                                 indexing="xy"), -1).reshape(-1, 2)
                      for h, w in shapes])


def own_frames(n: int, ndim: int):
    """The query's own frame coordinate, (i + 0.5) / N as the model makes it
    (an exact-integer f_im), shaped [n, 1, ...] to ``ndim`` dimensions."""
    import torch

    return ((torch.arange(n, dtype=torch.float32) + 0.5) / n).reshape(n, *[1] * (ndim - 1))


def frame_coords(n: int, shape, gen, spread: float = 1.5):
    """The third coordinate of 3D MSDA taps, [n, ...] = ``shape``: the
    query's own frame plus seeded offsets of about ``spread`` frames, so
    that taps reach past both ends of the frame axis and into neighbouring
    clips; point 0 (a pixel centre) sits exactly on the own frame (an
    exact-integer f_im), point 1 halfway between two frames (with N > 1)."""
    import torch

    own = own_frames(n, len(shape))
    f = own + torch.randn(shape, generator=gen) * spread / n
    f[..., 0] = own[..., 0]
    if n > 1:
        f[..., 1] = torch.randint(1, n, shape[:-1], generator=gen).float() / n
    return f


def msda_inputs(kind: str, n: int, q: int, dtype, gen, device, frames: bool = False,
                shapes=FLAGSHIP_SHAPES, points: int = P, spread: float = 4.0,
                frame_spread: float = 1.5):
    """Seeded MSDA inputs at the level ``shapes`` (the flagship's unless
    given) with ``points`` points, and the reference points of each call
    site: the query's own pixel centre (encoder, the first q of the S
    pixels, so neighbouring queries read neighbouring values), free points
    (FTF) or boxes (decoder, 4-d). Offsets of about ``spread`` pixels reach
    outside [0, 1], and one point of every head and level lands exactly on a
    pixel centre. ``frames`` adds the 3D op's frame coordinate
    (``frame_coords``, offsets of about ``frame_spread`` frames)."""
    import torch

    s = sum(h * w for h, w in shapes)
    n_levels = len(shapes)
    value = torch.randn(n, s, M, D, generator=gen).to(device=device, dtype=dtype)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32)
    if kind != "decoder":
        if kind == "encoder":
            ref = pixel_grid(shapes)[None, :q, None, None, None, :].expand(n, q, 1, 1, 1, 2)
        else:
            ref = torch.rand(n, q, 1, 1, 1, 2, generator=gen) * 1.2 - 0.1
        off = torch.randn(n, q, M, n_levels, points, 2, generator=gen) * spread
        loc = ref + off / wh[None, None, None, :, None, :]
    else:
        box = torch.rand(n, q, 1, 1, 1, 4, generator=gen)
        off = torch.randn(n, q, M, n_levels, points, 2, generator=gen)
        loc = box[..., :2] + off / points * box[..., 2:] * 0.5
    # exact pixel centres for one point of every head
    pix = torch.floor(torch.rand(n, q, M, n_levels, 2, generator=gen) * wh)
    loc[:, :, :, :, 0, :] = (pix + 0.5) / wh
    if frames:
        loc = torch.cat([loc, frame_coords(n, loc.shape[:-1], gen, frame_spread)[..., None]], -1)
    logits = torch.randn(n, q, M, n_levels * points, generator=gen)
    attn = torch.softmax(logits, -1).reshape(n, q, M, n_levels, points)
    return value, loc.contiguous().to(device), attn.contiguous().to(device)


def msda_traffic(value, loc, zero_weight_reads: bool, shapes=FLAGSHIP_SHAPES) -> dict:
    """What one MSDA call's taps touch on this call's data: the bytes of
    the value rows (one pixel of one frame and one head, D channels) that
    some live corner reads, and the counts of live corners, live (tap,
    frame) pairs and live taps. 2D taps read the query's own frame; 3D taps
    (loc [..., 3]) the frames floor(f_im) and floor(f_im) + 1 that lie in
    [0, N - 1]. A corner is live when it lies inside its level and frame
    and, unless ``zero_weight_reads``, has non-zero bilinear and frame
    weights: the forward skips the others, the backward reads them for the
    location gradient (the right derivative at a pixel centre or an
    integer frame)."""
    import torch

    n, s, m, d = value.shape
    dev = loc.device
    touched = torch.zeros(n * s * m, dtype=torch.bool, device=dev)
    m_idx = torch.arange(m, device=dev)[None, None, :, None]
    if loc.shape[-1] == 3:
        f = loc[..., 2] * n - 0.5  # [n, q, m, l, p]
        f0 = torch.floor(f)
        frames = ((f0, 1 - (f - f0)), (f0 + 1, f - f0))
    else:
        own = torch.arange(n, device=dev, dtype=torch.float32)[:, None, None, None, None]
        own = own.expand(loc.shape[:-1])
        frames = ((own, torch.ones_like(own)),)
    corners = frame_taps = taps = start = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5  # [n, q, m, p]
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        dx, dy = x - x0, y - y0
        tap_live = torch.zeros_like(x, dtype=torch.bool)
        for fr, fw in frames:
            fr, fw = fr[:, :, :, lvl], fw[:, :, :, lvl]
            f_ok = (fr >= 0) & (fr < n) & (zero_weight_reads | (fw != 0))
            fr_i = fr.clamp(0, n - 1).long()
            frame_live = torch.zeros_like(tap_live)
            for cx, cy, wgt in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                                (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
                ok = f_ok & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & (
                    zero_weight_reads | (wgt != 0))
                pix = start + (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
                touched[((fr_i * s + pix) * m + m_idx)[ok]] = True
                corners += int(ok.sum())
                frame_live |= ok
            frame_taps += int(frame_live.sum())
            tap_live |= frame_live
        taps += int(tap_live.sum())
        start += h * w
    return dict(value_bytes=int(touched.sum()) * d * value.element_size(), corners=corners,
                frame_taps=frame_taps, taps=taps, lerp=loc.shape[-1] == 3)


def _bound(nbytes: int, ops: int, value, value_bytes: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, value_bytes_read=value_bytes,
                value_bytes_all=value.numel() * value.element_size())


def msda_bound(value, loc, attn, out, shapes=FLAGSHIP_SHAPES) -> dict:
    """The least time of one MSDA forward call (2D or 3D) on this call's
    data: the larger of its compulsory bytes over the HBM rate and its
    operations over the f32 peak. Bytes: locations (2 or 3 floats a tap),
    weights and output once each, and of the value only the (frame, pixel)
    rows that some tap reads with non-zero weights; at the FTF and decoder
    shapes the taps touch a small part of the value. Operations: one FMA per
    channel for each such corner, one for each tap that has one, and in 3D
    one for each live (tap, frame) pair (the frame lerp)."""
    tr = msda_traffic(value, loc, zero_weight_reads=False, shapes=shapes)
    nbytes = tr["value_bytes"] + sum(t.numel() * t.element_size() for t in (loc, attn, out))
    fmas = tr["corners"] + tr["taps"] + (tr["frame_taps"] if tr["lerp"] else 0)
    return _bound(nbytes, 2 * value.shape[-1] * fmas, value, tr["value_bytes"])


def msda_bwd_bound(value, loc, attn, grad_out, shapes=FLAGSHIP_SHAPES) -> dict:
    """The least time of one MSDA backward call (2D or 3D) on this call's
    data. Bytes: the (frame, pixel) value rows that live corners read
    (zero-weight corners and frames included: the location gradient reads
    them), locations, weights and the upstream gradient once each, d_value
    written once in the value's dtype, and d_loc and d_attn (f32) written
    once. The kernel's f32 scratch, its zeroing and its cast are not
    counted: the function does not need them. Operations per channel: for
    each live corner its tap product, its two location-gradient terms and
    its d_value product and sum (8); for each live tap its d_attn product
    (2); in 3D for each live (tap, frame) pair the frame weight's products
    into the tap and the two location terms and the frame gradient's term
    (8)."""
    tr = msda_traffic(value, loc, zero_weight_reads=True, shapes=shapes)
    f32 = 4
    nbytes = (tr["value_bytes"] + sum(t.numel() * t.element_size() for t in (loc, attn, grad_out))
              + value.numel() * value.element_size() + (loc.numel() + attn.numel()) * f32)
    ops = 8 * tr["corners"] + 2 * tr["taps"] + (8 * tr["frame_taps"] if tr["lerp"] else 0)
    return _bound(nbytes, value.shape[-1] * ops, value, tr["value_bytes"])


# forward kernel against plain: f32, the kernel and the plain version sum
# the same f32 products in another order (~1e-6); bf16, both round an f32
# sum of bf16 taps to bf16 once, so they differ by at most one bf16 step
# (2^-8 relative). (rtol, atol)
FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (8e-3, 1e-2)}
# (rtol, atol as a share of the largest |reference|) of the backward kernel
# against autograd through the plain version. d_loc and d_attn are f32 sums
# of the same f32 products in another order, whatever the value's dtype;
# d_value is summed with atomics in an order that changes from run to run
# and then cast to the value's dtype: in bf16 the two may round to
# neighbouring values, one bf16 step (at most 2^-7 relative) apart.
BWD_TOL = {"f32": (1e-4, 1e-5), "bf16_d_value": (1e-2, 1e-3)}


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def hold_forward(op, plain, label: str, value, shapes, loc, attn):
    """One forward call of ``op`` (a kernel) against ``plain`` at FWD_TOL;
    returns (the kernel's output, the largest |difference|)."""
    import torch

    got = op(value, shapes, loc, attn)
    torch.cuda.synchronize()
    ref = plain(value, shapes, loc, attn)
    err = (got.float() - ref.float()).abs()
    rtol, atol = FWD_TOL[dtype_name(value.dtype)]
    bad = err > atol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel disagrees with plain, max |err| "
                             f"{float(err.max()):.3e}, {int(bad.sum())} elements out of "
                             f"tolerance (rtol {rtol}, atol {atol})")
    return got, float(err.max())


def hold_backward(op, plain, label: str, value, shapes, loc, attn, g) -> dict:
    """The gradients of ``op`` (through its autograd function, as the model
    calls it) against autograd through ``plain`` at BWD_TOL; returns the
    largest |difference| of each."""
    import torch

    grads = {}
    for which, fn in (("kernel", op), ("plain", plain)):
        ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, attn)]
        fn(ins[0], shapes, ins[1], ins[2]).backward(g)
        torch.cuda.synchronize()
        grads[which] = [t.grad.float() for t in ins]
    errs = {}
    for gname, got, ref in zip(("d_value", "d_loc", "d_attn"), grads["kernel"], grads["plain"]):
        rtol, atol = BWD_TOL["bf16_d_value" if (gname == "d_value" and value.dtype == torch.bfloat16)
                             else "f32"]
        scale = float(ref.abs().max())
        err = (got - ref).abs()
        bad = err > rtol * ref.abs() + atol * scale
        errs[gname] = float(err.max())
        if bool(bad.any()):
            raise AssertionError(
                f"{label} {gname}: kernel disagrees with plain, max |err| {errs[gname]:.3e} "
                f"(scale {scale:.3g}), {int(bad.sum())} elements out of tolerance (rtol {rtol}, "
                f"atol {atol} x scale)")
    return errs


def hold_plan(backward: bool, label: str, value, shapes, loc) -> dict:
    """The 2D kernels' launch plan as the library computes it against
    ``launch_plan`` (its Python mirror); returns it."""
    from tce_rvos_tpu_torch.ops.msda_cuda import kernel_plan, launch_plan

    n, _, m, _ = value.shape
    args = (backward, value.dtype, shapes, n, loc.shape[1], m)
    got, want = kernel_plan(*args), launch_plan(*args)
    if got != want:
        raise AssertionError(f"{label}: the kernel's launch plan {got} is not launch_plan's {want}")
    return got


def phase_kernels(e: int, is_3d: bool = False, shapes=FLAGSHIP_SHAPES, n: int = None) -> dict:
    """Forward kernel against plain at the serving trunk's MSDA call shapes
    (N = 5 frames x E expressions, or ``n`` frames, levels ``shapes``, the
    384x640 clip's unless given): 2D at the encoder, FTF and decoder shapes; 3D (the
    ``--msda_3d`` trunk) at the encoder and decoder shapes, with frames past
    both ends of the axis, exact-integer and halfway frames. Returns
    per-shape numbers."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2 if is_3d else 0)
    s = sum(h * w for h, w in shapes)
    n = 5 * e if n is None else n
    op, plain = ((ms_deform_attn_3d, ms_deform_attn_3d_plain) if is_3d
                 else (ms_deform_attn, ms_deform_attn_plain))
    kname = "msda3d_fwd" if is_3d else "msda_fwd"
    cases = [("encoder", n, s)] + ([] if is_3d else [("ftf", n, 8)]) + [("decoder", n, 5)]
    results = {}
    for name, nn_, q in cases:
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}/{dtype_name(dtype)}"
            label = f"{kname} {key} N={nn_} Q={q}"
            value, loc, attn = msda_inputs(name, nn_, q, dtype, gen, dev, frames=is_3d,
                                           shapes=shapes)
            plan = {} if is_3d else {"plan": hold_plan(False, label, value, shapes, loc)}
            got, max_err = hold_forward(op, plain, label, value, shapes, loc, attn)
            ms = graph_ms(lambda: op(value, shapes, loc, attn))
            plain_ms = cuda_ms(lambda: plain(value, shapes, loc, attn), reps=3, warmup=1)
            bound = msda_bound(value, loc, attn, got, shapes)
            rtol, atol = FWD_TOL[dtype_name(dtype)]
            results[key] = dict(N=nn_, Q=q, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                                rtol=rtol, atol=atol, levels=shapes, **plan, **bound)
            log(f"[kernels] {kname} {key:18s} N={nn_} Q={q}: max|err|={max_err:.3e} "
                f"(rtol {rtol}, atol {atol}) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; {bound['bytes']} bytes, "
                f"value {bound['value_bytes_read']} of {bound['value_bytes_all']})"
                + (f"; plan {plan['plan']}" if plan else ""))
    return results


def phase_backward_kernels(n: int = 5, is_3d: bool = False, shapes=FLAGSHIP_SHAPES) -> dict:
    """The backward kernel (through its autograd function, as the model
    calls it) against autograd through the plain version at the training
    step's MSDA call shapes (b = 1 clip of 5 frames: N = 5): 2D at the
    encoder, FTF and decoder shapes; 3D at the encoder and decoder shapes,
    also at N = 10 (two clips, taps crossing from one into the other). f32
    and bf16 value. Returns per-shape numbers."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import (
        ms_deform_attn,
        ms_deform_attn_3d,
        msda3d_backward,
        msda_backward,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3 if is_3d else 1)
    s = sum(h * w for h, w in shapes)
    op, plain, backward = ((ms_deform_attn_3d, ms_deform_attn_3d_plain, msda3d_backward) if is_3d
                           else (ms_deform_attn, ms_deform_attn_plain, msda_backward))
    kname = "msda3d_bwd" if is_3d else "msda_bwd"
    cases = [("encoder", s)] + ([] if is_3d else [("ftf", 8)]) + [("decoder", 5)]
    results = {}
    for name, q in cases:
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}/{dtype_name(dtype)}"
            label = f"{kname} {key} N={n} Q={q}"
            value, loc, attn = msda_inputs(name, n, q, dtype, gen, dev, frames=is_3d,
                                           shapes=shapes)
            g = torch.randn(n, q, M * D, generator=gen).to(device=dev, dtype=dtype)
            plan = {} if is_3d else {"plan": hold_plan(True, label, value, shapes, loc)}
            errs = hold_backward(op, plain, label, value, shapes, loc, attn, g)
            ms = graph_ms(lambda: backward(value, shapes, loc, attn, g))
            ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, attn)]
            out = plain(ins[0], shapes, ins[1], ins[2])
            plain_ms = cuda_ms(lambda: torch.autograd.grad(out, ins, g, retain_graph=True),
                               reps=3, warmup=1)
            bound = msda_bwd_bound(value, loc, attn, g, shapes)
            results[key] = dict(N=n, Q=q, max_abs_err=max(errs.values()), errors=errs, ms=ms,
                                plain_ms=plain_ms, library_ms=None, levels=shapes, **plan, **bound)
            log(f"[kernels] {kname} {key:18s} N={n} Q={q}: max|err| " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
                + f"; kernel {ms:.4f} ms  plain (autograd) {plain_ms:.4f} ms  bound "
                f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}; {bound['bytes']} bytes, "
                f"{bound['ops']} ops, value {bound['value_bytes_read']} of "
                f"{bound['value_bytes_all']}); library: none"
                + (f"; plan {plan['plan']}" if plan else ""))
    return results


def edge_cases(dtype, gen, dev):
    """2D inputs whose results must not rest on the encoder's layout
    (name, level shapes, value, loc, attn, whether the kernels take the
    staged path): a query count that no block run divides; the encoder's
    queries in shuffled order; offsets of about 25 pixels, far outside the
    staged levels and any window; point 1 of every head and level at
    x = -1 (first half of the queries) or y = -1 (second half), beside the
    pixel-centre point 0; and L = 3 levels with P = 2 points (the runtime
    loop), at the encoder and decoder shapes."""
    import torch

    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    n = 3
    value, loc, attn = msda_inputs("encoder", n, s, dtype, gen, dev)
    q = s - 37
    yield "ragged", FLAGSHIP_SHAPES, value, loc[:, :q].contiguous(), attn[:, :q].contiguous(), 1
    perm = torch.randperm(s, generator=gen).to(dev)
    yield "shuffled", FLAGSHIP_SHAPES, value, loc[:, perm].contiguous(), attn[:, perm].contiguous(), 1
    yield ("far", FLAGSHIP_SHAPES, *msda_inputs("encoder", n, s, dtype, gen, dev, spread=25.0), 1)
    edge = loc.clone()
    half = s // 2
    for lvl, (h, w) in enumerate(FLAGSHIP_SHAPES):
        edge[:, :half, :, lvl, 1, 0] = -0.5 / w  # pixel coordinate exactly -1
        edge[:, half:, :, lvl, 1, 1] = -0.5 / h
    yield "x_or_y_at_-1", FLAGSHIP_SHAPES, value, edge, attn, 1
    shapes3 = FLAGSHIP_SHAPES[:3]
    s3 = sum(h * w for h, w in shapes3)
    yield ("L3_P2_encoder", shapes3,
           *msda_inputs("encoder", n, s3, dtype, gen, dev, shapes=shapes3, points=2), 1)
    yield ("L3_P2_decoder", shapes3,
           *msda_inputs("decoder", n, 5, dtype, gen, dev, shapes=shapes3, points=2), 0)


def edge_cases_3d(dtype, gen, dev):
    """3D inputs whose results must not rest on the encoder's layout or on
    where a tap's frames land, as ``edge_cases`` yields them (the 3D kernels
    have one path, so the last item is None; N = 8 frames, so that
    f_im = f * N - 0.5 is exact at the chosen f): a ragged query count;
    shuffled queries; offsets of about 25 pixels and 6 frames; x = -1 or
    y = -1; point 2 at f_im exactly -1 (first half of the queries) or N - 1
    (second half); points 2 and 3 on integer frames other than the own one
    and halfway between two frames (points 0 and 1 of every case are on the
    own frame and halfway); points 2 and 3 past the first and the last
    frame, partly (one frame inside) or wholly; N = 1; L = 3 with P = 2 at
    the encoder and decoder shapes."""
    import torch

    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    n = 8
    value, loc, attn = msda_inputs("encoder", n, s, dtype, gen, dev, frames=True)
    q = s - 37
    yield "ragged", FLAGSHIP_SHAPES, value, loc[:, :q].contiguous(), attn[:, :q].contiguous(), None
    perm = torch.randperm(s, generator=gen).to(dev)
    yield ("shuffled", FLAGSHIP_SHAPES, value, loc[:, perm].contiguous(),
           attn[:, perm].contiguous(), None)
    yield ("far", FLAGSHIP_SHAPES, *msda_inputs("encoder", n, s, dtype, gen, dev, frames=True,
                                                spread=25.0, frame_spread=6.0), None)
    half = s // 2
    edge = loc.clone()
    for lvl, (h, w) in enumerate(FLAGSHIP_SHAPES):
        edge[:, :half, :, lvl, 1, 0] = -0.5 / w  # pixel coordinate exactly -1
        edge[:, half:, :, lvl, 1, 1] = -0.5 / h
    yield "x_or_y_at_-1", FLAGSHIP_SHAPES, value, edge, attn, None
    edge = loc.clone()
    edge[:, :half, :, :, 2, 2] = -0.5 / n         # f_im exactly -1
    edge[:, half:, :, :, 2, 2] = (n - 0.5) / n    # f_im exactly N - 1
    yield "f_at_-1_and_N-1", FLAGSHIP_SHAPES, value, edge, attn, None
    edge = loc.clone()
    shape = edge.shape[:4]
    edge[..., 2, 2] = ((torch.randint(0, n, shape, generator=gen).float() + 0.5) / n).to(dev)
    edge[..., 3, 2] = (torch.randint(1, n, shape, generator=gen).float() / n).to(dev)
    yield "integer_and_halfway_frames", FLAGSHIP_SHAPES, value, edge, attn, None
    edge = loc.clone()
    edge[..., 2, 2] = (torch.rand(shape, generator=gen) * -0.4 - 0.05).to(dev)  # f_im -4.1..-0.9
    edge[..., 3, 2] = (torch.rand(shape, generator=gen) * 0.4 + 1.0).to(dev)    # f_im 7.5..10.7
    yield "past_both_ends", FLAGSHIP_SHAPES, value, edge, attn, None
    yield "N1", FLAGSHIP_SHAPES, *msda_inputs("encoder", 1, s, dtype, gen, dev, frames=True), None
    shapes3 = FLAGSHIP_SHAPES[:3]
    s3 = sum(h * w for h, w in shapes3)
    yield ("L3_P2_encoder", shapes3, *msda_inputs("encoder", n, s3, dtype, gen, dev, frames=True,
                                                  shapes=shapes3, points=2), None)
    yield ("L3_P2_decoder", shapes3, *msda_inputs("decoder", n, 5, dtype, gen, dev, frames=True,
                                                  shapes=shapes3, points=2), None)


def phase_edge_kernels() -> dict:
    """The 2D and 3D forward and backward kernels against the plain version
    (and autograd through it) on ``edge_cases`` and ``edge_cases_3d``, f32
    and bf16, at phase 2's tolerances, each 2D case on the path it names
    (the launch plan is held against its mirror). Returns the largest
    errors."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn, ms_deform_attn_3d

    dev = torch.device("cuda")
    results = {}
    for dim, cases, op, plain in (("2d", edge_cases, ms_deform_attn, ms_deform_attn_plain),
                                  ("3d", edge_cases_3d, ms_deform_attn_3d,
                                   ms_deform_attn_3d_plain)):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator().manual_seed(5)
            for name, shapes, value, loc, attn, staged in cases(dtype, gen, dev):
                label = (f"[edge {dim}] {name} {dtype_name(dtype)} N={value.shape[0]} "
                         f"Q={loc.shape[1]}")
                if staged is not None:  # the 2D kernels' path
                    for backward in (False, True):
                        plan = hold_plan(backward, label, value, shapes, loc)
                        if plan["staged"] != staged:
                            raise AssertionError(f"{label}: {'backward' if backward else 'forward'}"
                                                 f" plan {plan}, expected staged={staged}")
                _, fwd = hold_forward(op, plain, label, value, shapes, loc, attn)
                g = torch.randn(*loc.shape[:2], M * D, generator=gen).to(device=dev, dtype=dtype)
                bwd = hold_backward(op, plain, label, value, shapes, loc, attn, g)
                results[f"{dim}/{name}/{dtype_name(dtype)}"] = dict(forward=fwd, **bwd)
                path = {None: "one", 0: "flat", 1: "staged"}[staged]
                log(f"{label}: {path} path; max |err| forward "
                    f"{fwd:.3e}, " + ", ".join(f"{k} {v:.3e}" for k, v in bwd.items()))
    return results


AB_DIR = "build/ab"  # git-ignored: other builds of the kernels' entry points, if any
# the file-name prefix of another build in AB_DIR -> (3D?, backward?)
AB_PREFIXES = {"fwd_": (False, False), "bwd_": (False, True), "fwd3d_": (True, False),
               "bwd3d_": (True, True)}


def own_pixel(loc):
    """Encoder-call locations with every tap moved onto the query's own
    reference point (the same at every head, level and point), and in 3D
    onto its own frame: the most local gathers the call can make."""
    import torch

    ref = pixel_grid().to(loc.device)[None, :, None, None, None, :].expand(*loc.shape[:-1], 2)
    return torch.cat([ref, own_frame(loc)[..., 2:]], -1) if loc.shape[-1] == 3 else ref.contiguous()


def own_frame(loc):
    """3D locations with every tap's frame coordinate on the query's own
    frame (zero temporal offset: one frame a tap, as at the model's init)."""
    out = loc.clone()
    out[..., 2] = own_frames(loc.shape[0], loc.dim() - 1).to(loc.device)
    return out


def near_frame(loc, gen):
    """3D locations with every tap's f_im within one frame of the query's
    own frame (uniform in (-1, 1) frames off it): two frames a tap, one of
    them the own frame, as ``temporal_taps`` finds the model's taps with
    ``random_state_dict`` weights."""
    import torch

    n = loc.shape[0]
    out = loc.clone()
    off = (torch.rand(loc.shape[:-1], generator=gen) * 2 - 1) / n
    out[..., 2] = (own_frames(n, loc.dim() - 1) + off).to(loc.device)
    return out


def phase_ab(ab_dir: str = AB_DIR, rounds: int = 3) -> dict:
    """The package's MSDA kernels against other builds of the same C entry
    points, in bf16 at the trunk's calls (forward N = 20 as serving at
    E = 4, backward N = 5 as training; ``msda_inputs``' seeded data), by
    device time (``graph_ms``) taken in turns: each round runs the package
    kernel, then every other build, then the same in reverse, and a build's
    time is the median of its readings. ``ab_dir`` holds the other builds'
    sources, named by ``AB_PREFIXES`` (``fwd_*.cu`` with ``tce_msda_fwd``,
    ``bwd_*.cu`` with ``tce_msda_bwd``, ``fwd3d_*.cu`` with
    ``tce_msda3d_fwd_nq``, ``bwd3d_*.cu`` with ``tce_msda3d_bwd``; ``bind``
    raises, naming the file, for a 3D forward without Nq); e.g. an
    earlier version's sources, from git), built in parallel; without it only
    the package kernels are timed. At the 2D encoder call every build also
    runs on ``own_pixel`` locations; at the 3D encoder call on
    ``frame_coords`` taps, ``near_frame`` taps, ``own_frame`` taps and
    ``own_pixel`` taps (own frame and pixel). Each build's largest
    difference from the plain version (backward: from autograd through it)
    is printed, not held: phase 2 holds the package kernels."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import torch

    from tce_rvos_tpu_torch.ops import _build
    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain, ms_deform_attn_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import (
        _bwd_kernel,
        _fwd_kernel,
        bind,
        launch_backward,
        launch_forward,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    s = sum(h * w for h, w in FLAGSHIP_SHAPES)
    root = Path(__file__).resolve().parent / ab_dir
    sources = sorted(root.glob("*_*.cu")) if root.is_dir() else []
    with ThreadPoolExecutor(max(1, len(sources))) as pool:
        for src, so in zip(sources, pool.map(_build.build, sources)):
            log_build("[ab]", src.name, so)
    results = {}
    for is_3d, backward, n in ((False, False, 20), (False, True, 5), (True, False, 20),
                               (True, True, 5)):
        kname = f"msda{'3d' if is_3d else ''}_{'bwd' if backward else 'fwd'}"
        plain = ms_deform_attn_3d_plain if is_3d else ms_deform_attn_plain
        calls = (("encoder", s), ("decoder", 5)) if is_3d else (("encoder", s), ("ftf", 8),
                                                                ("decoder", 5))
        for call, q in calls:
            value, loc, attn = msda_inputs(call, n, q, torch.bfloat16, gen, dev, frames=is_3d)
            g = torch.randn(n, q, M * D, generator=gen).to(device=dev, dtype=torch.bfloat16)
            kernels = {"package": _bwd_kernel(is_3d) if backward else _fwd_kernel(is_3d)}
            for src in sources:
                prefix = src.name[:src.name.index("_") + 1]
                if AB_PREFIXES.get(prefix) == (is_3d, backward):
                    kernels[src.stem] = bind(src, backward, is_3d)
            inputs = {"": loc}
            if call == "encoder":
                inputs = ({"": loc, "/near_frame": near_frame(loc, gen),
                           "/own_frame": own_frame(loc), "/own_pixel": own_pixel(loc)}
                          if is_3d else {"": loc, "/own_pixel": own_pixel(loc)})
            builds = {f"{k}{tag}": (fn, lc) for tag, lc in inputs.items()
                      for k, fn in kernels.items()}
            if backward:
                ins = [t.detach().clone().requires_grad_(True) for t in (value, loc, attn)]
                want = torch.autograd.grad(plain(ins[0], FLAGSHIP_SHAPES, ins[1], ins[2]), ins, g)
            else:
                want = plain(value, FLAGSHIP_SHAPES, loc, attn)
            runs, errs = {}, {}
            for name, (fn, lc) in builds.items():
                if backward:
                    runs[name] = lambda fn=fn, lc=lc: launch_backward(
                        fn, kname, value, FLAGSHIP_SHAPES, lc, attn, g)
                else:
                    runs[name] = lambda fn=fn, lc=lc: launch_forward(
                        fn, kname, value, FLAGSHIP_SHAPES, lc, attn)
                if lc is loc:
                    got = runs[name]()
                    torch.cuda.synchronize()
                    pairs = zip(got, want) if backward else [(got, want)]
                    errs[name] = [float((a.float() - b.float()).abs().max()) for a, b in pairs]
            order = list(runs) + list(runs)[::-1]
            times = {k: [] for k in runs}
            for _ in range(rounds):
                for name in order:
                    times[name].append(graph_ms(runs[name]))
            key = f"{'3d_' if is_3d else ''}{'backward' if backward else 'forward'}/{call}"
            results[key] = {}
            for name, ts in times.items():
                ms = statistics.median(ts)
                results[key][name] = dict(ms=ms, readings=ts, max_abs_err=errs.get(name))
                log(f"[ab] {kname} {call} N={n} Q={q} bf16 {name:26s} {ms:.4f} ms (readings "
                    + ", ".join(f"{t:.4f}" for t in ts) + ")"
                    + ("" if name not in errs else "; max |err| against plain "
                       + ", ".join(f"{e:.3e}" for e in errs[name])))
    return results


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

CAPTIONS = (
    "the person riding a brown horse on the beach",
    "a small white dog running after a ball",
    "the car on the left",
    "a man in a red jacket holding an umbrella",
)
N_FRAMES, FRAME_HW = 10, (360, 640)
OUT_SHAPES = {  # per caption, 10 frames, q = 5, stride-4 masks of 384x640
    "pred_logits": (10, 5, 1), "pred_boxes": (10, 5, 4), "pred_masks": (10, 5, 96, 160),
    "reference_points": (10, 5, 2), "inter_samples": (10, 5, 30, 2),
}


def random_state_dict(cfg, seed: int = 0):
    """Flagship weights at full width from a seed: the model's own init plus
    seeded noise on every parameter, so that the MSDA offsets and weights
    depend on the query (at init they do not)."""
    import torch

    from tce_rvos_tpu_torch.models.build import build_model

    model = build_model(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.state_dict()


def device_state_dict(cfg, seed: int = 0):
    """``random_state_dict``'s recipe (the model's own init, then 0.02
    noise on every parameter) drawn on the GPU from a CUDA generator: other
    values, the same distributions, in a fraction of the CPU's time. For the
    runs whose gates do not depend on the values (finite outputs, launch
    counts)."""
    import torch

    from tce_rvos_tpu_torch.models.referformer import ReferFormer, init_weights

    with torch.device("cuda"):
        model = ReferFormer(cfg)
    gen = torch.Generator("cuda").manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    return model.state_dict()


def synthetic_video(seed: int = 0, n: int = N_FRAMES):
    """``n`` (10) smooth random RGB frames in [0, 1] at 360x640 (the first
    10 the same for every ``n``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(n):
        f = np.stack([0.5 + 0.5 * np.sin((xx * a + yy * b) / 40.0 + t * 0.3 + c)
                      for a, b, c in rng.rand(3, 3)], -1)
        frames.append((f + 0.05 * rng.rand(h, w, 3)).clip(0, 1).astype(np.float32))
    return frames


def check_outputs(outs, label: str) -> None:
    import numpy as np

    if len(outs) != len(CAPTIONS):
        raise AssertionError(f"{label}: {len(outs)} results for {len(CAPTIONS)} captions")
    for e, out in enumerate(outs):
        for k, shape in OUT_SHAPES.items():
            if out[k].shape != shape:
                raise AssertionError(f"{label} caption {e}: {k} shape {out[k].shape} != {shape}")
            if not np.isfinite(out[k]).all():
                raise AssertionError(f"{label} caption {e}: {k} is not finite")
        boxes = out["pred_boxes"]
        if boxes.min() < 0.0 or boxes.max() > 1.0:
            raise AssertionError(f"{label} caption {e}: boxes outside [0, 1]")


def compare(got, want, rtol: float, atol_rel: float, label: str) -> float:
    """max |got - want| within rtol*|want| + atol_rel*max|want|; returns the
    max abs error."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    scale = max(float(np.abs(want).max()), 1.0)
    bad = err > rtol * np.abs(want) + atol_rel * scale
    if bad.any():
        raise AssertionError(f"{label}: max |err| {err.max():.3e} (scale {scale:.3g}), "
                             f"{int(bad.sum())} of {bad.size} out of tolerance")
    return float(err.max())


def mask_gap(got, want) -> tuple:
    """(relative RMS difference, share of pixels whose mask differs) of two
    mask-logit arrays; a pixel is in the mask where its logit is > 0."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rel_rms = float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2)))
    return rel_rms, float(np.mean((got > 0) != (want > 0)))


# bf16 batched against serial masks: (relative RMS, share of pixels whose
# mask differs) may reach twice the largest of the 12 readings (3 videos x
# 4 captions) of the calibration run on an H100, 2.537e-2 and 4.535e-3
# (PERF.md). The gap is bf16 rounding: the first decoder layer's kernels
# round differently at E = 1 and E = 4, while expression 0 is bitwise
# independent of the other expressions (expression_isolation checks both).
# f32 is held to rtol 1e-3 plus 1e-3 of the largest |logit| on every pixel.
BF16_BATCHED_VS_SERIAL_LIMITS = (5.1e-2, 9.1e-3)


def batched_vs_serial(engine, videos, first_outs, dtype_name: str, label: str,
                      limits=BF16_BATCHED_VS_SERIAL_LIMITS) -> dict:
    """run_video_batch (E = 4) against run_video (E = 1) for every caption
    of every video, bf16 within ``limits``; returns the readings and the
    masks, keyed by (video, caption), for the bf16-against-f32 reading."""
    import numpy as np

    readings, masks = [], {}
    for v, frames in enumerate(videos):
        outs = first_outs if v == 0 else engine.run_video_batch(
            frames, list(CAPTIONS), exp_batch=len(CAPTIONS))
        check_outputs(outs, f"{label} video {v}")
        for e, cap in enumerate(CAPTIONS):
            got = outs[e]["pred_masks"]
            want = engine.run_video(frames, cap)["pred_masks"]
            where = f"{label} batched vs serial masks, video {v} caption {e}"
            rel_rms, flip = mask_gap(got, want)
            if dtype_name == "float32":
                compare(got, want, 1e-3, 1e-3, where)
            elif rel_rms > limits[0] or flip > limits[1]:
                raise AssertionError(f"{where}: relative RMS {rel_rms:.3e}, mask differs on "
                                     f"{flip:.3e} of pixels; limits {limits}")
            readings.append(dict(video=v, caption=e, rel_rms=rel_rms, flip=flip,
                                 max_abs_err=float(np.abs(got - want).max()),
                                 max_abs_logit=float(np.abs(want).max())))
            masks[(v, e)] = (got, want)
    worst = {k: max(r[k] for r in readings) for k in ("rel_rms", "flip", "max_abs_err")}
    log(f"{label} batched vs serial masks, {len(videos)} videos x {len(CAPTIONS)} captions: "
        f"largest relative RMS {worst['rel_rms']:.3e}, largest share of pixels whose mask "
        f"differs {worst['flip']:.3e}, largest max |err| {worst['max_abs_err']:.3e}; readings "
        + json.dumps([[r["video"], r["caption"], r["rel_rms"], r["flip"]] for r in readings]))
    return dict(readings=readings, worst=worst, masks=masks)


def expression_isolation(engine, frames, label: str) -> dict:
    """Why batched and serial outputs differ, on one window in the engine's
    dtype:
    * isolation: expression 0 of an E = 4 batch must not depend on the
      other three. Captions 0-3 against caption 0 four times: the shapes
      are the same, so the same kernels run, and every stage's output for
      expression 0 must be bitwise equal;
    * divergence: expression 0 alone (E = 1) against the same expression
      in the E = 4 batch, stage by stage. Only the batch each kernel sees
      differs; the readings show where the two first part, and inside the
      first decoder layer, which submodule takes equal inputs and gives
      unequal outputs;
    * mechanism: the same rows through one op alone and in a 4x batch, at
      the shapes it sees for E = 1 and E = 4: nn.Linear in the text
      encoder, the encoder FFN and the decoder FFN, and the pieces of the
      first decoder layer's IQT self-attention (in-projection, logits
      matmul, probabilities times values)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    model = engine.model
    tr = model.transformer
    stages = [("text_encoder", model.text_encoder), ("resizer", model.resizer)]
    stages += [("input_proj", m) for m in model.input_proj]
    stages += [("fusion", model.fusion_module)]
    stages += [(f"encoder{i}", m) for i, m in enumerate(tr.encoder.layers)]
    stages += [(f"decoder{i}", m) for i, m in enumerate(tr.decoder.layers)]
    stages += [("pixel_decoder", model.pixel_decoder), ("controller", model.controller)]
    video, mask, size = engine.preprocess(frames[:engine.window])
    sizes = size
    feats = engine.backbone(video, mask)
    ids, attn = tokenize(list(CAPTIONS))

    def lead(o):
        while not torch.is_tensor(o):
            o = next(iter(o.values())) if isinstance(o, dict) else o[0]
        return o

    pinpoint = [(f"decoder0.{n or 'layer'}", m) for n, m in tr.decoder.layers[0].named_modules()]
    pinpoint += [(f"pixel_decoder.{n or 'module'}", m)
                 for n, m in model.pixel_decoder.named_modules()]
    mha = tr.decoder.layers[0].self_attn  # IQT: E*q sequences of t frames

    def run(ids_, attn_):
        caught = {name: [] for name, _ in stages}
        inner = {}  # pinpointed submodules, in the order they finish: name -> (input, output)
        hooks = [mod.register_forward_hook(
            lambda _m, _a, o, name=name: caught[name].append(lead(o).float().clone()))
            for name, mod in stages]

        def keep_first(name):
            def hook(_m, a, o):  # returns None: the module's output stands
                if name not in inner:
                    inner[name] = (lead(a).float().clone(), lead(o).float().clone())
                    if name == "decoder0.self_attn":  # its own inputs and layouts, for a replay
                        inner["mha_args"] = tuple((x.clone(), x.size(), x.stride()) for x in a)
            return hook

        hooks += [mod.register_forward_hook(keep_first(name)) for name, mod in pinpoint]
        try:
            out = engine._trunk_eager(feats, mask, ids_, attn_, sizes)
        finally:
            for h in hooks:
                h.remove()
        for k in ("pred_logits", "pred_boxes", "pred_masks"):
            caught[k] = [out[k].float()]
        return caught, inner

    full, inner_full = run(ids, attn)
    same, _ = run(np.repeat(ids[:1], 4, 0), np.repeat(attn[:1], 4, 0))
    alone, inner_alone = run(ids[:1], attn[:1])
    divergence = {}
    for name in full:
        rel, share = 0.0, 0.0
        for a, b, one in zip(full[name], same[name], alone[name]):
            k = a.shape[0] // 4  # expression-major: expression 0 leads
            if not torch.equal(a[:k], b[:k]):
                raise AssertionError(
                    f"{label} isolation: expression 0's {name} output changes with the other "
                    f"expressions of its batch (max |diff| {float((a[:k] - b[:k]).abs().max()):.3e})")
            diff = (one - a[:k]).abs()
            rel = max(rel, float(diff.max()) / max(float(a[:k].abs().max()), 1e-30))
            share = max(share, float((diff > 0).float().mean()))
        divergence[name] = (rel, share)
    log(f"{label} isolation: expression 0 bitwise equal with captions 0-3 and with caption 0 "
        f"x 4, at every stage")
    log(f"{label} E=1 vs E=4, expression 0, by stage (max |diff| / max |E=4|, share of "
        f"elements that differ): " + ", ".join(
            f"{k} {r:.2e} ({s:.3f})" for k, (r, s) in divergence.items()))

    def same_rows(one, four):  # expression 0 of E = 4 against E = 1, if batch-major
        return None if one.shape[0] * 4 != four.shape[0] else torch.equal(one, four[:one.shape[0]])

    mha_args = {"E=1": inner_alone.pop("mha_args"), "E=4": inner_full.pop("mha_args")}
    inner = {}
    for name, (a_in, a_out) in inner_full.items():
        o_in, o_out = inner_alone[name]
        inner[name] = (same_rows(o_in, a_in), same_rows(o_out, a_out))
    mark = {True: "=", False: "x", None: "?"}
    log(f"{label} submodules of decoder0 and the pixel decoder that take bitwise-equal inputs "
        "at E=1 and E=4 and give unequal outputs, in the order they finish: " + ", ".join(
            k for k, (i, o) in inner.items() if i and o is False))
    log(f"{label} decoder0 submodules in the order they finish, input/output of E=1 against "
        "E=4 (= bitwise equal, x not, ? not batch-major): " + ", ".join(
            f"{k.split('.', 1)[1]} {mark[i]}/{mark[o]}" for k, (i, o) in inner.items()
            if k.startswith("decoder0.")))
    strides = {e: [st for _, _, st in args] for e, args in mha_args.items()}
    log(f"{label} decoder0 IQT self-attention input strides (query, key, value): {strides}")

    gen = torch.Generator(device=engine.device).manual_seed(0)
    lin_txt = model.text_encoder.encoder.layer[0].attention.self.query
    s_vis = sum(h * w for h, w in FLAGSHIP_SHAPES)
    gemm = {}
    for name, lin, rows in (("text_query", lin_txt, ids.shape[1]),
                            ("encoder_linear1", tr.encoder.layers[0].linear1, engine.window * s_vis),
                            ("decoder_linear1", tr.decoder.layers[0].linear1,
                             engine.window * engine.cfg.num_queries)):
        x = torch.randn(4 * rows, lin.in_features, generator=gen, device=engine.device,
                        dtype=engine.dtype)
        with torch.inference_mode():
            y_one = F.linear(x[:rows], lin.weight, lin.bias)
            y_four = F.linear(x, lin.weight, lin.bias)
        gemm[f"{name} ({rows} vs {4 * rows} rows)"] = float((y_one != y_four[:rows]).float().mean())
    seqs, t, c, h = engine.cfg.num_queries, engine.window, mha.d_model, mha.num_heads
    x = torch.randn(4 * seqs, t, c, generator=gen, device=engine.device, dtype=engine.dtype)
    w, bias = mha.in_proj_weight.chunk(3), mha.in_proj_bias.chunk(3)

    def iqt_steps(*qkv):  # the steps of MultiheadAttention.forward, with its layouts
        n = qkv[0].shape[0]
        q, k, v = (F.linear(qkv[i], w[i], bias[i]).reshape(n, t, h, c // h).transpose(1, 2)
                   for i in range(3))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(c // h)
        probs = torch.softmax(logits, dim=-1)
        heads = torch.matmul(probs, v)
        out = mha.out_proj(heads.transpose(1, 2).reshape(n, t, c))
        return dict(input=torch.stack(qkv), in_proj=torch.stack([q, k, v]),
                    logits_matmul=logits, softmax=probs, probs_matmul=heads, out_proj=out,
                    module=mha(*qkv))

    def replay(e, layout):
        """The captured inputs, dense, or rebuilt with the trunk's strides
        (a stride-0 broadcast view clones to a dense tensor)."""
        out = []
        for x_, size, stride in mha_args[e]:
            y = x_.contiguous() if layout == "dense" else x_.as_strided(size, stride)
            if not torch.equal(y, x_):
                raise AssertionError(f"{label} replay: rebuilt input differs from the captured one")
            out.append(y)
        return out

    with torch.inference_mode():
        for src, one, four in (
                ("random", iqt_steps(x[:seqs], x[:seqs], x[:seqs]), iqt_steps(x, x, x)),
                ("replayed_dense", iqt_steps(*replay("E=1", "dense")),
                 iqt_steps(*replay("E=4", "dense"))),
                ("replayed_trunk_strides", iqt_steps(*replay("E=1", "trunk")),
                 iqt_steps(*replay("E=4", "trunk")))):
            for name in one:  # [3, n, ...] for the query, key and value inputs
                a, b = (one[name], four[name][:, :seqs]) if name in ("input", "in_proj") else (
                    one[name], four[name][:seqs])
                gemm[f"iqt_{name} {src} ({seqs} vs {4 * seqs} sequences)"] = float(
                    (a != b).float().mean())
    log(f"{label} the same rows through one op alone and in a 4x batch, share of outputs that "
        "differ (iqt_: decoder 0's IQT self-attention step by step, each step fed the previous "
        "one's output, on random inputs and replayed on the inputs it took in the E=1 and "
        "E=4 runs, as dense copies and with the strides they had there): " + ", ".join(f"{k} {v:.4f}" for k, v in gemm.items()))
    return dict(divergence=divergence, decoder0=inner, gemm_share_differ=gemm)


def phase_path(dtype_name: str, sd, videos, backbone: str = "resnet50", tag: str = "path",
               limits=BF16_BATCHED_VS_SERIAL_LIMITS, overrides: dict = None) -> tuple:
    """run_video_batch (E = 4, two 5-frame windows) through the kernel;
    expression isolation and where batched and serial part; the batched
    masks against serial run_video for every caption of every video (bf16
    within ``limits``). The flagship on ``backbone``, with the model
    options ``overrides``. Returns (the readings, the masks)."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine

    cfg = flagship_config(compute_dtype=dtype_name, backbone=backbone, **(overrides or {}))
    engine = InferenceEngine(cfg, sd, device="cuda")
    label = f"[{tag} {dtype_name}]"
    frames = videos[0]
    n_windows = -(-N_FRAMES // engine.window)
    per_forward = msda_per_forward(cfg)

    reset_launch_counts()
    outs, ran = device_launches(
        lambda: engine.run_video_batch(frames, list(CAPTIONS), exp_batch=len(CAPTIONS)))
    launches, counted = ran["msda_fwd"], launch_counts()["msda_fwd"]
    trunk_forwards = n_windows  # one expression chunk per window
    if not launches == counted == per_forward * trunk_forwards:
        raise AssertionError(f"{label} MSDA kernel ran {launches} times (launch counters: "
                             f"{counted}), expected {per_forward} per trunk forward x "
                             f"{trunk_forwards}")
    check_outputs(outs, label)
    log(f"{label} run_video_batch E={len(CAPTIONS)}, {n_windows} windows: outputs ok, "
        f"msda_fwd launches the device ran {launches} ({per_forward} x {trunk_forwards} trunk "
        f"forwards; launch counters {counted})")
    backbone_replay(engine, frames, label)

    isolation = expression_isolation(engine, frames, label)
    bvs = batched_vs_serial(engine, videos, outs, dtype_name, label, limits)
    result = dict(launches=launches, per_forward=per_forward, trunk_forwards=trunk_forwards,
                  isolation=isolation, batched_vs_serial=bvs["worst"])
    del engine
    torch.cuda.empty_cache()
    return result, bvs["masks"]


def backbone_replay(engine, frames, label: str) -> None:
    """The serving path's backbone at each window of ``frames`` (shapes
    ``run_video_batch`` has dispatched) against the same engine's eager
    backbone, bitwise: replayed from its CUDA graphs where
    ``infer.backbone_graph_gate`` passes the window, else eager."""
    import torch

    from tce_rvos_tpu_torch.infer import backbone_graph_gate

    modes = []
    for ext, _ in engine.windows(len(frames)):
        video, mask, _ = engine.preprocess([frames[i] for i in ext])
        want = engine._backbone_eager(video, mask)
        reset_launch_counts()
        got = engine.backbone(video, mask)
        mode = "replays" if backbone_graph_gate(video.shape[1], tuple(video.shape[2:4]),
                                                engine.dtype, "cuda") else "eager"
        if _counters().get(f"engine.backbone_graph_{mode}") != 1:
            raise AssertionError(f"{label} backbone: not one dispatch counted as {mode}")
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"{label} backbone ({mode}): level {i} is not bitwise the "
                                     f"eager backbone's")
        modes.append(mode)
    log(f"{label} backbone at each window ({', '.join(modes)}): features bitwise the eager "
        f"backbone's")


def temporal_taps(engine, feats, mask, sizes, e: int = 4) -> dict:
    """Where the 3D encoder's taps land in time, in one trunk forward at E
    expressions (N = 5E frames): forward hooks on each encoder layer's 3D
    ``MSDeformAttn`` (its ``sampling_offsets``) rebuild every tap's f_im as
    the module does, and this counts the shares of taps whose f_im is the
    query's own frame exactly, within 1 or 2 frames of it, or farther, and
    of those that lie partly or wholly outside [0, N - 1]. A reading for the
    staging choice of the 3D kernels, not held."""
    import torch

    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    counts = dict(exact=0, within_1=0, within_2=0, farther=0, outside=0, taps=0)

    def hook(module, inputs, out):
        n, q = inputs[0].shape[:2]
        parent = layers[module]
        off = out.reshape(n, q, parent.n_heads, parent.n_levels, parent.n_points, 3)[..., 2]
        ref_f = (torch.arange(n, dtype=torch.float32, device=out.device) + 0.5) / n
        f_im = ((ref_f[:, None, None, None, None] + off / n).float() * n - 0.5)
        dist = (f_im - torch.arange(n, device=out.device)[:, None, None, None, None]).abs()
        counts["exact"] += int((dist == 0).sum())
        counts["within_1"] += int(((dist > 0) & (dist <= 1)).sum())
        counts["within_2"] += int(((dist > 1) & (dist <= 2)).sum())
        counts["farther"] += int((dist > 2).sum())
        counts["outside"] += int(((f_im < 0) | (f_im > n - 1)).sum())
        counts["taps"] += f_im.numel()

    layers = {layer.self_attn.sampling_offsets: layer.self_attn
              for layer in engine.model.transformer.encoder.layers}
    handles = [lin.register_forward_hook(hook) for lin in layers]
    ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)])
    try:
        engine._trunk_eager(feats, mask, ids, attn, sizes)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    shares = {k: v / counts["taps"] for k, v in counts.items() if k != "taps"}
    log(f"[path 3d bfloat16] temporal taps of the 3D encoder, trunk E={e} (N={5 * e}), "
        f"{counts['taps']} taps: " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
        + " (own frame exact / within 1 / within 2 / farther; outside: partly or wholly "
          "outside [0, N - 1])")
    return dict(shares, taps=counts["taps"])


def phase_path_3d(sd3, frames) -> dict:
    """The temporal-MSDA flagship (``--msda_3d``) serving path in bf16:
    run_video_batch (E = 4, two 5-frame windows) through the kernels, with
    8 3D and 4 2D MSDA forward launches per trunk forward; shapes,
    finiteness, boxes in [0, 1]; where the 3D encoder's taps land in time
    (``temporal_taps``). The 3D op takes the whole batch axis (E x 5
    frames) as time, as in the JAX package, so expressions are not
    isolated from each other and batched masks need not equal serial ones:
    their gap is printed as a reading, not held."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine

    cfg = flagship_config(msda_3d=True, compute_dtype="bfloat16")
    engine = InferenceEngine(cfg, sd3, device="cuda")
    label = "[path 3d bfloat16]"
    n_windows = -(-N_FRAMES // engine.window)
    reset_launch_counts()
    outs, counts = device_launches(
        lambda: engine.run_video_batch(frames, list(CAPTIONS), exp_batch=len(CAPTIONS)))
    counted = launch_counts()
    want = {"msda_fwd": 4 * n_windows, "msda_bwd": 0, "msda3d_fwd": 8 * n_windows,
            "msda3d_bwd": 0}
    if not counts == counted == want:
        raise AssertionError(f"{label} MSDA kernels ran {counts} (launch counters: {counted}), "
                             f"expected {want} (8 3D and 4 2D forward launches per trunk "
                             f"forward x {n_windows})")
    check_outputs(outs, label)
    log(f"{label} run_video_batch E={len(CAPTIONS)}, {n_windows} windows: outputs ok, "
        f"launches the device ran {counts} (8 msda3d_fwd + 4 msda_fwd per trunk forward x "
        f"{n_windows}; the launch counters agree)")
    gaps = [mask_gap(outs[e]["pred_masks"], engine.run_video(frames, cap)["pred_masks"])
            for e, cap in enumerate(CAPTIONS)]
    log(f"{label} batched (E = 4) against serial (E = 1) masks, a reading (the 3D op's time "
        f"axis spans the expressions of a batch): relative RMS "
        + ", ".join(f"{g[0]:.3e}" for g in gaps) + "; share of pixels whose mask differs "
        + ", ".join(f"{g[1]:.3e}" for g in gaps))

    video, mask, size = engine.preprocess(frames[:engine.window])
    feats = engine.backbone(video, mask)
    taps = temporal_taps(engine, feats, mask, size)
    del engine
    torch.cuda.empty_cache()
    return dict(launches=counts, batched_vs_serial=gaps, temporal_taps=taps)


def bf16_against_f32(masks) -> None:
    """How far bf16 serving lies from f32 on the same weights and videos:
    serial and batched bf16 masks against serial f32 masks (a reading, for
    the size of bf16's own error beside the batched-vs-serial gap)."""
    out = {}
    for which, idx in (("serial", 1), ("batched", 0)):
        gaps = [mask_gap(masks["bfloat16"][key][idx], masks["float32"][key][1])
                for key in masks["float32"]]
        out[which] = dict(rel_rms=max(g[0] for g in gaps), flip=max(g[1] for g in gaps))
    log("[bf16 vs f32] masks against serial f32, largest over videos and captions: " + ", ".join(
        f"{k} bf16: relative RMS {v['rel_rms']:.3e}, mask differs on {v['flip']:.3e} of pixels"
        for k, v in out.items()))


def phase_parity(sd, frames, msda_3d: bool = False, backbone: str = "resnet50",
                 overrides: dict = None, tag: str = None) -> None:
    """One window, f32 with TF32 off: the GPU path (MSDA kernels) against
    the same weights on the CPU (plain MSDA); E = 1 for the flagship, E = 2
    for ``--msda_3d`` (10 frames on the batch axis, so temporal taps cross
    from one expression into the other on both devices). Tolerance: rtol
    2e-3 plus 2e-3 of each output's largest magnitude, the model-level bar
    of the JAX package's parity with the reference; cuDNN/cuBLAS and the CPU
    libraries sum in other orders."""
    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    label = "[parity 3d]" if msda_3d else "[parity]"
    if backbone != "resnet50":
        label = f"[parity {backbone}]"
    if tag:
        label = f"[parity {tag}]"
    cfg = flagship_config(msda_3d=msda_3d, backbone=backbone, **(overrides or {}))
    ids, attn = tokenize(list(CAPTIONS[:2 if msda_3d else 1]))
    # one trunk forward; the CPU takes the plain versions
    want = ({"msda_fwd": 4, "msda3d_fwd": 8} if msda_3d
            else {"msda_fwd": msda_per_forward(cfg), "msda3d_fwd": 0})
    outs = {}
    for dev in ("cuda", "cpu"):
        engine = InferenceEngine(cfg, sd, device=dev)
        video, mask, size = engine.preprocess(frames[:engine.window])
        reset_launch_counts()
        out = engine.run_window(video, mask, ids, attn, size)
        outs[dev] = {k: v.float().cpu().numpy() for k, v in out.items()}
        counts = launch_counts()
        launched = {k: counts[k] for k in want}
        log(f"{label} {dev}: one window, E={len(ids)}, launches {launched}")
        expected = want if dev == "cuda" else {k: 0 for k in want}
        if launched != expected:
            raise AssertionError(f"{label} {dev} run launched the MSDA kernels {launched} "
                                 f"times, expected {expected}")
        del engine
    errs = {}
    for k in ("pred_logits", "pred_boxes", "pred_masks", "reference_points"):
        errs[k] = compare(outs["cuda"][k], outs["cpu"][k], 2e-3, 2e-3, f"{label} {k}")
    log(f"{label} GPU kernel path vs CPU plain path, max |err|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))


# ---------------------------------------------------------------------------
# phases 5-6: the training path
# ---------------------------------------------------------------------------

TRAIN_T, TRAIN_HW = 5, (384, 640)   # the flagship training clip, b = 1
TRAIN_STEPS, TRAIN_STEPS_CKPT = 10, 6
# the train runs of phases 11 and 12 (the other backbones and options)
OTHER_TRAIN_STEPS, OTHER_TRAIN_STEPS_CKPT = 4, 3
PARITY_T, PARITY_HW = 2, (192, 320)  # small enough for the CPU's f32 step
PARITY_FRAMES = 2  # phases 11 and 12: the GPU-against-CPU window cut to 2 frames
# Gradients, per parameter, are held two ways against the model's largest
# |grad| g_max: every element within ELEM_TOL x g_max, and, for a tensor
# whose own largest |grad| reaches SIGNIFICANT x g_max, the difference
# within L2_TOL of its norm. A tensor below that (the text encoder's query
# and key weights: their gradients cancel to ~1e-7 of g_max) is rounding
# of the terms that cancel, whose relative error says nothing: two f32
# runs on the card already differ by 1e-2 of such a tensor's norm. A
# gradient that is zero in exact arithmetic (the text encoder's key biases:
# softmax ignores a constant added to a row of logits) is held below
# ZERO_TOL x g_max on both sides.
SIGNIFICANT, ZERO_TOL = 1e-3, 1e-6
# GPU against CPU, one f32 step: losses and the grad norm at rtol 2e-3
# (the model-level bar of the JAX package's parity with the reference);
# gradients at L2 5e-3 and elements at 1e-3 of g_max. cuDNN, cuBLAS and the
# CPU libraries sum in other orders, and on random weights some pre-ReLU
# activations of the backbone lie within f32 rounding of zero, so the two
# devices let a few different elements through: the first reading on an
# H100 was 1.76e-3 of the norm of backbone conv1's gradient and 2.7e-4 of
# g_max on one element of a layer3 conv (PERF.md), as the JAX-against-port
# CPU test reads on the backbone of the tiny model.
PARITY_L2_TOL, PARITY_ELEM_TOL = 5e-3, 1e-3
# with recomputation against without, one f32 step (TF32 off), dropout off:
# the forward is the same; the backward differs only by the order of
# atomic sums (the MSDA backward's d_value, embedding and other library
# backward kernels): two runs without recomputation differ by about 1e-7
# of g_max. Elements at 1e-6 of g_max, gradients at L2 2e-3. (In
# bf16 those reorderings move bf16 roundings, up to 8e-2 of a gradient's
# norm between two runs without recomputation, so a bf16 reading could not
# tell a fault of the recomputation from noise; tests/test_torch_train.py
# holds bf16 with and without recomputation bitwise equal on the CPU,
# where nothing is reordered.)
CKPT_L2_TOL, CKPT_ELEM_TOL = 2e-3, 1e-6


def train_batch(t: int, hw, seed: int) -> dict:
    """One training batch in collate_batch's format, as numpy: b = 1 clip
    of t random frames (as the JAX package's scripts/bench_train_step.py),
    caption 0, label 0, random boxes, random binary masks, every frame
    valid."""
    import numpy as np

    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    rng = np.random.RandomState(seed)
    h, w = hw
    ids, attn = tokenize([CAPTIONS[0]])
    return {"video": rng.randn(1, t, h, w, 3).astype(np.float32),
            "video_mask": np.zeros((1, t, h, w), bool),
            "text_ids": ids, "text_attn_mask": attn,
            "sizes": np.asarray([[h, w]], np.int32),
            "targets": {"labels": np.zeros((1, t), np.int32),
                        "boxes": rng.rand(1, t, 4).astype(np.float32),
                        "masks": (rng.rand(1, t, h, w) > 0.5).astype(np.float32),
                        "valid": np.ones((1, t), np.int32)}}


def zero_in_exact_arithmetic(name: str) -> bool:
    """Parameters whose gradient is zero in exact arithmetic: a key bias
    adds one constant to a query's row of logits, which softmax ignores
    (the packed in_proj_bias of the other attention blocks also holds q and
    v biases, whose gradients are not zero)."""
    return name.endswith("attention.self.key.bias")


def grad_gap(got: dict, want: dict, label: str, l2_tol: float, elem_tol: float) -> dict:
    """Per-parameter gradients ``got`` against ``want`` (name -> float
    tensor on one device), held as the SIGNIFICANT / ZERO_TOL note above
    says. Returns the worst readings."""
    g_max = max(float(w.abs().max()) for w in want.values())
    worst = dict(l2=0.0, l2_param="", elem=0.0, elem_param="", zero=0.0)
    for name, w in want.items():
        g = got[name]
        scale = float(w.abs().max())
        if zero_in_exact_arithmetic(name):
            zero = max(float(g.abs().max()), scale) / g_max
            worst["zero"] = max(worst["zero"], zero)
            if zero >= ZERO_TOL:
                raise AssertionError(f"{label}: the gradient of {name} should be zero; "
                                     f"|grad| reaches {zero:.3e} of the largest")
            continue
        elem = float((g - w).abs().max()) / g_max
        l2 = float((g - w).norm() / w.norm()) if scale >= SIGNIFICANT * g_max else 0.0
        if elem > worst["elem"]:
            worst.update(elem=elem, elem_param=name)
        if l2 > worst["l2"]:
            worst.update(l2=l2, l2_param=name)
        if l2 > l2_tol or elem > elem_tol:
            raise AssertionError(f"{label}: the gradient of {name} differs by {l2:.3e} of its "
                                 f"norm (limit {l2_tol}) and by up to {elem:.3e} of the "
                                 f"model's largest |grad| (limit {elem_tol})")
    log(f"{label}: largest |grad| {g_max:.4e}; worst element {worst['elem']:.3e} of it "
        f"({worst['elem_param']}); worst gap {worst['l2']:.3e} of a gradient's norm "
        f"({worst['l2_param']}); zero gradients below {worst['zero']:.3e} of it")
    return worst


def every_parameter_learns(model, start: dict, label: str, note: str = "") -> int:
    """Every parameter of ``model`` has a non-zero gradient and moved from
    ``start`` (name -> its value before the steps), the text encoder's key
    biases (zero in exact arithmetic) aside. Returns the parameter count."""
    import torch

    no_grad = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
               and (p.grad is None or float(p.grad.abs().max()) == 0.0)]
    still = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
             and torch.equal(p.detach(), start[n])]
    if no_grad or still:
        raise AssertionError(f"{label} parameters without a gradient: {no_grad}; "
                             f"parameters that did not move: {still}")
    n_params = sum(1 for _ in model.parameters())
    log(f"{label} all {n_params} parameters have a non-zero gradient and moved (the text "
        f"encoder's key biases, zero in exact arithmetic, aside)" + (f", {note}" if note else ""))
    return n_params


_COUNTING = []  # the program's tracing block that reset_launch_counts opened


def reset_launch_counts() -> None:
    """Every kernel's launch counter to 0 (the MSDA kernels' and the flat
    AdamW update's, in ``utils/profiling.py``) and counting on, in a fresh
    ``profiling.tracing()`` block, until the next read of the counts."""
    from tce_rvos_tpu_torch.utils import profiling

    _stop_counting()
    block = profiling.tracing()
    block.__enter__()
    _COUNTING.append(block)


def _stop_counting() -> None:
    while _COUNTING:
        _COUNTING.pop().__exit__(None, None, None)


def _counters() -> dict:
    """The program's counters since ``reset_launch_counts`` (counting stops)."""
    from tce_rvos_tpu_torch.utils import profiling

    _stop_counting()
    return profiling.counters()


def device_launches(fn) -> tuple:
    """``fn()`` under torch.profiler, and the launches of the four MSDA
    kernels (every instantiation of each) that the profiler saw the device
    run meanwhile: kernels replayed from a CUDA graph count as they run,
    where the launch counters add at a replay what its capture recorded.
    Returns (``fn()``'s result, the counts as ``launch_counts`` keys them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return out, {name: sum(e.count for e in events if f"{name}_kernel<" in e.key)
                 for name in ("msda_fwd", "msda_bwd", "msda3d_fwd", "msda3d_bwd")}


def launch_counts() -> dict:
    """The launches of the four MSDA kernels since ``reset_launch_counts``."""
    c = _counters()
    return {"msda_fwd": c.get("msda.fwd", 0), "msda_bwd": c.get("msda.bwd", 0),
            "msda3d_fwd": c.get("msda3d.fwd", 0), "msda3d_bwd": c.get("msda3d.bwd", 0)}


def adamw_launches() -> int:
    """The flat AdamW update kernel's launches since ``reset_launch_counts``."""
    return _counters().get("flat_adamw.launches", 0)


def adamw_per_step(state) -> int:
    """Update kernel launches a step of ``state``'s optimizer makes: 1 for
    the flat AdamW, 0 for torch.optim.AdamW (--no-flat_opt)."""
    return state.optimizer.update_launches


def train_run(state, step, batches, label: str, tag: str) -> dict:
    """train_one_epoch over ``batches``: finite losses, the MSDA launch
    counts of the run, one flat AdamW update launch a step (none with
    ``--no-flat_opt``)."""
    from tce_rvos_tpu_torch.engine import train_one_epoch

    losses = []

    def logged(st, batch):
        st, metrics = step(st, batch)
        losses.append(float(metrics["loss"]))
        return st, metrics

    reset_launch_counts()
    train_one_epoch(state, logged, batches, epoch=0, print_freq=5)
    counts, adamw = launch_counts(), adamw_launches()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label} {tag}: a loss is not finite: {losses}")
    if adamw != adamw_per_step(state) * len(batches):
        raise AssertionError(f"{label} {tag}: {adamw} flat AdamW update launches over "
                             f"{len(batches)} steps, expected {adamw_per_step(state)} a step")
    n_steps = len(batches)
    out = dict(steps=n_steps, losses=losses, launches=counts["msda_fwd"],
               backward_launches=counts["msda_bwd"], launches_3d=counts["msda3d_fwd"],
               backward_launches_3d=counts["msda3d_bwd"], adamw_launches=adamw)
    log(f"{label} {tag}: {n_steps} steps, losses {[round(x, 4) for x in losses]}; "
        f"MSDA launches forward {counts['msda_fwd']}, backward {counts['msda_bwd']}, "
        f"3D forward {counts['msda3d_fwd']}, 3D backward {counts['msda3d_bwd']}; flat AdamW "
        f"update launches {adamw}")
    return out


def phase_train(sd) -> dict:
    """The flagship training path on the card: train_one_epoch over
    TRAIN_STEPS bf16 steps with dropout, then recomputation (use_checkpoint)
    against none, then steps with recomputation. Returns the numbers."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        forward_losses,
        make_train_step,
    )

    label = "[train]"
    dev = torch.device("cuda")
    cfg = flagship_config(compute_dtype="bfloat16")
    tcfg = TrainConfig()
    model = ReferFormer(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(dev)  # float32 master weights
    spe = 1000     # an epoch far longer than this run: no LR drop inside it
    state = create_train_state(model, tcfg, steps_per_epoch=spe)
    crit = criterion_from_configs(cfg, tcfg)
    step = make_train_step(crit, cfg.compute_dtype)
    batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=10 + i), dev)
               for i in range(TRAIN_STEPS)]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    def run(n_steps: int, tag: str) -> dict:
        return train_run(state, step, batches[:n_steps], label, tag)

    result = {"plain": run(TRAIN_STEPS, "bf16 train_one_epoch, no recomputation")}
    if (result["plain"]["launches"], result["plain"]["backward_launches"]) != (
            12 * TRAIN_STEPS, 12 * TRAIN_STEPS):
        raise AssertionError(f"{label} MSDA launches {result['plain']['launches']} forward / "
                             f"{result['plain']['backward_launches']} backward, expected 12 + 12 "
                             f"per step x {TRAIN_STEPS}")
    for name in ("transformer.encoder.layers.0.self_attn.value_proj.weight",
                 "transformer.encoder.layers.0.self_attn.sampling_offsets.weight"):
        grad = model.get_parameter(name).grad
        if grad is None or float(grad.abs().max()) == 0.0:
            raise AssertionError(f"{label} {name} has no gradient: MSDA's backward is not wired")
    every_parameter_learns(model, start, label, "value_proj and sampling_offsets of encoder "
                                                "layer 0 included")
    del start

    # recomputation against none: one f32 step's gradients from the same
    # state, dropout off; a second run without recomputation reads the noise
    model.eval()

    def grads_of(ckpt: bool):
        model.transformer.use_checkpoint = ckpt
        model.zero_grad(set_to_none=True)
        reset_launch_counts()
        total, _ = forward_losses(model, batches[0], crit, "float32")
        total.backward()
        torch.cuda.synchronize()
        launched = launch_counts()
        counts = (launched["msda_fwd"], launched["msda_bwd"])
        return (float(total.detach()),
                {n: p.grad.float().clone() for n, p in model.named_parameters()}, counts)

    loss0, g0, c0 = grads_of(False)
    loss_n, g_n, _ = grads_of(False)
    loss1, g1, c1 = grads_of(True)
    if c0 != (12, 12) or c1 != (24, 12):
        raise AssertionError(f"{label} MSDA launches (forward, backward) per step: {c0} without "
                             f"recomputation (expected (12, 12)), {c1} with (expected (24, 12))")
    if not (loss0 == loss_n == loss1):
        raise AssertionError(f"{label} the loss with dropout off changed: {loss0}, {loss_n}, {loss1}")
    noise = grad_gap(g_n, g0, f"{label} f32 run-to-run, no recomputation",
                     l2_tol=math.inf, elem_tol=math.inf)
    gap = grad_gap(g1, g0, f"{label} f32 recomputation against none",
                   l2_tol=CKPT_L2_TOL, elem_tol=CKPT_ELEM_TOL)
    log(f"{label} MSDA launches per f32 step: {c0[0]} forward + {c0[1]} backward without "
        f"recomputation, {c1[0]} + {c1[1]} with")
    del g0, g_n, g1
    result.update(ckpt_gap=gap, noise_gap=noise, launches_per_step=c0, launches_per_step_ckpt=c1)

    model.transformer.use_checkpoint = True
    result["ckpt"] = run(TRAIN_STEPS_CKPT, "bf16 train_one_epoch, with recomputation")
    if (result["ckpt"]["launches"], result["ckpt"]["backward_launches"]) != (
            24 * TRAIN_STEPS_CKPT, 12 * TRAIN_STEPS_CKPT):
        raise AssertionError(f"{label} with recomputation: MSDA launches "
                             f"{result['ckpt']['launches']} / {result['ckpt']['backward_launches']}")
    del state, model, batches
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 5b: the fused flat AdamW (parallel/flat_adamw.py, csrc/flat_adamw.cu)
# ---------------------------------------------------------------------------

# the update reads g, p, mu and nu and writes p, mu and nu (f32): 28 bytes
# and 16 floating-point operations an element (the clip's scale, two for
# mu, four for nu, two bias corrections, the root, eps, the quotient, the
# decay, the LR and the difference); the norm reads g once more
ADAMW_BYTES, ADAMW_FLOPS, NORM_BYTES = 28, 16, 4
# p, mu and nu against the plain version: bitwise equal (every operation
# is rounded alone on both sides, __f*_rn against torch's one kernel an
# operation); weight decays of the default and of 0.1, whose term
# lr * wd * |p| (1e-5 |p|) stands far above the rounding of p
ADAMW_WDS = (None, 0.1)
ADAMW_AB_STEPS = 6  # bf16 steps of each of the flat AdamW and --no-flat_opt


def adamw_cases(lay, gen, dev):
    """Seeded flat buffers at the layout's live width (p ~ 0.05; each
    element's gradient and moments of one magnitude from 1e-6 to 1, so
    that sqrt(nu) runs from below eps to far above it) and two gradients,
    one with its norm below the clip and one far above it."""
    import torch

    n = lay.live_total
    mag = 10.0 ** (torch.rand(n, generator=gen, device=dev) * 6 - 6)
    p = torch.randn(n, generator=gen, device=dev) * 0.05
    mu = torch.randn(n, generator=gen, device=dev) * mag * 1e-4
    nu = torch.rand(n, generator=gen, device=dev) * (mag * 1e-4) ** 2
    g = torch.randn(n, generator=gen, device=dev) * mag
    g /= torch.linalg.vector_norm(g)
    grads = {"below_clip": g * (0.2 * lay.clip), "above_clip": g * (100.0 * lay.clip)}
    del g, mag
    return p, mu, nu, grads


def adamw_against_plain(p, g, mu, nu, gn, s, kernel=None) -> dict:
    """The update kernel (``kernel``: the wrapper, or it with other
    scalars) and ``flat_adamw_update_plain`` on copies of the same buffers:
    each of p, mu and nu bitwise equal or not, and max |kernel - plain|."""
    import torch

    from tce_rvos_tpu_torch.ops.flat_adamw_cuda import flat_adamw_cuda
    from tce_rvos_tpu_torch.parallel.flat_adamw import flat_adamw_update_plain

    bufs = {}
    for side, update in (("kernel", kernel or flat_adamw_cuda), ("plain", flat_adamw_update_plain)):
        pk, mk, vk = p.clone(), mu.clone(), nu.clone()
        update(pk, g, mk, vk, gn, s)
        bufs[side] = (pk, mk, vk)
    torch.cuda.synchronize()
    out = {name: dict(equal=bool(torch.equal(a, b)), max_abs_err=float((a - b).abs().max()))
           for name, a, b in zip(("p", "mu", "nu"), bufs["kernel"], bufs["plain"])}
    del bufs
    return out


def flagship_layout(tcfg):
    """The flat layout of the full-width flagship's parameters (built on the
    meta device: shapes only)."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.flat_adamw import make_layout

    with torch.device("meta"):
        model = ReferFormer(flagship_config())
    return make_layout(model, tcfg, steps_per_epoch=1000)


def adamw_library(lay, p, g, s) -> dict:
    """torch.optim.AdamW over the same parameters (one tensor a parameter,
    copies of the flat buffers) in the same tier groups at the same LRs:
    fused (one call of its kernels: ``library_ms``) and the default foreach
    implementation, each alone and after the port's per-leaf clip
    (``_foreach_norm``, the norm of the norms, ``_foreach_mul_``), timed
    with CUDA events around each call (its host share included)."""
    import torch

    out = {}
    for impl in ("fused", "foreach"):
        pl, gl = p.clone(), g.clone()
        params = [pl[o:o + sz].view(sh) for o, sz, sh in zip(lay.offsets, lay.sizes, lay.shapes)]
        grads = [gl[o:o + sz].view(sh) for o, sz, sh in zip(lay.offsets, lay.sizes, lay.shapes)]
        for q, gq in zip(params, grads):
            q.grad = gq
        groups = []
        for (t_lo, t_hi, _), lr in zip(lay.tier_slices, s.lrs):
            idx = [i for i, o in enumerate(lay.offsets) if t_lo <= o < t_hi]
            groups.append({"params": [params[i] for i in idx], "lr": lr})
        opt = torch.optim.AdamW(groups, betas=(s.b1, s.b2), eps=s.eps, weight_decay=lay.wd,
                                **{impl: True})
        opt.step()  # its state, allocated at the first step
        out[impl] = cuda_ms(opt.step, reps=10, warmup=2)

        def clipped():
            gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, torch.where(gn < lay.clip, 1.0, lay.clip / gn))
            opt.step()

        out[f"{impl}_clip"] = cuda_ms(clipped, reps=10, warmup=2)
        del opt, params, grads, groups, pl, gl
        torch.cuda.empty_cache()
    return out


def explain_gap(gap: dict, want: dict, got: dict, start: dict, tcfg, grads=None) -> dict:
    """Where a first step's largest parameter gap (``check_dp_step``'s
    ``param_worst``) is, read through Adam's first update, which is about
    ``-lr g / (|g| + eps)`` (plus the decay): on each side the move of the
    element, its Adam ratio ``a = -(p1 - p0 (1 - lr wd)) / lr`` and the
    clipped gradient ``g / eps = a / (1 - |a|)`` that ratio implies; with
    ``grads`` (the reference's clipped gradients) the reference's own."""
    from tce_rvos_tpu_torch.parallel.flat_adamw import EPS
    from tce_rvos_tpu_torch.parallel.train_step import param_group, tier_lrs

    name, i = gap["param_worst"]
    p0 = float(start[name].flatten()[i])
    lr = tier_lrs(tcfg)[param_group(name, tcfg)]
    out = dict(name=name, index=i, p0=p0, lr=lr)
    for side, run in (("want", want), ("got", got)):
        p1 = float(run["params"][name].flatten()[i])
        a = -(p1 - p0 * (1 - lr * tcfg.weight_decay)) / lr
        out[side] = dict(move=p1 - p0, adam=a, g_over_eps=a / max(1 - abs(a), 1e-6))
    if grads is not None:
        out["want"]["g_clipped_over_eps"] = float(grads[name].flatten()[i]) / EPS
    return out


def gap_line(w: dict) -> str:
    return (f"largest at {w['name']}[{w['index']}] (p0 {w['p0']:.6e}, lr {w['lr']:.1e}): moved "
            f"{w['want']['move']:.6e} against {w['got']['move']:.6e}, Adam ratios "
            f"{w['want']['adam']:.4f} and {w['got']['adam']:.4f}, clipped gradients of about "
            f"{w['want']['g_over_eps']:.3f} and {w['got']['g_over_eps']:.3f} eps"
            + (f" (the reference's: {w['want']['g_clipped_over_eps']:.3f} eps)"
               if "g_clipped_over_eps" in w["want"] else ""))


def phase_flat_adamw(sd) -> dict:
    """Phase 5b, the fused flat AdamW on the card:
    1. its update kernel against ``flat_adamw_update_plain`` at the
       flagship's full width (183,506,503 parameters in its four tiers,
       each at a 256-byte boundary), from seeded buffers, at Adam steps 1
       and 1000 with the gradient norm below and above the clip, at the
       default weight decay and at 0.1: p, mu and nu bitwise equal; the
       same gate refuses the kernel launched without decay or eps;
    2. its time by CUDA-graph replay, alone and after the norm, against
       their bounds (28 and 32 bytes an element over 3.35 TB/s), the plain
       version's and torch.optim.AdamW's (fused and foreach, alone and with
       the per-leaf clip) over the same parameters and tiers;
    3. the flagship's f32 step (dropout off, 2x192x320) with the flat
       AdamW against ``--no-flat_opt`` from the same weights: the loss
       bitwise equal (the forward through the aligned views runs the
       per-leaf kernels), the rest at the JAX package's DP tolerances
       (``dryrun.DP_TOL``), where the largest parameter gap is;
    4. the same two models' bf16 steps (dropout on): one update launch a
       flat step and none a ``--no-flat_opt`` one.
    Phase 5's run gives the main path's launches: one update a step."""
    import dataclasses

    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.ops.flat_adamw_cuda import flat_adamw_cuda
    from tce_rvos_tpu_torch.parallel import dryrun
    from tce_rvos_tpu_torch.parallel.flat_adamw import (
        flat_adamw_update_plain,
        global_norm,
        update_scalars,
    )
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    label = "[flat adamw]"
    dev = torch.device("cuda")
    tcfg = TrainConfig()
    lay = flagship_layout(tcfg)
    n = lay.live_total
    if lay.frozen_len:  # the default tiers: every parameter live
        raise AssertionError(f"{label} the flagship's layout freezes {lay.frozen_len} elements")
    gen = torch.Generator(device=dev).manual_seed(12)
    p, mu, nu, grads = adamw_cases(lay, gen, dev)

    # 1. the kernel against the plain version, bitwise; then the kernel
    # launched without its weight decay and without eps, which the same
    # gate must refuse
    cases, worst = {}, 0.0
    for count in (1, 1000):
        for which, g in grads.items():
            gn = global_norm(g)
            for wd in ADAMW_WDS:
                lay_wd = lay if wd is None else dataclasses.replace(lay, wd=wd)
                s = update_scalars(lay_wd, count - 1, sched=count - 1)
                got = adamw_against_plain(p, g, mu, nu, gn, s)
                errs = {k: v["max_abs_err"] for k, v in got.items()}
                tag = f"count{count}/{which}/wd{lay_wd.wd}"
                cases[tag] = dict(gnorm=float(gn), max_abs_err=errs)
                worst = max(worst, max(errs.values()))
                log(f"{label} {tag} (gnorm {float(gn):.4e}, clip {lay.clip}): max "
                    f"|kernel - plain| p {errs['p']:.3e}, mu {errs['mu']:.3e}, nu "
                    f"{errs['nu']:.3e}; bitwise equal: {all(v['equal'] for v in got.values())}")
                if not all(v["equal"] for v in got.values()):
                    raise AssertionError(f"{label} {tag}: the kernel is not bitwise the plain "
                                         f"version: max |kernel - plain| {errs}")
    s = update_scalars(lay, 999, sched=999)
    g = grads["below_clip"]
    gn = global_norm(g)
    refused = {}
    for name, wrong in (("no decay", s._replace(decays=(1.0,) * len(s.his))),
                        ("no eps", s._replace(eps=0.0))):
        got = adamw_against_plain(p, g, mu, nu, gn, s,
                                  kernel=lambda *a, w=wrong: flat_adamw_cuda(*a[:5], w))
        refused[name] = got["p"]["max_abs_err"]
        if got["p"]["equal"]:
            raise AssertionError(f"{label} the gate passes the kernel launched with {name}")
    log(f"{label} the gate refuses the kernel launched without its weight decay (max |p - "
        f"plain| {refused['no decay']:.3e}) and without eps ({refused['no eps']:.3e}), at "
        "count 1000, the default weight decay, below the clip")

    # 2. times
    g = grads["above_clip"]
    del grads["below_clip"]
    s = update_scalars(lay, 999, sched=999)
    gn = global_norm(g)
    pk, mk, vk = p.clone(), mu.clone(), nu.clone()
    ms = graph_ms(lambda: flat_adamw_cuda(pk, g, mk, vk, gn, s))
    pair_ms = graph_ms(lambda: flat_adamw_cuda(pk, g, mk, vk, global_norm(g), s))
    norm_ms = graph_ms(lambda: global_norm(g))
    plain_ms = cuda_ms(lambda: flat_adamw_update_plain(pk, g, mk, vk, gn, s), reps=5, warmup=1)
    del pk, mk, vk
    torch.cuda.empty_cache()
    library = adamw_library(lay, p, g, s)
    del p, mu, nu, g, grads
    torch.cuda.empty_cache()
    bytes_ms = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3
    ops_ms = ADAMW_FLOPS * n / FP32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    pair_bound_ms = (ADAMW_BYTES + NORM_BYTES) * n / HBM_BYTES_PER_S * 1e3
    log(f"{label} {n} elements ({sum(lay.sizes)} parameters and their padding to 256-byte "
        f"boundaries) in {len(lay.tier_slices)} tiers: the update kernel "
        f"{ms:.4f} ms (graph replay) against its bound {bound_ms:.4f} ms ({bound_by}: "
        f"{ADAMW_BYTES} B an element over 3.35 TB/s; {ADAMW_FLOPS} flops an element over "
        f"67 TFLOP/s: {ops_ms:.4f} ms), {100 * bound_ms / ms:.1f}% of it; norm + update "
        f"{pair_ms:.4f} ms against {pair_bound_ms:.4f}; the norm alone {norm_ms:.4f} ms; the "
        f"plain version {plain_ms:.3f} ms; torch.optim.AdamW over the same {len(lay.names)} "
        f"tensors in the same tiers: fused {library['fused']:.3f} ms (with the per-leaf clip "
        f"{library['fused_clip']:.3f}), foreach {library['foreach']:.3f} ms (with the clip "
        f"{library['foreach_clip']:.3f})")

    # 3. two flagship models from the same weights, one per optimizer: one
    # f32 step each (dropout off), flat against --no-flat_opt
    cfg = flagship_config(compute_dtype="bfloat16")
    crit = criterion_from_configs(cfg, tcfg)
    batch = train_batch(PARITY_T, PARITY_HW, seed=3)
    states, runs = {}, {}
    for flat_opt in (True, False):
        model = ReferFormer(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(dev).eval()
        states[flat_opt] = create_train_state(model, TrainConfig(flat_opt=flat_opt),
                                              steps_per_epoch=1000)
        _, m = make_train_step(crit)(states[flat_opt], batch)  # f32: no compute dtype
        runs[flat_opt] = {"metrics": {k: float(v) for k, v in m.items()},
                          "params": {k: v.detach().cpu() for k, v in model.named_parameters()}}
    step_gap = dryrun.check_dp_step(runs[True], runs[False], f"{label} f32 step, flat against "
                                                            "--no-flat_opt")
    # with every parameter at a 256-byte boundary the forward through the
    # flat buffer's views runs the kernels the per-leaf tensors get
    step_gap["loss_equal"] = runs[True]["metrics"]["loss"] == runs[False]["metrics"]["loss"]
    if not step_gap["loss_equal"]:
        raise AssertionError(f"{label} the f32 loss through the flat buffer "
                             f"{runs[True]['metrics']['loss']!r} is not --no-flat_opt's "
                             f"{runs[False]['metrics']['loss']!r} from the same weights")
    step_gap["worst"] = explain_gap(step_gap, runs[False], runs[True], sd, tcfg)
    log(f"{label} the flagship's f32 step with the flat AdamW against --no-flat_opt from the "
        f"same weights: loss {step_gap['loss_rel']:.3e} rel (bitwise equal: "
        f"{step_gap['loss_equal']}), grad norm {step_gap['grad_norm_rel']:.3e} rel, parameters "
        f"{step_gap['param_max_abs']:.3e} abs (limits {dryrun.DP_TOL}); "
        + gap_line(step_gap["worst"]))
    del runs

    # 4. their bf16 steps (dropout on)
    step = make_train_step(crit, cfg.compute_dtype)
    batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=10 + i), dev)
               for i in range(ADAMW_AB_STEPS)]
    bf16 = {}
    for flat_opt, name in ((True, "flat"), (False, "no_flat_opt")):
        states[flat_opt].model.train()
        tag = "bf16 steps, flat AdamW" if flat_opt else "bf16 steps, --no-flat_opt"
        run = train_run(states[flat_opt], step, batches, label, tag)
        bf16[name] = dict(adamw_launches_per_step=run["adamw_launches"] / run["steps"])
    del states, batches, step
    torch.cuda.empty_cache()
    log(f"{label} update launches a bf16 step: flat {bf16['flat']['adamw_launches_per_step']}, "
        f"--no-flat_opt {bf16['no_flat_opt']['adamw_launches_per_step']}")
    return dict(elements=n, parameters=sum(lay.sizes), tiers=[list(t) for t in lay.tier_slices],
                cases=cases,
                max_abs_err=worst, gate_refuses=refused, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms, pair_ms=pair_ms,
                pair_bound_ms=pair_bound_ms, norm_ms=norm_ms, library=library,
                library_ms=library["fused"], step_gap=step_gap, bf16_step=bf16)


TRAIN_STEPS_3D = 4


def phase_train_3d(sd3) -> dict:
    """The temporal-MSDA flagship (``--msda_3d``) training path on the card:
    train_one_epoch over TRAIN_STEPS_3D bf16 steps with dropout (b = 1,
    5x384x640); finite losses, 8 + 8 3D and 4 + 4 2D MSDA launches per
    step, a non-zero gradient on every trainable parameter, the temporal
    rows (every third) of each 3D ``sampling_offsets.weight`` included, and
    every parameter moved."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.models.transformer import MSDeformAttn
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    label = "[train 3d]"
    dev = torch.device("cuda")
    cfg = flagship_config(msda_3d=True, compute_dtype="bfloat16")
    tcfg = TrainConfig()
    model = ReferFormer(cfg)
    model.load_state_dict(sd3, strict=True)
    model.to(dev)
    state = create_train_state(model, tcfg, steps_per_epoch=1000)
    step = make_train_step(criterion_from_configs(cfg, tcfg), cfg.compute_dtype)
    batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=30 + i), dev)
               for i in range(TRAIN_STEPS_3D)]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    result = train_run(state, step, batches, label, "bf16 train_one_epoch")
    per_step = {k: result[k] // TRAIN_STEPS_3D for k in
                ("launches", "backward_launches", "launches_3d", "backward_launches_3d")}
    counts = (result["launches_3d"], result["backward_launches_3d"], result["launches"],
              result["backward_launches"])
    if counts != (8 * TRAIN_STEPS_3D, 8 * TRAIN_STEPS_3D, 4 * TRAIN_STEPS_3D, 4 * TRAIN_STEPS_3D):
        raise AssertionError(f"{label} MSDA launches (3D forward, 3D backward, 2D forward, 2D "
                             f"backward) {counts}, expected 8 + 8 and 4 + 4 per step x "
                             f"{TRAIN_STEPS_3D}")
    no_grad = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
               and (p.grad is None or float(p.grad.abs().max()) == 0.0)]
    still = [n for n, p in model.named_parameters() if not zero_in_exact_arithmetic(n)
             and torch.equal(p.detach(), start[n])]
    temporal = {}
    for name, mod in model.named_modules():
        if isinstance(mod, MSDeformAttn) and mod.is_3d:
            g = mod.sampling_offsets.weight.grad.reshape(-1, 3, cfg.hidden_dim)[:, 2]
            temporal[name] = float((g.abs().amax(-1) > 0).float().mean())
    if no_grad or still or len(temporal) != 8 or min(temporal.values()) == 0.0:
        raise AssertionError(f"{label} parameters without a gradient: {no_grad}; parameters "
                             f"that did not move: {still}; share of temporal offset rows with "
                             f"a gradient per 3D module: {temporal}")
    log(f"{label} all {sum(1 for _ in model.parameters())} parameters have a non-zero gradient "
        f"and moved (the text encoder's key biases aside); launches per step {per_step}; share "
        f"of the temporal rows of sampling_offsets.weight with a non-zero gradient, per 3D "
        f"module: " + ", ".join(f"{k.replace('transformer.', '')} {v:.3f}"
                                for k, v in temporal.items()))
    result.update(launches_per_step=per_step, temporal_rows_with_grad=temporal)
    del state, model, batches, start
    torch.cuda.empty_cache()
    return result


def phase_train_parity(sd, msda_3d: bool = False) -> None:
    """One f32 train step (TF32 off, dropout off) from the same weights and
    batch on the GPU (MSDA kernels) and on the CPU (plain MSDA): losses,
    grad norm and every parameter's gradient (before the optimizer, after
    the clip, which scales both by nearly the same factor). For the
    flagship or, with ``msda_3d``, its temporal-MSDA variant."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import create_train_state, make_train_step

    label = "[train parity 3d]" if msda_3d else "[train parity]"
    expected = ({"msda_fwd": 4, "msda_bwd": 4, "msda3d_fwd": 8, "msda3d_bwd": 8} if msda_3d
                else {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0})
    cfg = flagship_config(msda_3d=msda_3d)
    tcfg = TrainConfig()
    batch = train_batch(PARITY_T, PARITY_HW, seed=3)
    metrics, grads = {}, {}
    for dev in ("cuda", "cpu"):
        model = ReferFormer(cfg)
        model.load_state_dict(sd, strict=True)
        model.to(dev).eval()
        state = create_train_state(model, tcfg)
        step = make_train_step(criterion_from_configs(cfg, tcfg))
        reset_launch_counts()
        _, m = step(state, batch)
        metrics[dev] = {k: float(v) for k, v in m.items()}
        launched = launch_counts()
        if adamw_launches() != (1 if dev == "cuda" else 0):
            raise AssertionError(f"{label} {dev} step launched the flat AdamW update "
                                 f"{adamw_launches()} times, expected once on the GPU only")
        log(f"{label} {dev}: one f32 step on a {PARITY_T}x{PARITY_HW[0]}x{PARITY_HW[1]} "
            f"clip, loss {metrics[dev]['loss']:.6f}, MSDA launches {launched}")
        if launched != (expected if dev == "cuda" else {k: 0 for k in expected}):
            raise AssertionError(f"{label} {dev} step launched MSDA kernels {launched}, "
                                 f"expected {expected} on the GPU and none on the CPU")
        grads[dev] = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        del model, state
    torch.cuda.empty_cache()
    for k, want in metrics["cpu"].items():
        got = metrics["cuda"][k]
        if abs(got - want) > 2e-3 * abs(want) + (2e-3 if k.startswith("loss") else 0.0):
            raise AssertionError(f"{label} {k}: GPU {got} against CPU {want}")
    log(f"{label} GPU against CPU: " + ", ".join(
        f"{k} {metrics['cuda'][k]:.6g}/{metrics['cpu'][k]:.6g}" for k in ("loss", "grad_norm")))
    grad_gap(grads["cuda"], grads["cpu"], f"{label} GPU against CPU",
             l2_tol=PARITY_L2_TOL, elem_tol=PARITY_ELEM_TOL)


def step_gradients(sd, msda_3d: bool, device: str, dtype) -> tuple:
    """One train step's loss and gradients (the phase-6 batch, dropout off,
    no optimizer and no clip) on ``device`` in ``dtype``, with the launches
    of the MSDA kernels it made; gradients as float64 on the CPU. In
    float64 the locations are rounded to f32 as the model passes them, and
    the plain ops compute in float64."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import batch_to_device, forward_losses

    cfg = flagship_config(msda_3d=msda_3d)
    crit = criterion_from_configs(cfg, TrainConfig())
    batch = batch_to_device(train_batch(PARITY_T, PARITY_HW, seed=3), torch.device(device))
    model = ReferFormer(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(device=device, dtype=dtype).eval()
    reset_launch_counts()
    total, _ = forward_losses(model, dict(batch, video=batch["video"].to(dtype)), crit)
    total.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    return float(total), grads, launch_counts()


def phase_train_against_f64(msda_3d: bool = True) -> dict:
    """One f32 train step on the GPU (kernels) and on the CPU (plain MSDA),
    each against the same step in float64 on the CPU, at the weights of
    seeds 0 and 1. How far the CPU's f32 step lies from float64 is a
    reading: on these weights f32 arithmetic itself meets taps within
    rounding of an integer frame, where the 3D op's temporal derivative
    jumps (the right derivative), and two f32 runs may land on either side
    (1.6e-3 of the largest |grad| at seed 0). The GPU's step is held to
    lie no farther from float64 than the CPU's own f32 step does, plus the
    GPU-against-CPU limits (PARITY_L2_TOL of a gradient's norm,
    PARITY_ELEM_TOL of the largest |grad|); its loss within 2e-3 relative
    of float64's plus the CPU's own gap."""
    import torch

    from tce_rvos_tpu_torch import flagship_config

    tag = "3d" if msda_3d else "2d"
    expected = ({"msda_fwd": 4, "msda_bwd": 4, "msda3d_fwd": 8, "msda3d_bwd": 8} if msda_3d
                else {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0})
    readings = {}
    for seed in (0, 1):
        label = f"[train vs f64 {tag}, weights of seed {seed}]"
        sd = random_state_dict(flagship_config(msda_3d=msda_3d), seed=seed)
        runs = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cpu", torch.float64)):
            runs[(dev, dtype)] = step_gradients(sd, msda_3d, dev, dtype)
            launched = runs[(dev, dtype)][2]
            want = expected if dev == "cuda" else {k: 0 for k in expected}
            if launched != want:
                raise AssertionError(f"{label} {dev} {dtype} step launched MSDA kernels "
                                     f"{launched}, expected {want}")
            log(f"{label} {dev} {dtype_name(dtype)}: loss {runs[(dev, dtype)][0]:.9f}, "
                f"launches {launched}")
        del sd
        torch.cuda.empty_cache()
        loss64, g64, _ = runs[("cpu", torch.float64)]
        loss_cpu, g_cpu, _ = runs[("cpu", torch.float32)]
        loss_gpu, g_gpu, _ = runs[("cuda", torch.float32)]
        cpu = grad_gap(g_cpu, g64, f"{label} CPU f32 against f64, a reading",
                       l2_tol=math.inf, elem_tol=math.inf)
        gpu = grad_gap(g_gpu, g64, f"{label} GPU f32 against f64", l2_tol=PARITY_L2_TOL + cpu["l2"],
                       elem_tol=PARITY_ELEM_TOL + cpu["elem"])
        loss_limit = 2e-3 * abs(loss64) + abs(loss_cpu - loss64)
        if abs(loss_gpu - loss64) > loss_limit:
            raise AssertionError(f"{label} GPU f32 loss {loss_gpu} against f64 {loss64}: "
                                 f"limit {loss_limit}")
        log(f"{label} held: the GPU's f32 step lies {gpu['elem']:.3e} of the largest |grad| "
            f"from f64 (limit {PARITY_ELEM_TOL} + the CPU's {cpu['elem']:.3e}) and "
            f"{gpu['l2']:.3e} of a gradient's norm (limit {PARITY_L2_TOL} + {cpu['l2']:.3e}); "
            f"loss gaps GPU {abs(loss_gpu - loss64):.3e}, CPU {abs(loss_cpu - loss64):.3e}")
        readings[seed] = dict(cpu=cpu, gpu=gpu)
    return readings


# ---------------------------------------------------------------------------
# phase 9: the memory envelope and the inference protocols
# ---------------------------------------------------------------------------

# (E, T) points of the envelope fit per compute dtype: E x T frames from 5 to
# 160 in bf16 (the whole-video dispatch of 4 expressions x 40 frames), to 80
# in f32
ENVELOPE_POINTS = {"bfloat16": ((1, 5), (2, 10), (4, 20), (8, 20), (4, 40)),
                   "float32": ((1, 5), (2, 10), (4, 20), (2, 40))}


def phase_envelope(sd, frames, hold: bool = True) -> dict:
    """Peak memory (``max_memory_allocated`` less what was allocated before
    the engine was built; the weights and the window's backbone features
    resident) of one eager trunk forward at 384x640 at the
    (E, T) points of ENVELOPE_POINTS, per compute dtype; the least-squares
    line peak = base + per_frame x E x T and its largest residual, printed
    for ``infer._ENVELOPE_GIB``. ``hold``: every measured point must lie on
    or under the line of ``infer._ENVELOPE_GIB``, so that the cap it gives
    (``trunk_frame_envelope``) keeps each measured dispatch within the
    card's memory. Then the CUDA graphs of ``infer.BACKBONE_GRAPH_KEYS``
    window shapes ``infer.backbone_graph_gate`` passes and of
    ``infer.GRAPH_KEYS`` dispatch shapes ``infer.graph_gate`` passes: the
    device memory an engine keeps for each (static inputs and outputs, the
    graphs' pools) once each shape is captured and replayed, held
    together within the share of the card the cap leaves free
    (``graph_memory``)."""
    import numpy as np
    import torch

    from tce_rvos_tpu_torch import flagship_config, infer
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    fits = {}
    for name, points in ENVELOPE_POINTS.items():
        label = f"[envelope {name}]"
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 2**30  # left by earlier phases
        engine = infer.InferenceEngine(flagship_config(compute_dtype=name), sd, device="cuda")
        rows = []
        for e, t in points:
            video, mask, size = engine.preprocess([frames[i % len(frames)] for i in range(t)])
            sizes = size
            feats = engine._backbone_eager(video, mask)  # no backbone graph kept in the line
            ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = engine._trunk_eager(feats, mask, ids, attn, sizes)  # the line is eager's
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30 - before
            del out, feats, video, mask
            rows.append((e, t, peak))
            log(f"{label} E={e} T={t} (E*T={e * t}): trunk forward peak {peak:.4f} GiB")
        del engine
        torch.cuda.empty_cache()
        x = np.array([e * t for e, t, _ in rows], np.float64)
        y = np.array([peak for _, _, peak in rows], np.float64)
        slope, base = np.polyfit(x, y, 1)
        resid = float(np.abs(y - (base + slope * x)).max())
        ship_base, ship_slope = infer._ENVELOPE_GIB[name]
        cap = infer.trunk_frame_envelope((384, 640), name, device="cuda")
        log(f"{label} fit: peak_gib = {base:.4f} + {slope:.5f} x E*T, largest residual "
            f"{resid:.4f} GiB; infer._ENVELOPE_GIB: {ship_base} + {ship_slope} x E*T; cap on this "
            f"card ({total_gib:.2f} GiB): {cap} frames a dispatch, predicted peak "
            f"{ship_base + ship_slope * cap:.3f} GiB")
        over = [(e, t, peak) for e, t, peak in rows if peak > ship_base + ship_slope * e * t]
        if hold and over:
            raise AssertionError(f"{label} measured peaks above infer._ENVELOPE_GIB's line: {over}")
        fits[name] = dict(points=rows, base=float(base), per_frame=float(slope), resid=resid,
                          cap_frames=cap, total_gib=total_gib,
                          graphs=graph_memory(sd, frames, name, hold))
    return fits


# what ``graph_memory`` captures: (E, T) of the dispatches, frames as
# stored (FRAME_HW and portrait: buckets 384x640 and 640x384) and caption
# lengths in tokens
GRAPH_HOLD_SHAPES = ((1, 5), (1, 8), (1, 16), (2, 5), (2, 8), (4, 5))
GRAPH_HOLD_VARIANTS = ((FRAME_HW, 16), (FRAME_HW[::-1], 24), (FRAME_HW, 24),
                       (FRAME_HW[::-1], 16))


# what ``graph_memory`` captures of the backbone: window lengths, frames as
# stored (FRAME_HW) and portrait; and the families it captures: the
# flagship's ResNet-50 and the two whose captures keep the most a shape
# (Swin-L, Video-Swin-B; PERF.md)
BACKBONE_HOLD_FRAMES = (5, 4, 3, 2, 1)
BACKBONE_HOLD_FAMILIES = ("resnet50", "swin_l_p4w7", "video_swin_b_p4w7")


def backbone_hold_keys(dtype) -> list:
    """``infer.BACKBONE_GRAPH_KEYS`` distinct window shapes (T, frame size)
    that ``infer.backbone_graph_gate`` passes in ``dtype``: the largest Ts
    of BACKBONE_HOLD_FRAMES the gate passes at 384x640, each landscape,
    then portrait."""
    from tce_rvos_tpu_torch import infer

    ts = [t for t in BACKBONE_HOLD_FRAMES
          if infer.backbone_graph_gate(t, (384, 640), dtype, "cuda")]
    keys = [(t, hw) for t in ts for hw in (FRAME_HW, FRAME_HW[::-1])][:infer.BACKBONE_GRAPH_KEYS]
    assert len(set(keys)) == infer.BACKBONE_GRAPH_KEYS, keys
    return keys


def graph_hold_keys(dtype) -> list:
    """``infer.GRAPH_KEYS`` distinct dispatch shapes (E, T, frame size,
    caption tokens) that ``infer.graph_gate`` passes in ``dtype``: each
    (E, T) of GRAPH_HOLD_SHAPES the gate passes at 384x640, the largest
    first, in the first of GRAPH_HOLD_VARIANTS, then again in the next."""
    from tce_rvos_tpu_torch import infer

    shapes = sorted((s for s in GRAPH_HOLD_SHAPES
                     if infer.graph_gate(*s, (384, 640), dtype, "cuda")),
                    key=lambda s: -s[0] * s[1])
    keys = [shapes[i % len(shapes)] + GRAPH_HOLD_VARIANTS[i // len(shapes)]
            for i in range(infer.GRAPH_KEYS)]
    assert len(set(keys)) == infer.GRAPH_KEYS, keys
    return keys


def graph_memory(sd, frames, name: str, hold: bool) -> dict:
    """The device memory (``torch.cuda.mem_get_info``, the allocator's
    unused cache emptied before each reading) that an engine in compute
    dtype ``name`` keeps after capturing and replaying its backbone at
    each of ``backbone_hold_keys``, on each of BACKBONE_HOLD_FAMILIES
    (ResNet-50 with the flagship's weights ``sd``, the others drawn on the
    card), and the trunk at each of ``graph_hold_keys`` on the flagship
    (its features from the eager backbone; the other families' features
    have fewer channels), as many shapes as an engine keeps of each;
    ``hold``: all of them kept, the most any family's backbone keeps and
    the trunk's together within the share of the card that
    ``trunk_frame_envelope`` leaves to what is not a dispatch
    (1 - ``infer._MEMORY_SAFETY``)."""
    import numpy as np
    import torch

    from tce_rvos_tpu_torch import flagship_config, infer
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    label = f"[envelope {name}]"
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    dtype = getattr(torch, name)
    backbone_keys, keys = backbone_hold_keys(dtype), graph_hold_keys(dtype)

    def free() -> int:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info()[0]

    def clip_of(engine, t, hw):
        clip = [frames[i % len(frames)] for i in range(t)]
        if hw != clip[0].shape[:2]:  # portrait: the frames turned
            clip = [np.ascontiguousarray(f.transpose(1, 0, 2)) for f in clip]
        return engine.preprocess(clip)

    def backbone_kept(engine) -> tuple:
        """(GiB kept, shapes kept) after each of backbone_keys is captured
        and replayed."""
        before = free()
        for t, hw in backbone_keys:
            video, mask, _ = clip_of(engine, t, hw)
            for _ in range(2):  # the first dispatch captures, the second replays
                feats = engine.backbone(video, mask)
            del feats, video, mask
        return (before - free()) / 2**30, len(engine._backbone_graphs.entries)

    backbones = {}
    for family in BACKBONE_HOLD_FAMILIES[1:]:
        cfg = flagship_config(compute_dtype=name, backbone=family)
        family_sd = device_state_dict(flagship_config(backbone=family), seed=0)
        with torch.device("cuda"):  # the engine's model built on the card
            engine = infer.InferenceEngine(cfg, family_sd, device="cuda")
        del family_sd
        backbones[family] = backbone_kept(engine)
        del engine
        torch.cuda.empty_cache()
    engine = infer.InferenceEngine(flagship_config(compute_dtype=name), sd, device="cuda")
    backbones[BACKBONE_HOLD_FAMILIES[0]] = backbone_kept(engine)
    free_between = free()
    buckets = []
    for e, t, hw, tokens in keys:
        video, mask, size = clip_of(engine, t, hw)
        buckets.append(tuple(mask.shape[2:]))
        feats = engine._backbone_eager(video, mask)
        ids, attn = tokenize([CAPTIONS[i % len(CAPTIONS)] for i in range(e)], max_len=tokens)
        for _ in range(2):  # the first dispatch captures, the second replays
            out = engine.trunk(feats, mask, ids, attn, size)
        del out, feats, video, mask
    kept = (free_between - free()) / 2**30
    room = (1 - infer._MEMORY_SAFETY) * total_gib
    held = len(engine._graphs.entries)
    worst = max(gib for gib, _ in backbones.values())
    log(f"{label} backbone CUDA graphs of the window shapes (T, frames) {backbone_keys}: kept "
        + ", ".join(f"{f} {gib:.3f} GiB ({n} shapes)" for f, (gib, n) in backbones.items())
        + f"; trunk CUDA graphs of {held} shapes (E, T, frames, tokens) {keys}, buckets "
        f"{sorted(set(buckets))}: kept {kept:.3f} GiB; the most a backbone keeps and the "
        f"trunk's together {worst + kept:.3f} GiB of the card's {total_gib:.2f} GiB (room "
        f"beside the cap: {room:.2f} GiB)")
    del engine
    torch.cuda.empty_cache()
    if hold and not (all(n == len(backbone_keys) for _, n in backbones.values())
                     and held == infer.GRAPH_KEYS and worst + kept <= room):
        raise AssertionError(f"{label} CUDA graphs of the backbone ({backbones}: GiB, shapes) "
                             f"and of {held} trunk shapes ({kept:.3f} GiB) outside the "
                             f"{room:.2f} GiB beside the cap")
    return dict(keys=keys, buckets=buckets, kept_gib=kept, room_gib=room,
                backbone_keys=backbone_keys,
                backbone_kept_gib={f: gib for f, (gib, _) in backbones.items()})


PROTO_HW = (720, 1280)  # frames as stored: downscaled to 360x640 by the engine
PROTO_YTVOS = {"v12": (12, CAPTIONS[:2]), "v36": (36, CAPTIONS)}  # whole-video buckets 16, 40
PROTO_DAVIS = {"d20": (20, [f"{c} {a}" for c in ("the dog", "the horse")
                            for a in ("left", "running", "in front", "near the fence")])}
PROTO_MEVIS = {"m10": (10, CAPTIONS[:3])}
PROTO_SMALL = {"v6": (6, CAPTIONS[:2])}  # windows of 5 with a context frame a side


def write_tree(root: str, kind: str, videos: dict, test_only: dict = None, seed: int = 0,
               absent: dict = None) -> str:
    """A synthetic dataset on disk in the ``kind`` layout: smooth random JPEG
    frames at PROTO_HW and meta_expressions. ytvos, davis, mevis: the valid
    split; ``test_only`` videos are listed in the valid split and in the test
    split (so ytvos must skip them). train: the Ref-YouTube-VOS train split,
    captions given as (expression, object id), with meta.json (object 1 a
    person, 2 a dog) and palette PNG annotations of the two objects moving;
    object 2 leaves the frames ``absent[video]``."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = PROTO_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    split = "train" if kind == "train" else "valid"
    palette = [c for i in range(256) for c in (i, i, i)]
    meta = {}
    for video, (n, caps) in {**videos, **(test_only or {})}.items():
        d = os.path.join(root, split, "JPEGImages", video)
        os.makedirs(d)
        names = [f"{i:05d}" for i in range(n)]
        for i, name in enumerate(names):
            f = np.stack([0.5 + 0.5 * np.sin((xx * a + yy * b) / 80.0 + c)
                          for a, b, c in rng.rand(3, 3)], -1)
            Image.fromarray((f * 255).astype(np.uint8)).save(os.path.join(d, name + ".jpg"))
            if kind == "train":
                mask = np.zeros((h, w), np.uint8)
                mask[100 + 8 * i: 400 + 8 * i, 200 + 20 * i: 420 + 20 * i] = 1
                if i not in (absent or {}).get(video, ()):
                    mask[450 - 5 * i: 650 - 5 * i, 900 - 10 * i: 1200 - 10 * i] = 2
                png = Image.fromarray(mask, mode="P")
                png.putpalette(palette)
                a_dir = os.path.join(root, split, "Annotations", video)
                os.makedirs(a_dir, exist_ok=True)
                png.save(os.path.join(a_dir, name + ".png"), bits=8)
        meta[video] = {"frames": names, "expressions": {
            str(i): ({"exp": c[0], "obj_id": c[1]} if kind == "train" else {"exp": c})
            for i, c in enumerate(caps)}}
    split_dir = (os.path.join(root, "valid") if kind == "mevis"
                 else os.path.join(root, "meta_expressions", split))
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, "meta_expressions.json"), "w") as fh:
        json.dump({"videos": meta}, fh)
    if test_only:
        os.makedirs(os.path.join(root, "meta_expressions", "test"))
        with open(os.path.join(root, "meta_expressions", "test", "meta_expressions.json"),
                  "w") as fh:
            json.dump({"videos": {v: meta[v] for v in test_only}}, fh)
    if kind == "train":
        objects = {"1": {"category": "person"}, "2": {"category": "dog"}}
        with open(os.path.join(root, "train", "meta.json"), "w") as fh:
            json.dump({"videos": {v: {"objects": objects} for v in videos}}, fh)
    return root


def read_png(path: str):
    import numpy as np
    from PIL import Image

    img = Image.open(path)
    return img.mode, np.array(img), img.getpalette()


def check_binary_tree(out_dir: str, videos: dict, label: str) -> int:
    """Every PNG of a ytvos/mevis output tree: present, L mode, 0/255, at
    the original size. Returns the number of files."""
    import os

    n = 0
    for video, (n_frames, caps) in videos.items():
        for e in range(len(caps)):
            for i in range(n_frames):
                path = os.path.join(out_dir, "valid", video, str(e), f"{i:05d}.png")
                if not os.path.exists(path):
                    raise AssertionError(f"{label}: {path} missing")
                mode, m, _ = read_png(path)
                if mode != "L" or m.shape != PROTO_HW or not set(m.ravel().tolist()) <= {0, 255}:
                    raise AssertionError(f"{label}: {path} is {mode} {m.shape}, values "
                                         f"{sorted(set(m.ravel().tolist()))[:5]}")
                n += 1
    return n


def count_trunks(engine) -> list:
    """Wrap ``engine.trunk`` to record (E, T, 2D MSDA forward launches) of
    every trunk forward, counted while ``reset_launch_counts`` counts."""
    from tce_rvos_tpu_torch.utils import profiling

    calls = []
    trunk = engine.trunk

    def counted(feats, mask, ids, attn, sizes):
        before = profiling.counters().get("msda.fwd", 0)
        out = trunk(feats, mask, ids, attn, sizes)
        calls.append((len(ids), int(mask.shape[1]),
                      profiling.counters().get("msda.fwd", 0) - before))
        return out

    engine.trunk = counted
    return calls


def expected_trunks(n_exp: int, t_clip: int, dtype: str = "bfloat16", exp_batch: int = 8):
    """(E, T, 2D forward launches) of each trunk forward of one clip, as
    run_video_batch chunks ``n_exp`` expressions under the memory envelope
    at 384x640."""
    from tce_rvos_tpu_torch import infer

    cap = infer.trunk_frame_envelope((384, 640), dtype, device="cuda") // t_clip
    eb = max(1, min(exp_batch, infer._pow2_floor(max(cap, 1))))
    return [(infer._pow2_ceil(min(eb, n_exp - off)), t_clip, 12) for off in range(0, n_exp, eb)]


def protocol_launches(fn) -> dict:
    """Run ``fn`` (one protocol over a tree) with the launch counts at 0;
    the MSDA kernels' launches it made."""
    reset_launch_counts()
    fn()
    return launch_counts()


def phase_protocols(sd, sd3, root: str) -> dict:
    """The ytvos, davis and mevis protocols on synthetic trees of 720x1280
    JPEG frames under ``root``, flagship weights at full width:
    * ytvos, bf16, whole-video (windows of 16 and 40 frames, E = 2 and 4):
      every PNG present at the original size, the test-only video absent,
      each PNG bitwise the threshold of run_video_batch + select_query +
      masks_to_original on the same engine, 12 2D forward launches per
      trunk forward;
    * davis through ``infer.main`` (the command line on the card, bf16, its
      own seeded init, one 32-frame window, 8 expressions): palette PNGs;
    * mevis, bf16, windows of 5: PNGs;
    * ytvos windowed (5 frames, f_extra = 1) in f32 on the card and on the
      CPU: PNGs may differ only where the CPU's score lies within 2e-3 of
      the threshold;
    * ytvos windowed with the ``--msda_3d`` flagship (weights of seed 1),
      bf16: 8 3D and 4 2D forward launches per trunk forward; the
      whole-video batched-against-serial gap as a reading."""
    import os

    import numpy as np
    import torch

    from tce_rvos_tpu_torch import flagship_config, infer

    res = {}
    ytvos = write_tree(os.path.join(root, "ytvos"), "ytvos", PROTO_YTVOS,
                       test_only={"vtest": (3, CAPTIONS[:1])}, seed=10)
    davis = write_tree(os.path.join(root, "davis"), "davis", PROTO_DAVIS, seed=11)
    mevis = write_tree(os.path.join(root, "mevis"), "mevis", PROTO_MEVIS, seed=12)
    small = write_tree(os.path.join(root, "small"), "ytvos", PROTO_SMALL, seed=13)
    out = {k: os.path.join(root, "out_" + k) for k in
           ("ytvos", "davis", "mevis", "cuda", "cpu", "3d")}

    # ytvos, whole-video, bf16
    label = "[protocol ytvos bf16 whole-video]"
    engine = infer.InferenceEngine(flagship_config(compute_dtype="bfloat16"), sd, device="cuda")
    trunks = count_trunks(engine)
    res["ytvos"] = {"launches": protocol_launches(
        lambda: infer.run_ytvos(engine, ytvos, out["ytvos"]))}
    log(f"{label} trunk forwards (E, T, msda_fwd launches): {trunks}; launches "
        f"{res['ytvos']['launches']}")
    want = [t for n, c in PROTO_YTVOS.values() for t in expected_trunks(len(c), -(-n // 8) * 8)]
    if trunks != want or res["ytvos"]["launches"]["msda_fwd"] != 12 * len(want):
        raise AssertionError(f"{label} trunk forwards {trunks}, launches "
                             f"{res['ytvos']['launches']}; expected {want}, 12 a forward")
    files = check_binary_tree(out["ytvos"], PROTO_YTVOS, label)
    if os.path.exists(os.path.join(out["ytvos"], "valid", "vtest")):
        raise AssertionError(f"{label}: the test split's video was not skipped")
    for video, (n, caps) in PROTO_YTVOS.items():
        frames = [infer._load_frame(os.path.join(ytvos, "valid", "JPEGImages", video,
                                                 f"{i:05d}.jpg")) for i in range(n)]
        outs = engine.run_video_batch(frames, [" ".join(c.lower().split()) for c in caps],
                                      whole_video=True)
        for e, o in enumerate(outs):
            q = infer.select_query(o["pred_logits"])
            scores = infer.masks_to_original(o["pred_masks"][:, q], o["model_size"], PROTO_HW,
                                             device=engine.device)
            for i in range(n):
                _, png, _ = read_png(os.path.join(out["ytvos"], "valid", video, str(e),
                                                  f"{i:05d}.png"))
                if not np.array_equal(png, (scores[i] > 0.5).astype(np.uint8) * 255):
                    raise AssertionError(f"{label} {video}/{e}/{i:05d}.png is not the threshold "
                                         f"of run_video_batch on the same engine")
    log(f"{label} {files} PNGs at {PROTO_HW[0]}x{PROTO_HW[1]}, the test-only video skipped, "
        f"each bitwise the threshold of run_video_batch + select_query + masks_to_original")

    # mevis, windows of 5, bf16 (E = 3, padded to 4)
    label = "[protocol mevis bf16]"
    trunks.clear()
    (n, caps), = PROTO_MEVIS.values()
    windows = -(-n // engine.window)
    res["mevis"] = {"launches": protocol_launches(
        lambda: infer.run_mevis(engine, mevis, out["mevis"]))}
    want = expected_trunks(len(caps), engine.window) * windows
    if trunks != want:
        raise AssertionError(f"{label} trunk forwards {trunks}, expected {want}")
    check_binary_tree(out["mevis"], PROTO_MEVIS, label)
    del engine
    torch.cuda.empty_cache()

    # davis through the command line: bf16, the model's own init, window 32
    label = "[protocol davis bf16, infer.main]"
    (n, caps), = PROTO_DAVIS.values()
    chunks = len(expected_trunks(len(caps), 32))
    argv = ["--dataset_file", "davis", "--davis_path", davis, "--output_dir", out["davis"],
            "--binary", "--with_box_refine", "--f_token", "8", "--qtrans",
            "--compute_dtype", "bfloat16"]
    res["davis"] = {"launches": protocol_launches(lambda: infer.main(argv))}
    if res["davis"]["launches"]["msda_fwd"] != 12 * chunks:
        raise AssertionError(f"{label} launches {res['davis']['launches']}, expected 12 x "
                             f"{chunks} trunk forwards")
    palette = infer.davis_palette()
    for a in range(4):
        for i in range(n):
            path = os.path.join(out["davis"], "valid", f"anno_{a}", "d20", f"{i:05d}.png")
            if not os.path.exists(path):
                raise AssertionError(f"{label}: {path} missing")
            mode, m, pal = read_png(path)
            if (mode != "P" or m.shape != PROTO_HW or pal[:len(palette)] != palette
                    or not set(m.ravel().tolist()) <= {0, 1, 2}):
                raise AssertionError(f"{label}: {path} is {mode} {m.shape}, values "
                                     f"{sorted(set(m.ravel().tolist()))[:5]}")
    log(f"{label} {4 * n} palette PNGs at {PROTO_HW[0]}x{PROTO_HW[1]}, trunk forwards "
        f"(E, T, msda_fwd launches) {expected_trunks(len(caps), 32)}")

    # ytvos windowed, f32 (TF32 off): the card against the CPU
    label = "[protocol ytvos f32 windowed, GPU against CPU]"
    cpu_scores = []
    mto = infer.masks_to_original
    (n, caps), = PROTO_SMALL.values()
    for dev in ("cuda", "cpu"):
        engine = infer.InferenceEngine(flagship_config(), sd, device=dev, window=5)
        if dev == "cpu":
            def recording(*a, **k):
                cpu_scores.append(mto(*a, **k))
                return cpu_scores[-1]

            infer.masks_to_original = recording
        try:
            infer.run_ytvos(engine, small, out[dev], whole_video=False, f_extra=1)
        finally:
            infer.masks_to_original = mto
        del engine
    torch.cuda.empty_cache()
    n_diff = n_near = 0
    for e in range(len(caps)):
        for i in range(n):
            _, g, _ = read_png(os.path.join(out["cuda"], "valid", "v6", str(e), f"{i:05d}.png"))
            _, c, _ = read_png(os.path.join(out["cpu"], "valid", "v6", str(e), f"{i:05d}.png"))
            near = np.abs(cpu_scores[e][i] - 0.5) <= 2e-3
            n_near += int(near.sum())
            n_diff += int((g != c).sum())
            if ((g != c) & ~near).any():
                raise AssertionError(f"{label} v6/{e}/{i:05d}.png: pixels differ where the CPU "
                                     f"score is farther than 2e-3 from the threshold")
    res["gpu_vs_cpu"] = dict(pixels_differ=n_diff, pixels_near_threshold=n_near)
    log(f"{label} {n_diff} pixels differ, of {n_near} whose CPU score lies within 2e-3 of the "
        f"threshold ({len(caps) * n * PROTO_HW[0] * PROTO_HW[1]} pixels)")

    # --msda_3d, windowed, bf16
    label = "[protocol ytvos --msda_3d bf16 windowed]"
    engine = infer.InferenceEngine(flagship_config(msda_3d=True, compute_dtype="bfloat16"), sd3,
                                   device="cuda", window=5)
    windows = -(-n // engine.window)
    res["msda_3d"] = {"launches": protocol_launches(
        lambda: infer.run_ytvos(engine, small, out["3d"], whole_video=False, f_extra=1))}
    want = {"msda_fwd": 4 * windows, "msda_bwd": 0, "msda3d_fwd": 8 * windows, "msda3d_bwd": 0}
    if res["msda_3d"]["launches"] != want:
        raise AssertionError(f"{label} launches {res['msda_3d']['launches']}, expected {want}")
    check_binary_tree(out["3d"], PROTO_SMALL, label)
    frames = [infer._load_frame(os.path.join(small, "valid", "JPEGImages", "v6",
                                             f"{i:05d}.jpg")) for i in range(n)]
    batched = engine.run_video_batch(frames, list(caps), whole_video=True)
    gaps = [mask_gap(b["pred_masks"], engine.run_video(frames, c, whole_video=True)["pred_masks"])
            for b, c in zip(batched, caps)]
    res["msda_3d"]["batched_vs_serial"] = gaps
    log(f"{label} whole-video (8 frames) batched E = {len(caps)} against serial, a reading (the "
        f"3D op's time axis spans the batch's E x T frames): relative RMS "
        + ", ".join(f"{g[0]:.3e}" for g in gaps) + "; share of pixels whose mask differs "
        + ", ".join(f"{g[1]:.3e}" for g in gaps))
    del engine
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9: training through train.main
# ---------------------------------------------------------------------------

# 2 videos x 10 frames x 2 expressions, anchors every 5 frames: 8 samples.
# The dog leaves video t0 for frames 6-9 (frames with valid = 0) and is in
# frame 0 only of t1, whose later clips mostly see no dog and resample.
MAIN_FRAMES = 10
MAIN_ANCHORS = -(-MAIN_FRAMES // 5)  # samples a (video, expression)
MAIN_VIDEOS = {f"t{v}": (MAIN_FRAMES, (("a person walking on the left", "1"),
                                       ("the dog running to the right", "2")))
               for v in range(2)}
MAIN_ABSENT = {"t0": range(6, MAIN_FRAMES), "t1": range(1, MAIN_FRAMES)}
MAIN_FLAGS = ["--binary", "--with_box_refine", "--f_token", "8", "--qtrans", "--masks",
              "--compute_dtype", "bfloat16", "--lr_drop", "1", "--num_workers", "4",
              "--device", "cuda"]


@contextlib.contextmanager
def main_probe():
    """Instruments the runs of ``train.main``: each train step's base LR,
    loss, padded (H, W) and invisible frames, the state handed to the first
    step (to ``rec["on_first"]``), the checkpoint saves (directory, bytes)
    and loads, and the dataset's sampling attempts (more attempts than
    samples = resamples of empty clips)."""
    import os
    import threading

    from tce_rvos_tpu_torch.data import ytvos
    from tce_rvos_tpu_torch.parallel import train_step
    from tce_rvos_tpu_torch.utils import native_ckpt

    rec = {"steps": [], "on_first": None, "saves": [], "loads": [], "attempts": 0, "samples": 0}
    lock = threading.Lock()
    make, save, load = (train_step.make_train_step, native_ckpt.save_checkpoint,
                        native_ckpt.load_any_checkpoint)
    sample_indices, getitem = ytvos.YTVOSDataset._sample_indices, ytvos.YTVOSDataset.__getitem__

    def make_probed(*args, **kw):
        step = make(*args, **kw)

        def probed(state, batch):
            if rec["on_first"] is not None:
                rec["on_first"](state)
                rec["on_first"] = None
            state, metrics = step(state, batch)
            rec["steps"].append(dict(lr=metrics["lr"], loss=float(metrics["loss"]),
                                     hw=tuple(int(x) for x in batch["video"].shape[2:4]),
                                     invisible=int((batch["targets"]["valid"] == 0).sum())))
            return state, metrics

        return probed

    def save_probed(path, *args, **kw):
        save(path, *args, **kw)
        rec["saves"].append(dict(path=path, bytes=sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))))

    def load_probed(path, *args, **kw):
        rec["loads"].append(path)
        return load(path, *args, **kw)

    def count(key, fn):
        def counted(*args, **kw):
            with lock:
                rec[key] += 1
            return fn(*args, **kw)
        return counted

    train_step.make_train_step = make_probed
    native_ckpt.save_checkpoint, native_ckpt.load_any_checkpoint = save_probed, load_probed
    ytvos.YTVOSDataset._sample_indices = count("attempts", sample_indices)
    ytvos.YTVOSDataset.__getitem__ = count("samples", getitem)
    try:
        yield rec
    finally:
        train_step.make_train_step = make
        native_ckpt.save_checkpoint, native_ckpt.load_any_checkpoint = save, load
        ytvos.YTVOSDataset._sample_indices = sample_indices
        ytvos.YTVOSDataset.__getitem__ = getitem


def read_log(out: str) -> list:
    import os

    with open(os.path.join(out, "log.txt")) as fh:
        return [json.loads(line) for line in fh]


def main_run(rec: dict, argv: list, label: str, launches_per_step: dict, entry=None) -> tuple:
    """One ``train.main`` run (or ``entry``'s, e.g. ``train_joint.main``)
    under ``main_probe``: the launch counts set to 0 before it and read
    after, held at ``launches_per_step`` per step; finite losses. Returns
    (the final TrainState, the run's numbers)."""
    from tce_rvos_tpu_torch import train

    first = len(rec["steps"])
    n_saves, n_loads, attempts, samples = (len(rec["saves"]), len(rec["loads"]),
                                           rec["attempts"], rec["samples"])
    reset_launch_counts()
    state = (entry or train.main)(argv)
    counts, adamw = launch_counts(), adamw_launches()
    steps = rec["steps"][first:]
    want = {k: v * len(steps) for k, v in launches_per_step.items()}
    if counts != want:
        raise AssertionError(f"{label}: MSDA launches {counts} over {len(steps)} steps, expected "
                             f"{launches_per_step} per step")
    if adamw != adamw_per_step(state) * len(steps):
        raise AssertionError(f"{label}: {adamw} flat AdamW update launches over {len(steps)} "
                             f"steps, expected {adamw_per_step(state)} a step")
    losses = [s["loss"] for s in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    out = dict(steps=len(steps), launches=counts, adamw_launches=adamw,
               saves=rec["saves"][n_saves:], loads=rec["loads"][n_loads:],
               attempts=rec["attempts"] - attempts, samples=rec["samples"] - samples,
               invisible_frames=sum(s["invisible"] for s in steps),
               hw=sorted({s["hw"] for s in steps}))
    log(f"{label}: {len(steps)} steps; MSDA launches {counts}; padded (H, W) {out['hw']}; "
        f"{out['invisible_frames']} invisible frames; "
        f"{out['attempts'] - out['samples']} resamples in {out['samples']} samples; checkpoint "
        + ", ".join(f"save ({s['bytes']} bytes)" for s in out["saves"])
        + "".join(f", load {x}" for x in out["loads"]))
    return state, out


def adam_counts(state) -> set:
    """The Adam step counters (bias correction) of ``state``'s optimizer:
    the flat AdamW's ``count``, or torch.optim.AdamW's per-parameter
    ``step`` values (empty before its first step)."""
    return state.optimizer.adam_counts()


def same_state(live, saved) -> bool:
    """Nested state dicts equal, tensors bitwise."""
    import torch

    if isinstance(saved, dict):
        return (sorted(map(str, live)) == sorted(map(str, saved))
                and all(same_state(live[k], saved[k]) for k in saved))
    if isinstance(saved, (list, tuple)):
        return len(live) == len(saved) and all(map(same_state, live, saved))
    if isinstance(saved, torch.Tensor):
        return live.cpu().equal(saved)
    return live == saved


def assert_state_saved(state, path: str, label: str) -> None:
    """Every parameter, buffer and optimizer state tensor of ``state``
    bitwise equal to the checkpoint directory ``path`` (the flat AdamW's
    layout, counters, moments and norm, or AdamW's per-parameter state),
    Adam's counters at the step count."""
    from tce_rvos_tpu_torch.utils.native_ckpt import load_checkpoint

    sd, opt_sd, _ = load_checkpoint(path)
    for name, value in state.model.state_dict().items():
        if not value.cpu().equal(sd[name]):
            raise AssertionError(f"{label}: {name} is not the saved tensor")
    if not same_state(state.optimizer.state_dict(), opt_sd):
        raise AssertionError(f"{label}: the optimizer state is not the saved one")
    if adam_counts(state) != {state.step}:
        raise AssertionError(f"{label}: Adam's counters {sorted(adam_counts(state))} at step "
                             f"{state.step}")


def main_levels(hw) -> tuple:
    """The MSDA level shapes of a padded (H, W): strides 8, 16, 32, 64."""
    return tuple((-(-hw[0] // s), -(-hw[1] // s)) for s in (8, 16, 32, 64))


def phase_main(root: str) -> dict:
    """``train.main`` on the card at full width and depth (ResNet-50,
    RoBERTa-base, f_token 8, IQT, box refinement, binary, bf16 over f32
    masters) on a synthetic 720x1280 Ref-YouTube-VOS train tree, 24
    samples an epoch:
    1. two epochs with ``--lr_drop 1 --num_workers 4`` (12 + 12 MSDA
       launches per step);
    2. a resume from ``checkpoint/`` for a third epoch: it starts at epoch 2
       with the saved parameters and AdamW state (bitwise) and the
       schedule's LR at step 2 x steps_per_epoch;
    3. a resume from a reference-format ``.pth`` (``{"model", "epoch": 1}``)
       for a third epoch: before its first step AdamW's state is empty and
       ``TrainState.step`` = 2 x steps_per_epoch, its first LR is the
       schedule's there, and after the epoch AdamW's own step counters
       hold steps_per_epoch;
    4. ``--msda_3d --batch_size 2`` for one epoch (8 + 8 3D and 4 + 4 2D
       launches per step, N = 10).
    Gates: one log line per epoch with finite losses, the checkpoint
    directories, the launch counts, frames with valid = 0 and resamples;
    then the 2D forward and backward kernels held against their plain
    versions at the largest padded shape of run 1 (N = 5), and the 2D and
    3D forward and backward at N = 10 at run 4's."""
    import os
    import shutil

    import numpy as np
    import torch

    label = "[main]"
    tree = write_tree(os.path.join(root, "tree"), "train", MAIN_VIDEOS, seed=20,
                      absent=MAIN_ABSENT)
    out = os.path.join(root, "out")
    flags = ["--dataset_file", "ytvos", "--ytvos_path", tree, *MAIN_FLAGS]
    per_step_2d = {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0}
    res = {}
    with main_probe() as rec:
        _, res["run1"] = main_run(rec, flags + ["--output_dir", out, "--epochs", "2"],
                                  f"{label} run 1, 2 epochs", per_step_2d)
        spe = res["run1"]["steps"] // 2
        for name in ("checkpoint", "checkpoint0000", "checkpoint0001"):
            if sorted(os.listdir(os.path.join(out, name))) != ["meta.json", "model.pt",
                                                             "optimizer.pt"]:
                raise AssertionError(f"{label} {name}: {os.listdir(os.path.join(out, name))}")
        shutil.rmtree(os.path.join(out, "checkpoint0000"))  # disk: 2 GB a checkpoint

        def resumed(state):
            if state.step != 2 * spe:
                raise AssertionError(f"{label} run 2 starts at step {state.step}, not {2 * spe}")
            assert_state_saved(state, os.path.join(out, "checkpoint"), f"{label} run 2")

        rec["on_first"] = resumed
        _, res["run2"] = main_run(rec, flags + ["--output_dir", out, "--epochs", "3", "--resume",
                                                os.path.join(out, "checkpoint")],
                                  f"{label} run 2, resumed for epoch 2", per_step_2d)
        if rec["on_first"] is not None:
            raise AssertionError(f"{label} run 2 took no step")
        logs = read_log(out)
        if [x["epoch"] for x in logs] != [0, 1, 2]:
            raise AssertionError(f"{label} log.txt epochs {[x['epoch'] for x in logs]}")
        bad = [x for x in logs if not all(math.isfinite(v) for k, v in x.items()
                                          if k.startswith("train_loss"))]
        if bad:
            raise AssertionError(f"{label} log.txt holds a loss that is not finite: {bad}")
        first_lr = rec["steps"][-res["run2"]["steps"]]["lr"]
        want_lr = float(np.float32(np.float32(0.1) * np.float32(1e-4)))  # one drop, at spe
        if first_lr != want_lr:
            raise AssertionError(f"{label} run 2's first LR {first_lr}, the schedule's at step "
                                 f"{2 * spe} is {want_lr}")
        shutil.rmtree(os.path.join(out, "checkpoint0001"))

        pth = os.path.join(root, "reference.pth")
        torch.save({"model": torch.load(os.path.join(out, "checkpoint", "model.pt"),
                                        weights_only=True), "epoch": 1}, pth)
        shutil.rmtree(out)

        def pth_resumed(state):
            if state.step != 2 * spe or adam_counts(state) not in (set(), {0}):
                raise AssertionError(
                    f"{label} run 3 starts at step {state.step} (expected {2 * spe}) with Adam "
                    f"step counters {sorted(adam_counts(state))} (expected none or 0)")

        rec["on_first"] = pth_resumed
        out_pth = os.path.join(root, "out_pth")
        state, res["run3"] = main_run(rec, flags + ["--output_dir", out_pth, "--epochs", "3",
                                                    "--resume", pth],
                                      f"{label} run 3, resumed from a .pth for epoch 2",
                                      per_step_2d)
        if rec["on_first"] is not None:
            raise AssertionError(f"{label} run 3 took no step")
        first_lr = rec["steps"][-res["run3"]["steps"]]["lr"]
        if first_lr != want_lr:
            raise AssertionError(f"{label} run 3's first LR {first_lr}, the schedule's at step "
                                 f"{2 * spe} is {want_lr}")
        # a fresh AdamW: its own counters count this epoch's steps only
        adam_steps = adam_counts(state)
        if state.step != 3 * spe or adam_steps != {spe}:
            raise AssertionError(f"{label} run 3 ends at step {state.step} (expected {3 * spe}) "
                                 f"with AdamW step counters {sorted(adam_steps)} (expected {spe})")
        if [x["epoch"] for x in read_log(out_pth)] != [2]:
            raise AssertionError(f"{label} run 3's log.txt epochs "
                                 f"{[x['epoch'] for x in read_log(out_pth)]}")
        del state
        os.remove(pth)
        shutil.rmtree(out_pth)
        torch.cuda.empty_cache()

        out3 = os.path.join(root, "out_3d")
        _, res["run4"] = main_run(
            rec, flags + ["--output_dir", out3, "--epochs", "1", "--msda_3d", "--batch_size", "2"],
            f"{label} run 4, --msda_3d --batch_size 2",
            {"msda_fwd": 4, "msda_bwd": 4, "msda3d_fwd": 8, "msda3d_bwd": 8})
        shutil.rmtree(out3)
    torch.cuda.empty_cache()
    if not res["run1"]["invisible_frames"] + res["run2"]["invisible_frames"]:
        raise AssertionError(f"{label} no batch held a frame with valid = 0")
    resamples = sum(r["attempts"] - r["samples"] for r in res.values())
    if not resamples:
        raise AssertionError(f"{label} no clip was resampled")
    res.update(resamples=resamples, steps_per_epoch=spe)

    hw = max(res["run1"]["hw"], key=lambda x: x[0] * x[1])
    hw3 = max(res["run4"]["hw"], key=lambda x: x[0] * x[1])
    lv, lv3 = main_levels(hw), main_levels(hw3)
    res["hold"] = {"hw": hw, "levels": lv,
                   "fwd": phase_kernels(e=1, shapes=lv),
                   "bwd": phase_backward_kernels(5, shapes=lv),
                   "hw_3d": hw3, "levels_3d": lv3,
                   "fwd_n10": phase_kernels(e=2, shapes=lv3),
                   "bwd_n10": phase_backward_kernels(10, shapes=lv3),
                   "fwd_3d": phase_kernels(e=2, is_3d=True, shapes=lv3),
                   "bwd_3d": phase_backward_kernels(10, is_3d=True, shapes=lv3)}
    log(f"{label} the 2D forward and backward held against plain at run 1's largest padded "
        f"(H, W) {hw}, levels {lv}, N = 5; the 2D and 3D forward and backward at N = 10 at "
        f"run 4's {hw3}, levels {lv3}")
    return res


# ---------------------------------------------------------------------------
# phase 10: evaluation (train.main --eval), eval_davis, train_joint, mevis
# ---------------------------------------------------------------------------

EVAL_FLAGS = ["--binary", "--with_box_refine", "--f_token", "8", "--qtrans",
              "--compute_dtype", "bfloat16", "--num_workers", "4", "--device", "cuda"]
A2D_KEYS = ["AP 0.5", "AP 0.75", "P@0.5", "P@0.6", "P@0.7", "P@0.8", "P@0.9", "mAP 0.5:0.95",
            "mean_iou", "overall_iou"]
JHMDB_HW, JHMDB_VIDEOS, JHMDB_FRAMES = (240, 320), 6, 30   # JHMDB's frame size
COCO_HW = (480, 640)                                         # COCO's usual image size
REFEXP_VAL_IMAGES, REFEXP_TRAIN_IMAGES = 8, 2
MEVIS_VIDEOS, MEVIS_FRAMES = 3, 10


def smooth_frame(rng, hw, period: float = 80.0):
    """A smooth random RGB image, uint8."""
    import numpy as np

    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([0.5 + 0.5 * np.sin((xx * a + yy * b) / period + c)
                  for a, b, c in rng.rand(3, 3)], -1)
    return (f * 255).astype(np.uint8)


def write_jhmdb(root: str, seed: int = 30) -> str:
    """A JHMDB-Sentences root at JHMDB's size: JHMDB_VIDEOS videos of
    JHMDB_FRAMES 320x240 PNG frames (Rename_Images, 1-based),
    puppet_mask.mat (``part_mask`` [H, W, T], a person moving) and
    jhmdb_sentences_samples_metadata.json, two samples a video."""
    import os

    import numpy as np
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    h, w = JHMDB_HW
    samples = []
    for v in range(JHMDB_VIDEOS):
        vid = f"clip_{v}"
        fdir = os.path.join(root, "Rename_Images", "walk", vid)
        mdir = os.path.join(root, "puppet_mask", "walk", vid)
        os.makedirs(fdir)
        os.makedirs(mdir)
        masks = np.zeros((h, w, JHMDB_FRAMES), np.uint8)
        for i in range(JHMDB_FRAMES):
            Image.fromarray(smooth_frame(rng, JHMDB_HW, 40.0)).save(
                os.path.join(fdir, f"{i + 1:05d}.png"))
            masks[40 + 2 * i: 200, 60 + 4 * i + 10 * v: 140 + 4 * i + 10 * v, i] = 1
        savemat(os.path.join(mdir, "puppet_mask.mat"), {"part_mask": masks})
        for frame in (3, JHMDB_FRAMES - 1 - v):
            samples.append([f"the man walking to the right {v}", vid,
                            f"Rename_Images/walk/{vid}/{frame:05d}.png",
                            f"puppet_mask/walk/{vid}/puppet_mask.mat", JHMDB_FRAMES])
    with open(os.path.join(root, "jhmdb_sentences_samples_metadata.json"), "w") as fh:
        json.dump(samples, fh)
    return root


def write_refexp(root: str, name: str, split: str, n_images: int, seed: int) -> str:
    """train2014/*.jpg (640x480) and instances_<name>_<split>.json: per
    image a caption and one polygon annotation (a 12-vertex star), with its
    box and polygon area."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = COCO_HW
    os.makedirs(os.path.join(root, "train2014"), exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        img_id = seed * 1000 + i
        fname = f"COCO_train2014_{img_id:012d}.jpg"
        Image.fromarray(smooth_frame(rng, COCO_HW)).save(os.path.join(root, "train2014", fname))
        images.append({"id": img_id, "file_name": fname, "height": h, "width": w,
                       "caption": CAPTIONS[i % len(CAPTIONS)]})
        ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        r = np.where(np.arange(12) % 2, 0.5, 1.0) * rng.uniform(60, 180)
        c = rng.uniform(0.3, 0.7, 2) * [w, h]
        poly = np.clip(c + np.stack([np.cos(ang), np.sin(ang)], 1) * r[:, None], 0, [w, h])
        x0, y0 = poly.min(0)
        x1, y1 = poly.max(0)
        area = 0.5 * abs(np.dot(poly[:, 0], np.roll(poly[:, 1], 1))
                         - np.dot(poly[:, 1], np.roll(poly[:, 0], 1)))
        anns.append({"id": i, "image_id": img_id, "iscrowd": 0, "area": float(area),
                     "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                     "segmentation": [poly.ravel().round(2).tolist()]})
    with open(os.path.join(root, f"instances_{name}_{split}.json"), "w") as fh:
        json.dump({"images": images, "annotations": anns}, fh)
    return root


def write_mevis_train(root: str, seed: int = 31) -> str:
    """A MeViS train split at 720x1280: MEVIS_VIDEOS videos of
    MEVIS_FRAMES JPEG frames, mask_dict.json (RLEs of two moving objects,
    None where one is absent) and meta_expressions.json, one expression a
    video (the second video's refers to both objects: the union mask)."""
    import os

    import numpy as np
    from PIL import Image

    from tce_rvos_tpu_torch.utils import rle

    rng = np.random.RandomState(seed)
    h, w = PROTO_HW
    mask_dict, videos = {}, {}
    for v in range(MEVIS_VIDEOS):
        vid = f"mv{v}"
        os.makedirs(os.path.join(root, "train", "JPEGImages", vid))
        names = [f"{i:05d}" for i in range(MEVIS_FRAMES)]
        tracks = {str(2 * v): [], str(2 * v + 1): []}
        for i, name in enumerate(names):
            Image.fromarray(smooth_frame(rng, PROTO_HW)).save(
                os.path.join(root, "train", "JPEGImages", vid, name + ".jpg"))
            a = np.zeros((h, w), np.uint8)
            a[100 + 10 * i: 400 + 10 * i, 200 + 20 * i: 500 + 20 * i] = 1
            b = np.zeros((h, w), np.uint8)
            if i >= 3:
                b[420: 620, 900 - 15 * i: 1150 - 15 * i] = 1
            tracks[str(2 * v)].append(rle.encode(a))
            tracks[str(2 * v + 1)].append(rle.encode(b) if b.any() else None)
        mask_dict.update(tracks)
        anno = [2 * v, 2 * v + 1] if v == 1 else [2 * v]
        videos[vid] = {"frames": names, "expressions": {"0": {
            "exp": CAPTIONS[v], "obj_id": list(range(len(anno))), "anno_id": anno}}}
    with open(os.path.join(root, "train", "mask_dict.json"), "w") as fh:
        json.dump(mask_dict, fh)
    with open(os.path.join(root, "train", "meta_expressions.json"), "w") as fh:
        json.dump({"videos": videos}, fh)
    return root


def write_davis_annotations(root: str, seqs: dict) -> str:
    """A DAVIS 2017 root for ``eval_davis`` (the unsupervised task):
    ImageSets/2017/val.txt and Annotations_unsupervised/480p/<seq>/*.png
    palette PNGs at PROTO_HW with two moving objects (labels 1 and 2) and
    the void label 255 on the border."""
    import os

    import numpy as np
    from PIL import Image

    from tce_rvos_tpu_torch import infer

    os.makedirs(os.path.join(root, "ImageSets", "2017"))
    with open(os.path.join(root, "ImageSets", "2017", "val.txt"), "w") as fh:
        fh.write("\n".join(seqs) + "\n")
    h, w = PROTO_HW
    for seq, n in seqs.items():
        d = os.path.join(root, "Annotations_unsupervised", "480p", seq)
        os.makedirs(d)
        for i in range(n):
            lab = np.zeros((h, w), np.uint8)
            lab[150 + 5 * i: 450 + 5 * i, 100 + 15 * i: 500 + 15 * i] = 1
            lab[300: 600, 800 - 10 * i: 1100 - 10 * i] = 2
            lab[:4] = lab[-4:] = 255
            png = Image.fromarray(lab, mode="P")
            png.putpalette(infer.davis_palette())
            png.save(os.path.join(d, f"{i:05d}.png"))
    return root


def msda_per_forward(cfg) -> int:
    """2D MSDA calls of one ReferFormer forward, as the transformer makes
    them: one self-attention per encoder layer, one frame-token attention
    per encoder layer when f_token > 0 (FTF; LastLayerAsToken, f_token < 0,
    makes none), one cross-attention per decoder layer."""
    return cfg.enc_layers * (2 if cfg.f_token > 0 else 1) + cfg.dec_layers


@contextlib.contextmanager
def eval_probe():
    """Instruments ``train.main --eval``: the [b, t, H, W] of each batch
    the model takes, the evaluator's arguments and its ground truth."""
    from tce_rvos_tpu_torch import engine
    from tce_rvos_tpu_torch.eval import a2d_eval

    rec = {"batches": [], "args": None, "gt": None}

    def evaluator(fn):
        def call(*args, **kw):
            rec["args"] = (args, kw)
            return fn(*args, **kw)
        return call

    def forward(make):
        def wrapped(model, compute_dtype="float32"):
            fwd = make(model, compute_dtype)

            def call(batch, *args, **kw):
                rec["batches"].append((tuple(int(x) for x in batch["video"].shape[:4])))
                return fwd(batch, *args, **kw)
            return call
        return wrapped

    def recording_gt(fn):
        def call(gt_by_image, *args, **kw):
            rec["gt"] = gt_by_image
            return fn(gt_by_image, *args, **kw)
        return call

    patches = [(a2d_eval, "calculate_map", recording_gt),
               (engine, "evaluate_a2d", evaluator), (engine, "evaluate_coco_pretrain", evaluator),
               (engine, "model_forward", forward)]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, wrap in patches:
        setattr(owner, name, wrap(getattr(owner, name)))
    try:
        yield rec
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)


def eval_run(argv: list, label: str, per_batch: int) -> tuple:
    """One ``train.main --eval`` run under ``eval_probe`` with the launch
    counts set to 0 before it and read after, held at ``per_batch`` 2D
    forward launches per batch. Returns (the metric dict, the run's
    numbers, the probe's record)."""
    from tce_rvos_tpu_torch import train

    reset_launch_counts()
    with eval_probe() as rec:
        stats = train.main(argv)
    counts = launch_counts()
    batches = rec["batches"]
    want = {"msda_fwd": per_batch * len(batches), "msda_bwd": 0, "msda3d_fwd": 0,
            "msda3d_bwd": 0}
    if counts != want:
        raise AssertionError(f"{label}: MSDA launches {counts} over {len(batches)} batches, "
                             f"expected {per_batch} forward launches a batch")
    samples = sum(b[0] for b in batches)
    out = dict(samples=samples, batches=len(batches), shapes=sorted(set(batches)),
               launches=counts, launches_per_batch=per_batch)
    log(f"{label} {samples} samples in {len(batches)} batches (shapes [b, t, H, W] "
        f"{out['shapes']}); MSDA forward launches {counts['msda_fwd']} = {per_batch} a batch "
        "(msda_per_forward)")
    return stats, out, rec


def check_unit_metrics(stats: dict, label: str) -> None:
    for k, v in stats.items():
        for x in (v if isinstance(v, list) else [v]):
            if not (math.isfinite(x) and (0.0 <= x <= 1.0 or x == -1.0)):
                raise AssertionError(f"{label} {k} = {v}: not finite in [0, 1]")


def jhmdb_gpu_vs_cpu(tree: str, label: str) -> dict:
    """Two JHMDB samples (one batch) through the flagship in f32 (TF32 off)
    on the card and on the CPU, from train.main's init at --seed 42, with
    valid_indices: the scores within 1e-3 relative, and the device
    postprocess's masks differing only where the CPU's upsampled mask logit
    lies within 2e-3 of 0."""
    import torch

    from tce_rvos_tpu_torch import engine, flagship_config
    from tce_rvos_tpu_torch.config import DataConfig
    from tce_rvos_tpu_torch.data.registry import build_dataset, collate_batch
    from tce_rvos_tpu_torch.models.build import build_model
    from tce_rvos_tpu_torch.models.postprocessors import a2d_device_postprocess
    from tce_rvos_tpu_torch.utils.interpolate import resize_bilinear

    cfg = flagship_config()
    ds = build_dataset("jhmdb", "val", DataConfig(jhmdb_path=tree), cfg)
    batch = collate_batch([ds[0], ds[1]])
    outs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev, seed=42)
        out = engine.model_forward(model)(batch, valid_indices=True)
        outs[dev] = {k: out[k].float().cpu() for k in ("pred_logits", "pred_masks")}
        del model, out
    torch.cuda.empty_cache()
    g, c = (a2d_device_postprocess(outs[d]) for d in ("cuda", "cpu"))
    rel = ((g["scores"] - c["scores"]).abs() / c["scores"].abs()).max().item()
    if rel > 1e-3:
        raise AssertionError(f"{label}: scores GPU against CPU {rel:.3e} relative (limit 1e-3)")
    masks = outs["cpu"]["pred_masks"][:, 0]
    logit = resize_bilinear(masks, (masks.shape[-2] * 4, masks.shape[-1] * 4))
    differ = g["masks"] != c["masks"]
    near = logit.abs() <= 2e-3
    if bool((differ & ~near).any()):
        raise AssertionError(f"{label}: mask pixels differ where the CPU's logit is farther than "
                             f"2e-3 from 0")
    res = dict(score_rel=rel, pixels_differ=int(differ.sum()), pixels_near=int(near.sum()),
               pixels=differ.numel())
    log(f"{label} f32 GPU against CPU, 2 samples: scores {rel:.3e} relative; {res['pixels_differ']}"
        f" mask pixels differ, of {res['pixels_near']} whose CPU logit lies within 2e-3 of 0 "
        f"({res['pixels']} pixels)")
    return res


def phase_eval(root: str, davis_results: str, ytvos_train: str) -> dict:
    """Phase 10, on synthetic trees at the datasets' sizes under ``root``,
    the flagship at full width from train.main's own init, bf16:
    1. ``train.main --eval --dataset_file jhmdb --batch_size 2`` (6 videos x
       30 frames of 320x240, 12 samples): the JAX package's metric keys,
       every value finite in [0, 1], 12 2D forward launches a batch, the
       run's ground truth scored against itself (mAP, P@K and IoU 1.0); the
       2D forward held against plain at the run's shape (N = batch, t = 1);
       an f32 GPU-against-CPU check on 2 samples;
    2. ``--eval --dataset_file refcoco --masks`` (8 images of 640x480):
       P@1/5/10, coco_eval_bbox and coco_eval_masks, finite; the run's
       ground truth scored against itself gives box and mask AP 1.0 and
       P@1 1.0; launches as for JHMDB; the 2D forward held at N = 10;
    3. ``eval_davis`` on phase 8's davis PNGs (4 annotators) against
       synthetic annotations: J&F finite in [0, 1], and 1.0 for the
       annotations scored against themselves;
    4. ``train_joint`` for one epoch (refcoco/+/g train trees of 2 images
       each plus phase 9's ytvos train tree, ``--batch_size 2``): 12 + 12
       MSDA launches a step, the 2D forward and backward held at the
       epoch's largest padded shape (N = 10);
    5. ``train.main --dataset_file mevis`` for one epoch (6 steps) on a
       MeViS train tree at 720x1280, 12 + 12 MSDA launches a step."""
    import shutil

    import numpy as np
    from PIL import Image

    from tce_rvos_tpu_torch import eval_davis, flagship_config, train_joint
    from tce_rvos_tpu_torch.eval import a2d_eval, coco_eval, refexp_eval

    res = {}
    per_forward = msda_per_forward(flagship_config())
    log(f"[eval] the flagship makes {per_forward} 2D MSDA calls a forward "
        "(msda_per_forward: encoder self-attention and FTF per encoder layer, decoder "
        "cross-attention per layer)")

    # 1. JHMDB
    label = "[eval jhmdb bf16]"
    tree = write_jhmdb(os.path.join(root, "jhmdb"))
    stats, res["jhmdb"], rec = eval_run(
        ["--eval", "--dataset_file", "jhmdb", "--jhmdb_path", tree, "--batch_size", "2",
         "--output_dir", os.path.join(root, "out_jhmdb"), *EVAL_FLAGS], label, per_forward)
    if sorted(stats) != A2D_KEYS:
        raise AssertionError(f"{label} keys {sorted(stats)}, expected {A2D_KEYS}")
    check_unit_metrics(stats, label)
    gt = rec["gt"]
    if len(gt) != 2 * JHMDB_VIDEOS:
        raise AssertionError(f"{label} scored {len(gt)} samples, expected {2 * JHMDB_VIDEOS}")
    own = [{"image_id": k, "score": 1.0, "rle": v} for k, v in gt.items()]
    own_map = a2d_eval.calculate_map(gt, own)
    own_p, own_o, own_m = a2d_eval.calculate_precision_at_k_and_iou_metrics(gt, own)
    if set(own_map.values()) != {1.0} or set(own_p) != {1.0} or (own_o, own_m) != (1.0, 1.0):
        raise AssertionError(f"{label} ground truth against itself: {own_map}, P@K {own_p}, "
                             f"IoU {own_o} {own_m}")
    res["jhmdb"]["metrics"] = stats
    hw = max((b[2:] for b in res["jhmdb"]["shapes"]), key=lambda x: x[0] * x[1])
    lv = main_levels(hw)
    res["jhmdb"]["hold"] = {"hw": hw, "levels": lv,
                            "fwd": phase_kernels(e=1, shapes=lv, n=2)}
    res["jhmdb"]["gpu_vs_cpu"] = jhmdb_gpu_vs_cpu(tree, label)
    log(f"{label} metrics {json.dumps(stats)}; the ground truth against itself: mAP, P@K and "
        f"IoU 1.0; the 2D forward held against plain at {hw}, levels {lv}, N = 2")

    # 2. RefCOCO
    label = "[eval refcoco bf16]"
    coco = write_refexp(os.path.join(root, "coco"), "refcoco", "val", REFEXP_VAL_IMAGES, 40)
    stats, res["refcoco"], rec = eval_run(
        ["--eval", "--dataset_file", "refcoco", "--coco_path", coco, "--masks",
         "--batch_size", "2", "--output_dir", os.path.join(root, "out_refcoco"), *EVAL_FLAGS],
        label, per_forward)
    if sorted(stats) != ["P@1", "P@10", "P@5", "coco_eval_bbox", "coco_eval_masks"]:
        raise AssertionError(f"{label} keys {sorted(stats)}")
    check_unit_metrics(stats, label)
    (_, _, gt_boxes, coco_gt), _ = rec["args"]
    own = {i: {"scores": np.ones(len(a), np.float32),
               "boxes": np.array([[x, y, x + w, y + h] for x, y, w, h in
                                  (b["bbox"] for b in a)], np.float32),
               "rle_masks": [b["segmentation"] for b in a]} for i, a in coco_gt.items()}
    ev = coco_eval.CocoEvaluator(coco_gt, iou_types=("bbox", "segm"))
    ev.update(own)
    ref_ev = refexp_eval.RefExpEvaluator(gt_boxes)
    ref_ev.update(own)
    own_ap = (ev.stats("bbox")[0], ev.stats("segm")[0], ref_ev.summarize()["P@1"])
    if own_ap != (1.0, 1.0, 1.0):
        raise AssertionError(f"{label} ground truth against itself: box AP, mask AP, P@1 "
                             f"{own_ap}")
    res["refcoco"]["metrics"] = stats
    hw = max((b[2:] for b in res["refcoco"]["shapes"]), key=lambda x: x[0] * x[1])
    n = max(b[0] * b[1] for b in res["refcoco"]["shapes"])
    lv = main_levels(hw)
    res["refcoco"]["hold"] = {"hw": hw, "levels": lv, "N": n,
                              "fwd": phase_kernels(e=1, shapes=lv, n=n)}
    log(f"{label} P@1/5/10 {[stats[k] for k in ('P@1', 'P@5', 'P@10')]}, coco_eval_bbox "
        f"{stats['coco_eval_bbox']}, coco_eval_masks {stats['coco_eval_masks']}; the ground "
        f"truth against itself: box AP, mask AP, P@1 {own_ap}; the 2D forward held against "
        f"plain at {hw}, levels {lv}, N = {n}")

    # 3. eval_davis on phase 8's davis results
    label = "[eval_davis]"
    (n_frames, _), = PROTO_DAVIS.values()
    davis17 = write_davis_annotations(os.path.join(root, "davis17"),
                                      {seq: n_frames for seq in PROTO_DAVIS})
    jf = eval_davis.main(["--davis_path", davis17, "--results_path", davis_results])
    if len(jf) != 4 or not all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in jf):
        raise AssertionError(f"{label} J&F per annotator {jf}")
    self_dir = os.path.join(root, "davis_self")
    anno = os.path.join(davis17, "Annotations_unsupervised", "480p")
    for seq in PROTO_DAVIS:
        os.makedirs(os.path.join(self_dir, seq))
        for name in sorted(os.listdir(os.path.join(anno, seq))):
            _, lab, pal = read_png(os.path.join(anno, seq, name))
            png = Image.fromarray(np.where(lab == 255, 0, lab).astype(np.uint8), mode="P")
            png.putpalette(pal)
            png.save(os.path.join(self_dir, seq, name))
    own_jf = eval_davis.main(["--davis_path", davis17, "--results_path", self_dir])
    if own_jf != [1.0]:
        raise AssertionError(f"{label} the annotations against themselves: J&F {own_jf}")
    # a reading: how much of the protocol's PNGs the (random) model marks as an object
    fg = [float((read_png(os.path.join(davis_results, a, seq, f))[1] > 0).mean())
          for a in sorted(os.listdir(davis_results)) if a.startswith("anno_")
          for seq in PROTO_DAVIS for f in os.listdir(os.path.join(davis_results, a, seq))
          if f.endswith(".png")]
    res["eval_davis"] = dict(jf=jf, frames=n_frames, annotators=len(jf),
                             object_share=float(np.mean(fg)))
    log(f"{label} {len(jf)} annotators x {n_frames} frames of "
        f"{PROTO_HW[0]}x{PROTO_HW[1]} (2 objects): J&F {jf} (the protocol's PNGs mark "
        f"{100 * np.mean(fg):.3f}% of their pixels as an object); the annotations against "
        "themselves: 1.0")

    # 4. train_joint, 5. mevis
    for name, seed in (("refcoco", 41), ("refcoco+", 42), ("refcocog", 43)):
        write_refexp(coco, name, "train", REFEXP_TRAIN_IMAGES, seed)
    mevis = write_mevis_train(os.path.join(root, "mevis"))
    per_step = {"msda_fwd": per_forward, "msda_bwd": per_forward, "msda3d_fwd": 0,
                "msda3d_bwd": 0}
    flags = [f for f in MAIN_FLAGS if f != "--binary"]
    with main_probe() as prec:
        _, res["train_joint"] = main_run(
            prec, ["--coco_path", coco, "--ytvos_path", ytvos_train, "--output_dir",
                   os.path.join(root, "out_joint"), "--epochs", "1", "--batch_size", "2", *flags],
            "[train_joint bf16]", per_step, entry=train_joint.main)
        _, res["mevis"] = main_run(
            prec, ["--dataset_file", "mevis", "--mevis_path", mevis, "--output_dir",
                   os.path.join(root, "out_mevis"), "--epochs", "1", "--binary", *flags],
            "[train mevis bf16]", per_step)
    for out in ("out_joint", "out_mevis"):
        shutil.rmtree(os.path.join(root, out))  # disk: 2 GB a checkpoint
    want_steps = (3 * REFEXP_TRAIN_IMAGES + len(MAIN_VIDEOS) * 2 * MAIN_ANCHORS) // 2  # batch 2
    if res["train_joint"]["steps"] != want_steps:
        raise AssertionError(f"[train_joint] {res['train_joint']['steps']} steps, expected "
                             f"{want_steps}")
    if res["mevis"]["steps"] != MEVIS_VIDEOS * -(-MEVIS_FRAMES // 5):
        raise AssertionError(f"[train mevis] {res['mevis']['steps']} steps")
    hw = max(res["train_joint"]["hw"], key=lambda x: x[0] * x[1])
    lv = main_levels(hw)
    res["train_joint"]["hold"] = {"hw": hw, "levels": lv, "N": 10,
                                  "fwd": phase_kernels(e=2, shapes=lv),
                                  "bwd": phase_backward_kernels(10, shapes=lv)}
    log(f"[train_joint] the 2D forward and backward held against plain at the epoch's largest "
        f"padded (H, W) {hw}, levels {lv}, N = 10")
    return res


# ---------------------------------------------------------------------------
# phase 11: the other backbones
# ---------------------------------------------------------------------------

VSWIN_B = "video_swin_b_p4w7"  # BASELINE.json's flagship WACV configuration
# one bf16 trunk forward of the flagship on each other family: the reference
# scripts' video_swin_t/s, BASELINE.json's swin_l (config 3) and resnet101
# (config 2), ResNet-50 with DC5, X3D-M
OTHER_BACKBONES = (("video_swin_t_p4w7", False), ("video_swin_s_p4w7", False),
                   ("swin_l_p4w7", False), ("resnet101", False), ("resnet50", True),
                   ("x3d_m", False))
DC5_SHAPES = ((48, 80), (24, 40), (24, 40), (12, 20))  # 384x640 with DC5: S = 6000
WHOLE_VIDEO = {"w18": (18, CAPTIONS)}  # whole-video: a 24-frame window, E = 4
# Video-Swin-B bf16 batched against serial masks: twice the largest of the
# 12 readings of the calibration run on an H100 (relative RMS 1.463e-2,
# share of pixels whose mask differs 1.964e-3; PERF.md), as for ResNet-50
VSWIN_B_BF16_LIMITS = (2.93e-2, 3.93e-3)


def whole_video_backbone(root: str) -> dict:
    """Video-Swin-B whole-video ytvos through ``infer.main`` (bf16, the
    model's own init) on a synthetic 720x1280 tree, one video of 18 frames:
    one 24-frame window (8-frame windows, a temporal shift of 4), E = 4:
    one backbone call of the whole window, 12 launches a trunk forward, the
    PNG tree."""
    import os

    from tce_rvos_tpu_torch import infer

    label = "[backbones video_swin_b ytvos whole-video, infer.main]"
    tree = write_tree(os.path.join(root, "vswin_ytvos"), "ytvos", WHOLE_VIDEO, seed=14)
    out = os.path.join(root, "out_vswin")
    (n, caps), = WHOLE_VIDEO.values()
    argv = ["--dataset_file", "ytvos", "--ytvos_path", tree, "--output_dir", out,
            "--binary", "--with_box_refine", "--f_token", "8", "--qtrans",
            "--compute_dtype", "bfloat16", "--backbone", VSWIN_B]
    calls = []  # the frames of each backbone call
    original = infer.InferenceEngine.backbone

    def backbone(self, video, mask):
        calls.append(int(video.shape[1]))
        return original(self, video, mask)

    infer.InferenceEngine.backbone = backbone
    try:
        res = {"launches": protocol_launches(lambda: infer.main(argv))}
    finally:
        infer.InferenceEngine.backbone = original
    t_clip = -(-n // 8) * 8
    trunks = expected_trunks(len(caps), t_clip)
    if calls != [t_clip] or res["launches"]["msda_fwd"] != 12 * len(trunks):
        raise AssertionError(f"{label} backbone calls {calls}, launches {res['launches']}; "
                             f"expected one {t_clip}-frame call and 12 x {len(trunks)}")
    files = check_binary_tree(out, WHOLE_VIDEO, label)
    res.update(t_clip=t_clip, pngs=files)
    log(f"{label} {n} frames as one {t_clip}-frame window, launches {res['launches']}; "
        f"{files} PNGs at {PROTO_HW[0]}x{PROTO_HW[1]}")
    return res


def backbone_train(sd) -> dict:
    """OTHER_TRAIN_STEPS bf16 Video-Swin-B flagship steps (b = 1, 5x384x640,
    dropout and DropPath on) without and OTHER_TRAIN_STEPS_CKPT with
    recomputation (the backbone's blocks and the transformer's layers):
    12 + 12 MSDA launches a step (24 + 12 with recomputation); every
    backbone parameter gets a gradient."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        forward_losses,
        make_train_step,
    )

    label = "[backbones video_swin_b train]"
    dev = torch.device("cuda")
    cfg = flagship_config(compute_dtype="bfloat16", backbone=VSWIN_B)
    tcfg = TrainConfig()
    model = ReferFormer(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    body = model.backbone[0].body
    state = create_train_state(model, tcfg, steps_per_epoch=1000)
    crit = criterion_from_configs(cfg, tcfg)
    step = make_train_step(crit, cfg.compute_dtype)
    batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=10 + i), dev)
               for i in range(OTHER_TRAIN_STEPS)]
    res = {"plain": train_run(state, step, batches, label,
                              "bf16 train_one_epoch, no recomputation")}
    if (res["plain"]["launches"], res["plain"]["backward_launches"]) != (
            12 * OTHER_TRAIN_STEPS, 12 * OTHER_TRAIN_STEPS):
        raise AssertionError(f"{label} MSDA launches {res['plain']['launches']} / "
                             f"{res['plain']['backward_launches']}, expected 12 + 12 a step")
    # one more bf16 step's gradients with DropPath and dropout off: at b = 1
    # DropPath drops a whole block's branch for the step, and its
    # parameters get no gradient in that step
    model.eval()
    model.zero_grad(set_to_none=True)
    forward_losses(model, batches[0], crit, cfg.compute_dtype)[0].backward()
    no_grad = [n for n, p in body.named_parameters()
               if p.grad is None or float(p.grad.abs().max()) == 0.0]
    if no_grad:
        raise AssertionError(f"{label} backbone parameters without a gradient: {no_grad}")
    log(f"{label} every backbone parameter has a non-zero gradient in a bf16 step with "
        f"DropPath and dropout off")
    model.transformer.use_checkpoint = body.use_checkpoint = True
    res["ckpt"] = train_run(state, step, batches[:OTHER_TRAIN_STEPS_CKPT], label, "bf16 "
                            "train_one_epoch, with recomputation")
    if (res["ckpt"]["launches"], res["ckpt"]["backward_launches"]) != (
            24 * OTHER_TRAIN_STEPS_CKPT, 12 * OTHER_TRAIN_STEPS_CKPT):
        raise AssertionError(f"{label} with recomputation: MSDA launches "
                             f"{res['ckpt']['launches']} / {res['ckpt']['backward_launches']}")
    del state, model, batches
    torch.cuda.empty_cache()
    return res


def family_forward(name: str, dilation: bool, frames) -> dict:
    """One bf16 flagship forward on backbone ``name`` (weights drawn on the
    card, ``device_state_dict``): a 5-frame 384x640 window, E = 4: finite
    outputs, 12 MSDA forward launches."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.infer import InferenceEngine
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    tag = name + (" dc5" if dilation else "")
    label = f"[backbones {tag}]"
    sd = device_state_dict(flagship_config(backbone=name, dilation=dilation), seed=0)
    with torch.device("cuda"):  # the engine's model built on the card
        engine = InferenceEngine(flagship_config(compute_dtype="bfloat16", backbone=name,
                                                 dilation=dilation), sd, device="cuda")
    del sd
    video, mask, size = engine.preprocess(frames[:5])
    sizes = size
    ids, attn = tokenize(list(CAPTIONS))
    reset_launch_counts()
    feats = engine.backbone(video, mask)
    out = engine.trunk(feats, mask, ids, attn, sizes)
    launches = launch_counts()["msda_fwd"]
    bad = [k for k, v in out.items() if not bool(torch.isfinite(v.float()).all())]
    if bad or launches != 12:
        raise AssertionError(f"{label} outputs not finite: {bad}; MSDA launches {launches}, "
                             f"expected 12")
    replayed = engine.backbone(video, mask)  # the first dispatch captured the shape
    if len(engine._backbone_graphs.entries) != 1 or not all(
            torch.equal(a, b) for a, b in zip(replayed, feats)):
        raise AssertionError(f"{label} the backbone's replay is not bitwise its first, eager "
                             f"dispatch")
    levels = [tuple(f.shape[-2:]) for f in feats]
    log(f"{label} one 5x384x640 window, E={len(CAPTIONS)}: outputs finite, msda_fwd launches "
        f"{launches}; backbone levels {levels}, channels {[f.shape[1] for f in feats]}; its "
        f"replay bitwise the first dispatch")
    del engine
    torch.cuda.empty_cache()
    return dict(launches=launches, levels=[list(x) for x in levels])


def phase_backbones(videos, root: str) -> dict:
    """Phase 11: the 2D kernels held at the DC5 levels and at Video-Swin-B's
    serving and training shapes; the Video-Swin-B flagship served in bf16
    and f32 (phase 3's gates: 24 launches per run_video_batch of two
    windows, exact expression isolation, batched against serial), its f32
    2-frame window GPU against CPU, the whole-video ytvos run, bf16 train
    steps without and with recomputation; one forward on each other
    family."""
    import torch

    from tce_rvos_tpu_torch import flagship_config

    res = {"kernels": {"dc5_e4": phase_kernels(e=4, shapes=DC5_SHAPES),
                       "video_swin_b_e4": phase_kernels(e=4)},
           "backward": {"video_swin_b_train": phase_backward_kernels()}}
    sd = random_state_dict(flagship_config(backbone=VSWIN_B), seed=0)
    # the script's time limit: GPU against CPU on a 2-frame window
    res["path"] = {dtype: phase_path(dtype, sd, videos[:2], backbone=VSWIN_B,
                                     tag="backbones video_swin_b", limits=VSWIN_B_BF16_LIMITS)[0]
                   for dtype in ("bfloat16", "float32")}
    phase_parity(sd, videos[0][:PARITY_FRAMES], backbone=VSWIN_B)
    res["whole_video"] = whole_video_backbone(root)
    res["train"] = backbone_train(sd)
    del sd
    torch.cuda.empty_cache()
    res["families"] = {name + ("_dc5" if dil else ""): family_forward(name, dil, videos[0])
                       for name, dil in OTHER_BACKBONES}
    return res


# ---------------------------------------------------------------------------
# phase 12: the model options
# ---------------------------------------------------------------------------

TOKENS = {"f_token": -1}                 # LastLayerAsToken, the flagship's switches otherwise
NO_VL = {"vlblock": False, "rel_coord": False}  # --vlblock --no_rel_coord
TOKENS_WHOLE_T = (40, 160)               # whole-video windows: 2,400 and 9,600 tokens at E = 4
TRAIN_STEPS_NO_VL = 3
# the 65-class ytvos objective: no --binary, the visibility and contrastive
# heads, the mask losses
CLASSES_FLAGS = ["--masks", "--vis_loss", "--contrastive", "--with_box_refine", "--f_token", "8",
                 "--qtrans", "--compute_dtype", "bfloat16"]
OPTIONS_TRAIN_FLAGS = ["--lr_drop", "1", "--num_workers", "4", "--device", "cuda"]


@contextlib.contextmanager
def tokenizer_guard_lifted():
    """``require_real_tokenizer`` passes: the runs of phase 12 resume and
    fine-tune from weights that this run trained with the same fallback
    tokenizer, not from a pretrained text encoder, which is what the guard
    keeps from the fallback's token ids."""
    from tce_rvos_tpu_torch.models import text_encoder

    guard = text_encoder.require_real_tokenizer
    text_encoder.require_real_tokenizer = lambda context="": None
    try:
        yield
    finally:
        text_encoder.require_real_tokenizer = guard


def tokens_whole_video(sd, frames) -> dict:
    """LastLayerAsToken whole-video (bf16, 360x640 frames, the video's 10
    frames repeated): ``run_video_batch`` with E = 4 at T = 40 and 160, each
    trunk dispatch's E as the memory envelope gives it, 8 launches a trunk
    forward, finite masks; then one trunk forward at each dispatched
    (E, T), its peak (less what was allocated before the engine was built)
    held under ``infer._ENVELOPE_GIB``'s line. The token attention's and
    the V-L blocks' logits grow as T squared (9,600 and 38,400 tokens a
    clip at T = 160); ``MultiheadAttention`` computes them in chunks."""
    import numpy as np
    import torch

    from tce_rvos_tpu_torch import flagship_config, infer
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    label = "[options f_token -1 whole-video]"
    cfg = flagship_config(compute_dtype="bfloat16", **TOKENS)
    hw = (384, 640)
    base, per_frame = infer._ENVELOPE_GIB["bfloat16"]
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated() / 2**30
    engine = infer.InferenceEngine(cfg, sd, device="cuda")
    res = {}
    for t in TOKENS_WHOLE_T:
        clip = [frames[i % len(frames)] for i in range(t)]
        cap = infer.trunk_frame_envelope(hw, "bfloat16", device="cuda") // t
        eb = min(len(CAPTIONS), infer._pow2_floor(max(cap, 1)))
        want = [(infer._pow2_ceil(min(eb, len(CAPTIONS) - off)), t, msda_per_forward(cfg))
                for off in range(0, len(CAPTIONS), eb)]
        calls = count_trunks(engine)
        reset_launch_counts()
        outs = engine.run_video_batch(clip, list(CAPTIONS), whole_video=True)
        launches = launch_counts()["msda_fwd"]
        del engine.trunk  # count_trunks' wrapper
        if calls != want or launches != sum(c[2] for c in want):
            raise AssertionError(f"{label} T={t}: trunk forwards (E, T, launches) {calls}, "
                                 f"{launches} launches; expected {want}")
        for e, out in enumerate(outs):
            m = out["pred_masks"]
            if m.shape != (t, 5, 96, 160) or not np.isfinite(m).all():
                raise AssertionError(f"{label} T={t} caption {e}: masks {m.shape}, finite "
                                     f"{bool(np.isfinite(m).all())}")
        e = want[0][0]
        video, mask, size = engine.preprocess(clip)
        sizes = size
        feats = engine.backbone(video, mask)
        ids, attn = tokenize(list(CAPTIONS[:e]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = engine.trunk(feats, mask, ids, attn, sizes)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30 - before
        del out, feats, video, mask
        line = base + per_frame * e * t
        tokens = t * (hw[0] // 64) * (hw[1] // 64)
        res[t] = dict(dispatches=calls, launches=launches, cap=cap, e=e, tokens=tokens,
                      peak_gib=peak, line_gib=line)
        log(f"{label} T={t} ({tokens} tokens a clip), E={len(CAPTIONS)}: trunk dispatches "
            f"(E, T, launches) {calls} (the envelope's cap {cap} expressions); one trunk "
            f"forward at E={e}: "
            f"peak {peak:.3f} GiB above what was allocated before the engine, the envelope's "
            f"line {line:.3f} GiB")
        if peak > line:
            raise AssertionError(f"{label} T={t}: trunk peak {peak:.3f} GiB above the "
                                 f"envelope's line {line:.3f} GiB")
    del engine
    torch.cuda.empty_cache()
    return res


def tokens_train(sd) -> dict:
    """OTHER_TRAIN_STEPS bf16 steps of the LastLayerAsToken flagship (b = 1,
    5x384x640, dropout on): 8 + 8 MSDA launches a step, every parameter
    (``inter_frame_atten.*`` included) gets a gradient and moves."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    label = "[options f_token -1 train]"
    dev = torch.device("cuda")
    cfg = flagship_config(compute_dtype="bfloat16", **TOKENS)
    tcfg = TrainConfig()
    model = ReferFormer(cfg)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    state = create_train_state(model, tcfg, steps_per_epoch=1000)
    step = make_train_step(criterion_from_configs(cfg, tcfg), cfg.compute_dtype)
    batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=10 + i), dev)
               for i in range(OTHER_TRAIN_STEPS)]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    res = train_run(state, step, batches, label, "bf16 train_one_epoch")
    per = msda_per_forward(cfg)
    if (res["launches"], res["backward_launches"]) != (per * OTHER_TRAIN_STEPS,
                                                       per * OTHER_TRAIN_STEPS):
        raise AssertionError(f"{label} MSDA launches {res['launches']} forward / "
                             f"{res['backward_launches']} backward, expected {per} + {per} a "
                             f"step x {OTHER_TRAIN_STEPS}")
    tokens = sorted(n for n, _ in model.named_parameters() if ".inter_frame_atten." in n)
    if len(tokens) != 10 * cfg.enc_layers:
        raise AssertionError(f"{label} {len(tokens)} inter_frame_atten parameters")
    every_parameter_learns(model, start, label, f"the {len(tokens)} inter_frame_atten.* included")
    del state, model, batches, start
    torch.cuda.empty_cache()
    return res


def vl_off(frames) -> dict:
    """``--vlblock --no_rel_coord`` (no V-L blocks in the FPN, no relative
    coordinates into the mask head; the flagship's switches otherwise), on
    weights drawn on the card (``device_state_dict``), beside the flagship:
    the trunk at E = 1 and 4 (12 launches a forward, finite outputs), no
    V-L block in the FPN; TRAIN_STEPS_NO_VL bf16 train steps, finite,
    12 + 12 launches a step."""
    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.config import TrainConfig
    from tce_rvos_tpu_torch.infer import InferenceEngine
    from tce_rvos_tpu_torch.models.criterion import criterion_from_configs
    from tce_rvos_tpu_torch.models.referformer import ReferFormer
    from tce_rvos_tpu_torch.models.text_encoder import tokenize
    from tce_rvos_tpu_torch.parallel.train_step import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    res = {}
    for name, over in (("flagship", {}), ("vl_off", NO_VL)):
        label = f"[options {name}]"
        sd = device_state_dict(flagship_config(**over), seed=0)
        cfg = flagship_config(compute_dtype="bfloat16", **over)
        with torch.device("cuda"):  # the engine's model built on the card
            engine = InferenceEngine(cfg, sd, device="cuda")
        video, mask, size = engine.preprocess(frames[:engine.window])
        sizes = size
        feats = engine.backbone(video, mask)
        res[name] = {}
        for e in (1, 4):
            ids, attn = tokenize(list(CAPTIONS[:e]))
            reset_launch_counts()
            out = engine.trunk(feats, mask, ids, attn, sizes)
            launches = launch_counts()["msda_fwd"]
            bad = [k for k, v in out.items() if not bool(torch.isfinite(v.float()).all())]
            if bad or launches != 12:
                raise AssertionError(f"{label} E={e}: outputs not finite {bad}, MSDA launches "
                                     f"{launches} (expected 12)")
        log(f"{label} trunk E=1 and E=4: outputs finite, 12 msda_fwd launches each")
        del engine, feats
        if name == "flagship":
            continue
        with torch.device("cuda"):
            model = ReferFormer(cfg)
        model.load_state_dict(sd, strict=True)
        if any(n.startswith("pixel_decoder.cross_attn") for n, _ in model.named_parameters()):
            raise AssertionError(f"{label} the FPN holds V-L blocks")
        tcfg = TrainConfig()
        state = create_train_state(model, tcfg, steps_per_epoch=1000)
        step = make_train_step(criterion_from_configs(cfg, tcfg), cfg.compute_dtype)
        batches = [batch_to_device(train_batch(TRAIN_T, TRAIN_HW, seed=10 + i), "cuda")
                   for i in range(TRAIN_STEPS_NO_VL)]
        run = train_run(state, step, batches, label, "bf16 train_one_epoch")
        if (run["launches"], run["backward_launches"]) != (12 * TRAIN_STEPS_NO_VL,
                                                           12 * TRAIN_STEPS_NO_VL):
            raise AssertionError(f"{label} MSDA launches {run['launches']} / "
                                 f"{run['backward_launches']}, expected 12 + 12 a step")
        res[name]["train"] = run
        del state, model, batches
    torch.cuda.empty_cache()
    return res


def options_main(tree: str, small_tree: str, root: str) -> dict:
    """The class heads and the objective through the command lines, on
    phase 9's 720x1280 train tree (bf16, full width):
    1. ``train.main`` on the 65-class ytvos objective (no ``--binary``;
       CLASSES_FLAGS: the mask losses, the visibility heads and loss, the
       contrastive output) for one epoch: 12 + 12 launches a step, 65 class
       logits, ``loss_vis`` and its aux copies logged;
    2. ``infer.main --resume`` on those weights (saved as a reference-layout
       ``.pth``) with the same flags on phase 8's small ytvos tree: every
       PNG, ``select_query`` over 65 classes;
    3. ``train.main --binary --pretrained_weights`` that ``.pth`` for one
       epoch without ``--masks``: only the ``class_embed.*`` tensors
       re-initialised, no mask loss logged (two runs until the script's
       time limit joined them).
    Then the 2D forward and backward held against plain at the runs'
    largest padded shape (N = 5)."""
    import os
    import shutil

    import torch

    from tce_rvos_tpu_torch import infer
    from tce_rvos_tpu_torch.utils import checkpoint

    label = "[options main]"
    per_step = {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0}
    base = ["--dataset_file", "ytvos", "--ytvos_path", tree, *CLASSES_FLAGS]
    pth = os.path.join(root, "classes65.pth")
    res = {}
    with main_probe() as rec, tokenizer_guard_lifted():
        out = os.path.join(root, "out_classes65")
        state, res["classes65"] = main_run(
            rec, base + OPTIONS_TRAIN_FLAGS + ["--output_dir", out, "--epochs", "1"],
            f"{label} 1. 65 classes", per_step)
        widths = [h.out_features for h in state.model.class_embed]
        logged = read_log(out)[0]
        want = {"train_loss_ce", "train_loss_vis", "train_loss_mask", "train_loss_dice",
                *(f"train_loss_vis_{i}" for i in range(3))}
        if widths != [65] * 4 or len(state.model.visible_embed) != 4 or not want <= set(logged):
            raise AssertionError(f"{label} 1. class heads {widths}, logged {sorted(logged)}")
        torch.save({"model": {k: v.cpu() for k, v in state.model.state_dict().items()},
                    "epoch": 0}, pth)
        del state
        shutil.rmtree(out)
        torch.cuda.empty_cache()

        classes = []
        select_query = infer.select_query
        infer.select_query = lambda logits: (classes.append(logits.shape[-1]),
                                             select_query(logits))[1]
        out = os.path.join(root, "out_classes65_infer")
        (_, caps), = PROTO_SMALL.values()
        try:
            res["infer"] = {"launches": protocol_launches(
                lambda: infer.main(["--dataset_file", "ytvos", "--ytvos_path", small_tree,
                                    "--output_dir", out, "--resume", pth, *CLASSES_FLAGS]))}
        finally:
            infer.select_query = select_query
        if classes != [65] * len(caps) or res["infer"]["launches"]["msda_fwd"] != 12:
            raise AssertionError(f"{label} 2. select_query saw {classes} classes, launches "
                                 f"{res['infer']['launches']}")
        res["infer"]["pngs"] = check_binary_tree(out, PROTO_SMALL, f"{label} 2.")
        shutil.rmtree(out)

        loaded = {}
        convert = checkpoint.convert_state_dict

        def recorded(sd, reference, *args, **kw):
            new, missing, unexpected = convert(sd, reference, *args, **kw)
            loaded.update(reference=len(reference), missing=missing, unexpected=unexpected)
            return new, missing, unexpected

        checkpoint.convert_state_dict = recorded
        out = os.path.join(root, "out_binary")
        try:
            state, res["binary_finetune_no_masks"] = main_run(
                rec, [f for f in base if f != "--masks"] + OPTIONS_TRAIN_FLAGS
                + ["--binary", "--pretrained_weights", pth, "--output_dir", out, "--epochs", "1"],
                f"{label} 3. --binary --pretrained_weights, without --masks", per_step)
        finally:
            checkpoint.convert_state_dict = convert
        heads = sorted(k for k in state.model.state_dict() if k.startswith("class_embed."))
        if (sorted(loaded["missing"]) != heads or loaded["unexpected"]
                or [h.out_features for h in state.model.class_embed] != [1] * 4):
            raise AssertionError(f"{label} 3. left at init {loaded['missing']}, unused "
                                 f"{loaded['unexpected']}; the class_embed tensors are {heads}")
        res["binary_finetune_no_masks"].update(
            loaded=loaded["reference"] - len(loaded["missing"]), reinitialised=loaded["missing"])
        log(f"{label} 3. --pretrained_weights: {loaded['reference'] - len(loaded['missing'])} "
            f"tensors loaded, {len(loaded['missing'])} re-initialised, all of them class "
            f"heads: {loaded['missing']}")
        del state
        os.remove(pth)
        logged = read_log(out)[0]
        masked = [k for k in logged if "loss_mask" in k or "loss_dice" in k]
        if masked or "train_loss_ce" not in logged:
            raise AssertionError(f"{label} 3. without --masks the log holds {sorted(logged)}")
        log(f"{label} 3. without --masks: no mask loss logged ({sorted(logged)})")
        shutil.rmtree(out)
    torch.cuda.empty_cache()
    hw = max((x for k in ("classes65", "binary_finetune_no_masks") for x in res[k]["hw"]),
             key=lambda x: x[0] * x[1])
    lv = main_levels(hw)
    res["hold"] = {"hw": hw, "levels": lv, "fwd": phase_kernels(e=1, shapes=lv),
                   "bwd": phase_backward_kernels(5, shapes=lv)}
    log(f"{label} the 2D forward and backward held against plain at the runs' largest padded "
        f"(H, W) {hw}, levels {lv}, N = 5")
    return res


def phase_options(videos, tree: str, small_tree: str, root: str) -> dict:
    """Phase 12: the model options at full width. The LastLayerAsToken
    flagship (``--f_token -1``) served through phase 3's path and gates in
    bf16 (8 launches a trunk forward) and held f32 GPU
    against CPU on a 2-frame window, its whole-video windows at T = 40 and
    160, its train steps; the 65-class objective, ``--resume`` and the
    binary fine-tune without ``--masks`` through the command lines
    (``options_main``); ``--vlblock --no_rel_coord`` against the flagship
    (``vl_off``)."""
    import torch

    from tce_rvos_tpu_torch import flagship_config

    sd = random_state_dict(flagship_config(**TOKENS), seed=0)
    res = {"tokens_path": phase_path("bfloat16", sd, videos[:2], tag="options f_token -1",
                                     overrides=TOKENS)[0]}
    phase_parity(sd, videos[0][:PARITY_FRAMES], overrides=TOKENS, tag="options f_token -1")
    res["tokens_whole_video"] = tokens_whole_video(sd, videos[0])
    res["tokens_train"] = tokens_train(sd)
    del sd
    torch.cuda.empty_cache()
    res["main"] = options_main(tree, small_tree, root)
    res["vl_off"] = vl_off(videos[0])
    return res


# ---------------------------------------------------------------------------
# phase 13: distributed training and evaluation, and the host modules
# ---------------------------------------------------------------------------

DIST_VIDEOS = {"d0": (10, MAIN_VIDEOS["t0"][1])}  # 4 samples: 4 steps an epoch
DIST_MODEL = dict(enc_layers=2, dec_layers=2, vis_loss=True, masks=True)  # full width


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def nccl_world_one():
    """A launcher's environment for one process (RANK 0 of WORLD_SIZE 1 on
    localhost), the process group torn down and the environment restored
    after."""
    from tce_rvos_tpu_torch.parallel.mesh import shutdown_distributed

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        shutdown_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def reduction_probe():
    """Wraps the train step's gradient all-reduce and its sum of the logged
    losses: every gradient and every loss bitwise the same after them as
    before (one rank reduces to itself), the backend and world held;
    exactly one all-reduce a step, of every parameter's gradient (with the
    flat AdamW, in place on its gradient buffer)."""
    import torch
    import torch.distributed as dist

    from tce_rvos_tpu_torch.parallel import collectives, train_step

    rec = {"checked_grads": 0, "checked_losses": 0, "allreduce_calls": []}
    reduce_grads, sum_losses = train_step.all_reduce_gradients, train_step.sum_over_ranks
    all_reduce_sum_ = collectives.all_reduce_sum_

    def grads_checked(state):
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"[dist] the process group is {dist.get_backend()} of "
                                 f"{dist.get_world_size()}, expected NCCL of 1")
        model = state.model
        before = [None if p.grad is None else p.grad.clone() for p in model.parameters()]
        calls = []

        def counted(t):
            calls.append((t.data_ptr(), t.numel()))
            return all_reduce_sum_(t)

        collectives.all_reduce_sum_ = counted
        try:
            reduce_grads(state)
        finally:
            collectives.all_reduce_sum_ = all_reduce_sum_
        rec["allreduce_calls"].append(len(calls))
        buf = getattr(state.optimizer, "grads", None)  # the flat AdamW's gradient buffer
        n = buf.numel() if buf is not None else sum(p.numel() for p in model.parameters()
                                                    if p.requires_grad)
        if len(calls) != 1 or calls[0][1] != n or (buf is not None
                                                   and calls[0][0] != buf.data_ptr()):
            raise AssertionError(f"[dist] the gradient all-reduce made the calls {calls}, "
                                 f"expected one of {n} elements"
                                 + (" on the flat buffer" if buf is not None else ""))
        for (name, p), b in zip(model.named_parameters(), before):
            if (b is None) != (p.grad is None) or (b is not None and not torch.equal(b, p.grad)):
                raise AssertionError(f"[dist] the all-reduce changed the gradient of {name}")
            rec["checked_grads"] += b is not None

    def losses_checked(values):
        out = sum_losses(values)
        for k, v in values.items():
            if not torch.equal(out[k], v.detach().float()):
                raise AssertionError(f"[dist] the sum over one rank changed {k}")
            rec["checked_losses"] += 1
        return out

    train_step.all_reduce_gradients, train_step.sum_over_ranks = grads_checked, losses_checked
    try:
        yield rec
    finally:
        train_step.all_reduce_gradients, train_step.sum_over_ranks = reduce_grads, sum_losses


def dist_rank(rank: int, spec: dict) -> dict:
    """What each of the two processes sharing the card runs (gloo): one f32
    train step (TF32 off, dropout off) on its clip of ``spec``'s batch
    (``parallel/dryrun.py::train_step_on_shard``), then ``train.main
    --eval`` on ``spec["eval_argv"]``; each with its launch counts."""
    import torch
    import torch.distributed as dist

    from tce_rvos_tpu_torch import train
    from tce_rvos_tpu_torch.parallel import dryrun

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if dist.get_backend() != "gloo" or dist.get_world_size() != 2:
        raise AssertionError(f"rank {rank}: {dist.get_backend()} of {dist.get_world_size()}")
    reset_launch_counts()
    step = dryrun.train_step_on_shard(rank, spec)
    step["launches"] = launch_counts()
    step.pop("grads", None)
    reset_launch_counts()
    stats = train.main(spec["eval_argv"])
    return {"step": step, "eval": stats, "eval_launches": launch_counts()}


def rle_native_against_numpy(masks: list, label: str) -> dict:
    """Each mask through the C library and through numpy: RLE strings,
    decoded masks and boundary maps bitwise equal."""
    import numpy as np

    from tce_rvos_tpu_torch.eval import davis_eval
    from tce_rvos_tpu_torch.utils import rle

    pixels = 0
    for i, m in enumerate(masks):
        rle.USE_NATIVE = True
        enc, dec, bmap = rle.encode(m), None, davis_eval.seg2bmap(m)
        dec = rle.decode(enc)
        rle.USE_NATIVE = False
        try:
            if (rle.encode(m) != enc or not np.array_equal(rle.decode(enc), dec)
                    or not np.array_equal(davis_eval.seg2bmap(m), bmap)
                    or not np.array_equal(dec, m.astype(np.uint8))):
                raise AssertionError(f"{label} mask {i}: the C path differs from numpy")
        finally:
            rle.USE_NATIVE = True
        pixels += m.size
    return {"masks": len(masks), "pixels": pixels}


def dist_step_spec(cfg, root: str):
    """The two-rank step's spec for ``dryrun.train_step_on_shard``: seeded
    weights of ``cfg`` and two seeded 5x384x640 clips (one frame of the
    second not valid) written under ``root``. Returns (spec, weights)."""
    import dataclasses

    import numpy as np
    import torch

    spec = {"model": dataclasses.asdict(cfg), "device": "cuda",
            "weights": os.path.join(root, "dist_weights.pt"),
            "batch": os.path.join(root, "dist_batch.pt")}
    weights = random_state_dict(cfg, seed=5)
    torch.save(weights, spec["weights"])
    clips = [train_batch(5, (384, 640), seed=s) for s in (50, 51)]
    batch = {k: np.concatenate([c[k] for c in clips]) for k in clips[0] if k != "targets"}
    batch["targets"] = {k: np.concatenate([c["targets"][k] for c in clips])
                        for k in clips[0]["targets"]}
    batch["targets"]["valid"][1, 2] = 0
    torch.save(batch, spec["batch"])
    return spec, weights


def phase_dist(jhmdb_tree: str, root: str) -> dict:
    """Phase 13, the port's multi-process path and its host modules:
    (a) ``train.main`` at world 1 over NCCL through the launcher's
        environment, one epoch on a 720x1280 train tree (4 steps, bf16):
        the gradient all-reduce and the sum of the logged losses leave
        every gradient and loss bitwise as they were, 12 + 12 launches a
        step, finite losses;
    (b) two processes sharing the card over gloo: one f32 step (TF32 off,
        dropout off, ``--vis_loss --masks``) of the flagship at full width
        and 2 + 2 layers on one 5x384x640 clip each, held against the
        one-process step on both clips at the JAX package's DP tolerances
        (loss rtol 1e-5, grad norm rtol 1e-4, parameters atol 1e-4 / rtol
        1e-3), the ranks' parameters bitwise equal; then ``train.main
        --eval`` on phase 10's JHMDB tree (``--batch_size 1``, bf16): each
        rank's merged metrics exactly those of one process;
    (c) that one process's JHMDB evaluation with the C RLE and with numpy:
        the library built and taken, the metrics equal, every predicted
        mask's RLE, decoding and boundary map bitwise equal;
    (d) ``utils/profiling.trace`` around the one-process step writes a
        Chrome trace holding its span, the step's spans and device kernels,
        and ``spans.json`` with the span's CUDA-event time."""
    import shutil

    import torch

    from tce_rvos_tpu_torch import flagship_config, native
    from tce_rvos_tpu_torch.models import postprocessors
    from tce_rvos_tpu_torch.parallel import dryrun
    from tce_rvos_tpu_torch.utils import profiling, rle

    label = "[dist]"
    res = {}

    # (c) one process: JHMDB with the C RLE, then with numpy
    argv = ["--eval", "--dataset_file", "jhmdb", "--jhmdb_path", jhmdb_tree,
            "--batch_size", "1", "--output_dir", os.path.join(root, "out_dist_jhmdb"),
            *EVAL_FLAGS]
    per_forward = msda_per_forward(flagship_config())
    masks, host_post = [], postprocessors.a2d_host_postprocess

    def recording(*args, **kw):
        preds = host_post(*args, **kw)
        masks.extend(m for p in preds for m in p["masks"])
        return preds

    if native.lib() is None:
        raise AssertionError(f"{label} the C RLE library did not build (no C compiler?)")
    rle.USE_NATIVE = False  # numpy first, then the C path
    try:
        stats_numpy, _, _ = eval_run(argv, f"{label} jhmdb, numpy RLE", per_forward)
    finally:
        rle.USE_NATIVE = True
    calls = native.CALLS["native"]
    postprocessors.a2d_host_postprocess = recording
    try:
        stats_native, run_native, _ = eval_run(argv, f"{label} jhmdb, C RLE", per_forward)
    finally:
        postprocessors.a2d_host_postprocess = host_post
    native_calls = native.CALLS["native"] - calls
    if not native_calls:
        raise AssertionError(f"{label} the evaluation took no native RLE call")
    if stats_numpy != stats_native:
        raise AssertionError(f"{label} JHMDB metrics with numpy {stats_numpy} against the C "
                             f"RLE's {stats_native}")
    res["rle"] = dict(rle_native_against_numpy(masks, label), native_calls=native_calls,
                      library=str(native.library_path()))
    log(f"{label} JHMDB --batch_size 1 with the C RLE ({native_calls} library calls) and with "
        f"numpy: metrics equal; {len(masks)} predicted masks: RLE, decoding and boundary maps "
        "bitwise equal")

    # (b) two processes on the card over gloo, against one process
    cfg = flagship_config(**DIST_MODEL)
    spec, weights = dist_step_spec(cfg, root)
    spec["eval_argv"] = [os.path.join(root, "out_dist_jhmdb_2") if a.endswith("out_dist_jhmdb")
                         else a for a in argv]
    # (d) the one-process step under the profiler
    trace_dir = os.path.join(root, "trace")
    reset_launch_counts()
    with profiling.trace(trace_dir):
        with profiling.span("tce_dist_reference_step", 1):
            want = dryrun.train_step_on_shard(0, spec)
    want["launches"] = launch_counts()
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    with open(os.path.join(trace_dir, profiling.SPANS_FILE)) as fh:
        spans = {s["name"]: s for s in json.load(fh)["spans"]}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    names = {e.get("name") for e in events}
    if not {"tce_dist_reference_step", "tce.train.step"} <= names or not kernels:
        raise AssertionError(f"{label} the trace holds no span or no kernel")
    step_ms = spans["tce_dist_reference_step"]["device_ms"]
    if not step_ms or "tce.train.backward" not in spans:
        raise AssertionError(f"{label} spans.json: {sorted(spans)}, step {step_ms} ms")
    res["profiling"] = dict(trace_bytes=os.path.getsize(os.path.join(trace_dir,
                                                                     profiling.TRACE_FILE)),
                            events=len(events), kernels=kernels, step_device_ms=step_ms)
    shutil.rmtree(trace_dir)
    ranks = dryrun.run_processes(2, dist_rank, (spec,), device="cuda", backend="gloo",
                                 timeout=600)
    gaps = [dryrun.check_dp_step(r["step"], want, f"{label} gloo rank {i}")
            for i, r in enumerate(ranks)]
    for name, p in ranks[0]["step"]["params"].items():
        if not torch.equal(ranks[1]["step"]["params"][name], p):
            raise AssertionError(f"{label} the ranks hold other {name} after the step")
    per_step = {"msda_fwd": msda_per_forward(cfg), "msda_bwd": msda_per_forward(cfg),
                "msda3d_fwd": 0, "msda3d_bwd": 0}
    for i, r in enumerate(ranks):
        if r["step"]["launches"] != per_step:
            raise AssertionError(f"{label} rank {i} step launches {r['step']['launches']}, "
                                 f"expected {per_step}")
        if r["eval"] != stats_native:
            raise AssertionError(f"{label} rank {i}'s merged JHMDB metrics {r['eval']} against "
                                 f"one process's {stats_native}")
        if r["eval_launches"]["msda_fwd"] != per_forward * run_native["samples"] // 2:
            raise AssertionError(f"{label} rank {i}'s evaluation launches {r['eval_launches']}")
    if want["launches"] != per_step:
        raise AssertionError(f"{label} one-process step launches {want['launches']}")
    from tce_rvos_tpu_torch.config import TrainConfig

    worst = explain_gap(gaps[0], want, ranks[0]["step"], weights, TrainConfig(),
                        grads=want["grads"])
    res["gloo"] = dict(gaps=gaps, worst=worst, loss=want["metrics"]["loss"],
                       step_launches=[r["step"]["launches"] for r in ranks],
                       eval_launches=[r["eval_launches"] for r in ranks],
                       eval_samples=run_native["samples"])
    log(f"{label} two processes on the card over gloo: the f32 step on one clip each against "
        f"one process on both: " + "; ".join(
            f"rank {i} loss {g['loss_rel']:.3e} rel, grad norm {g['grad_norm_rel']:.3e} rel, "
            f"parameters {g['param_max_abs']:.3e} abs" for i, g in enumerate(gaps))
        + f"; the ranks' parameters bitwise equal; launches {per_step} a rank; JHMDB metrics "
        f"merged from two shards equal one process's exactly; " + gap_line(worst))
    del want, ranks, weights

    # (a) train.main at world 1 over NCCL
    tree = write_tree(os.path.join(root, "dist_tree"), "train", DIST_VIDEOS, seed=21,
                      absent={"d0": range(6, 10)})
    out = os.path.join(root, "out_dist")
    per_step_2d = {"msda_fwd": 12, "msda_bwd": 12, "msda3d_fwd": 0, "msda3d_bwd": 0}
    with nccl_world_one(), main_probe() as rec, reduction_probe() as red:
        _, run = main_run(rec, ["--dataset_file", "ytvos", "--ytvos_path", tree, *MAIN_FLAGS,
                                "--output_dir", out, "--epochs", "1"],
                          f"{label} train.main, NCCL world 1", per_step_2d)
    if red["checked_grads"] < 600 or red["checked_losses"] < run["steps"]:
        raise AssertionError(f"{label} the probe checked {red['checked_grads']} gradients and "
                             f"{red['checked_losses']} losses")
    if read_log(out)[0]["epoch"] != 0 or not os.path.exists(os.path.join(out, "checkpoint")):
        raise AssertionError(f"{label} no log line or checkpoint")
    shutil.rmtree(out)
    res["nccl"] = dict(run, allreduce_calls=red["allreduce_calls"],
                       grads_checked=red["checked_grads"])
    torch.cuda.empty_cache()
    log(f"{label} train.main over NCCL at world 1: {run['steps']} steps, every gradient and "
        f"loss bitwise through the reductions ({red['checked_grads']} gradients checked); "
        f"{red['allreduce_calls']} all-reduce calls a step on the flat buffer")
    return res


# ---------------------------------------------------------------------------
# phase 14: the frame-sharded forward of one video over two processes
# ---------------------------------------------------------------------------

SP_T, SP_HW = 10, (384, 640)  # one 10x384x640 clip (360x640 frames, padded), 5 frames a rank
SP_VSWIN_T = 12  # Video-Swin-B: 6 frames a rank, 8-frame windows crossing the ranks' boundary
SP_VALID = [7]   # valid_indices: the annotated frame is rank 1's (frames 5-9)
# f32 (TF32 off), two ranks' gathered outputs against the one-process
# forward on the card, (rtol, atol as a share of the largest |value|, as
# ``compare`` takes it): the same function with the attention GEMMs at
# other query lengths and cuDNN/cuBLAS at other batch sizes, so the sums
# round differently; the mask logits are a dynamic head's sums over the
# mask features, and carry more of it
SP_F32_TOL = {"pred_logits": (1e-4, 1e-4), "pred_boxes": (1e-4, 1e-4),
              "pred_masks": (1e-3, 1e-3)}
# bf16: a pixel's mask decision (logit > 0) may differ from the one-process
# forward's only where that logit lies within SP_BF16_MARGIN of the largest
# |logit| of 0, and on at most SP_BF16_FLIPPED of the pixels: the batch
# sizes of every GEMM and convolution differ, and bf16 rounds each
# differently (the logits' relative RMS gap is 2.0-2.1e-2, as phase 3's
# batched-against-serial one). Twice the larger of the 2D and 3D readings
# of the calibration run on an H100 (PERF.md §5, §6): margins 2.348e-2
# and 2.487e-3, shares 2.840e-3 and 1.432e-5, the same on both ranks and
# in two calls
SP_BF16_MARGIN, SP_BF16_FLIPPED = 4.7e-2, 5.7e-3
# the other cases' (margin, share), set the same way: twice the reading
# (the same on both ranks) of a calibration call with these gates off
# (PERF.md §5, §6). valid_indices: 1.773e-2, 3.932e-3; X3D-M: 1.017e-3,
# 2.604e-5. Video-Swin-B read 0, 0: its bf16 outputs equal the one-process
# forward's bitwise (logits, boxes and masks), so no decision may differ
SP_BF16_LIMITS = {"2d": (SP_BF16_MARGIN, SP_BF16_FLIPPED), "3d": (SP_BF16_MARGIN, SP_BF16_FLIPPED),
                  "valid": (3.55e-2, 7.9e-3), "x3d_m": (2.04e-3, 5.3e-5), "vswin_b": (0.0, 0.0)}
# name: (flagship_config's overrides, the weights' seed, frames, valid_indices).
# The weights: phase 3's (2d, valid), phase 7's (3d), phase 11's (vswin_b)
SP_CASES = {"2d": ({}, 0, SP_T, None), "3d": ({"msda_3d": True}, 1, SP_T, None),
            "vswin_b": ({"backbone": VSWIN_B}, 0, SP_VSWIN_T, None),
            "x3d_m": ({"backbone": "x3d_m"}, 0, SP_T, None),
            "valid": ({}, 0, SP_T, SP_VALID)}
SP_LAUNCHES = {name: {"msda_fwd": 4 if over.get("msda_3d") else 12, "msda_bwd": 0,
                      "msda3d_fwd": 8 if over.get("msda_3d") else 0, "msda3d_bwd": 0}
               for name, (over, _, _, _) in SP_CASES.items()}
SP_NCCL = ("2d", "vswin_b", "x3d_m")  # the models held at world 1 over NCCL, f32


def sp_clip_inputs(path: str, t: int = SP_T) -> None:
    """``synthetic_video(0, t)``'s frames normalised and padded to 384x640
    as the engine does, with CAPTIONS[0], saved as model inputs (numpy)."""
    import numpy as np

    from tce_rvos_tpu_torch.infer import IMAGENET_MEAN, IMAGENET_STD
    from tce_rvos_tpu_torch.models.text_encoder import tokenize

    h, w = FRAME_HW
    frames = np.stack(synthetic_video(0, t))
    video = np.zeros((1, t, *SP_HW, 3), np.float32)
    video[0, :, :h, :w] = (frames - IMAGENET_MEAN) / IMAGENET_STD
    mask = np.ones((1, t, *SP_HW), bool)
    mask[0, :, :h, :w] = False
    ids, attn = tokenize([CAPTIONS[0]])
    import torch

    torch.save(dict(video=video, video_mask=mask, text_ids=np.asarray(ids, np.int64),
                    text_attn_mask=np.asarray(attn, np.int64),
                    sizes=np.asarray([[h, w]], np.int64)), path)


def sp_forward(model, inputs: dict, shard) -> dict:
    """A first forward, then the one held (the second, as the limits were
    calibrated on) with the launch counts of this process; the outputs on
    the CPU, gathered into the whole clip's (with ``valid_indices`` every
    rank holds the annotated frames' whole)."""
    import torch

    from tce_rvos_tpu_torch.parallel.collectives import all_gather_frames
    from tce_rvos_tpu_torch.parallel.dryrun import SP_OUTPUTS

    kept = None if "valid_indices" in inputs else shard
    with torch.inference_mode():
        model(**inputs, frame_shard=shard)
        reset_launch_counts()
        out = model(**inputs, frame_shard=shard)
        launches = launch_counts()
        outs = {k: all_gather_frames(out[k], kept, clip_axis=True).float().cpu()
                for k in SP_OUTPUTS}
    return dict(outs, launches=launches)


def sp_runs(spec: dict, shard_fn) -> dict:
    """Each model of ``spec["models"]`` in f32 then bf16 through
    ``sp_forward``, its inputs laid out by ``shard_fn`` (inputs -> (inputs,
    shard))."""
    import torch

    from tce_rvos_tpu_torch.parallel import dryrun

    res = {}
    for name, case in spec["models"].items():
        model = dryrun.sp_model(case)
        for dtype in ("float32", "bfloat16"):
            model.to(getattr(torch, dtype))
            inputs, shard = shard_fn(dryrun.sp_model_inputs(dict(case, dtype=dtype)))
            res[f"{name}/{dtype}"] = dict(sp_forward(model, inputs, shard),
                                          shard=None if shard is None else
                                          (shard.rank, shard.world, shard.first, shard.count))
        del model
        torch.cuda.empty_cache()
    return res


def sp_rank(rank: int, spec: dict) -> dict:
    """What each of the two processes sharing the card runs (gloo): the
    frame-sharded forward of each model and dtype on its half of the
    frames."""
    import torch
    import torch.distributed as dist

    from tce_rvos_tpu_torch.parallel.mesh import shard_time_axis

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if dist.get_backend() != "gloo" or dist.get_world_size() != 2:
        raise AssertionError(f"rank {rank}: {dist.get_backend()} of {dist.get_world_size()}")
    return sp_runs(spec, shard_time_axis)


def sp_decisions(got, want) -> dict:
    """bf16 mask decisions against the one-process forward's: the share of
    pixels whose decision (logit > 0) differs, the largest |one-process
    logit| among them as a share of the largest |logit|, and the relative
    RMS difference of the logits."""
    g, w = got.double(), want.double()
    scale = max(float(w.abs().max()), 1.0)
    flipped = (g > 0) != (w > 0)
    worst = float(w.abs()[flipped].max()) / scale if bool(flipped.any()) else 0.0
    return {"flipped_share": float(flipped.double().mean()), "worst_margin": worst,
            "rel_rms": float(((g - w) ** 2).mean().sqrt() / (w ** 2).mean().sqrt())}


def sp_halos(frames: int, world: int = 2) -> dict:
    """Video-Swin's halo on each rank: the frames of the clip it gathers
    from the other rank for an unshifted and for a shifted block
    (``swin.temporal_window_plan``; the pad frames are zeros, not
    gathered). The same at every stage: the windows are 8 frames at every
    stage (T > 8), or the whole clip."""
    from tce_rvos_tpu_torch.models.swin import get_window_size, temporal_window_plan

    count = frames // world
    out = {}
    for rank in range(world):
        first = rank * count
        for kind, shift in (("unshifted", 0), ("shifted", 4)):
            (wt, _, _), (st, _, _) = get_window_size((frames, 96, 160), (8, 7, 7), (shift, 3, 3))
            plan = temporal_window_plan(frames, wt, st, first, count)
            held = {f for lo, hi in plan.ranges for f in range(lo, min(hi, frames))}
            out[f"rank{rank}_{kind}"] = len(held - set(range(first, first + count)))
    return out


def dryrun_on_card() -> dict:
    """``python -m tce_rvos_tpu_torch.parallel.dryrun --world 2`` as a user
    runs it, with no device flag: on the card, two ranks sharing it over
    gloo. Its JSON line."""
    run = subprocess.run([sys.executable, "-m", "tce_rvos_tpu_torch.parallel.dryrun",
                          "--world", "2"], capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if run.returncode != 0:
        raise AssertionError(f"[sp] the dry run exited {run.returncode}:\n{run.stderr[-4000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    if (res["device"], res["backend"], res["world"]) != ("cuda", "gloo", 2):
        raise AssertionError(f"[sp] the dry run ran on {res['device']} over {res['backend']} "
                             f"at world {res['world']}")
    log(f"[sp] dry run (python -m tce_rvos_tpu_torch.parallel.dryrun --world 2) on "
        f"{res['device']} over {res['backend']}: the step's gaps " + "; ".join(
            f"rank {i} loss {g['loss_rel']:.3e}, grad norm {g['grad_norm_rel']:.3e} relative, "
            f"parameters {g['param_max_abs']:.3e}" for i, g in enumerate(res["gaps"]))
        + "; the sp step's gaps " + "; ".join(
            f"rank {i} " + ", ".join(f"{tag} " + "/".join(f"{v:.3e}" for v in gaps.values())
                                     for tag, gaps in sp.items())
            for i, sp in enumerate(res["sp"]))
        + " (logits/boxes/masks)")
    return res


def phase_sp_kernels(shapes=FLAGSHIP_SHAPES) -> dict:
    """The 3D forward kernel at the frame-sharded forward's calls: rank 1's
    queries (frames 5-9 of each 10-frame clip) over the whole gathered
    value, at E = 1 (Nq = 5 of N = 10) and E = 4 (Nq = 20 of N = 40), at
    the encoder (Q = S) and decoder (Q = 5) shapes, f32 and bf16: against
    the plain version (FWD_TOL) and bitwise against the matching rows of
    the whole call; times and bounds as ``phase_kernels``."""
    import torch

    from tce_rvos_tpu_torch.ops.msda import ms_deform_attn_3d_plain
    from tce_rvos_tpu_torch.ops.msda_cuda import ms_deform_attn_3d

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(14)
    s = sum(h * w for h, w in shapes)
    half = SP_T // 2
    results = {}
    for e in (1, 4):
        n = SP_T * e
        rows = (torch.arange(e)[:, None] * SP_T + half + torch.arange(half)).reshape(-1).to(dev)
        for call, q in (("encoder", s), ("decoder", 5)):
            for dtype in (torch.float32, torch.bfloat16):
                key = f"sp_e{e}_{call}/{dtype_name(dtype)}"
                label = f"msda3d_fwd {key} Nq={len(rows)} N={n} Q={q}"
                value, loc, attn = msda_inputs(call, n, q, dtype, gen, dev, frames=True,
                                               shapes=shapes)
                lq, aq = loc[rows].contiguous(), attn[rows].contiguous()
                got, max_err = hold_forward(ms_deform_attn_3d, ms_deform_attn_3d_plain, label,
                                            value, shapes, lq, aq)
                if not torch.equal(got, ms_deform_attn_3d(value, shapes, loc, attn)[rows]):
                    raise AssertionError(f"{label}: not the whole call's rows bitwise")
                ms = graph_ms(lambda: ms_deform_attn_3d(value, shapes, lq, aq))
                plain_ms = cuda_ms(lambda: ms_deform_attn_3d_plain(value, shapes, lq, aq),
                                   reps=3, warmup=1)
                bound = msda_bound(value, lq, aq, got, shapes)
                rtol, atol = FWD_TOL[dtype_name(dtype)]
                results[key] = dict(Nq=len(rows), N=n, Q=q, max_abs_err=max_err, ms=ms,
                                    plain_ms=plain_ms, rtol=rtol, atol=atol, levels=shapes,
                                    **bound)
                log(f"[kernels] {label}: max|err|={max_err:.3e} (rtol {rtol}, atol {atol}), "
                    f"the whole call's rows bitwise; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                    f"  bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; {bound['bytes']} "
                    f"bytes, value {bound['value_bytes_read']} of {bound['value_bytes_all']})")
    return results


def phase_sp(root: str) -> dict:
    """Phase 14, the frame-sharded forward of one video
    (``parallel/mesh.py::shard_time_axis``): first the dry run as a user
    runs it (``dryrun_on_card``); then the flagship at full width and depth
    (RoBERTa-base, f_token 8, IQT, box refinement, binary, 4 + 4 layers)
    from seeded random weights, with one caption, on each of SP_CASES:
    ResNet-50 and its ``--msda_3d`` variant on one 10x384x640 clip,
    Video-Swin-B on 12 frames (6 a rank: its 8-frame windows cross the
    ranks' boundary and its backbone gathers their frames), X3D-M on 10
    (temporal-convolution halos, the squeeze-excitation means all-reduced)
    and ResNet-50 with ``valid_indices`` on rank 1's frame:
    (a) two processes sharing the card over gloo, f32 with TF32 off: each
        rank's gathered logits, boxes and masks (with ``valid_indices``,
        the annotated frame's, which every rank holds) against the
        one-process forward on the card at SP_F32_TOL;
    (b) the same in bf16: the gaps printed, the mask decisions held to
        SP_BF16_LIMITS;
    (e) NCCL at world 1 (SP_NCCL's models, f32): a shard of the whole clip
        gives the unsharded forward bitwise;
    (f) each rank's launches: 12 2D forwards (the 3D model: 8 3D and 4
        2D), as one process's.
    (d), the 3D kernel at the sharded call's shapes, runs with phase 2
    (``phase_sp_kernels``). Video-Swin-B's halo: ``sp_halos``."""
    import dataclasses

    import torch

    from tce_rvos_tpu_torch import flagship_config
    from tce_rvos_tpu_torch.parallel import dryrun
    from tce_rvos_tpu_torch.parallel.mesh import init_distributed, shard_time_axis

    label = "[sp]"
    res = {"dryrun": dryrun_on_card()}
    spec = {"models": {}}
    weights, clips = {}, {}
    for name, (over, seed, frames, valid) in SP_CASES.items():
        cfg = flagship_config(**over)
        key = (tuple(sorted(over.items())), seed)
        if key not in weights:
            weights[key] = os.path.join(root, f"sp_weights_{name}.pt")
            torch.save(random_state_dict(cfg, seed=seed), weights[key])
        if frames not in clips:
            clips[frames] = os.path.join(root, f"sp_inputs_t{frames}.pt")
            sp_clip_inputs(clips[frames], frames)
        spec["models"][name] = {"model": dataclasses.asdict(cfg), "device": "cuda",
                                "weights": weights[key], "inputs": clips[frames],
                                "valid_indices": valid}
    want = sp_runs(spec, lambda x: (x, None))  # one process, the whole clip
    ranks = dryrun.run_processes(2, sp_rank, (spec,), device="cuda", backend="gloo",
                                 timeout=900)
    # (e) NCCL at world 1, f32
    nccl = {}
    with nccl_world_one():
        init_distributed("cuda")
        for name in SP_NCCL:
            case = spec["models"][name]
            model = dryrun.sp_model(case)
            local, shard = shard_time_axis(dryrun.sp_model_inputs(case))
            if shard is None or (shard.world, shard.count) != (1, SP_CASES[name][2]):
                raise AssertionError(f"{label} NCCL world 1 {name}: shard {shard}")
            nccl[name] = sp_forward(model, local, shard)
            del model
            torch.cuda.empty_cache()
    for name, got in nccl.items():
        for k in dryrun.SP_OUTPUTS:
            if not torch.equal(got[k], want[f"{name}/float32"][k]):
                raise AssertionError(f"{label} NCCL world 1 {name}: {k} is not the unsharded "
                                     "forward's")
        if got["launches"] != SP_LAUNCHES[name]:
            raise AssertionError(f"{label} NCCL world 1 {name}: launches {got['launches']}")
    res["nccl_world1"] = {name: {"launches": g["launches"]} for name, g in nccl.items()}
    res["halos_video_swin_b"] = sp_halos(SP_VSWIN_T)
    log(f"{label} Video-Swin-B at T = {SP_VSWIN_T}, 6 frames a rank: frames each rank gathers "
        f"from the other for a block (the same at every stage): {res['halos_video_swin_b']}; at "
        f"T = {SP_T}: {sp_halos(SP_T)}; at T <= 8 the whole clip")
    for tag, w in want.items():
        name, dtype = tag.split("/")
        _, _, frames, valid = SP_CASES[name]
        t_out = 1 if valid else frames
        entry = {"one_process": {"launches": w["launches"]}, "ranks": []}
        if w["launches"] != SP_LAUNCHES[name]:
            raise AssertionError(f"{label} {tag} one process launched {w['launches']}")
        for k, shape in (("pred_logits", (1, t_out, 5, 1)), ("pred_boxes", (1, t_out, 5, 4)),
                         ("pred_masks", (1, t_out, 5, SP_HW[0] // 4, SP_HW[1] // 4))):
            if tuple(w[k].shape) != shape or not bool(torch.isfinite(w[k]).all()):
                raise AssertionError(f"{label} {tag} one process: {k} {tuple(w[k].shape)}, "
                                     "or not finite")
        for i, r in enumerate(ranks):
            got = r[tag]
            if got["shard"] != (i, 2, i * frames // 2, frames // 2):
                raise AssertionError(f"{label} rank {i} {tag}: shard {got['shard']}")
            if got["launches"] != SP_LAUNCHES[name]:
                raise AssertionError(f"{label} rank {i} {tag}: launches {got['launches']}, "
                                     f"expected {SP_LAUNCHES[name]}")
            gaps = {k: float((got[k].double() - w[k].double()).abs().max())
                    for k in dryrun.SP_OUTPUTS}
            gaps.update({f"{k}_of_scale": gaps[k] / max(float(w[k].abs().max()), 1.0)
                         for k in dryrun.SP_OUTPUTS})
            if dtype == "bfloat16":
                gaps["decisions"] = sp_decisions(got["pred_masks"], w["pred_masks"])
            entry["ranks"].append(dict(launches=got["launches"], gaps=gaps))
        res[tag] = entry
        what = (f"the annotated frame {valid[0]} of {frames}, on rank {valid[0] // (frames // 2)}"
                if valid else f"{frames // 2} frames against one process of {frames}")
        log(f"{label} {tag}: two ranks, {what}: " + "; ".join(
            f"rank {i} " + ", ".join(f"{k} {v:.3e}" for k, v in r["gaps"].items()
                                     if not isinstance(v, dict))
            + ("; mask decisions differ on {flipped_share:.3e} of pixels (worst margin "
               "{worst_margin:.3e}, rel RMS {rel_rms:.3e})".format(**r["gaps"]["decisions"])
               if "decisions" in r["gaps"] else "")
            for i, r in enumerate(entry["ranks"]))
            + f"; launches {SP_LAUNCHES[name]}")
    res["bf16_against_f32"] = {name: sp_decisions(want[f"{name}/bfloat16"]["pred_masks"],
                                                   want[f"{name}/float32"]["pred_masks"])
                                for name in SP_CASES}
    log(f"{label} one process, bf16 mask logits against f32 (decisions differing, worst "
        "margin, rel RMS): " + "; ".join(
            f"{n} {d['flipped_share']:.3e}, {d['worst_margin']:.3e}, {d['rel_rms']:.3e}"
            for n, d in res["bf16_against_f32"].items()))
    for tag, w in want.items():  # the gates, after every case's numbers are logged
        name, dtype = tag.split("/")
        for i, r in enumerate(ranks):
            if dtype == "float32":
                for k, (rtol, atol) in SP_F32_TOL.items():
                    compare(r[tag][k].numpy(), w[k].numpy(), rtol, atol,
                            f"{label} rank {i} {tag} {k}")
            else:
                d = res[tag]["ranks"][i]["gaps"]["decisions"]
                margin, share = SP_BF16_LIMITS[name]
                if d["worst_margin"] > margin or d["flipped_share"] > share:
                    raise AssertionError(
                        f"{label} rank {i} {tag}: mask decisions differ on "
                        f"{d['flipped_share']:.3e} of pixels (limit {share}), up to "
                        f"{d['worst_margin']:.3e} of the largest |logit| from 0 (limit "
                        f"{margin})")
    log(f"{label} NCCL world 1: a shard of the whole clip gives the unsharded f32 forward "
        f"bitwise ({', '.join(nccl)})")
    return res


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def kernels_line(kern: dict, bwd: dict, kern3: dict, bwd3: dict, serve: dict, train: dict,
                 serve3: dict, train3: dict, main_runs: dict, evals: dict,
                 backbones: dict, options: dict, dist: dict, adamw: dict, sp: dict) -> dict:
    """The JSON ``kernels`` record: each kernel's main shape in its
    deployment dtype (the encoder call in bf16: E = 4 for the forwards'
    serving paths, N = 5 for the training steps' backwards) in the top-level
    numbers, every measured shape under ``shapes``. ``launches`` counts the
    launches of the kernel's own main path (flagship serving for msda_fwd,
    flagship training for msda_bwd, the --msda_3d serving and training paths
    for the 3D kernels); ``launches_by_path`` gives every path's count,
    ``train.main``'s two runs (phase 9: 2D, two epochs; ``--msda_3d``) among
    them, and ``shapes`` the calls held at those runs' largest padded
    shapes (``main_HxW`` N = 5, ``main_3d_HxW`` N = 10); phase 10's paths
    (``eval_jhmdb``, ``eval_refcoco``, ``train_joint``, ``train_mevis``)
    likewise, with the 2D calls held at their shapes (``eval_jhmdb_HxW_N2``,
    ``eval_refcoco_HxW_N10``, ``train_joint_HxW_N10``); phase 11's paths
    (the Video-Swin-B flagship's serving, whole-video and training runs,
    one forward on each other family) likewise, with the 2D calls held at
    the DC5 levels (``dc5_e4``, S = 6000) and at Video-Swin-B's serving
    (``video_swin_b_e4``) and training (``video_swin_b_train``) shapes;
    phase 12's paths (the LastLayerAsToken flagship's serving, whole-video
    and training runs, the option runs of ``train.main`` and the
    ``--vlblock --no_rel_coord`` steps) likewise, with the 2D calls held at
    the ``train.main`` runs' largest padded shape (``options_HxW``);
    phase 13's paths (``train.main`` over NCCL at world 1, each gloo rank's
    step and evaluation) likewise; phase 14's (for each model of SP_CASES,
    ``sp_{name}_rank{i}`` each gloo rank's frame-sharded forward,
    ``sp_{name}_one_process`` the one-process forward and
    ``sp_{name}_nccl_world1`` the NCCL world-1 shard, all in f32) likewise,
    with the 3D forward held at
    the sharded calls (``sp/sp_e{1,4}_*``: Nq = 5 of N = 10 and 20 of 40).
    The flat AdamW update (``flat_adamw``)
    replaces no Pallas kernel but the update XLA fuses
    (``make_flat_adamw_fused``); its ``launches`` are phase 5's flagship
    training run's, its numbers phase 5b's at the flagship's 183,506,503
    elements, ``library_ms`` torch.optim.AdamW(fused=True).step over the
    same parameters and tiers, with the norm + update pair and the other
    library timings beside them."""
    def entry(name, source, replaces, also, main, launches, by_path, shapes):
        return {"name": name, "route": "cuda", "source": f"tce_rvos_tpu_torch/csrc/{source}",
                "replaces": f"tce_rvos_tpu/ops/{replaces}",
                "replaces_also": [f"tce_rvos_tpu/ops/{r}" for r in also],
                "launches": launches, "launches_by_path": by_path,
                "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None, "shapes": shapes}

    def flat(d):
        return {f"{outer}/{k}": v for outer, inner in d.items() for k, v in inner.items()}

    s3 = serve3["launches"]
    m2, m3 = main_runs["run1"]["launches"], main_runs["run4"]["launches"]
    hold = main_runs["hold"]
    run1, run4 = (f"main_{hold['hw'][0]}x{hold['hw'][1]}",
                  f"main_3d_{hold['hw_3d'][0]}x{hold['hw_3d'][1]}")
    at_main = {"fwd": {**{f"{run1}/{k}": v for k, v in hold["fwd"].items()},
                       **{f"{run4}/{k}": v for k, v in hold["fwd_n10"].items()}},
               "bwd": {**{f"{run1}/{k}": v for k, v in hold["bwd"].items()},
                       **{f"{run4}/{k}": v for k, v in hold["bwd_n10"].items()}},
               "fwd3": {f"{run4}/{k}": v for k, v in hold["fwd_3d"].items()},
               "bwd3": {f"{run4}/{k}": v for k, v in hold["bwd_3d"].items()}}

    def at(key, path, kind):
        h = evals[key]["hold"]
        tag = f"{path}_{h['hw'][0]}x{h['hw'][1]}_N{h.get('N', 2)}"
        return {f"{tag}/{k}": v for k, v in h[kind].items()}

    at_main["fwd"].update({**at("jhmdb", "eval_jhmdb", "fwd"),
                           **at("refcoco", "eval_refcoco", "fwd"),
                           **at("train_joint", "train_joint", "fwd")})
    at_main["bwd"].update(at("train_joint", "train_joint", "bwd"))
    p10 = {"eval_jhmdb": evals["jhmdb"]["launches"], "eval_refcoco": evals["refcoco"]["launches"],
           "train_joint": evals["train_joint"]["launches"],
           "train_mevis": evals["mevis"]["launches"]}

    bb = backbones
    p11 = {"serve_video_swin_b": {"msda_fwd": bb["path"]["bfloat16"]["launches"], "msda_bwd": 0},
           "whole_video_video_swin_b": {"msda_fwd": bb["whole_video"]["launches"]["msda_fwd"],
                                        "msda_bwd": 0},
           "train_video_swin_b": {"msda_fwd": bb["train"]["plain"]["launches"],
                                  "msda_bwd": bb["train"]["plain"]["backward_launches"]},
           **{f"forward_{name}": {"msda_fwd": f["launches"], "msda_bwd": 0}
              for name, f in bb["families"].items()}}
    at_main["fwd"].update(flat(bb["kernels"]))
    at_main["bwd"].update(flat(bb["backward"]))

    op, om = options, options["main"]
    whole = sum(r["launches"] for r in op["tokens_whole_video"].values())
    p12 = {"serve_f_token_-1": {"msda_fwd": op["tokens_path"]["launches"], "msda_bwd": 0},
           "whole_video_f_token_-1": {"msda_fwd": whole, "msda_bwd": 0},
           "train_f_token_-1": {"msda_fwd": op["tokens_train"]["launches"],
                                "msda_bwd": op["tokens_train"]["backward_launches"]},
           **{f"train_main_{k}": om[k]["launches"]
              for k in ("classes65", "binary_finetune_no_masks")},
           "infer_main_classes65": om["infer"]["launches"],
           "train_vl_off": {"msda_fwd": op["vl_off"]["vl_off"]["train"]["launches"],
                            "msda_bwd": op["vl_off"]["vl_off"]["train"]["backward_launches"]}}
    tag = f"options_{om['hold']['hw'][0]}x{om['hold']['hw'][1]}"
    at_main["fwd"].update({f"{tag}/{k}": v for k, v in om["hold"]["fwd"].items()})
    at_main["bwd"].update({f"{tag}/{k}": v for k, v in om["hold"]["bwd"].items()})

    p13 = {"train_main_nccl_world1": dist["nccl"]["launches"],
           **{f"gloo_rank{i}_step": c for i, c in enumerate(dist["gloo"]["step_launches"])},
           **{f"gloo_rank{i}_eval_jhmdb": c
              for i, c in enumerate(dist["gloo"]["eval_launches"])}}

    p14 = {**{f"sp_{name}_{who}": c for name in SP_CASES for who, c in (
              ("one_process", sp[f"{name}/float32"]["one_process"]["launches"]),
              *((f"rank{i}", r["launches"])
                for i, r in enumerate(sp[f"{name}/float32"]["ranks"])))},
           **{f"sp_{name}_nccl_world1": g["launches"] for name, g in sp["nccl_world1"].items()}}

    def by_path(d, kname):
        return {**d, "train_main": m2[kname], "train_main_3d": m3[kname],
                **{path: counts[kname] for path, counts in p10.items()},
                **({path: counts[kname] for p in (p11, p12) for path, counts in p.items()}
                   if kname in ("msda_fwd", "msda_bwd") else {}),
                **{path: counts[kname] for p in (p13, p14) for path, counts in p.items()}}

    return {"kernels": [
        entry("msda_fwd", "msda_fwd.cu", "pallas_msda.py:166", ["pallas_msda.py:265"],
              kern["e4"]["encoder/bfloat16"], serve,
              by_path({"serve": serve, "train": train["plain"]["launches"],
                       "serve_3d": s3["msda_fwd"], "train_3d": train3["launches"]}, "msda_fwd"),
              {**flat(kern), **at_main["fwd"]}),
        entry("msda_bwd", "msda_bwd.cu", "pallas_msda_bwd.py:70",
              ["pallas_msda_bwd.py:157", "pallas_msda_bwd.py:232", "pallas_msda_bwd.py:311"],
              bwd["encoder/bfloat16"], train["plain"]["backward_launches"],
              by_path({"serve": 0, "train": train["plain"]["backward_launches"], "serve_3d": 0,
                       "train_3d": train3["backward_launches"]}, "msda_bwd"),
              {**bwd, **at_main["bwd"]}),
        entry("msda3d_fwd", "msda3d_fwd.cu", "pallas_msda_3d.py:51", ["pallas_msda_3d.py:124"],
              kern3["e4"]["encoder/bfloat16"], s3["msda3d_fwd"],
              by_path({"serve": 0, "train": 0, "serve_3d": s3["msda3d_fwd"],
                       "train_3d": train3["launches_3d"]}, "msda3d_fwd"),
              {**flat(kern3), **at_main["fwd3"]}),
        entry("msda3d_bwd", "msda3d_bwd.cu", "pallas_msda_3d_bwd.py:48",
              ["pallas_msda_3d_bwd.py:120", "pallas_msda_3d_bwd.py:175",
               "pallas_msda_3d_bwd.py:247"],
              bwd3["n5"]["encoder/bfloat16"], train3["backward_launches_3d"],
              by_path({"serve": 0, "train": 0, "serve_3d": 0,
                       "train_3d": train3["backward_launches_3d"]}, "msda3d_bwd"),
              {**flat(bwd3), **at_main["bwd3"]}),
        {"name": "flat_adamw", "route": "cuda", "source": "tce_rvos_tpu_torch/csrc/flat_adamw.cu",
         "replaces": "tce_rvos_tpu/parallel/flat_adamw.py:238",
         "replaces_kind": "not Pallas: the update XLA fuses (make_flat_adamw_fused)",
         "launches": train["plain"]["adamw_launches"],
         "launches_by_path": {
             "train": train["plain"]["adamw_launches"],
             "train_ckpt": train["ckpt"]["adamw_launches"],
             "train_3d": train3["adamw_launches"],
             "train_main": main_runs["run1"]["adamw_launches"],
             "train_main_3d": main_runs["run4"]["adamw_launches"],
             "train_main_nccl_world1": dist["nccl"]["adamw_launches"]},
         "max_abs_err": adamw["max_abs_err"], "ms": adamw["ms"], "plain_ms": adamw["plain_ms"],
         "bound_ms": adamw["bound_ms"], "bound_by": adamw["bound_by"],
         "library_ms": adamw["library_ms"], "elements": adamw["elements"],
         "pair_ms": adamw["pair_ms"], "pair_bound_ms": adamw["pair_bound_ms"],
         "norm_ms": adamw["norm_ms"], "library_all_ms": adamw["library"],
         "cases": adamw["cases"]},
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import tce_rvos_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the tce_rvos_tpu_torch package is not importable ({exc}); "
              "run from the root of a checkout", file=sys.stderr)
        return 1
    # float32 means float32: no TF32 in cuDNN convolutions or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    times = {}

    def done(phase: str) -> None:  # the wall time at each phase's end
        times[phase] = round(time.perf_counter() - t_start, 1)
        log(f"[time] {phase} done at {times[phase]} s")

    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    phase_build()
    done("1 build")
    # E = 32 is N = 160 frames: the whole-video dispatch of 4 expressions x 40
    kern = {"e4": phase_kernels(e=4), "e1": phase_kernels(e=1), "e32": phase_kernels(e=32)}
    bwd = phase_backward_kernels()
    phase_edge_kernels()
    phase_ab()
    kern3 = {"e4": phase_kernels(e=4, is_3d=True), "e1": phase_kernels(e=1, is_3d=True),
             "sp": phase_sp_kernels()}  # phase 14's calls: fewer query frames than N
    bwd3 = {"n5": phase_backward_kernels(5, is_3d=True),
            "n10": phase_backward_kernels(10, is_3d=True)}
    done("2 kernels")
    from tce_rvos_tpu_torch import flagship_config

    sd = random_state_dict(flagship_config(), seed=0)
    videos = [synthetic_video(seed=v) for v in range(3)]
    paths, masks = {}, {}
    for dtype_name in ("bfloat16", "float32"):
        paths[dtype_name], masks[dtype_name] = phase_path(dtype_name, sd, videos)
    bf16_against_f32(masks)
    del masks
    done("3 path")
    phase_parity(sd, videos[0])
    done("4 parity")
    train = phase_train(sd)
    done("5 train")
    adamw = phase_flat_adamw(sd)
    done("5b flat adamw")
    phase_train_parity(sd)
    done("6 train parity")
    # the 3D f32 step, GPU and CPU each against float64, at two weight seeds
    phase_train_against_f64(msda_3d=True)
    # the 3D model's weights: seed 1. With those of seed 0 the CPU's own f32
    # step lies 1.6e-3 of the largest |grad| from float64 on one tensor,
    # beyond the direct GPU-against-CPU element limit (1e-3); with seed 1,
    # 1.6e-4 (PERF.md)
    sd3 = random_state_dict(flagship_config(msda_3d=True), seed=1)
    serve3 = phase_path_3d(sd3, videos[0])
    phase_parity(sd3, videos[0], msda_3d=True)
    train3 = phase_train_3d(sd3)
    phase_train_parity(sd3, msda_3d=True)
    done("7 3D path")
    envelope = phase_envelope(sd, videos[0])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        protocols = phase_protocols(sd, sd3, root)
        del sd, sd3
        done("8 protocols")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_main_") as main_root:
            main_runs = phase_main(main_root)
            done("9 main")
            # phase 10 scores phase 8's davis PNGs and trains on phase 9's ytvos tree
            evals = phase_eval(os.path.join(root, "eval"),
                               davis_results=os.path.join(root, "out_davis", "valid"),
                               ytvos_train=os.path.join(main_root, "tree"))
            done("10 eval")
            # phase 12 trains on phase 9's tree and serves phase 8's small ytvos tree
            options = phase_options(videos, os.path.join(main_root, "tree"),
                                    os.path.join(root, "small"), main_root)
            done("12 options")
        backbones = phase_backbones(videos, root)
        done("11 backbones")
        # phase 13 evaluates phase 10's JHMDB tree
        dist = phase_dist(os.path.join(root, "eval", "jhmdb"), root)
        done("13 dist")
        sp = phase_sp(root)
        done("14 sp")
    log("[numbers] " + json.dumps({"flat_adamw": adamw, "envelope": envelope,
                                   "protocols": protocols,
                                   "main": main_runs, "eval": evals, "backbones": backbones,
                                   "options": options, "dist": dist, "sp": sp,
                                   "times_s": times}))
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels_line(kern, bwd, kern3, bwd3, paths["bfloat16"]["launches"], train,
                                  serve3, train3, main_runs, evals, backbones, options, dist,
                                  adamw, sp)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
