"""The benchmark's own arithmetic: the H100's peaks, the useful FLOPs of the
TCE-RVOS model at a request's real frames and expressions, and the least
time of an MSDA call and of the flat AdamW update, all from the
configuration and the shapes. Nothing here reads the program.

FLOPs are 2 per multiply-add of the model's matrix products and
convolutions (what ``torch.utils.flop_counter`` counts), at the real
frames, the real expressions and each caption's own tokens: padded frames,
padded expressions, padded tokens and Swin's window padding are not useful
work and are not counted. MSDA's sampling, norms, softmax and other
elementwise work are not counted either. The backbone's count is its
family's (``reference/backbones.py``), by these rules; the rest is here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from reference import family
from reference.layers import conv_out

# NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12   # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


def backbone_flops(cfg: dict, t: int, hw: Tuple[int, int]):
    """(FLOPs of the backbone on a t-frame clip at padded size ``hw``, those
    of its first convolution, the four output sizes), by the backbone's
    family (``reference/backbone_<family>.py``); an unknown name raises."""
    return family(cfg["backbone"]).flops(cfg["backbone"], cfg, t, hw)


def backbone_channels(cfg: dict) -> List[int]:
    return family(cfg["backbone"]).channels(cfg["backbone"])


def mha(sq: int, sk: int, c: int) -> float:
    """One attention of sq queries over sk keys, width c: the q and output
    projections of the queries, k and v of the keys, q k^T and the
    weighted sum."""
    return 2.0 * c * c * (2 * sq + 2 * sk) + 4.0 * sq * sk * c


def dynamic_head_params(cfg: dict) -> int:
    m, ch, n = cfg["mask_dim"], cfg["dynamic_mask_channels"], cfg["controller_layers"]
    first = (m + 2 if cfg["rel_coord"] else m) * ch
    weights = [first] + [ch * ch] * (n - 2) + [ch]
    return sum(weights) + ch * (n - 1) + 1


def _levels(sizes: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The transformer's four levels: res3..res5 and a stride-2 3x3 on res5."""
    h, w = sizes[-1]
    return list(sizes[1:]) + [(conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1))]


def trunk_flops(cfg: dict, t: int, sizes: List[Tuple[int, int]], tokens: int,
                heads_calls: int = 1) -> Dict[str, float]:
    """FLOPs of the text-conditioned trunk for one expression (b = 1) on a
    t-frame clip whose backbone gave ``sizes`` (res2..res5), with a caption
    of ``tokens`` tokens; ``heads_calls``: how many decoder layers' classes
    and masks are computed (1 in serving; every layer in training with the
    auxiliary losses). By part, for the readers and the tests."""
    c, f, q = cfg["hidden_dim"], cfg["dim_feedforward"], cfg["num_queries"]
    hidden, inter = cfg["text_encoder_hidden"], cfg["text_encoder_intermediate"]
    s_txt = tokens
    m, lv = cfg["nheads"], cfg["num_feature_levels"]
    if lv != 4:
        raise ValueError("the count follows the 4-level model")
    off = m * lv * cfg["enc_n_points"]          # sampling offsets' and weights' width / 2, / 1
    dec_off = m * lv * cfg["dec_n_points"]
    chans = backbone_channels(cfg)
    levels = _levels(sizes)
    s_all = sum(h * w for h, w in levels)
    n = t
    out = {}
    text = cfg["text_encoder_layers"] * (
        2.0 * s_txt * hidden * hidden * 4 + 4.0 * s_txt * s_txt * hidden
        + 4.0 * s_txt * hidden * inter) + 2.0 * hidden * hidden
    out["text"] = text + 2.0 * s_txt * hidden * c + 2.0 * hidden * c
    proj = sum(2.0 * n * h * w * ch * c for (h, w), ch in zip(levels[:3], chans[1:]))
    proj += 2.0 * n * levels[3][0] * levels[3][1] * chans[3] * c * 9
    fusion = sum(mha(n * h * w, s_txt, c) for h, w in levels)
    out["input_proj_fusion"] = proj + fusion
    enc = 0.0
    tk = cfg["f_token"]
    for _ in range(cfg["enc_layers"]):
        if tk > 0:
            enc += 2.0 * n * tk * c * 2                                     # reference points
            enc += 2.0 * n * s_all * c * c                                  # value_proj
            enc += 2.0 * n * tk * c * (3 * off + c)                         # offsets, weights, out
            enc += mha(n * tk, n * tk, c)                                   # token self-attention
            enc += 2.0 * c * c * (2 * n * s_all + 2 * n * tk) + 4.0 * n * s_all * tk * c
            enc += 4.0 * n * s_all * c * f                                  # FFN
        elif tk < 0:
            raise ValueError("the count has no LastLayerAsToken (f_token < 0)")
        enc += 2.0 * n * s_all * c * (2 * c + 3 * off) + 4.0 * n * s_all * c * f
    out["encoder"] = enc
    dec = 2.0 * n * q * c * 2
    for _ in range(cfg["dec_layers"]):
        # self-attention: IQT over each query slot's t frames, else over the
        # query slots of one frame
        dec += 8.0 * n * q * c * c + (4.0 * q * t * t * c if cfg["qtrans"] else 4.0 * n * q * q * c)
        dec += 2.0 * n * s_all * c * c + 2.0 * n * q * c * (3 * dec_off + c)
        dec += 4.0 * n * q * c * f
        if cfg["with_box_refine"]:
            dec += 2.0 * n * q * (2 * c * c + 4 * c)
    if not cfg["with_box_refine"]:
        dec += 2.0 * n * q * (2 * c * c + 4 * c)
    out["decoder"] = dec
    fpn = 0.0
    sr = (8, 4, 2, 1)
    for stage in range(1, 5):
        h, w = sizes[stage - 1]
        cin = chans[0] if stage == 1 else c
        fpn += 2.0 * n * h * w * cin * c + 2.0 * n * h * w * c * c * 9
        if cfg["vlblock"]:
            nh, nw = int(h / sr[stage - 1]), int(w / sr[stage - 1])
            fpn += mha(t * nh * nw, t * nh * nw, c)
            fpn += mha(t * h * w, s_txt, c) + 4.0 * t * h * w * c * f
    h0, w0 = sizes[0]
    fpn += 2.0 * n * h0 * w0 * c * cfg["mask_dim"] * 9
    out["pixel_decoder"] = fpn
    ch = cfg["dynamic_mask_channels"]
    per_head = 2.0 * n * q * (2 * c * c + c * dynamic_head_params(cfg)) + 2.0 * n * q * c * cfg[
        "num_classes"]
    per_head += 2.0 * n * q * h0 * w0 * (ch * cfg["mask_dim"] + ch * ch * (
        cfg["controller_layers"] - 2) + ch)
    rel = 2.0 * n * q * h0 * w0 * ch * 2 if cfg["rel_coord"] else 0.0
    out["mask_head"] = heads_calls * (per_head + rel)
    out["rel_coord"] = heads_calls * rel
    return out


def num_classes(cfg: dict) -> int:
    if cfg["binary"]:
        return 1
    return {"ytvos": 65, "davis": 78, "a2d": 1, "jhmdb": 1}.get(cfg["dataset_file"], 91)


def model_cfg(cfg: dict) -> dict:
    """The configuration with ``num_classes`` worked out, as the counts read it."""
    return {**cfg, "num_classes": num_classes(cfg)}


def forward_flops(cfg: dict, t: int, hw: Tuple[int, int], tokens: Sequence[int]) -> float:
    """Serving: one window of t real frames at padded size ``hw``, the
    backbone once and the trunk once per expression (its caption's tokens)."""
    cfg = model_cfg(cfg)
    bb, _, sizes = backbone_flops(cfg, t, hw)
    trunk = sum(sum(v for k, v in trunk_flops(cfg, t, sizes, s).items() if k != "rel_coord")
                for s in tokens)
    return bb + trunk


def train_flops(cfg: dict, t: int, hw: Tuple[int, int], tokens: Sequence[int]) -> float:
    """Training: forward with every decoder layer's heads (the auxiliary
    losses), and the backward of what trains: two products for each forward
    product, except the input gradient of the first convolution (the video
    needs none) and of the relative-coordinate product (the reference
    points are detached)."""
    cfg = model_cfg(cfg)
    bb, first, sizes = backbone_flops(cfg, t, hw)
    calls = cfg["dec_layers"] if cfg["aux_loss"] else 1
    fwd, rel = bb, 0.0
    for s in tokens:
        parts = trunk_flops(cfg, t, sizes, s, heads_calls=calls)
        fwd += sum(v for k, v in parts.items() if k != "rel_coord")
        rel += parts["rel_coord"]
    return 3.0 * fwd - first - rel


# ---------------------------------------------------------------------------
# MSDA: the least time of a call, from its shapes
# ---------------------------------------------------------------------------

def msda_bound_s(n: int, q: int, s: int, heads: int, head_dim: int, levels: int, points: int,
                 elem: int, own_pixels: bool, backward: bool) -> float:
    """The least time of one 2D MSDA call of N clip-frames, Q queries and S
    value pixels, at ``elem`` bytes an element (the compute dtype's; the
    least any kernel must carry): the larger of its bytes over the HBM rate
    and its operations over the f32 peak. Bytes: the sampling locations (2
    a tap), the attention weights and the output once, in backward their
    gradients too (and the incoming gradient); the value, and in backward
    d_value, only where the queries are the value's own pixels (the
    encoder), since elsewhere the taps touch a small part of it. Operations:
    one multiply-add a channel a tap (the weighted sum), two in backward
    (d_attn and d_value). A lower bound on what any kernel must do."""
    taps = n * q * heads * levels * points
    out = n * q * heads * head_dim
    nbytes = elem * (3 * taps + out)
    ops = 2.0 * head_dim * taps
    if backward:
        nbytes += elem * (3 * taps + out)
        ops *= 2
    if own_pixels:
        nbytes += elem * n * s * heads * head_dim * (2 if backward else 1)
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS)


def trunk_msda_calls(cfg: dict, n: int, sizes: List[Tuple[int, int]]) -> List[Tuple[int, int, bool]]:
    """The MSDA calls of one trunk forward over N clip-frames (expressions
    times frames, padding included, as the call is made): (N, Q, queries
    are the value's own pixels) for each encoder layer, its FTF tokens and
    each decoder layer."""
    s_all = sum(h * w for h, w in _levels(sizes))
    calls = []
    for _ in range(cfg["enc_layers"]):
        if cfg["f_token"] > 0:
            calls.append((n, cfg["f_token"], False))
        calls.append((n, s_all, True))
    calls += [(n, cfg["num_queries"], False)] * cfg["dec_layers"]
    return calls


def trunk_msda_bound_s(cfg: dict, n: int, hw: Tuple[int, int], elem: int,
                       backward: bool = False) -> float:
    """The least time of all MSDA calls (forward, or backward) of one trunk
    forward over N clip-frames at padded size ``hw``."""
    _, _, sizes = backbone_flops(cfg, 1, hw)
    s_all = sum(h * w for h, w in _levels(sizes))
    m = cfg["nheads"]
    return sum(msda_bound_s(nn, q, s_all, m, cfg["hidden_dim"] // m, cfg["num_feature_levels"],
                            cfg["enc_n_points"] if own else cfg["dec_n_points"], elem, own,
                            backward)
               for nn, q, own in trunk_msda_calls(cfg, n, sizes))


ADAMW_BYTES_PER_PARAM = 28  # p read and written, g read, mu and nu read and written (f32)


def adamw_bound_s(params: int) -> float:
    """The least time of one flat AdamW update over ``params`` f32 parameters."""
    return ADAMW_BYTES_PER_PARAM * params / PEAK_HBM_BYTES


def model_size(hw: Tuple[int, int], size: int, max_size: int) -> Tuple[int, int]:
    """Short side ``size``, long side at most ``max_size`` (torchvision's rule)."""
    h, w = hw
    lo, hi = float(min(h, w)), float(max(h, w))
    if hi / lo * size > max_size:
        size = int(round(max_size * lo / hi))
    if (h <= w and h == size) or (w <= h and w == size):
        return h, w
    if h < w:
        return size, int(size * w / h)
    return int(size * h / w), size


def padded_hw(frame_hw: Tuple[int, int], size: int, max_size: int, pad: int) -> Tuple[int, int]:
    """The engine's model size, padded to multiples of ``pad``."""
    oh, ow = model_size(tuple(frame_hw), size, max_size)
    return -(-oh // pad) * pad, -(-ow // pad) * pad
