"""The port's ``InferenceEngine.run_video`` and ``run_video_batch`` with
context frames (``f_extra``), whole-video windows and ``t_bucket``, against
the JAX engine on the CPU: the tiny flagship-shaped model on shared seeded
weights, engines at size 64 / max_size 96 with windows of 3, frames
downscaled (96x144 -> 64x96: cv2 on the host in the JAX engine,
``F.interpolate`` on the device in the port) and upscaled (48x72 -> 64x96).
Every output at 2e-3 (rtol and atol), the model-level bar of the JAX
package's parity with the reference. The protocols over these paths are
in ``tests/test_torch_protocols.py``."""

import numpy as np
import pytest

from tce_rvos_tpu_torch.infer import OUTPUT_KEYS
from torch_parity_helpers import torch_threads  # noqa: F401 (autouse fixture)
from torch_parity_helpers import SLICE_TOL, assert_close, engine_pair

TOL = dict(rtol=SLICE_TOL, atol=SLICE_TOL)
CAPS = ["the red ball", "a running dog"]


@pytest.fixture(scope="module")
def engines():
    return engine_pair(size=64, max_size=96, window=3, t_bucket=5)


def _frames(hw, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(hw[0], hw[1], 3).astype(np.float32) for _ in range(n)]


def _assert_outputs_close(got, want, n_frames):
    assert got["model_size"] == want["model_size"]
    assert got["pred_masks"].shape[0] == n_frames
    for k in OUTPUT_KEYS:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], name=k, **TOL)


@pytest.mark.parametrize("hw", [(96, 144), (48, 72)], ids=["downscale", "upscale"])
def test_run_video_batch_f_extra_and_whole_video_match_jax(engines, hw):
    """E = 2: 5 frames in windows of 3 with a context frame on each side
    (clamped at the ends, the last window padded), and 4 frames as one
    whole-video window rounded up to 5 by a t_bucket of 5 (clips of 5
    frames either way, so that the JAX engine compiles one program of
    each half)."""
    frames = _frames(hw, 5, seed=4)
    for kw, n in ((dict(f_extra=1), 5), (dict(whole_video=True), 4)):
        want = engines[0].run_video_batch(frames[:n], CAPS, **kw)
        got = engines[1].run_video_batch(frames[:n], CAPS, **kw)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_outputs_close(g, w, n)


def test_run_video_f_extra_and_whole_video_match_jax(engines):
    """The serial path on the same two kinds of window, downscaled."""
    frames = _frames((96, 144), 5, seed=5)
    for kw, n in ((dict(f_extra=1), 5), (dict(whole_video=True), 4)):
        want = engines[0].run_video(frames[:n], CAPS[0], **kw)
        got = engines[1].run_video(frames[:n], CAPS[0], **kw)
        _assert_outputs_close(got, want, n)


def test_windows_index_the_jax_way(engines):
    """Context frames clamp at the video's ends, the last clip repeats its
    last frame; a whole video rounds up to a multiple of t_bucket."""
    port = engines[1]
    assert list(port.windows(7, f_extra=1)) == [
        ([0, 0, 1, 2, 3], 3), ([2, 3, 4, 5, 6], 3), ([5, 6, 6, 6, 6], 1)]
    assert list(port.windows(7, whole_video=True)) == [([0, 1, 2, 3, 4, 5, 6, 6, 6, 6], 7)]
    assert list(port.windows(3, f_extra=2, whole_video=True)) == [
        ([0, 0, 0, 1, 2, 2, 2, 2, 2], 3)]
    assert port.window_length(11, whole_video=True) == 15
