"""Checkpoints of training (counterpart of
``tce_rvos_tpu/utils/native_ckpt.py``), in place of the reference's
torch.save of {'model', 'optimizer', 'lr_scheduler', 'epoch', 'args'}
(main.py:262-275).

A checkpoint is a directory of ``model.pt`` (the model's state_dict),
``optimizer.pt`` (``optimizer.state_dict()``, absent when not saved) and
``meta.json`` (epoch, step), each written under a temporary name and
renamed, ``meta.json`` last, by rank 0 only. ``CheckpointManager`` keeps
such directories per step with retention, the contract of the JAX
package's ``OrbaxCheckpointManager``. ``load_any_checkpoint`` also reads a
reference-format ``.pth`` file or URL, which carries no optimizer state.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from tce_rvos_tpu_torch.utils.checkpoint import convert_state_dict, load_torch_file
from tce_rvos_tpu_torch.utils.device import process_rank

MODEL_FILE, OPTIMIZER_FILE, META_FILE = "model.pt", "optimizer.pt", "meta.json"
Restored = Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]], Dict[str, Any]]


def _replace_into(path: str, name: str, write) -> None:
    tmp = os.path.join(path, name + ".tmp")
    write(tmp)
    os.replace(tmp, os.path.join(path, name))


def save_checkpoint(
    path: str,
    state_dict: Mapping[str, torch.Tensor],
    optimizer_state: Optional[Dict[str, Any]] = None,
    epoch: int = 0,
    step: int = 0,
    extra: Optional[Dict] = None,
) -> None:
    """Write the checkpoint directory ``path`` (rank 0 only). A stale
    ``optimizer.pt`` is removed when ``optimizer_state`` is None."""
    if process_rank() != 0:
        return
    os.makedirs(path, exist_ok=True)
    _replace_into(path, MODEL_FILE, lambda f: torch.save(dict(state_dict), f))
    if optimizer_state is not None:
        _replace_into(path, OPTIMIZER_FILE, lambda f: torch.save(optimizer_state, f))
    elif os.path.exists(os.path.join(path, OPTIMIZER_FILE)):
        os.remove(os.path.join(path, OPTIMIZER_FILE))
    meta = {"epoch": epoch, "step": step, **(extra or {})}

    def write_meta(f):
        with open(f, "w") as fh:
            json.dump(meta, fh)

    _replace_into(path, META_FILE, write_meta)


def load_checkpoint(path: str) -> Restored:
    """(state_dict, optimizer state or None, meta) of a checkpoint
    directory, on the CPU."""
    sd = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu", weights_only=True)
    opt_path = os.path.join(path, OPTIMIZER_FILE)
    opt = (torch.load(opt_path, map_location="cpu", weights_only=True)
           if os.path.exists(opt_path) else None)
    meta: Dict[str, Any] = {}
    if os.path.exists(os.path.join(path, META_FILE)):
        with open(os.path.join(path, META_FILE)) as fh:
            meta = json.load(fh)
    return sd, opt, meta


def load_any_checkpoint(path: str, reference: Mapping[str, torch.Tensor],
                        strict: bool = False) -> Restored:
    """Resume from either format: a checkpoint directory (its keys must be
    ``reference``'s), or a reference-format torch ``.pth`` file or
    ``http(s)://`` URL, laid over ``reference`` (a fresh model's
    state_dict; ``strict`` refuses missing and unexpected keys), whose
    optimizer state is None and whose meta holds the epoch it records. A
    directory of the JAX package's format is refused."""
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, MODEL_FILE)):
            if os.path.exists(os.path.join(path, "variables.msgpack")):
                raise ValueError(
                    f"{path} holds a JAX-package checkpoint (variables.msgpack, flax "
                    "serialization); the port reads model.pt directories or torch .pth "
                    "state_dicts (export with tce_rvos_tpu.utils.checkpoint.export_state_dict)")
            raise FileNotFoundError(f"{path} holds no {MODEL_FILE}")
        sd, opt, meta = load_checkpoint(path)
        sd, _, _ = convert_state_dict(sd, reference, strict=True, verbose=False)
        return sd, opt, meta
    sd, meta = load_torch_file(path, with_meta=True)
    sd, _, _ = convert_state_dict(sd, reference, strict=strict)
    return sd, None, meta


class CheckpointManager:
    """Checkpoint directories per step under ``directory`` (``<step>/``),
    the newest ``max_to_keep`` retained: the contract of the JAX package's
    ``OrbaxCheckpointManager`` (``save``, ``restore`` of the latest or a
    given step, ``wait``, ``close``). A step counts once its ``meta.json``
    is written. Saves are synchronous, so ``wait`` returns at once."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, META_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state_dict, optimizer_state=None, meta: Optional[Dict] = None):
        meta = dict(meta or {})
        save_checkpoint(os.path.join(self.directory, str(step)), state_dict, optimizer_state,
                        epoch=meta.pop("epoch", 0), step=meta.pop("step", step), extra=meta)
        if process_rank() == 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None) -> Restored:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_checkpoint(os.path.join(self.directory, str(step)))

    def wait(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing is held open."""
