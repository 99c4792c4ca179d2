"""Checkpoint save and restore keyed by (stage, cascade, epoch[, step]).

The counterpart of the JAX package's ``utils/checkpoint.py``.  The
reference saves whole torch modules per epoch under
``{name}{cascadeLevel}_{epoch}.pth`` and resumes with an LR rescale
(trainBRDF.py:90-103, 392-396).  Here a checkpoint is a directory with
the JAX package's name, ``{exp_dir}/{stage}{cascade}_{epoch}`` (per-step:
``{stage}{cascade}_step_{epoch}_{j}``), holding ``state.pt``: a
``torch.save`` of a dict, by convention the trained nets' ``state_dict``
(``"nets"``), the optimizer's and the scheduler's (``"optimizer"``,
``"scheduler"``), and the epoch and step.  :func:`train_state` and
:func:`load_train_state` make and apply that dict.

A save writes a temp file in the directory and renames it over
``state.pt``, so a kill during a save leaves the previous checkpoint
readable, and the listings count a directory only once its ``state.pt``
exists.  The port does not read orbax checkpoints: weights cross from
the JAX package through ``utils/weights.py``.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil

import numpy as np
import torch

STATE_FILE = "state.pt"


def _ckpt_dir(exp_dir: str, stage: str, cascade: int, epoch: int) -> str:
    return osp.abspath(osp.join(exp_dir, f"{stage}{cascade}_{epoch}"))


def _step_dir(exp_dir, stage, cascade, epoch, j) -> str:
    return osp.abspath(
        osp.join(exp_dir, f"{stage}{cascade}_step_{epoch}_{j}"))


def _save(path: str, state: dict) -> str:
    os.makedirs(path, exist_ok=True)
    tmp = osp.join(path, f"{STATE_FILE}.tmp.{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, osp.join(path, STATE_FILE))
    return path


def _load(path: str, map_location) -> dict:
    return torch.load(osp.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def train_state(nets, optimizer, scheduler=None) -> dict:
    """The state a train step resumes from: the trained nets', the
    optimizer's and the scheduler's ``state_dict`` (None without one)."""
    return {"nets": nets.state_dict(), "optimizer": optimizer.state_dict(),
            "scheduler": None if scheduler is None
            else scheduler.state_dict()}


def load_train_state(state: dict, nets, optimizer=None,
                     scheduler=None) -> None:
    """Put ``state`` (:func:`train_state`) back into the nets and, where
    given, the optimizer and the scheduler (the LR schedule's position
    with it)."""
    nets.load_state_dict(state["nets"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None and state["scheduler"] is not None:
        scheduler.load_state_dict(state["scheduler"])


def save_checkpoint(exp_dir, stage, cascade, epoch, state: dict) -> str:
    """Save ``state`` as the epoch-``epoch`` checkpoint; returns its
    directory."""
    return _save(_ckpt_dir(exp_dir, stage, cascade, epoch),
                 {**state, "epoch": int(epoch)})


def restore_checkpoint(exp_dir, stage, cascade, epoch,
                       map_location=None) -> dict:
    """The state saved at ``epoch``, its tensors on ``map_location``."""
    return _load(_ckpt_dir(exp_dir, stage, cascade, epoch), map_location)


def _listed(exp_dir, prefix):
    """Names after ``prefix`` of the complete checkpoints in
    ``exp_dir``."""
    if not osp.isdir(exp_dir):
        return []
    return [name[len(prefix):] for name in os.listdir(exp_dir)
            if name.startswith(prefix)
            and osp.isfile(osp.join(exp_dir, name, STATE_FILE))]


def latest_epoch(exp_dir, stage, cascade):
    """Largest epoch with a saved checkpoint, or None."""
    epochs = []
    for rest in _listed(exp_dir, f"{stage}{cascade}_"):
        try:
            epochs.append(int(rest))
        except ValueError:  # a step checkpoint
            continue
    return max(epochs, default=None)


def lr_scale_for_epoch(epoch: int) -> float:
    """The reference's LR halving every 10 epochs (trainBRDF.py:90-103)."""
    return 1.0 / (2.0 ** int(np.floor((epoch + 1) / 10.0)))


# Per-step checkpoints.  The reference saves once an epoch, so a killed
# run loses up to an epoch of work.  A step checkpoint holds the state,
# the epoch and the step in the epoch; ``--resume auto`` in the train CLIs
# restores the most recent of the epoch and step checkpoints, the LR
# schedule with the scheduler's state and the data position by skipping
# the batches already taken (the loaders' augmentation streams are keyed
# by (seed, epoch, item), so the rest of the stream is the same).


def list_step_checkpoints(exp_dir, stage, cascade):
    """Sorted [(epoch, step_in_epoch)] of the step checkpoints on disk."""
    out = []
    for rest in _listed(exp_dir, f"{stage}{cascade}_step_"):
        parts = rest.split("_")
        if len(parts) != 2:
            continue
        try:
            out.append((int(parts[0]), int(parts[1])))
        except ValueError:
            continue
    return sorted(out)


def save_step_checkpoint(exp_dir, stage, cascade, state, epoch, j, keep=2):
    """Save ``state`` after step ``j`` of ``epoch`` and remove all but the
    newest ``keep`` step checkpoints (``keep=0`` keeps none)."""
    path = _save(_step_dir(exp_dir, stage, cascade, epoch, j),
                 {**state, "epoch": int(epoch), "j": int(j)})
    entries = list_step_checkpoints(exp_dir, stage, cascade)
    for e, jj in entries[:-keep] if keep else entries:
        shutil.rmtree(_step_dir(exp_dir, stage, cascade, e, jj),
                      ignore_errors=True)
    return path


def restore_step_checkpoint(exp_dir, stage, cascade, epoch, j,
                            map_location=None):
    """-> (state, epoch, step_in_epoch) of a step checkpoint."""
    state = _load(_step_dir(exp_dir, stage, cascade, epoch, j), map_location)
    return state, int(state["epoch"]), int(state["j"])
