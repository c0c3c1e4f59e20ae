"""Parameter and training-state checkpoints (PyTorch port of
``tcgnn_tpu.utils.checkpoint``).

* ``save`` / ``restore``: a model's parameters (the trainer's
  ``--save_params`` / ``--load_params``), one ``torch.save`` file.
* ``save_state`` / ``restore_state``: the training state behind
  ``--checkpoint_dir`` / ``--checkpoint_every`` / ``--resume``: the
  parameters, the optimizer's state (Adam's moments and step counts), the
  epoch and the dropout generator's state, which takes the place of the JAX
  package's PRNG key (without it a resumed run would draw other dropout
  masks).  Each snapshot ``state_<epoch:08d>.pt`` is written to a temporary
  file and renamed into place, then ``LATEST`` is moved to it the same way,
  so a crash mid-write leaves the previous snapshot resumable; only the
  newest ``keep`` are kept.

Files are read with ``torch.load(weights_only=True)``: tensors, numbers and
strings only.  A shape or dtype that differs from the model's raises
``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

LATEST = "LATEST"


def _write(obj, path: str) -> None:
    """``torch.save`` to a temporary file beside ``path``, renamed into place."""
    tmp = os.path.join(os.path.dirname(path) or ".", ".tmp_" + os.path.basename(path))
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _check(params: dict, net: torch.nn.Module) -> None:
    """Raise unless ``params`` has the keys, shapes and dtypes of ``net``'s
    state."""
    want = net.state_dict()
    if set(params) != set(want):
        raise ValueError(f"checkpoint parameters {sorted(params)} vs {sorted(want)}")
    for key, w in want.items():
        got = params[key]
        if tuple(got.shape) != tuple(w.shape):
            raise ValueError(f"checkpoint shape mismatch: {tuple(got.shape)} vs "
                             f"{tuple(w.shape)} ({key})")
        if got.dtype != w.dtype:
            raise ValueError(f"checkpoint dtype mismatch: {got.dtype} vs {w.dtype} ({key})")


def save(path: str, net: torch.nn.Module, step: int = 0) -> str:
    """Save ``net``'s parameters; ``.pt`` is appended to ``path`` unless it
    ends so.  Returns the written path."""
    path = path if path.endswith(".pt") else path + ".pt"
    params = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    _write({"step": int(step), "params": params}, path)
    return path


def restore(path: str, net: torch.nn.Module) -> torch.nn.Module:
    """Load the parameters saved at ``path`` (or ``path + ".pt"``) into
    ``net``, in place, and return it."""
    if not os.path.exists(path) and os.path.exists(path + ".pt"):
        path = path + ".pt"
    params = torch.load(path, map_location="cpu", weights_only=True)["params"]
    _check(params, net)
    net.load_state_dict(params)
    return net


def save_state(ckpt_dir: str, net: torch.nn.Module, optimizer: torch.optim.Optimizer,
               epoch: int, generator: Optional[torch.Generator] = None,
               keep: Optional[int] = 3) -> str:
    """Write the training state at ``epoch`` to ``ckpt_dir``, move
    ``LATEST`` to it and keep the newest ``keep`` snapshots (all with
    None).  Returns the snapshot's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"state_{epoch:08d}.pt")
    _write({
        "epoch": int(epoch),
        "params": {k: v.detach().cpu() for k, v in net.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "generator": None if generator is None else generator.get_state(),
    }, path)
    latest_tmp = os.path.join(ckpt_dir, LATEST + ".tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(path))
    os.replace(latest_tmp, os.path.join(ckpt_dir, LATEST))
    if keep is not None:
        snaps = sorted(f for f in os.listdir(ckpt_dir)
                       if f.startswith("state_") and f.endswith(".pt"))
        for old in snaps[:-keep]:
            os.remove(os.path.join(ckpt_dir, old))
    return path


def restore_state(ckpt_dir: str, net: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  generator: Optional[torch.Generator] = None):
    """Load the newest training state into ``net``, ``optimizer`` and
    ``generator``, in place.

    Returns ``(epoch, generator)``, the generator None where none was given
    or the snapshot holds no generator state, or None when ``ckpt_dir``
    holds no checkpoint."""
    latest = os.path.join(ckpt_dir, LATEST)
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        path = os.path.join(ckpt_dir, f.read().strip())
    state = torch.load(path, map_location="cpu", weights_only=True)
    _check(state["params"], net)
    net.load_state_dict(state["params"])
    optimizer.load_state_dict(state["optimizer"])
    restored = None
    if generator is not None and state["generator"] is not None:
        generator.set_state(state["generator"])
        restored = generator
    return state["epoch"], restored
