"""Checkpoints — the port of ``repro.train.checkpoint``, with the
reference's on-disk layout:

    <dir>/step_<n>/
        manifest.json     step, every leaf's path, shape and dtype, extra
        arrays.npz        one entry per leaf, keyed by its path (bf16
                          leaves as raw 2-byte words, as numpy holds the
                          reference's bfloat16)

Leaves are named by the reference's paths (``utils.tree``): a port model
is saved as the reference's stacked parameter tree, so the arrays of one
package's checkpoint load into the other's. The manifest has no treedef
(a jax object); its path list stands in for it. A step is written to
``step_<n>.tmp`` and renamed into place; ``keep`` bounds the steps kept.
``save`` copies every leaf to the host before it returns, so with
``async_=True`` only the write runs on a background thread; ``wait()``
joins it (one writer at a time). ``restore`` reads a step into the
structure of ``like``: a model's parameters are loaded in place, tensors
come back on ``device`` (default: the device of the ``like`` leaf). Mesh
placement waits for the mesh (ROADMAP.md, Queue 1, item 7b).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import (
    find_config,
    is_model,
    is_param_dict,
    join_path,
    param_layout,
    tree_flatten_with_paths,
)


#: bf16 leaves are stored as the reference stores them: their raw 2-byte
#: words in a ``|V2`` array, "bfloat16" in the manifest
_BF16 = "bfloat16"
_BF16_HOST = np.dtype("V2")


def _to_host(parts: List[Any]) -> Tuple[np.ndarray, str]:
    """The leaf's parts stacked on the host, and its dtype's name."""
    arrays = []
    for p in parts:
        if isinstance(p, torch.Tensor):
            # a copy even of a CPU tensor: training goes on mutating it in place
            t = p.detach().to("cpu", copy=True)
            arrays.append(t.view(torch.int16).numpy().view(_BF16_HOST)
                          if t.dtype == torch.bfloat16 else t.numpy())
        else:
            arrays.append(np.array(p))
    a = arrays[0] if len(arrays) == 1 else np.stack(arrays)
    return a, _BF16 if a.dtype == _BF16_HOST else str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, async_: bool = False,
             extra: Optional[dict] = None) -> None:
        host = [(name, *_to_host(parts))
                for name, parts in tree_flatten_with_paths(tree)]
        manifest = {
            "step": step,
            "leaves": [{"path": n, "shape": list(a.shape), "dtype": dt}
                       for n, a, dt in host],
            "extra": extra or {},
        }

        def _write():
            path = os.path.join(self.dir, f"step_{step:08d}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **{n: a for n, a, _ in host})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
            self._gc()

        self.wait()
        if async_:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, device=None) -> Any:
        """Step ``step`` in the structure of ``like`` (see the module
        docstring)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            data = {k: z[k] for k in z.files}
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = {l["path"]: l["dtype"] for l in json.load(f)["leaves"]}
        cfg = find_config(like)
        restored: Dict[str, List[Any]] = {}
        for name, parts in tree_flatten_with_paths(like, cfg=cfg):
            a = data[name]
            pieces = [a] if len(parts) == 1 else list(a)
            if len(pieces) != len(parts):
                raise ValueError(f"{name}: {len(pieces)} stacked entries, "
                                 f"the model has {len(parts)}")
            restored[name] = [_from_host(arr, dtypes[name], part, device)
                              for part, arr in zip(parts, pieces, strict=True)]
        return _rebuild(like, "", cfg, restored)


def _from_host(a: np.ndarray, dtype: str, like: Any, device) -> Any:
    if not isinstance(like, torch.Tensor):
        return a
    if dtype == _BF16:
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a contiguous copy; keeps a 0-d shape
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"restored shape {tuple(t.shape)}, want {tuple(like.shape)}")
    return t.to(like.device if device is None else device)


def _rebuild(node: Any, prefix: str, cfg, restored: Dict[str, List[Any]]) -> Any:
    """``node`` with every leaf replaced by its restored value; a model's
    parameters are loaded in place."""
    if node is None:
        return None
    if is_model(node) or (is_param_dict(node) and cfg is not None):
        named = dict(node.named_parameters()) if is_model(node) else dict(node)
        out = {}
        for path, names in param_layout(cfg, list(named)):
            for n, value in zip(names, restored[join_path(prefix, path)], strict=True):
                out[n] = value
        if not is_model(node):
            return out
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(out[n])
        return node
    if isinstance(node, Mapping):
        return {k: _rebuild(v, join_path(prefix, k), cfg, restored) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, join_path(prefix, i), cfg, restored)
                          for i, v in enumerate(node))
    return restored[prefix][0]
