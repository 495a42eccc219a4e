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
come back on ``device`` (default: the device of the ``like`` leaf).

On a mesh of data ranks (``mesh=`` and ``specs=``, a tree of ZeRO specs
beside the saved one, e.g. ``{"opt": mesh_opt_specs(...)}``; a leaf with
no spec is replicated), ``save`` gathers every sharded leaf whole, one at
a time, in rank order, rank 0 copies it to the host and writes the whole
arrays, the reference's layout, and
every rank waits for the write (``wait()``: the writer joined, then a
barrier). ``restore`` reads the same files on any number of data ranks
(the one-device trainer included) and keeps this rank's shard of each
sharded leaf, reading only that shard's part of the file: the elastic
restore. On a mesh with a "model" dimension a model sharded over it
(``models.tensor_parallel.shard_model``) brings its own parameter specs
(``model.tp.specs``, under the tree's key that holds the model), the
ZeRO specs are the whole tensors' (``mesh_opt_specs``), and ``save``
gathers each leaf over the data ranks, then over the model ranks: the
files hold whole leaves, so a checkpoint of (data 2, model 4) restores
on one device and back again.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import zipfile
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


def _spec_parts(specs: Any, cfg) -> Dict[str, List[Any]]:
    """{leaf path: the spec of each part} of a spec tree laid out as the
    saved tree (a dict keyed by parameter names is laid out as the model)."""
    return dict(tree_flatten_with_paths(specs, cfg=cfg)) if specs else {}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._axis = None  # the data ranks of the last save on a mesh
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, async_: bool = False,
             extra: Optional[dict] = None, mesh=None, specs: Any = None) -> None:
        self.wait()
        if mesh is not None:
            from repro_torch.launch.mesh import data_axis, model_axis

            axis = data_axis(mesh)
            tp = model_axis(mesh) if "model" in (mesh.mesh_dim_names or ()) else None
            sp = _spec_parts(_with_model_specs(tree, specs), find_config(tree))
            host = []
            for name, parts in tree_flatten_with_paths(tree):
                whole = [_gather(part.detach(), spec, axis, tp)
                         if isinstance(part, torch.Tensor) else part
                         for part, spec in zip(parts, sp.get(name, [None] * len(parts)),
                                               strict=True)]
                if axis.index == 0 and (tp is None or tp.index == 0):
                    host.append((name, *_to_host(whole)))
                del whole
            self._axis = axis if tp is None else (axis, tp)
            if axis.index != 0 or (tp is not None and tp.index != 0):
                if not async_:
                    self.wait()
                return
        else:
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

        if async_:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            if mesh is not None:
                self.wait()

    def wait(self) -> None:
        """Join the writer; after a save on a mesh, every rank then waits
        for every other (the write is on disk for all of them)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._axis is not None:
            axes, self._axis = self._axis, None
            for axis in (axes if isinstance(axes, tuple) else (axes,)):
                axis.barrier()

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

    def restore(self, step: int, like: Any, *, device=None, mesh=None,
                specs: Any = None) -> Any:
        """Step ``step`` in the structure of ``like`` (see the module
        docstring); with ``mesh`` and ``specs`` this rank's shard of each
        sharded leaf."""
        from repro_torch.train.optimizer import local_shard, mesh_coords

        path = os.path.join(self.dir, f"step_{step:08d}")
        data = _npz_arrays(os.path.join(path, "arrays.npz"))
        with open(os.path.join(path, "manifest.json")) as f:
            dtypes = {l["path"]: l["dtype"] for l in json.load(f)["leaves"]}
        cfg = find_config(like)
        sp = _spec_parts(_with_model_specs(like, specs), cfg) if mesh is not None else {}
        coords = mesh_coords(mesh) if mesh is not None else {}
        restored: Dict[str, List[Any]] = {}
        for name, parts in tree_flatten_with_paths(like, cfg=cfg):
            a = data[name]
            pieces = [a] if len(parts) == 1 else list(a)
            if len(pieces) != len(parts):
                raise ValueError(f"{name}: {len(pieces)} stacked entries, "
                                 f"the model has {len(parts)}")
            specs_here = sp.get(name, [None] * len(parts))
            restored[name] = [
                _from_host(arr if spec is None else local_shard(arr, spec, coords),
                           dtypes[name], part, device)
                for part, arr, spec in zip(parts, pieces, specs_here, strict=True)]
        return _rebuild(like, "", cfg, restored)


def _with_model_specs(tree: Any, specs: Any) -> Any:
    """``specs`` with the parameter specs of each model sharded over
    "model" that ``tree`` holds at its top level, under the same key."""
    if not isinstance(tree, Mapping):
        return specs
    out = dict(specs or {})
    for k, v in tree.items():
        tp = getattr(v, "tp", None) if is_model(v) else None
        if tp is not None and k not in out:
            out[k] = tp.specs
    return out


def _gather(t: torch.Tensor, spec, axis, tp) -> torch.Tensor:
    """The whole leaf on every rank: the rank's piece gathered over the
    data ranks (``axis``), then over the model ranks (``tp``)."""
    from repro_torch.train.optimizer import DATA_AXES, gather_whole, restrict

    if spec is None:
        return t
    t = gather_whole(t, restrict(spec, DATA_AXES), axis)
    return t if tp is None else gather_whole(t, restrict(spec, ("model",)), tp)


def _npz_arrays(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an ``.npz``, each mapped from the file where it is
    stored uncompressed (``np.savez`` stores so): a rank that keeps one
    shard of a leaf reads that shard's pages only. A compressed entry is
    read whole."""
    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with zf.open(info) as member:
                    out[name] = np.lib.format.read_array(member)
                continue
            # the local header: 30 bytes, then the name and the extra field
            f.seek(info.header_offset)
            head = f.read(30)
            start = info.header_offset + 30 + int.from_bytes(head[26:28], "little") \
                + int.from_bytes(head[28:30], "little")
            f.seek(start)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                                     if version == (1, 0)
                                     else np.lib.format.read_array_header_2_0(f))
            if dtype.hasobject or math.prod(shape) * dtype.itemsize < (1 << 20):
                f.seek(start)
                out[name] = np.lib.format.read_array(f)
                continue
            out[name] = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(),
                                  shape=shape, order="F" if fortran else "C")
    return out


def _from_host(a: np.ndarray, dtype: str, like: Any, device) -> Any:
    if not isinstance(like, torch.Tensor):
        return np.array(a)
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
