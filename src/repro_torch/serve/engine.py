"""Batched LM serving engine — the port of ``repro.serve.engine``.

Prefill → decode with greedy or temperature sampling, EOS tracking and
optional IHTC KV-cache compression: the caches are compressed right after
prefill and again whenever the uncompressed tail fills, so steady-state
memory is O(S / t^m + tail) per sequence.

As in the reference, the decode loop keeps a host-side mirror of the
cache write position (it never reads the device to know where it is), and
after a compress the rope positions restart at ``pos = P``, the number of
prototypes, since the decode position is the cache's ``pos``.

Each result carries host-clock timings of its phases; the clock is read
after a device synchronise at each phase boundary (a handful per call).

On a mesh (``plan=``, the cell's ``launch.mesh.make_plan``, and ``mesh=``,
default the runtime's), as the reference's ``ServeEngine(..., plan=)``:
each data rank serves its rows of the batch (``plan.resid``'s batch axes;
every row where the batch does not divide); the caches follow
``plan.cache`` (``models.tensor_parallel.cache_layout``): a model sharded
over "model" (``models.tensor_parallel.shard_model``) holds each rank's kv
heads where they divide the ranks and compresses them unchanged (every
(row, head) set draws with its layer's key, so a head's prototypes do not
depend on the rank that holds it), else each rank's slice of the slots
(the sequence over "model"; at batch 1 over the data dimensions too),
whose compression gathers each layer whole, compresses it as one device
does and keeps the rank's slice (the boundaries move with P + tail at each
compression, never in the decode loop); the last position's logits are
gathered over the model ranks (an exact copy) before sampling, and the
tokens are gathered over the data ranks at the end.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models.registry import ModelBundle
from repro_torch.serve.kv_compression import (
    compress_model_caches,
    find_attention_caches,
)


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 ⇒ greedy
    eos_id: int = -1                # -1 ⇒ never stop early
    # IHTC cache compression
    compress: bool = False
    compress_t: int = 2
    compress_m: int = 1
    compress_tail: int = 128
    #: dispatch policy of attention and compression ("auto": the kernels on
    #: the card; "ref": the plain paths). None: the runtime config's.
    impl: Optional[str] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        # repro_torch: allow[HS201]: the timing boundaries of generate (prefill, compression, decode)
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, bundle: ModelBundle, model: torch.nn.Module,
                 scfg: Optional[ServeConfig] = None, plan=None, mesh=None):
        self.bundle = bundle
        self.model = model
        self.scfg = scfg if scfg is not None else ServeConfig()
        self.device = next(model.parameters()).device
        self.plan = plan
        self.tp = getattr(model, "tp", None)
        self.rows = None  # the data ranks' axis, where each serves its rows
        self.mesh = None
        if plan is not None:
            from repro_torch.launch.mesh import data_axis
            from repro_torch.runtime import active

            mesh = active().mesh if mesh is None else mesh
            self.mesh = mesh
            if mesh is not None and plan.resid is not None and plan.resid[0] is not None:
                self.rows = data_axis(mesh)
        if self.tp is not None:
            self.tp.check_plan(plan)

    def _sample(self, logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:  # the vocabulary gathered: an exact copy
            from repro_torch.models.tensor_parallel import gather_dim

            logits = gather_dim(logits[:, -1:], self.tp.axis, 2)
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        x = logits[:, -1] / self.scfg.temperature
        if self.rows is None:
            return prng.categorical(key, x).to(torch.int32)
        # the whole batch's draws, this rank's rows of them: prng.categorical
        batch, lo = self._rows_of
        noise = prng.gumbel(key, (batch, x.shape[-1]), device=x.device)
        return torch.argmax(noise[lo:lo + x.shape[0]].to(x.dtype) + x,
                            dim=-1).to(torch.int32)

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, object],
        *,
        max_len: Optional[int] = None,
        key: Optional[torch.Tensor] = None,
        **cache_kw,
    ) -> Dict[str, object]:
        """batch: the prompt inputs of the arch's family: ``{"tokens": (b,
        s) prompt ids}``, with ``"patch_embeds"`` (b, 256, d) for a VLM or
        ``"frames"`` (b, s_enc, d) for an enc-dec model (then pass
        ``enc_len=s_enc``, which goes to ``init_caches`` with the rest of
        ``cache_kw``). Returns ``{"tokens": (b, n_steps) int32, "n_steps",
        "compressions" (in-flight ones, after the first), "timings":
        {"prefill_s", "decode_s", "compress": [{"seconds", "slots_before",
        "slots_after"}, ...]}}``."""
        scfg, dev = self.scfg, self.device
        cfg = self.bundle.cfg
        if scfg.compress and cfg.family == "encdec-audio":
            # the reference's compress_model_caches cannot take an enc-dec
            # cache either (ROADMAP.md, Queue 3)
            raise ValueError(
                f"{cfg.name}: compress=True is not supported on an "
                f"encoder-decoder (its self-attention caches sit beside the "
                f"cross k/v; the reference cannot compress them either)")
        if key is None:
            key = prng.PRNGKey(0)
        # repro_torch: allow[HS201]: the caller's host batch, on its way to the card
        inputs = {name: (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
                         ).to(dev) for name, a in batch.items()}
        inputs["tokens"] = inputs["tokens"].to(torch.int64)
        if self.rows is not None:  # this data rank's rows
            batch = inputs["tokens"].shape[0]
            per = batch // self.rows.size
            lo = self.rows.index * per
            inputs = {n: a[lo:lo + per] for n, a in inputs.items()}
            self._rows_of = (batch, lo)
        prompt = inputs["tokens"]
        b, s = prompt.shape
        total = max_len or (s + scfg.max_new_tokens)
        compress_log: List[dict] = []

        _sync(dev)
        t0 = time.perf_counter()
        if self.tp is not None:
            cache_kw = dict(cache_kw, tp_size=self.tp.size)
        if self.plan is not None and self.mesh is not None:
            cache_kw = dict(cache_kw, plan=self.plan, mesh=self.mesh)
        caches = self.bundle.init_caches(b, total, device=dev, **cache_kw)
        if scfg.compress and next(find_attention_caches(caches), None) is None:
            raise ValueError(
                f"{cfg.name}: compress=True compresses attention "
                f"KV caches, and this model has none (every layer is Mamba)")
        logits, caches = self.bundle.prefill(self.model, caches, inputs,
                                             impl=scfg.impl, plan=self.plan)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        def compress(caches):
            before = self._cache_size(caches)
            _sync(dev)
            t1 = time.perf_counter()
            caches = compress_model_caches(caches, scfg.compress_t,
                                           scfg.compress_m,
                                           tail=scfg.compress_tail,
                                           impl=scfg.impl)
            _sync(dev)
            compress_log.append({"seconds": time.perf_counter() - t1,
                                 "slots_before": before,
                                 "slots_after": self._cache_size(caches)})
            return caches

        pos_host = -1
        if scfg.compress:
            caches = compress(caches)
            pos_host = self._cache_size(caches) - scfg.compress_tail
        t_loop = time.perf_counter()

        out: List[torch.Tensor] = []
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        n_compress = 0
        tok = self._sample(logits, key)
        for i in range(scfg.max_new_tokens):
            out.append(tok)
            if scfg.eos_id >= 0:
                done = done | (tok == scfg.eos_id)
                finished = done.all()
                if self.rows is not None:  # every data rank stops together
                    finished = self.rows.pmin(finished.to(torch.int32)[None])[0]
                # repro_torch: allow[HS202]: the one card read of the decode loop, the stop test (ROADMAP item 4)
                if bool(finished):  # the one device read of the loop
                    break
            key = prng.fold_in(key, i)
            logits, caches = self.bundle.decode_step(
                self.model, caches, {"tokens": tok[:, None].to(torch.int64)},
                impl=scfg.impl, plan=self.plan)
            tok = self._sample(logits, key)
            if scfg.compress:
                pos_host += 1  # decode appended one token per sequence
                if pos_host >= self._cache_size(caches):  # tail full
                    caches = compress(caches)
                    pos_host = self._cache_size(caches) - scfg.compress_tail
                    n_compress += 1
        _sync(dev)
        loop_s = time.perf_counter() - t_loop
        decode_s = loop_s - sum(c["seconds"] for c in compress_log[1:])
        tokens = torch.stack(out, dim=1)
        if self.rows is not None:
            tokens = self.rows.gather_rows(tokens)
        return {
            "tokens": tokens,
            "n_steps": len(out),
            "compressions": n_compress,
            "timings": {"prefill_s": prefill_s, "decode_s": decode_s,
                        "compress": compress_log},
        }

    @staticmethod
    def _cache_size(caches) -> int:
        """Sequence capacity of the first attention cache (Mamba layers
        skipped; an enc-dec model's first self-attention cache; a cache
        split along the sequence: its logical ``"slots"``): shape metadata,
        no device read."""
        c = next(find_attention_caches(caches))
        return int(c.get("slots", c["k"].shape[2]))
