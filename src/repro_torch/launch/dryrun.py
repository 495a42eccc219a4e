"""Multi-pod dry run — the port of ``repro.launch.dryrun``: one rank's step
of every (arch × shape × mesh) cell, traced on the "meta" device, and its
roofline terms against the H100's data-sheet peaks.

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's cost and memory analyses. The port has no compiler to
ask: it builds one rank's model, optimizer state, batch and caches on
"meta" (shapes and dtypes, no data, no device) at the production mesh's
slices (``launch.mesh.TracedMesh``: rank 0 of each dimension, its
collectives recorded by ``core._collectives.RecordingAxis``) and runs the
port's own step under a dispatch mode that counts what every aten op
would do (:class:`StepTrace`):

  * FLOPs of the products (mm, bmm, addmm, baddbmm, einsum's products,
    convolution; ``torch.utils.flop_counter``'s formulas) by operand
    dtype. Elementwise FLOPs are not counted (XLA counts them);
  * bytes accessed: each op's inputs plus its outputs (views, and
    allocations that write nothing, move none). The eager port runs
    unfused, so this is its real traffic;
  * peak live bytes: the storages live at once, the step's inputs
    included;
  * the kernels' own work: on a meta tensor a kernel wrapper (K1–K5)
    returns its outputs' shapes and reports its FLOPs and bytes
    (``kernels/meta.py``) instead of running its plain version;
  * collectives: every call of the model and data axes
    (``_collectives.op_records``), read by ``utils/hlo.py``'s ring model.

A train cell is forward, backward and AdamW on the rank's ZeRO-1 shard
(``make_train_step(mesh=)``, remat "block", 8 microbatches as the
reference's policy); a prefill cell is the prompt into an empty cache, a
decode cell one step against a full one. The port traces every layer, so
the count is direct: the reference's two-point extrapolation (XLA counts
a scanned layer once) has no counterpart.

The model axis runs the dense, VLM, MoE (expert parallel: the experts'
outputs gathered along E, recorded as ``gather_rows``), SSM and hybrid
families (Mamba by heads: the gated norm's (b, s, 1) partial sums added
over the ranks, recorded as ``gather_rows`` too); the encoder-decoder on
a model axis larger than one waits for ROADMAP.md, Queue 1, item 7d, and
its cells report ``status: "waits"`` with that message. Where the query
heads, the experts or the SSD heads do not divide the model ranks
(gemma2-2b's 8 heads over 16), the port runs that module replicated, and
the dry run reckons what the port runs.

Usage (any machine: it traces on "meta", as the reference's runs on host
devices):
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k --mesh pod1
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
  python -m repro_torch.launch.dryrun --arch granite-20b --shape long_500k \\
      --variant ihtc-kv   # paper-technique-compressed long context
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core import _collectives
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch.mesh import (
    PRODUCTION_MESHES,
    MeshShape,
    batch_specs,
    make_plan,
    traced_mesh,
)
from repro_torch.models import encdec, tensor_parallel, transformer
from repro_torch.models.frontends import VISION_PREFIX_TOKENS
from repro_torch.models.registry import build
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step, mesh_opt_specs
from repro_torch.utils import hlo as hlo_utils
from repro_torch.utils.roofline import build_report, link_for, model_flops_for

META = torch.device("meta")

# long_500k baseline needs sub-quadratic sequence mixing: only ssm/hybrid
# qualify. Dense/MoE/enc-dec archs run it only under the --variant ihtc-kv
# paper-technique compression.
LONG_OK_FAMILIES = ("ssm", "hybrid")

#: ops that allocate without writing: no bytes accessed
_ALLOCS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"})
#: in-place ops whose first argument is written, not read
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_"})


def cell_is_baseline_runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False
    return True


def _active_params(cfg: ModelConfig, model: torch.nn.Module) -> int:
    """Parameters a token's products touch: the whole model (built on
    "meta", unsharded) less an untied embedding table (a gather, not
    products) and the experts a token is not routed to."""
    total = sum(p.numel() for p in model.parameters())
    if not cfg.tie_embeddings:
        total -= cfg.vocab_size * cfg.d_model
    if cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
        total -= n_moe * (cfg.n_experts - cfg.n_experts_per_tok) * per_expert
    return int(total)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` an op reads: its elements, at most its storage (an
    expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class StepTrace(TorchDispatchMode):
    """Counts, while active, the products' FLOPs by operand dtype, the
    bytes every op reads and writes, the peak of live storage bytes (from
    the tensors passed to ``live`` on), and the kernel wrappers' own
    reckoning (``kernels.meta.reckoning``)."""

    def __init__(self, live: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, dict] = {}
        self._live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        for t in live:
            self._hold(t)
        self.start_bytes = self.current

    # ---- live storages
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.current -= self._live.pop(key, 0)

    # ---- counting
    def _flops(self, dtype: torch.dtype, n: float) -> None:
        name = _dtype_name(dtype)
        self.flops_by_dtype[name] = self.flops_by_dtype.get(name, 0.0) + float(n)

    def kernel(self, kernel: str, route: str, flops: Dict[str, float],
               nbytes: float) -> None:
        rec = self.kernels.setdefault(f"{kernel}/{route}",
                                      {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += sum(flops.values())
        rec["bytes"] += nbytes
        for t, n in flops.items():
            self.flops_by_dtype[t] = self.flops_by_dtype.get(t, 0.0) + n
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func.overloadpacket
        if packet in flop_registry and ins:
            self._flops(ins[0].dtype, flop_registry[packet](*args, **kwargs,
                                                            out_val=out))
        name = packet.__name__
        if name not in _ALLOCS:
            mutable = func._schema.is_mutable
            in_st = {t.untyped_storage()._cdata for t in ins}
            aliases = outs and all(t.untyped_storage()._cdata in in_st for t in outs)
            if mutable or not aliases:
                read = ins[1:] if name in _WRITE_ONLY else ins
                self.bytes += sum(_read_bytes(t) for t in read)
                self.bytes += sum(t.numel() * t.element_size() for t in outs)
        for t in outs:
            self._hold(t)
        return out

    def __enter__(self):
        self._reckoning = kernel_meta.reckoning(self.kernel)
        self._reckoning.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._reckoning.__exit__(*exc)

    def summary(self) -> dict:
        return {"flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
                "flops": sum(self.flops_by_dtype.values()), "bytes": self.bytes,
                "peak_bytes": self.peak, "start_bytes": self.start_bytes,
                "ops": self.ops, "kernels": dict(sorted(self.kernels.items()))}


# ------------------------------------------------------------------ inputs
def _local_batch(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Rows one rank takes: the global batch over the data axes where
    ``batch_specs`` splits it, else all of it."""
    b = shape.global_batch
    if mesh is None:
        return b
    spec = batch_specs(cfg, shape, mesh, kind=shape.kind)["tokens"]
    if spec[0] is None:
        return b
    names = (spec[0],) if isinstance(spec[0], str) else spec[0]
    dims = tuple(mesh.mesh_dim_names)
    dp = 1
    for a in names:
        dp *= mesh.size(dims.index(a))
    return b // dp


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *, kind: str,
                variant: str = "baseline", device=META) -> dict:
    """Zero stand-ins for every model input of this cell on ``device``: a
    train step takes the global batch (the step keeps this rank's rows), a
    prefill or decode this rank's rows."""
    b, s = shape.global_batch, shape.seq_len
    if kind != "train":
        b = _local_batch(cfg, shape, mesh)

    def z(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)

    if kind == "decode":
        return {"tokens": z((b, 1), torch.int64)}
    batch = {"tokens": z((b, s), torch.int64)}
    if kind == "train":
        batch["labels"] = z((b, s), torch.int64)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = z((b, VISION_PREFIX_TOKENS, cfg.d_model),
                                  torch.bfloat16)
    if cfg.frontend == "audio":
        batch["frames"] = z((b, s, cfg.d_model), torch.bfloat16)
    return batch


def cache_abstract(cfg: ModelConfig, shape: ShapeConfig, mesh, bundle, tp_size: int,
                   variant: str, *, kind: str, device=META,
                   cache_len: Optional[int] = None) -> dict:
    """One rank's caches: a prefill's empty cache of ``seq_len`` slots; a
    decode step's full one (``pos`` at its last slot), under ``ihtc-kv``
    the compressed cache (t = m = 2: a quarter of the slots plus a 1024
    tail) with its prototype bias and mass. ``cache_len`` sets the slots
    instead (a prefill's prompt is still ``seq_len``)."""
    b, s = _local_batch(cfg, shape, mesh), shape.seq_len
    if variant == "ihtc-kv" and kind == "decode":
        t, m, tail = 2, 2, 1024
        s = s // (t ** m) + tail
    if cache_len is not None:
        s = cache_len
    if cfg.family == "encdec-audio":
        caches = bundle.init_caches(b, s, enc_len=shape.seq_len, device=device,
                                    tp_size=tp_size)
    else:
        caches = bundle.init_caches(b, s, device=device, tp_size=tp_size)
    for c in caches["layers"]:
        c = c.get("self", c)
        if "pos" not in c:
            continue
        if kind == "decode":
            c["pos"] = c["k"].shape[2] - 1
        if variant == "ihtc-kv" and kind == "decode":
            c["bias"] = torch.zeros(c["k"].shape[:-1], dtype=torch.float32,
                                    device=device)
            c["mass"] = torch.zeros(c["k"].shape[:-1], dtype=torch.float32,
                                    device=device)
    return caches


def _model(cfg: ModelConfig, *, trainable: bool, mesh, device=META):
    mk = encdec.EncDec if cfg.family == "encdec-audio" else transformer.LM
    model = mk(cfg, device=device, trainable=trainable)
    if mesh is not None:
        tensor_parallel.shard_model(model, mesh)
    return model


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Optional[MeshShape], *,
               parallel: ParallelConfig, variant: str = "baseline",
               heads_mode: str = "auto", param_dtype: str = "float32",
               device=META, cache_len: Optional[int] = None) -> dict:
    """One rank's step of ``shape.kind`` for ``cfg`` on ``mesh`` (None: one
    device), traced on ``device`` ("meta"; the CPU with real zeros gives
    the same counts): :meth:`StepTrace.summary`, the collective records,
    and the rank's parameter count. ``cache_len``: the serving caches'
    slots (:func:`cache_abstract`)."""
    mesh = None if mesh is None else traced_mesh(mesh)
    tp = tensor_parallel.model_ranks(mesh)
    tensor_parallel.check_model_axis(cfg, tp)
    bundle = build(cfg)
    plan = make_plan(cfg, shape, mesh, heads_mode=heads_mode) if mesh is not None else None
    kind = shape.kind
    if kind == "train":
        model = _model(cfg, trainable=True, mesh=mesh, device=device)
        master = param_dtype == "bfloat16"
        if mesh is None:
            opt = init_opt_state(model, master=master)
        else:
            opt = init_opt_state(model, master=master, mesh=mesh, specs=mesh_opt_specs(
                model, mesh, zero_stage=parallel.zero_stage, master=master))
        batch = input_specs(cfg, shape, mesh, kind=kind, device=device)
        step = make_train_step(bundle, OptConfig(), parallel, impl="ref", mesh=mesh,
                               plan=plan)
        live = _tensors((list(model.parameters()), opt, batch))

        def run():
            return step(model, opt, batch)
    else:
        model = _model(cfg, trainable=False, mesh=mesh, device=device)
        caches = cache_abstract(cfg, shape, mesh, bundle, tp, variant, kind=kind,
                                device=device, cache_len=cache_len)
        batch = input_specs(cfg, shape, mesh, kind=kind, device=device)
        fn = bundle.prefill if kind == "prefill" else bundle.decode_step
        live = _tensors((list(model.parameters()), caches, batch))

        def run():
            return fn(model, caches, batch, plan=plan)
    n_rank_params = sum(p.numel() for p in model.parameters())
    _collectives.reset_op_counts()
    trace = StepTrace(live)
    with trace, tensor_parallel.expert_gathers() as experts, \
            torch.no_grad() if kind != "train" else contextlib.nullcontext():
        out = run()
    del out
    return dict(trace.summary(), records=_collectives.op_records(),
                op_counts=_collectives.op_counts(), rank_params=n_rank_params,
                expert_gather={"calls": len(experts), "bytes": sum(experts)})


def _strides(mesh: MeshShape) -> Dict[str, int]:
    """Each dimension's stride in the mesh's row-major rank order."""
    out, s = {}, 1
    for name, n in reversed(list(zip(mesh.mesh_dim_names, mesh.sizes, strict=True))):
        out[name] = s
        s *= n
    return out


def collectives_by_link(records: List[dict], mesh: MeshShape) -> Dict[str, float]:
    """Per-chip wire bytes by link (``utils.roofline.link_for``): a model
    group is the "model" dimension; a data group is the data dimensions'
    ranks ("data", then "pod" outside it)."""
    strides = _strides(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.sizes, strict=True))
    out: Dict[str, float] = {}
    for r in records:
        k = int(r["group"])
        if "model" in sizes and k == sizes["model"]:
            link = link_for(k, strides["model"])
        else:  # the data ranks: the innermost data dimension's stride
            link = link_for(k, strides["data"]) if "data" in strides else "ib"
        wire = hlo_utils.collective_bytes([r]).get("total", 0.0)
        out[link] = out.get(link, 0.0) + wire
    return out


def run_cell(
    arch: str,
    shape_name: str,
    mesh_name: str,
    *,
    variant: str = "baseline",
    parallel: Optional[ParallelConfig] = None,
    verbose: bool = True,
    cfg_override: Optional[ModelConfig] = None,
    heads_mode: str = "auto",
    param_dtype: str = "float32",
    force: bool = False,  # bypass the long_500k full-attention skip policy
) -> dict:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    mesh = PRODUCTION_MESHES[mesh_name]
    chips = mesh.size()
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "variant": variant}
    if parallel is None:
        # train: grad-accumulation microbatches bound activation memory; the
        # per-step cost accounting is unchanged (same total tokens/step).
        micro = 8 if shape.kind == "train" else 1
        parallel = ParallelConfig(
            remat="block" if shape.kind == "train" else "none",
            microbatches=micro,
        )
    if variant == "baseline" and not force \
            and not cell_is_baseline_runnable(cfg, shape):
        return dict(head, status="skip",
                    reason="full-attention arch at 500k context (DESIGN.md §6); "
                           "runnable under --variant ihtc-kv")
    try:
        tensor_parallel.check_model_axis(cfg, mesh.sizes[-1])
    except NotImplementedError as e:
        return dict(head, status="waits", reason=str(e))

    t0 = time.time()
    got = trace_step(cfg, shape, mesh, parallel=parallel, variant=variant,
                     heads_mode=heads_mode, param_dtype=param_dtype)
    trace_s = time.time() - t0
    whole = _model(cfg, trainable=False, mesh=None)
    n_active = _active_params(cfg, whole)
    n_params = sum(p.numel() for p in whole.parameters())
    mf = model_flops_for(cfg, shape, n_active=n_active)
    coll = hlo_utils.collective_bytes(got["records"])
    by_link = collectives_by_link(got["records"], mesh)
    report = build_report(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        flops=got["flops"] * chips, hbm_bytes=got["bytes"] * chips,
        collective_per_chip_bytes=float(coll.get("total", 0.0)),
        model_flops=mf, bytes_per_chip=got["peak_bytes"],
        flops_by_dtype={t: f * chips for t, f in got["flops_by_dtype"].items()},
        collective_bytes_by_link=by_link)
    out = dict(
        head, status="ok", chips=chips, n_params=n_params, n_active_params=n_active,
        cost_method=("direct: one rank's step traced on the meta device, every "
                     "layer; FLOPs of the products only (no elementwise), by "
                     "operand dtype; bytes = each op's inputs + outputs; the "
                     "kernels' own reckoning (kernels/meta.py)"),
        trace_s=round(trace_s, 1),
        memory={"argument_gb": got["start_bytes"] / 1e9,
                "temp_gb": (got["peak_bytes"] - got["start_bytes"]) / 1e9,
                "peak_gb": got["peak_bytes"] / 1e9},
        cost={"flops_per_chip": got["flops"], "bytes_per_chip": got["bytes"]},
        flops_by_dtype=got["flops_by_dtype"],
        kernels=got["kernels"],
        collectives={"bytes_per_chip": coll, "bytes_per_chip_by_link": by_link,
                     "op_counts": hlo_utils.collective_op_counts(got["records"]),
                     "calls": got["op_counts"], "expert_gather": got["expert_gather"]},
        roofline=dataclasses.asdict(report),
    )
    if verbose:
        r = report
        print(f"[{arch} × {shape_name} × {mesh_name} × {variant}] traced in "
              f"{trace_s:.1f}s, chips={chips}")
        print(f"  memory: peak {got['peak_bytes']/1e9:.2f} GB/chip (inputs "
              f"{got['start_bytes']/1e9:.2f})")
        print(f"  cost: {got['flops']/1e9:.1f} GFLOP/chip "
              f"{ {t: round(f / 1e9, 1) for t, f in got['flops_by_dtype'].items()} }, "
              f"{got['bytes']/1e9:.2f} GB/chip accessed")
        print(f"  collectives/chip: { {k: f'{v/1e6:.1f}MB' for k, v in coll.items()} }")
        print(f"  roofline (reckoned from data-sheet peaks): compute "
              f"{r.compute_term_s:.2e}s | memory {r.memory_term_s:.2e}s | collective "
              f"{r.collective_term_s:.2e}s → {r.dominant}-bound; useful-FLOP ratio "
              f"{r.useful_ratio:.2f}; MFU bound {r.mfu_bound*100:.1f}%")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="pod1", choices=("pod1", "pod2", "both"))
    ap.add_argument("--variant", default="baseline",
                    choices=("baseline", "ihtc-kv"))
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args(argv)

    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for a in ARCHS:
            for s in SHAPES:
                for m in meshes:
                    cells.append((a, s, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for m in meshes:
            cells.append((args.arch, args.shape, m))

    failures = waits = 0
    for a, s, m in cells:
        try:
            res = run_cell(a, s, m, variant=args.variant)
        except Exception as e:  # noqa: BLE001 — report and continue
            traceback.print_exc()
            res = {"arch": a, "shape": s, "mesh": m, "variant": args.variant,
                   "status": "error", "error": str(e)}
            failures += 1
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = f"{a}__{s}__{m}__{args.variant}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(res, f, indent=1)
        if res["status"] in ("skip", "waits"):
            waits += res["status"] == "waits"
            print(f"[{a} × {s} × {m}] {res['status'].upper()}: {res['reason']}")
    print(f"\ndry-run finished: {len(cells)} cells, {failures} failures, "
          f"{waits} waiting for the enc-dec on the model axis (ROADMAP.md item 7d)")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
