"""Tensor parallelism over the mesh's "model" dimension (Megatron's layout).

The reference leaves the model axis to GSPMD, which inserts the
collectives from the parameter specs (``transformer.lm_specs``). The port
runs one process a rank, so the collectives are written out here, on the
model :class:`~repro_torch.core._collectives.Axis`:

  * :func:`copy_to` — identity forward, sum backward: a replicated tensor
    entering a computation whose pieces differ by rank (a column-parallel
    projection, a replicated weight used by this rank's heads only);
  * :func:`reduce_from` — sum forward, identity backward: the pieces of a
    row-parallel projection (or of the vocabulary-parallel lookup) leave
    as one replicated tensor;
  * :func:`gather_from` — a sharded weight gathered whole (an exact copy),
    its gradient this rank's slice: where the layout computes with the
    whole weight.

Every float sum over the model ranks is :func:`rank_sum`: every rank's
tensor gathered (``gather_rows``, an exact copy) and added in rank order
on each rank, in f32 for narrower floats, so every model rank gets the
same bits and the replicated residual stream, the norms and their
gradients stay equal across the model ranks; the arithmetic is
``sum_scatter``'s, in one exchange through the mailboxes instead of two
(a decode step is bound by those exchanges). gloo's float
``all_reduce`` (and ``Axis.psum``) never serve: their ring order is not
fixed.

Where each module runs (:class:`TensorParallel`):

  * attention: q, k, v column-parallel by heads and the out projection
    row-parallel, RoPE and the softcap per local head. Where the query
    heads divide the model ranks but the kv heads do not, k and v are
    projected whole on every rank (``wk``/``wv`` gathered where the spec
    splits them, mid-head), the cache holds every kv head, and this rank's
    query heads attend over the kv heads they use. Where the query heads
    do not divide, the attention runs replicated with every weight
    gathered;
  * the MLP: gate and up column-parallel, down row-parallel;
  * the embedding: vocabulary-parallel; the lookup is a masked local
    lookup then the sum (one rank is non-zero for each token: exact), the
    tied unembedding gives this rank's columns of the logits, the final
    softcap and the padding mask by the global column index;
  * the loss (:meth:`TensorParallel.cross_entropy`): vocabulary-parallel;
  * the MoE (expert parallel, :meth:`TensorParallel.expert_share`): where
    the model ranks divide the experts a rank holds E/M of them
    (``moe_specs``' dim 0). The router, top-k, dispatch and aux loss run
    on the replicated residual stream, so every rank routes the same
    way; the tokens enter this rank's experts through :func:`copy_to`,
    their outputs are gathered along E (an exact copy; its backward is
    this rank's slice), and the one-device combine runs on every rank.
    Where the experts do not divide, every rank holds them all and the
    MoE runs replicated. The shared experts are the MLP's pair;
  * Mamba (:meth:`TensorParallel.mamba_operands`): where the model ranks
    divide the SSD heads, ``wz``/``wx``/``wdt`` are column-parallel,
    ``A_log``/``D``/``dt_bias`` taken by head and ``out`` row-parallel;
    ``wB``/``wC`` and the conv of B and C run whole on every rank, the
    conv's x channels and the gate norm at this rank's columns (one
    :meth:`~TensorParallel.copy_many` of the three); B and C enter this
    rank's heads through one :func:`copy_to` in f32, so the heads'
    partial gradients add before they round to bf16; the gated norm's
    sum of squares over d_inner is one :func:`rank_sum` of a (b, s, 1)
    partial. The partial products stay f32 until their sums, which then
    round to bf16 once, as one device's products round: ``out``'s, and the
    input gradient of ``wz``/``wx``/``wdt``'s columns, which enter through
    one f32 :func:`copy_to` (bf16 partials, rounded on every rank, moved a
    deep Mamba stack's step-0 gradients further from one device's;
    ``tests/mamba_tp_rounding_check.py`` measures what remains). The
    decode cache holds this rank's heads of ``ssm`` and its
    x channels plus B and C of ``conv``. Where the heads do not divide
    (d_inner may: the column specs then split a head), the weights are
    gathered whole and the block runs replicated.

  * the encoder-decoder (:meth:`TensorParallel.cross_kv_operands`): its
    encoder and decoder self-attention, the cross-attention's q and the
    MLPs as above, the embedding, unembedding and loss
    vocabulary-parallel; each decoder layer projects the cross k/v of the
    kv heads this rank holds from its ``wk``/``wv`` columns, the encoder
    output entering through :func:`copy_to` (its gradient summed over the
    ranks), and the cross k/v cache holds those heads.

A model's layout under one cell's plan is :meth:`TensorParallel.bind`:

  * context parallelism (``heads_mode="seq"``, ``plan.kv`` set: train and
    prefill where the query heads do not divide the ranks): a rank takes
    the queries of its chunk of the sequence (:func:`seq_chunk`; the
    chunks of ``ceil(s / M)`` rows, the last ones shorter or empty where
    M does not divide s, as GSPMD pads them) through :func:`seq_scatter`
    (its gradient gathered back along the sequence), projects them with
    the whole ``wq`` (every weight gathered in one exchange,
    :func:`gather_many`; the gradients of ``wq`` and ``wo`` are the rank
    sums of the chunks' partials, this rank's slice of them, one
    ``sum_scatter``), computes k and v whole on every rank (they enter
    through one :meth:`~TensorParallel.copy_many`: the chunks' partial
    gradients add in one rank sum), attends its queries over the keys up
    to its chunk's end (the causal mask and gemma2's window are aligned to
    the end of kv, so the chunk's rows see what they see on one device),
    runs the whole ``wo`` on its rows and gathers the rows along the
    sequence (:func:`seq_gather`, an exact copy);
  * the decode cache (:func:`cache_layout`) follows ``plan.cache``: a
    rank holds its kv heads where the plan puts them over "model", and
    its contiguous slice of the slots where the plan puts the sequence
    over mesh dimensions ("model" at batch > 1 where the kv heads do not
    divide; at batch 1 the data dimensions, plus "model" where they do
    not divide). Such a cache carries its ``"seq"`` axis and its logical
    ``"slots"``; a decode step attends each rank's slots through K5's lse
    entry and merges the ranks' (o, lse) in rank order
    (``models/attention.py``).
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import no_tf32
from repro_torch.models import mamba2

#: the mesh dimension of tensor parallelism
MODEL = "model"


def entry_names(entry) -> Tuple[str, ...]:
    """The mesh dimensions of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def model_dim(spec) -> Optional[int]:
    """The dimension ``spec`` shards over "model" (None: whole)."""
    for i, e in enumerate(spec or ()):
        if MODEL in entry_names(e):
            return i
    return None


def model_ranks(mesh) -> int:
    """The size of ``mesh``'s "model" dimension (1 without one or without
    a mesh)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return int(mesh.size(names.index(MODEL))) if MODEL in names else 1


def mamba_heads_local(cfg: ModelConfig, tp_size: int) -> bool:
    """Whether a rank of ``tp_size`` model ranks runs its share of the SSD
    heads (the ranks divide them) rather than the whole Mamba block
    replicated: the layout of the weights (:class:`TensorParallel`) and of
    the decode cache (``transformer.init_lm_caches``)."""
    return tp_size > 1 and bool(cfg.ssm_state) and mamba2.dims(cfg)[1] % tp_size == 0


def cache_kv_heads(cfg: ModelConfig, tp_size: int) -> int:
    """The kv heads one rank's attention cache holds with no plan (the
    caches ``init_caches(tp_size=)`` builds): its share where the query and
    kv heads both divide the model ranks, else all of them."""
    if tp_size > 1 and cfg.n_heads % tp_size == 0 and cfg.n_kv_heads % tp_size == 0:
        return cfg.n_kv_heads // tp_size
    return cfg.n_kv_heads


@dataclass(frozen=True)
class CacheLayout:
    """How a rank's attention caches hold the (b, hkv, S, hd) decode cache
    under a plan: ``heads`` kv heads (its share, or all), and with ``seq``
    (the collective axis over the mesh dimensions the plan puts the
    sequence on) its contiguous slice of the slots: ``ceil(S / seq.size)``
    of them from ``seq.index`` times that."""
    heads: int
    seq: Optional[object] = None


def cache_layout(cfg: ModelConfig, plan, mesh) -> CacheLayout:
    """This rank's :class:`CacheLayout` under ``plan`` on ``mesh`` (a mesh
    of process groups or a ``launch.mesh.TracedMesh``): the kv heads over
    "model" where ``plan.cache`` puts them there, the slots over the mesh
    dimensions its sequence entry names (one axis over them, row-major)."""
    from repro_torch.launch.mesh import _axis

    spec = plan.cache if plan is not None and plan.cache is not None else (None,) * 4
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    tp_size = int(mesh.size(names.index(MODEL))) if MODEL in names else 1
    heads = (cache_kv_heads(cfg, tp_size) if MODEL in entry_names(spec[1])
             else cfg.n_kv_heads)
    seq_names = tuple(a for a in entry_names(spec[2]) if a in names)
    if not seq_names or int(np.prod([mesh.size(names.index(a)) for a in seq_names])) == 1:
        return CacheLayout(heads)
    return CacheLayout(heads, _axis(mesh, seq_names))


def seq_chunk(s: int, size: int, index: int) -> Tuple[int, int, int]:
    """(lo, hi, c): rank ``index`` of ``size`` takes rows [lo, hi) of a
    sequence of ``s``, chunks of c = ceil(s / size) rows (GSPMD's padded
    split: the last chunks are shorter, or empty, where size does not
    divide s)."""
    c = -(-s // size)
    lo = min(s, index * c)
    return lo, min(s, lo + c), c


# ------------------------------------------------------------- the sums
#: bytes of every rank's copies that one gather of :func:`rank_sum` holds at
#: most: a larger tensor is summed in pieces, each its elements' same
#: rank-order sum (16 ranks' copies of a prefill's (4, 2048, 2304) f32
#: partial are 1.2 GB a rank at once, past one card beside 15 others)
RANK_SUM_BYTES = 1 << 29


def rank_sum(t: torch.Tensor, axis) -> torch.Tensor:
    """The sum of every model rank's ``t``, ``t_0 + t_1 + ... + t_(size-1)``
    (in f32 for narrower floats, returned in ``t``'s dtype); every rank
    gets the same bits. Gathered in pieces of at most RANK_SUM_BYTES of
    every rank's copies."""
    dt = t.dtype
    flat = t.detach().reshape(-1)
    if dt in (torch.bfloat16, torch.float16):
        flat = flat.float()
    per = max(1, RANK_SUM_BYTES // (axis.size * flat.element_size()))
    acc = torch.empty_like(flat) if flat.numel() > per else None
    for a in range(0, flat.numel(), per):
        rows = axis.gather_rows(flat[a:a + per].reshape(1, -1).contiguous())
        part = rows[0].clone()
        for r in range(1, axis.size):
            part += rows[r]
        if acc is None:
            acc = part
        else:
            acc[a:a + per] = part
        del rows
    return acc.view(t.shape).to(dt)


def gather_dim(t: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (exact)."""
    front = t.detach().movedim(dim, 0).contiguous()
    return axis.gather_rows(front).movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return rank_sum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return rank_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axis, dim):
        ctx.dim, ctx.index, ctx.per = dim, axis.index, w.shape[dim]
        return gather_dim(w, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.per, ctx.per).contiguous(), None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, lo, hi, c):
        ctx.axis, ctx.lo, ctx.hi, ctx.c, ctx.s = axis, lo, hi, c, x.shape[1]
        return x[:, lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        pad = ctx.c - (ctx.hi - ctx.lo)
        if pad:
            g = torch.cat([g, g.new_zeros((g.shape[0], pad) + tuple(g.shape[2:]))], dim=1)
        return gather_dim(g, ctx.axis, 1)[:, :ctx.s], None, None, None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, axis, s, c):
        ctx.n = y.shape[1]
        ctx.lo = min(s, axis.index * c)
        pad = c - y.shape[1]
        if pad:
            y = torch.cat([y, y.new_zeros((y.shape[0], pad) + tuple(y.shape[2:]))], dim=1)
        return gather_dim(y, axis, 1)[:, :s]

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo:ctx.lo + ctx.n].contiguous(), None, None, None


class _ColumnMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dt):
        xb, wb = x.to(dt), w.to(dt)
        ctx.save_for_backward(xb, wb)
        ctx.w_dtype = w.dtype
        return xb @ wb

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            gf = g2.float()
            no_tf32(gf)
            dx = (gf @ wb.float().t()).view(*g.shape[:-1], wb.shape[0])
        if ctx.needs_input_grad[1]:
            dw = (xb.reshape(-1, xb.shape[-1]).t() @ g2).to(ctx.w_dtype)
        return dx, dw, None


def column_mm(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x @ w`` in ``dt``, the product of a column-parallel projection:
    ``x`` as :meth:`TensorParallel.column_input` gives it. An f32 ``x``
    (training) holds ``dt`` values: the product is the same ``dt`` product,
    and its input gradient is computed in f32 and stays f32, so this rank's
    partial of a sum over the ranks rounds once after the sum, as one
    device's product rounds (the weight's gradient is the ``dt`` product
    autograd gives it)."""
    if x.dtype == dt:
        return x @ w.to(dt)
    return _ColumnMM.apply(x, w, dt)


def seq_scatter(x: torch.Tensor, axis, lo: int, hi: int, c: int) -> torch.Tensor:
    """Rows [lo, hi) of a replicated (b, s, ...) tensor (:func:`seq_chunk`);
    the gradient is every rank's rows gathered along the sequence (exact)."""
    return _SeqScatter.apply(x, axis, lo, hi, c)


def seq_gather(y: torch.Tensor, axis, s: int, c: int) -> torch.Tensor:
    """Every rank's (b, rows, ...) chunk of a sequence of ``s`` (chunks of
    ``c``, :func:`seq_chunk`) gathered in rank order, an exact copy; the
    gradient is this rank's rows."""
    return _SeqGather.apply(y, axis, s, c)


class _GatherMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dims, summed, *ws):
        ctx.axis, ctx.dims, ctx.summed = axis, dims, summed
        ctx.pers = [w.shape[d] for w, d in zip(ws, dims)]
        fronts = [w.detach().movedim(d, 0).contiguous() for w, d in zip(ws, dims)]
        every = axis.gather_rows(torch.cat([f.reshape(-1) for f in fronts])[None])
        outs, at = [], 0
        for f, d in zip(fronts, dims):
            part = every[:, at:at + f.numel()].reshape((axis.size * f.shape[0],)
                                                       + tuple(f.shape[1:]))
            outs.append(part.movedim(0, d))
            at += f.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        axis, size = ctx.axis, ctx.axis.size
        out = [None if g is None or s else
               g.narrow(d, axis.index * per, per).contiguous()
               for g, d, per, s in zip(gs, ctx.dims, ctx.pers, ctx.summed)]
        summed = [i for i, s in enumerate(ctx.summed) if s and gs[i] is not None]
        if summed:  # one sum_scatter: rank r's chunk holds every summed tensor's rows of r
            rows = [gs[i].movedim(ctx.dims[i], 0).reshape(size, -1).float()
                    for i in summed]
            mine = axis.sum_scatter(torch.cat(rows, dim=1).reshape(-1).contiguous())
            for i, part in zip(summed, torch.split(mine, [r.shape[1] for r in rows]),
                               strict=True):
                front = gs[i].movedim(ctx.dims[i], 0)
                out[i] = (part.view((ctx.pers[i],) + tuple(front.shape[1:]))
                          .movedim(0, ctx.dims[i]).to(gs[i].dtype))
        return (None, None, None) + tuple(out)


def gather_many(ws, axis, dims, summed=None) -> Tuple[torch.Tensor, ...]:
    """Several sharded tensors of one dtype gathered whole in one exchange
    (the same bits as :func:`gather_from` of each, along its dimension in
    rank order). A tensor's gradient is this rank's slice of its gradient
    (:func:`gather_from`'s), or with ``summed`` (a flag a tensor) this
    rank's slice of the rank-order sum of every rank's gradient (where
    every rank computes with all of it on its own part of the data; one
    ``sum_scatter`` for all of them, in f32)."""
    summed = tuple(summed) if summed is not None else (False,) * len(ws)
    return _GatherMany.apply(axis, tuple(dims), summed, *ws)


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    return _ReduceFrom.apply(x, axis)


def gather_from(w: torch.Tensor, axis, dim: int) -> torch.Tensor:
    return _GatherFrom.apply(w, axis, dim)


#: calls in this process of the layouts ``models/attention.py`` runs under a
#: plan: "context_parallel" (a context-parallel attention layer) and
#: "seq_merge" (a decode step's merge of a sequence-split cache's (o, lse)
#: over the ranks)
CALLS = {"context_parallel": 0, "seq_merge": 0}

# the bytes each TensorParallel.gather hands in while expert_gathers runs
_GATHERS: Optional[List[int]] = None


@contextlib.contextmanager
def expert_gathers() -> Iterator[List[int]]:
    """While the block runs, the bytes this rank hands to each gather of
    the experts' outputs (:meth:`TensorParallel.gather`), in call order."""
    global _GATHERS
    outer, _GATHERS = _GATHERS, []
    try:
        yield _GATHERS
    finally:
        _GATHERS = outer


# ------------------------------------------------------------- the layout
class TensorParallel:
    """A sharded model's place on the model axis: the ``axis``, the
    parameter ``specs`` it was sliced by, and the layout of each module
    (module docstring)."""

    #: context-parallel attention (:meth:`bind`: ``plan.kv`` set)
    context_parallel = False

    def __init__(self, cfg: ModelConfig, axis, specs: Dict[str, tuple]):
        self.cfg, self.axis, self.specs = cfg, axis, specs
        self._wholes: Dict[tuple, Tuple[torch.Tensor, ...]] = {}  # whole_many's
        self.size, self.index = axis.size, axis.index
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        self.heads_local = hq % self.size == 0
        self.kv_local = self.heads_local and hkv % self.size == 0
        self.kv_split = (hkv * cfg.head_dim) % self.size == 0  # wk/wv sharded
        self.kv_range = None
        if self.heads_local and not self.kv_local:
            g, per = hq // hkv, hq // self.size
            if per % g and g % per:
                raise NotImplementedError(
                    f"{cfg.name}: {per} query heads a rank do not group with "
                    f"{hkv} kv heads ({g} queries each) on {self.size} model ranks")
            lo = self.index * per // g
            self.kv_range = (lo, ((self.index + 1) * per - 1) // g + 1)
        # the MoE: experts over the ranks where they divide, else replicated
        self.experts_local = bool(cfg.n_experts) and cfg.n_experts % self.size == 0
        # Mamba: heads over the ranks where they divide, else replicated
        self.mamba_local = mamba_heads_local(cfg, self.size)
        self.mamba_dims: Dict[str, Optional[int]] = {}
        if cfg.ssm_state:
            self.mamba_dims = {n: model_dim(sp) for n, sp in
                               mamba2.mamba_specs(cfg, MODEL, self.size).items()}

    # ---- the plan
    def check_plan(self, plan) -> None:
        """A plan this layout can run: vocabulary-sharded logits."""
        if plan is None or plan.logits is None or model_dim(plan.logits) is None:
            raise ValueError(
                f"{self.cfg.name} is sharded over {self.size} model ranks: pass "
                f"plan= (launch.mesh.make_plan) with vocabulary-sharded logits")

    def bind(self, plan) -> "TensorParallel":
        """This layout under one cell's ``plan`` (checked): a copy whose
        attention runs context-parallel where ``plan.kv`` is set (module
        docstring)."""
        self.check_plan(plan)
        bound = copy.copy(self)
        bound.context_parallel = plan.kv is not None
        return bound

    # ---- the pieces
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.axis)

    def column_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` entering this rank's columns of column-parallel projections
        (:func:`copy_to`): in f32 while autograd records it, so the
        projections' partial input gradients (:func:`column_mm`) add over
        the ranks in f32 and round once (16 ranks' bf16 partials put a norm's
        gradient past 8 bf16 ulps of one device's); as it is otherwise."""
        if torch.is_grad_enabled() and x.requires_grad:
            return self.copy(x.float())
        return self.copy(x)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_from(x, self.axis)

    def row_reduce(self, x: torch.Tensor, w: torch.Tensor, dt: torch.dtype
                   ) -> torch.Tensor:
        """A row-parallel projection ``x @ w`` (this rank's rows of ``w``)
        summed over the ranks, in ``dt``: this rank's partial product of
        ``dt`` values in f32, the partials added in f32 in rank order and
        rounded to ``dt`` once, as one device's product rounds (16 ranks'
        partials rounded to bf16 each put gradients past 8 bf16 ulps of one
        device's)."""
        xf = x.float()
        no_tf32(xf)
        return self.reduce(xf @ w.to(dt).float()).to(dt)

    def copy_many(self, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """:meth:`copy` of several tensors at once, through one f32 buffer
        (each returned in its own dtype and shape): one sum of their
        gradients."""
        flat = self.copy(torch.cat([t.reshape(-1).float() for t in ts]))
        parts = torch.split(flat, [t.numel() for t in ts])
        return tuple(x.view(t.shape).to(t.dtype) for x, t in zip(parts, ts, strict=True))

    def whole(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """``w`` whole (gathered along ``dim``; ``dim`` None: it is whole)."""
        return w if dim is None else gather_from(w, self.axis, dim)

    def whole_many(self, ws: Dict[str, torch.Tensor],
                   dims: Dict[str, Optional[int]]) -> Dict[str, torch.Tensor]:
        """:meth:`whole` of every tensor of ``ws`` by its ``dims`` entry, the
        sharded ones of one dtype in one exchange (:func:`gather_many`: a
        replicated attention layer's weights). Outside autograd (serving)
        the gathered weights are kept while their slices are unchanged (the
        same storage at the same version on every rank), so a decode step
        does not gather them again."""
        out = dict(ws)
        names = [n for n in ws if dims.get(n) is not None]
        for dt in dict.fromkeys(ws[n].dtype for n in names):  # in the order of ws
            group = [n for n in names if ws[n].dtype == dt]
            key = None
            if not torch.is_grad_enabled() and not ws[group[0]].is_meta:
                key = tuple((ws[n].data_ptr(), ws[n]._version, dims[n]) for n in group)
            got = self._wholes.get(key) if key is not None else None
            if got is None:
                got = gather_many([ws[n] for n in group], self.axis,
                                  [dims[n] for n in group])
                if key is not None:
                    self._wholes[key] = got
            out.update(zip(group, got, strict=True))
        return out

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``dim`` in rank order (an exact copy);
        its gradient is this rank's slice. The MoE's experts' outputs come
        back through here (:func:`expert_gathers` counts them)."""
        if _GATHERS is not None:
            _GATHERS.append(t.numel() * t.element_size())
        return gather_from(t, self.axis, dim)

    def attention_operands(self, p, x: torch.Tensor) -> dict:
        """What one attention layer computes with on this rank: the inputs
        of the q and kv projections, the weights, the heads projected, the
        kv heads the local query heads use (None: all), and whether the
        output is this rank's part of a sum."""
        cfg = self.cfg
        w = {n: getattr(p, n) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
             if hasattr(p, n)}
        kv_dim = 1 if self.kv_split else None
        if not self.heads_local:  # replicated: every weight whole
            dims = {"wq": 1, "wk": kv_dim, "wv": kv_dim, "wo": 0, "bq": 0,
                    "bk": 0 if self.kv_split else None,
                    "bv": 0 if self.kv_split else None}
            w = self.whole_many(w, dims)
            return dict(xq=x, xkv=x, w=w, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                        kv_range=None, partial=False)
        xq = self.column_input(x)
        hkv = cfg.n_kv_heads // self.size if self.kv_local else cfg.n_kv_heads
        if not self.kv_local:  # whole k/v, used by this rank's heads only
            kv = [n for n in ("wk", "wv", "bk", "bv") if n in w]
            dims = {n: (1 if n[0] == "w" else 0) if self.kv_split else None for n in kv}
            got = self.whole_many({n: w[n] for n in kv}, dims)
            w.update({n: self.copy(got[n]) for n in kv})
        return dict(xq=xq, xkv=xq, w=w, hq=cfg.n_heads // self.size, hkv=hkv,
                    kv_range=self.kv_range, partial=True)

    def cross_kv_operands(self, p, enc_out: torch.Tensor):
        """What a decoder layer projects its cross k/v with on this rank:
        (the encoder output, ``wk``, ``wv``, the kv heads projected). Where
        the kv heads are this rank's, its ``wk``/``wv`` columns, the input
        entering through :func:`copy_to` (the encoder output's gradient is
        summed over the ranks); where the query heads are local but the kv
        heads are not, every kv head (the weights gathered, entered through
        :func:`copy_to`); where the attention runs replicated, every weight
        gathered."""
        cfg = self.cfg
        kv_dim = 1 if self.kv_split else None
        if not self.heads_local:
            return (enc_out, self.whole(p.wk, kv_dim), self.whole(p.wv, kv_dim),
                    cfg.n_kv_heads)
        x = self.column_input(enc_out)
        if self.kv_local:
            return x, p.wk, p.wv, cfg.n_kv_heads // self.size
        return (x, self.copy(self.whole(p.wk, kv_dim)), self.copy(self.whole(p.wv, kv_dim)),
                cfg.n_kv_heads)

    def context_operands(self, p, x: torch.Tensor) -> dict:
        """Context-parallel attention's operands on this rank (module
        docstring): this rank's rows of the sequence (lo, hi; chunks of c)
        entered through :func:`seq_scatter`, and every weight whole in one
        exchange (:func:`gather_many`): ``wq``/``bq``/``wo`` with the rank
        sum of their gradients, ``wk``/``wv``/``bk``/``bv`` with this rank's
        slice (their gradients are the same on every rank)."""
        lo, hi, c = seq_chunk(x.shape[1], self.size, self.index)
        w = {n: getattr(p, n) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
             if hasattr(p, n)}
        kv_dim = 1 if self.kv_split else None
        dims = {"wq": 1, "bq": 0, "wo": 0, "wk": kv_dim, "wv": kv_dim,
                "bk": 0 if self.kv_split else None, "bv": 0 if self.kv_split else None}
        shard = [n for n in w if dims[n] is not None]
        got = gather_many([w[n] for n in shard], self.axis, [dims[n] for n in shard],
                          summed=[n in ("wq", "bq", "wo") for n in shard])
        w.update(zip(shard, got, strict=True))
        return dict(xq=seq_scatter(x, self.axis, lo, hi, c), w=w, lo=lo, hi=hi, c=c)

    def expert_share(self, p) -> Optional[Tuple[int, int]]:
        """The experts of one MoE layer this rank holds and runs: (first,
        count) where they are sharded (expert parallel; ``p.gate`` holds
        them), None where every rank holds and runs all of them
        (``moe_specs`` keeps them whole where the ranks do not divide their
        count)."""
        if not self.experts_local:
            return None
        per = p.gate.shape[0]
        return self.index * per, per

    def mamba_operands(self, p) -> Tuple[Dict[str, torch.Tensor],
                                          Optional[Tuple[int, int]]]:
        """One Mamba block's weights by name as this rank computes with
        them, and the d_inner columns it holds: (first, count) where the
        heads are this rank's (the conv and the gate norm taken at this
        rank's x channels, whose gradients sum over the ranks; the conv
        keeps B and C whole), None where the block runs replicated (every
        weight gathered whole)."""
        w = {n: getattr(p, n) for n in self.mamba_dims}
        if not self.mamba_local:
            return {n: self.whole(t, self.mamba_dims[n]) for n, t in w.items()}, None
        d_in = mamba2.dims(self.cfg)[0]
        per = d_in // self.size
        lo = self.index * per
        # the x channels' conv and the norm, used at this rank's columns: one
        # copy (one sum of their gradients); B's and C's conv runs whole
        cw, cb, norm = self.copy_many(w["conv_w"][:, :d_in], w["conv_b"][:d_in],
                                      w["norm"])
        w["conv_w"] = torch.cat([cw.narrow(1, lo, per), w["conv_w"][:, d_in:]], dim=1)
        w["conv_b"] = torch.cat([cb.narrow(0, lo, per), w["conv_b"][d_in:]])
        w["norm"] = norm.narrow(0, lo, per)
        return w, (lo, per)

    def rms_norm(self, x: torch.Tensor, w: torch.Tensor, eps: float,
                 width: int) -> torch.Tensor:
        """``layers.rms_norm`` of a tensor whose last dimension is this
        rank's columns of ``width``: the sum of squares over all of them
        (this rank's (…, 1) partial in f32, added over the ranks in rank
        order; its gradient summed back over the ranks), then this rank's
        columns normalised."""
        dt = x.dtype
        x = x.float()
        part = torch.sum(torch.square(x), dim=-1, keepdim=True)
        var = self.reduce(self.copy(part)) / width
        return (x * torch.rsqrt(var + eps) * (1.0 + w.float())).to(dt)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The vocabulary-parallel lookup: this rank's rows, zeros for the
        tokens of other ranks, summed over the ranks (exact)."""
        per = table.shape[0]
        local = tokens - self.index * per
        ok = (local >= 0) & (local < per)
        x = table[local.clamp(0, per - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.reduce(x)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor,
                      weights: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train_step.cross_entropy`` on vocabulary-sharded logits (b, s,
        V / tp): the max over the ranks (``pmax``, exact), the local sums of
        exponentials and the gold logit as a masked local sum, both added
        over the ranks in rank order."""
        per = logits.shape[-1]
        lo = self.index * per
        mask = (labels >= 0).to(torch.float32)
        lab = torch.where(labels >= 0, labels, 0).to(torch.int64) - lo
        mine = (lab >= 0) & (lab < per)
        m = self.axis.pmax(logits.detach().amax(dim=-1))
        sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
        gold = torch.gather(logits, -1, lab.clamp(0, per - 1)[..., None])[..., 0]
        gold = torch.where(mine, gold, torch.zeros((), dtype=gold.dtype,
                                                   device=gold.device))
        both = self.reduce(torch.stack([sumexp, gold]))
        tok_loss = (torch.log(both[0]) + m - both[1]) * mask
        if weights is not None:
            w = weights.to(torch.float32)[:, None]
            tok_loss = tok_loss * w
            mask = mask * w
        tot = torch.clamp_min(torch.sum(mask), 1e-6)
        return torch.sum(tok_loss) / tot, tot

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of gradients keyed by parameter name: each
        leaf's sum of squares, those of model-sharded leaves added over the
        ranks in rank order, the replicated ones counted once, then summed
        in the given order (the same bits on every model rank)."""
        names = list(grads)
        local = torch.stack([torch.sum(torch.square(grads[n].detach().float()))
                             for n in names])
        sharded = torch.tensor([model_dim(self.specs.get(n)) is not None for n in names],
                               device=local.device)
        summed = rank_sum(torch.where(sharded, local, torch.zeros_like(local)), self.axis)
        per = torch.where(sharded, summed, local)
        total = per[0]
        for i in range(1, len(names)):
            total = total + per[i]
        return torch.sqrt(total)


# ------------------------------------------------------------- weights
def _set(model: nn.Module, name: str, value: nn.Parameter) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, leaf, value)


@torch.no_grad()
def shard_params(model: nn.Module, specs: Dict[str, tuple],
                 coords: Dict[str, Tuple[int, int]]) -> nn.Module:
    """Replace, in place, each parameter of ``model`` that ``specs`` shards
    over "model" by this rank's slice of it (``coords``: {dimension:
    (index, size)}, ``optimizer.mesh_coords``): an exact copy."""
    index, size = coords.get(MODEL, (0, 1))
    for name, p in list(model.named_parameters()):
        d = model_dim(specs.get(name))
        if d is None or size == 1:
            continue
        if p.shape[d] % size:
            raise ValueError(f"{name}: dimension {d} of {tuple(p.shape)} does not "
                             f"divide over {size} model ranks")
        per = p.shape[d] // size
        piece = p.detach().narrow(d, index * per, per).clone()
        _set(model, name, nn.Parameter(piece, requires_grad=p.requires_grad))
    return model


@torch.no_grad()
def gather_params(model: nn.Module) -> nn.Module:
    """Rebuild, in place, the whole parameters of a model sharded over its
    model axis (``model.tp``): each sharded parameter gathered in rank
    order (an exact copy). The model is then a one-device model again."""
    tp = model.tp
    for name, p in list(model.named_parameters()):
        d = model_dim(tp.specs.get(name))
        if d is None:
            continue
        whole = gather_dim(p.detach(), tp.axis, d)
        _set(model, name, nn.Parameter(whole, requires_grad=p.requires_grad))
    model.tp = None
    return model


def _attach(model: nn.Module, mesh, specs: Dict[str, tuple]) -> nn.Module:
    from repro_torch.launch.mesh import model_axis

    model.tp = TensorParallel(model.cfg, model_axis(mesh), specs)
    return model


def _model_specs(model: nn.Module, mesh, specs) -> Dict[str, tuple]:
    from repro_torch.models.registry import build

    return specs if specs is not None else build(model.cfg).param_specs(
        tp=MODEL, tp_size=model_ranks(mesh))


def shard_model(model: nn.Module, mesh, specs: Optional[Dict[str, tuple]] = None
                ) -> nn.Module:
    """A one-device model sliced, in place, for this rank of ``mesh``'s
    "model" dimension (``specs``: default, the bundle's ``param_specs``),
    and given its :class:`TensorParallel` (``model.tp``). A mesh without a
    model dimension, or of one model rank, leaves the model as it is.
    (A model drawn from a seed is drawn sliced instead:
    :func:`init_sharded`.)"""
    from repro_torch.train.optimizer import mesh_coords

    model.tp = None
    size = model_ranks(mesh)
    if size == 1:
        return model
    specs = _model_specs(model, mesh, specs)
    shard_params(model, specs, mesh_coords(mesh))
    return _attach(model, mesh, specs)


@torch.no_grad()
def init_sharded(model: nn.Module, generator: torch.Generator, mesh,
                 device: torch.device) -> nn.Module:
    """``model``, built on the "meta" device, drawn from ``generator``
    straight into this rank's slices on ``device`` over ``mesh``'s model
    ranks (more than one): each parameter is allocated at its slice, and
    ``init_weights`` draws each leaf whole (the one-device draw, the same
    generator stream) and keeps the slice (``layers.dense_init_``), so at
    most one whole leaf is on the device at a time. The result is bitwise
    ``shard_model`` of the one-device draw."""
    from repro_torch.train.optimizer import mesh_coords

    size = model_ranks(mesh)
    specs = _model_specs(model, mesh, None)
    index = mesh_coords(mesh)[MODEL][0]
    for name, p in list(model.named_parameters()):
        d = model_dim(specs.get(name))
        shape = list(p.shape)
        if d is not None:
            if shape[d] % size:
                raise ValueError(f"{name}: dimension {d} of {tuple(p.shape)} does not "
                                 f"divide over {size} model ranks")
            shape[d] //= size
        piece = nn.Parameter(torch.empty(shape, dtype=p.dtype, device=device),
                             requires_grad=p.requires_grad)
        if d is not None:
            piece.whole = (tuple(p.shape), d, index * shape[d])
        _set(model, name, piece)
    model.init_weights(generator)
    for p in model.parameters():
        p.__dict__.pop("whole", None)
    return _attach(model, mesh, specs)
