"""Model registry: one bundle of callables per architecture, as
``repro.models.registry`` gives the serving engine and the tests.

    bundle = build(cfg)
    model = bundle.init(torch.Generator("cuda").manual_seed(0))
    caches = bundle.init_caches(batch, max_len, device=model_device)
    logits, caches = bundle.prefill(model, caches, {"tokens": prompts})
    logits, caches = bundle.decode_step(model, caches, {"tokens": tok[:, None]})

    model = bundle.init(gen, trainable=True)        # f32, requires_grad
    logits, aux = bundle.forward(model, {"tokens": tokens}, remat="block")

Batches follow the reference's conventions:

  decoder-only:  {"tokens": (b, s)[, "labels"]}
  vlm:           + "patch_embeds": (b, 256, d)   (prefill and forward)
  audio enc-dec: {"frames": (b, s_enc, d), "tokens": (b, s)};
                 ``init_caches(b, max_len, enc_len=s_enc)``
  decode step:   {"tokens": (b, 1)}

``init`` builds the model on ``device`` (default: the runtime config's,
"cuda" unless the caller asks for the CPU; a missing GPU raises); with
``mesh=`` of more than one model rank it draws this rank's slices of the
same model (``tensor_parallel.init_sharded``), one whole leaf at a time. Every
family of ``transformer.FAMILIES``; ``forward``'s aux is the MoE layers'
load-balancing loss (0 without MoE). The VLM's ``forward`` drops the
prefix's logits; its prefill keeps the last position's.

``param_specs(tp=, tp_size=)`` and ``cache_specs(plan=, tp_size=)`` are
the reference's, keyed by the port's parameter names and laid out as
``init_caches`` lays out the caches. A model sharded over a mesh's "model"
dimension (``models.tensor_parallel.shard_model``; every family) takes
``plan=`` (``launch.mesh.make_plan``) in ``forward``, ``prefill`` and
``decode_step``, and its caches come from ``init_caches(..., tp_size=,
plan=, mesh=)``: with the plan and the mesh they follow ``plan.cache``
(``tensor_parallel.cache_layout``: kv heads or slots over the ranks);
with ``tp_size`` alone each rank holds its kv heads where they divide,
else all of them whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, tensor_parallel, transformer
from repro_torch.models.frontends import VISION_PREFIX_TOKENS
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., torch.nn.Module]
    forward: Callable[..., Any]       # (logits (b, s, V) f32, aux)
    prefill: Callable[..., Any]       # (logits (b, 1, V), caches)
    decode_step: Callable[..., Any]   # (logits (b, 1, V), caches)
    init_caches: Callable[..., dict]
    #: ``param_specs(tp="model", tp_size=1)``: {parameter name: spec tuple}
    param_specs: Callable[..., dict]
    #: ``cache_specs(plan=ShardingPlan(), tp_size=1)``: specs laid out as
    #: ``init_caches`` lays out the caches
    cache_specs: Callable[..., dict]


def _initialiser(make: Callable[..., torch.nn.Module]):
    def init(generator: Optional[torch.Generator] = None, *,
             device=None, trainable: bool = False, mesh=None) -> torch.nn.Module:
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if tensor_parallel.model_ranks(mesh) > 1:
            return tensor_parallel.init_sharded(
                make(device=torch.device("meta"), trainable=trainable), generator,
                mesh, dev)
        return make(device=dev, trainable=trainable).init_weights(generator)
    return init


def _lm_bundle(cfg: ModelConfig) -> ModelBundle:
    is_vlm = cfg.frontend == "vision"

    def prefix_of(batch):
        return batch.get("patch_embeds") if is_vlm else None

    def forward(model, batch, *, impl="ref", remat="none", plan=None):
        prefix = prefix_of(batch)
        logits, _, aux = model(batch["tokens"], prefix_embeds=prefix, impl=impl,
                               remat=remat, with_aux=True, plan=plan)
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]
        return logits, aux

    def prefill(model, caches, batch, *, impl=None, plan=None):
        return model(batch["tokens"], prefix_embeds=prefix_of(batch),
                     caches=caches, impl=impl, last_only=True, plan=plan)

    def decode_step(model, caches, batch, *, impl=None, plan=None):
        start = transformer.cache_start_pos(caches)
        return model(batch["tokens"], caches=caches, start_pos=start, impl=impl,
                     plan=plan)

    def init_caches(batch: int, max_len: int, *, dtype=COMPUTE_DTYPE,
                    device=None, tp_size: int = 1, plan=None, mesh=None) -> dict:
        if is_vlm:  # room for the patch-embedding prefix
            max_len = max_len + VISION_PREFIX_TOKENS
        return transformer.init_lm_caches(cfg, batch, max_len, dtype=dtype,
                                          device=resolve_device(device),
                                          tp_size=tp_size,
                                          layout=_layout(cfg, plan, mesh))

    def param_specs(tp="model", tp_size=1):
        return transformer.lm_specs(cfg, tp, tp_size)

    def cache_specs(plan=transformer.ShardingPlan(), tp_size=1):
        return transformer.cache_specs(cfg, plan, tp_size)

    init = _initialiser(lambda **kw: transformer.LM(cfg, **kw))
    return ModelBundle(cfg, init, forward, prefill, decode_step, init_caches,
                       param_specs, cache_specs)


def _layout(cfg: ModelConfig, plan, mesh):
    """The caches' ``tensor_parallel.CacheLayout`` under ``plan`` on
    ``mesh`` (None without both)."""
    if plan is None or mesh is None:
        return None
    return tensor_parallel.cache_layout(cfg, plan, mesh)


def _encdec_bundle(cfg: ModelConfig) -> ModelBundle:
    def forward(model, batch, *, impl="ref", remat="none", plan=None):
        logits = model(batch["frames"], batch["tokens"], impl=impl, remat=remat,
                       plan=plan)
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def prefill(model, caches, batch, *, impl=None, plan=None):
        enc_out = model.encode(batch["frames"], impl=impl, plan=plan)
        return model.decode(batch["tokens"], enc_out, caches=caches, impl=impl,
                            last_only=True, plan=plan)

    def decode_step(model, caches, batch, *, impl=None, plan=None):
        return model.decode(batch["tokens"], None, caches=caches,
                            start_pos=encdec.cache_start_pos(caches), impl=impl,
                            plan=plan)

    def init_caches(batch: int, max_len: int, enc_len: Optional[int] = None, *,
                    dtype=COMPUTE_DTYPE, device=None, tp_size: int = 1, plan=None,
                    mesh=None) -> dict:
        return encdec.init_encdec_caches(cfg, batch, max_len, enc_len or max_len,
                                         dtype=dtype, device=resolve_device(device),
                                         tp_size=tp_size,
                                         layout=_layout(cfg, plan, mesh))

    def param_specs(tp="model", tp_size=1):
        return encdec.encdec_specs(cfg, tp, tp_size)

    def cache_specs(plan=transformer.ShardingPlan(), tp_size=1):
        return encdec.encdec_cache_specs(cfg, plan, tp_size)

    init = _initialiser(lambda **kw: encdec.EncDec(cfg, **kw))
    return ModelBundle(cfg, init, forward, prefill, decode_step, init_caches,
                       param_specs, cache_specs)


def build(cfg: ModelConfig) -> ModelBundle:
    transformer.check_supported(cfg)
    if cfg.family == "encdec-audio":
        return _encdec_bundle(cfg)
    return _lm_bundle(cfg)
