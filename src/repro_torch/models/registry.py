"""Model registry: one bundle of callables per architecture, as
``repro.models.registry`` gives the serving engine and the tests.

    bundle = build(cfg)
    model = bundle.init(torch.Generator("cuda").manual_seed(0))
    caches = bundle.init_caches(batch, max_len, device=model_device)
    logits, caches = bundle.prefill(model, caches, {"tokens": prompts})
    logits, caches = bundle.decode_step(model, caches, {"tokens": tok[:, None]})

    model = bundle.init(gen, trainable=True)        # f32, requires_grad
    logits, aux = bundle.forward(model, {"tokens": tokens}, remat="block")

``init`` builds the model on ``device`` (default: the runtime config's,
"cuda" unless the caller asks for the CPU; a missing GPU raises). The
dense, MoE, SSM and hybrid families (``transformer.check_supported``);
``forward``'s aux is the MoE layers' load-balancing loss (0 without MoE).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.runtime import resolve_device


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., transformer.LM]
    forward: Callable[..., Any]       # (logits (b, s, V) f32, aux)
    prefill: Callable[..., Any]       # (logits (b, 1, V), caches)
    decode_step: Callable[..., Any]   # (logits (b, 1, V), caches)
    init_caches: Callable[..., dict]


def build(cfg: ModelConfig) -> ModelBundle:
    transformer.check_supported(cfg)

    def init(generator: Optional[torch.Generator] = None, *,
             device=None, trainable: bool = False) -> transformer.LM:
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model = transformer.LM(cfg, device=dev, trainable=trainable)
        return model.init_weights(generator)

    def forward(model, batch, *, impl="ref", remat="none"):
        logits, _, aux = model(batch["tokens"], impl=impl, remat=remat,
                               with_aux=True)
        return logits, aux

    def prefill(model, caches, batch, *, impl=None):
        return model(batch["tokens"], caches=caches, impl=impl, last_only=True)

    def decode_step(model, caches, batch, *, impl=None):
        start = transformer.cache_start_pos(caches)
        return model(batch["tokens"], caches=caches, start_pos=start, impl=impl)

    def init_caches(batch: int, max_len: int, *, dtype=COMPUTE_DTYPE,
                    device=None) -> dict:
        return transformer.init_lm_caches(cfg, batch, max_len, dtype=dtype,
                                          device=resolve_device(device))

    return ModelBundle(cfg, init, forward, prefill, decode_step, init_caches)
