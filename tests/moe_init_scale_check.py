"""How far two attention routes of one random MoE model part, at the
reference's expert init scale and at the experts' fan-in (CPU, about a
minute; or on the card, deepseek-moe-16b whole).

    PYTHONPATH=src python tests/moe_init_scale_check.py [--layers 28]
    python tests/moe_init_scale_check.py --card      # on a GPU, ~5 min

deepseek-moe-16b's layer pattern at a CPU width (d 512, 64 experts top-6
+ 2 shared of width 256, dh 128): the port's seeded model once with its
routed experts drawn as the reference's ``_dense_init`` draws them
(1/sqrt(E): it takes ``shape[0]`` of an (E, d_in, d_out) tensor as the
fan-in) and once at 1/sqrt(d_in). The last position's logits of a
128-token prefill on the "auto" route (the kernels' plain versions on
the CPU) and on the "ref" route (the chunked attention), every MoE call of
the second pinned to the first's routing; the difference in bf16 ulps of
the largest |logit|.

``--card`` runs ``chip_smoke.py``'s lm_moe phase (deepseek-moe-16b whole,
its serving, compression and parity checks, every routing choice of the
plain paths pinned) with the routed experts redrawn as the reference
draws them, and prints the phase's lines and, where a check fails, the
failure. Not collected by pytest.
"""
import argparse
import dataclasses
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import RoutingPin  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.layers import dense_init_  # noqa: E402


def reference_scale_(model, seed: int = 1) -> None:
    """Redraw every routed expert's gate, up and down as the reference's
    ``_dense_init`` draws an (E, d_in, d_out) tensor: scale 1/sqrt(E)."""
    g = torch.Generator(device=model.embed.table.device).manual_seed(seed)
    for blk in model.layers:
        if hasattr(blk, "moe"):
            for w in (blk.moe.gate, blk.moe.up, blk.moe.down):
                dense_init_(w, g)


def spread(layers: int, reference_scale: bool, d: int = 512, experts: int = 64,
           ff: int = 256) -> dict:
    cfg = dataclasses.replace(
        ARCHS["deepseek-moe-16b"], n_layers=layers, d_model=d, n_heads=4,
        n_kv_heads=4, head_dim=128, d_ff=ff, dense_d_ff=4 * d, n_experts=experts,
        vocab_size=4096)
    bundle = models.build(cfg)
    model = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    if reference_scale:
        reference_scale_(model)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 4096, size=(2, 128)))
    pin = RoutingPin(pin_far=True)
    with torch.inference_mode():
        with pin.record():
            a, _ = model(toks, impl="auto", last_only=True)
        with pin.replay():
            b, _ = model(toks, impl="ref", last_only=True)
    top = float(a.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    return {"layers": layers, "scale": "reference" if reference_scale else "fan-in",
            "max_logit": round(top, 3), "ulps": round(float((a - b).abs().max()) / ulp, 2),
            "pinned": pin.pinned, "far": pin.far}


def card() -> int:
    """The lm_moe phase of chip_smoke.py at the reference's expert scale."""
    import chip_smoke

    real = models.build

    def build(cfg):
        bundle = real(cfg)

        def init(*a, **kw):
            model = bundle.init(*a, **kw)
            reference_scale_(model)
            return model
        return dataclasses.replace(bundle, init=init)

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's main
    torch.backends.cudnn.allow_tf32 = False
    models.build = build
    chip_smoke.phase_build()
    try:
        chip_smoke.phase_lm_family({}, "lm_moe")
    except AssertionError:
        traceback.print_exc(file=sys.stdout)
        print("reference scale: a check of the lm_moe phase failed", flush=True)
        return 1
    finally:
        models.build = real
    print("reference scale: every check of the lm_moe phase held", flush=True)
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--card", action="store_true",
                    help="deepseek-moe-16b whole through chip_smoke.py's lm_moe phase")
    args = ap.parse_args()
    if args.card:
        sys.exit(card())
    torch.set_num_threads(8)
    for reference_scale in (True, False):
        print(spread(args.layers, reference_scale), flush=True)


if __name__ == "__main__":
    main()
