"""Hold a card's IHTC + HAC fit against the JAX package's HAC.

    python3 chip_smoke.py --phases device,build,hac --save-hac FILE.npz  # on the GPU
    PYTHONPATH=src python tests/hac_reference_check.py FILE.npz          # here

Runs ``repro.cluster.hac.hac`` (the JAX package, on the CPU) and the
port's plain HAC on the fit's valid prototypes with their masses (ward,
k 3), compares both with the prototype labels the card gave, and prints
the fit's accuracy against the GMM's components (``gmm_sample(n,
seed=0)``). Equal prototype labels mean the reference composes the same
labels onto the n rows, so it reads the same accuracy. Not a pytest
module: the JAX HAC over ~2,500 prototypes takes about a minute.
"""
import json
import sys

import jax.numpy as jnp
import numpy as np
import torch

from repro.cluster.hac import hac as j_hac
from repro_torch.cluster.hac import hac as t_hac
from repro_torch.cluster.metrics import clustering_accuracy
from repro_torch.data import gmm_sample


def main(path: str) -> dict:
    z = np.load(path)
    keep = np.flatnonzero(z["valid"])
    p, w = z["protos"][keep], z["mass"][keep]
    card = z["proto_labels"][keep]
    ref = np.asarray(j_hac(jnp.asarray(p), 3, weights=jnp.asarray(w),
                           linkage="ward", impl="ref").labels)
    plain = t_hac(torch.from_numpy(p), 3, weights=torch.from_numpy(w),
                  linkage="ward", impl="ref").labels.numpy()
    _, comp = gmm_sample(int(z["n"]), seed=0)
    return {"prototypes": int(keep.size), "m": int(z["m"]),
            "jax_vs_card": float((ref == card).mean()),
            "port_plain_vs_card": float((plain == card).mean()),
            "card_accuracy": clustering_accuracy(comp, z["labels"], 3)}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
