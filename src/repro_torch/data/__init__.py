"""Synthetic data of the paper's experiments (host numpy, seeded)."""
from repro_torch.data.synthetic import (  # noqa: F401
    PAPER_DATASETS,
    DatasetSpec,
    dataset_analog,
    gmm_sample,
)
