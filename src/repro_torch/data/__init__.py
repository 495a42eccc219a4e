"""Synthetic data of the paper's experiments and point streams (host
numpy, seeded)."""
from repro_torch.data.synthetic import (  # noqa: F401
    PAPER_DATASETS,
    DatasetSpec,
    dataset_analog,
    gmm_sample,
)
from repro_torch.data.pipeline import (  # noqa: F401
    PointStreamConfig,
    point_chunk,
    point_chunks,
)
