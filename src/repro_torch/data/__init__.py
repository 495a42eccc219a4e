"""Data of the port: the paper's synthetic experiments, the point streams
of the clustering pipeline, the LM token pipeline and ITIS instance
selection (host numpy or seeded ``prng`` draws)."""
from repro_torch.data.synthetic import (  # noqa: F401
    PAPER_DATASETS,
    DatasetSpec,
    dataset_analog,
    gmm_sample,
)
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    PointStreamConfig,
    batch_iterator,
    make_batch,
    point_chunk,
    point_chunks,
    stream_to_mesh,
    synth_tokens,
)
