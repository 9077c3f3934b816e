"""Numpy-only data streams, kept as a copy of ``repro.data`` so the port imports
nothing of the JAX package. The two must stay byte-for-byte equal in what they
generate (``tests/test_torch_data_sampler.py`` holds ``round_batches`` bitwise)."""
from repro_torch.data.partition import (  # noqa: F401
    PILE_CATEGORIES,
    build_client_streams,
    make_heterogeneous_partition,
    validate_disjoint,
    validation_stream,
)
from repro_torch.data.streams import (  # noqa: F401
    FileShardStream,
    MixedStream,
    SyntheticCategoryStream,
    TokenStream,
    round_batches,
)
