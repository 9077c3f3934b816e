"""The Photon federated pre-training engine: the synchronous path (flat or in
cohort tiles), the asynchronous buffered aggregator, the uplink codecs, the
Byzantine-robust defenses and the centralized baseline."""
from repro_torch.core.aggregator import (  # noqa: F401
    AGGREGATOR_SCHEMA_VERSION,
    Aggregator,
    AsyncBufferAggregator,
    AsyncFederationDriver,
    SyncAggregator,
    partial_progress_weights,
)
from repro_torch.core.async_agg import (  # noqa: F401
    AsyncAggConfig,
    admission_record,
    admit_delta,
    admit_deltas,
    flush_buffer,
    init_async_state,
    staleness_discount,
)
from repro_torch.core.compression import (  # noqa: F401
    UPLINK_SCHEMES,
    Bf16Codec,
    Codec,
    IdentityCodec,
    Int8Codec,
    TopKCodec,
    get_codec,
    uplink_bytes,
)
from repro_torch.core.federated import (  # noqa: F401
    FederatedConfig,
    SparseResidualStore,
    aggregation_metrics,
    apply_aggregate,
    apply_aggregate_partial,
    centralized_step,
    combine_tile_metrics,
    federated_round,
    federated_round_with_uplink,
    hierarchical_mean,
    init_centralized_state,
    init_federated_state,
    init_uplink_residuals,
    prng_key,
    run_client_tile,
    run_clients,
    tile_rng,
)
from repro_torch.core.inner_opt import InnerOptConfig, cosine_lr, global_norm  # noqa: F401
from repro_torch.core.outer_opt import OuterOptConfig  # noqa: F401
from repro_torch.core.robust import (  # noqa: F401
    CORRUPT_KINDS,
    ROBUST_RULES,
    RobustAggConfig,
    RobustState,
    corrupt_tree,
    make_byzantine_fn,
    make_robust_apply_fn,
    masked_median,
    median_clients,
    normclip_scale,
    sanitize_deltas,
    screen_cohort,
    trimmed_mean_clients,
)
from repro_torch.core.sampler import (  # noqa: F401
    STRAGGLER_PROFILES,
    AsyncTimeline,
    DispatchEvent,
    ParticipationConfig,
    ParticipationPlan,
    StragglerProfile,
    client_example_counts,
    client_speeds,
    dirichlet_popularity,
    markov_availability,
    participation_counts,
    plan_round,
    sample_round,
)
