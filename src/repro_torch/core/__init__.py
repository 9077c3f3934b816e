"""The Photon federated pre-training engine: the synchronous path."""
from repro_torch.core.aggregator import (  # noqa: F401
    AGGREGATOR_SCHEMA_VERSION,
    SyncAggregator,
    partial_progress_weights,
)
from repro_torch.core.federated import (  # noqa: F401
    FederatedConfig,
    aggregation_metrics,
    apply_aggregate,
    federated_round,
    init_federated_state,
    prng_key,
    run_clients,
)
from repro_torch.core.inner_opt import InnerOptConfig, cosine_lr  # noqa: F401
from repro_torch.core.outer_opt import OuterOptConfig  # noqa: F401
from repro_torch.core.sampler import (  # noqa: F401
    STRAGGLER_PROFILES,
    ParticipationConfig,
    ParticipationPlan,
    StragglerProfile,
    plan_round,
)
