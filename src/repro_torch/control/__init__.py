"""Closed-loop aggregation control: telemetry in, knob updates out
(``repro.control``'s copy)."""
from repro_torch.control.controller import (  # noqa: F401
    CONTROL_KEYS,
    FederationController,
    build_controller,
)
from repro_torch.control.policy import (  # noqa: F401
    ALPHA_MAX,
    ALPHA_STEP,
    CONTROL_POLICIES,
    CohortTuner,
    ControlPolicy,
    DEADLINE_STEP,
    KnobUpdate,
    StalenessGovernor,
    StaticPolicy,
)
