from repro_torch.metrics.fedmetrics import (  # noqa: F401
    MetricLogger,
    evaluate_perplexity,
    partial_progress_metrics,
    participation_metrics,
    perplexity,
    uplink_round_metrics,
)
