from repro_torch.metrics.fedmetrics import (  # noqa: F401
    MetricLogger,
    evaluate_perplexity,
    partial_progress_metrics,
    participation_metrics,
    perplexity,
    staleness_hist_counts,
    staleness_stats,
    uplink_round_metrics,
    wallclock_speedup,
)
