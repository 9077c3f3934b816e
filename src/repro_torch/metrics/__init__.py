from repro_torch.metrics.fedmetrics import (  # noqa: F401
    MetricLogger,
    evaluate_perplexity,
    histogram_quantile,
    partial_progress_metrics,
    participation_metrics,
    perplexity,
    staleness_hist_counts,
    staleness_stats,
    uplink_round_metrics,
    wallclock_speedup,
    window_concat,
    window_mean,
)
