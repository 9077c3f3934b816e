"""Device time of a round's server phase (the decode where a codec runs,
packing, ``server_apply``, the outer update, the aggregation metrics), in
milliseconds: the ``server`` span (CUDA events, ``repro_torch/obs/phases.py``),
the median over the window's rounds. None where the program has no such span."""
import statistics


def read(trace):
    per_round = [1e3 * a["server_dev_s"]
                 for a in (s.get("attrs", {}) for s in trace["spans"] if s["name"] == "round")
                 if "server_dev_s" in a]
    return statistics.median(per_round) if per_round else None
