"""Device time of one local step's forward and backward, every micro-batch
included, in milliseconds: a round's summed ``fwd_bwd`` spans (CUDA events at
each span's ends, ``repro_torch/obs/phases.py``) over their count, the median
over the window's rounds. None where the program has no such spans."""
import statistics


def read(trace):
    per_round = [1e3 * a["fwd_bwd_dev_s"] / a["fwd_bwd_n"]
                 for a in (s.get("attrs", {}) for s in trace["spans"] if s["name"] == "round")
                 if "fwd_bwd_dev_s" in a and a.get("fwd_bwd_n")]
    return statistics.median(per_round) if per_round else None
