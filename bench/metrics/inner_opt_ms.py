"""Device time of one local step's optimiser (FedProx term, gradient clip,
AdamW), in milliseconds: a round's summed ``opt`` spans (CUDA events,
``repro_torch/obs/phases.py``) over their count, the median over the window's
rounds. None where the program has no such spans."""
import statistics


def read(trace):
    per_round = [1e3 * a["opt_dev_s"] / a["opt_n"]
                 for a in (s.get("attrs", {}) for s in trace["spans"] if s["name"] == "round")
                 if "opt_dev_s" in a and a.get("opt_n")]
    return statistics.median(per_round) if per_round else None
