"""Device time of a round's uplink codec, in milliseconds: the client side's
``encode`` span plus the server side's ``decode`` span (CUDA events,
``repro_torch/obs/phases.py``), the median over the window's rounds. None
where no codec decoded, or the program has no such spans."""
import statistics


def read(trace):
    per_round = [1e3 * (a["encode_dev_s"] + a["decode_dev_s"])
                 for a in (s.get("attrs", {}) for s in trace["spans"] if s["name"] == "round")
                 if "encode_dev_s" in a and "decode_dev_s" in a]
    return statistics.median(per_round) if per_round else None
