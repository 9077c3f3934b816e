"""Host synchronisations a round makes: the round's ``host_syncs``, counted
by ``torch.cuda.set_sync_debug_mode("warn")`` inside the program's phase
spans (``repro_torch/obs/phases.py``), less the traced readout's own reads;
the median over the window's rounds. None where the program counts none."""
import statistics


def read(trace):
    per_round = [a["host_syncs"]
                 for a in (s.get("attrs", {}) for s in trace["spans"] if s["name"] == "round")
                 if "host_syncs" in a]
    return float(statistics.median(per_round)) if per_round else None
