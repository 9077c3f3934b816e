"""``server_apply``'s share of its roofline: the least bytes one launch must
move (``reference/bytes.py``) over HBM's peak rate, divided by the device
time of its two kernels (the pass and the reduction of its partial sums)."""
from reference.bytes import server_apply_bytes
from reference.peaks import HBM_BYTES_PER_S


def read(trace):
    launches = sum(1 for name, _ in trace["kernels"] if "server_apply_kernel" in name)
    t = sum(d for name, d in trace["kernels"]
            if "server_apply_kernel" in name or "reduce_partials_kernel" in name)
    if not launches or t <= 0:
        return None
    least = launches * server_apply_bytes(trace["np"], trace["clients"], trace["outer"])
    return 100.0 * least / HBM_BYTES_PER_S / t
