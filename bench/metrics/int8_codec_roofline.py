"""The int8 uplink codec's share of its roofline: 5 bytes per element of the
(C, Np) cohort buffer for each launch of ``int8_quant`` and of
``int8_dequant`` (``reference/bytes.py``) over HBM's peak rate, divided by
the summed device time of those launches."""
from reference.bytes import int8_codec_bytes
from reference.peaks import HBM_BYTES_PER_S

KERNELS = ("int8_quant_kernel", "int8_dequant_kernel")


def read(trace):
    times = [d for name, d in trace["kernels"] if any(k in name for k in KERNELS)]
    if not times or sum(times) <= 0:
        return None
    least = len(times) * int8_codec_bytes(trace["np"], trace["clients"])
    return 100.0 * least / HBM_BYTES_PER_S / sum(times)
