"""Device time of every kernel that is not one of the federated kernels
(``server_apply`` and the uplink codecs), per local step of the profiled
round, in milliseconds: the client phase's cost of one AdamW step."""
FEDCORE = ("server_apply_kernel", "reduce_partials_kernel", "int8_quant_kernel",
           "int8_dequant_kernel", "topk_mask_ef_kernel", "sr_bf16_kernel")


def read(trace):
    steps = trace["local_steps"]
    client = [d for name, d in trace["kernels"] if not any(k in name for k in FEDCORE)]
    return 1e3 * sum(client) / steps if client else None
