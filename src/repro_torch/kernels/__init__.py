"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version."""


def all_kernels() -> dict:
    """Every kernel wrapper, by name; each counts its launches in ``.launches``
    (importing the wrappers builds nothing)."""
    from repro_torch.kernels.fedcore import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_decode import kernel as DK
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_scan import kernel as SK

    return {**K.KERNELS, **SK.KERNELS, **FK.KERNELS, **DK.KERNELS, **RK.KERNELS}
