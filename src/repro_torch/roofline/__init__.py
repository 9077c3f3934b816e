from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineReport,
    analyze_compiled,
    measure,
    model_flops_6nd,
)
