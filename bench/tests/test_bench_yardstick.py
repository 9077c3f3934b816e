"""The frozen yardstick: bytes, FLOPs, parameter counts, the seeded weights,
the per-layer readers and the reduction of profiler events (CPU only)."""
import math
import re
from types import SimpleNamespace

import pytest
import torch

from harness import spec
from harness.program import get
from harness.trace import reduce_events
from reference import bytes as ybytes, flops, layout
from reference.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def _config(name):
    return spec.load_json(spec.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("np_, clients, outer, ms", [
    (74_104_832, 4, "fedavg", 0.531),  # photon-75m's sync round, the kernel table's row 1
    (1_344_053_248, 1, "fedmom", 8.024),  # mamba2-1.3b's host-mesh step
])
def test_server_apply_bytes_give_the_kernel_tables_bounds(np_, clients, outer, ms):
    assert round(ybytes.server_apply_bytes(np_, clients, outer) / HBM_BYTES_PER_S * 1e3, 3) == ms


def test_int8_codec_bytes_give_the_kernel_tables_bound():
    assert round(ybytes.int8_codec_bytes(1_344_053_248, 1) / HBM_BYTES_PER_S * 1e3, 3) == 2.006


@pytest.mark.parametrize("name, n, n_padded, np_", [
    ("photon-1.3b", 1_311_313_920, 1_311_444_992, 1_311_449_088),
    ("mamba2-1.3b", 1_343_740_928, 1_344_052_224, 1_344_053_248),
])
def test_parameter_counts_are_the_ports(name, n, n_padded, np_):
    from repro_torch.models.model import build_model

    cfg = _config(name)
    port = build_model(name).abstract_params()
    assert sum(get(port, leaf.name).numel() for leaf in layout.leaves(cfg)) == n_padded
    assert layout.n_params(cfg, padded=True) == n_padded
    assert layout.n_params(cfg) == n
    assert ybytes.model_flat_len(cfg) == np_


@pytest.mark.parametrize("name", ["photon-1.3b", "mamba2-1.3b"])
def test_layout_is_the_ports_tree_leaf_for_leaf(name):
    from repro_torch.models.model import build_model
    from repro_torch.tree import flatten_with_paths

    cfg = _config(name)
    def dotted(path):
        return ".".join(a or b for a, b in re.findall(r"\['([^']*)'\]|\[(\d+)\]", path))

    port = {dotted(p): tuple(t.shape)
            for p, t in flatten_with_paths(build_model(name).abstract_params())}
    assert port == {leaf.name: leaf.shape for leaf in layout.leaves(cfg)}


def test_train_flops_are_six_n_t_plus_causal_attention():
    photon, mamba = _config("photon-1.3b"), _config("mamba2-1.3b")
    t = 65_536
    assert flops.train_flops(photon, t, 2048) == (6 * 1_311_313_920 + 6 * 24 * 2048 * 2048) * t
    assert flops.train_flops(mamba, t, 2048) == 6 * 1_343_740_928 * t


def test_seeded_weights_repeat_and_differ_by_seed():
    cfg = dict(_config("mamba2-1.3b"), n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
               vocab_size=512)
    big = 2**31 + 12345
    a, b = layout.make_params(cfg, big, "cpu"), layout.make_params(cfg, big, "cpu")
    c = layout.make_params(cfg, big + 1, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed"], c["embed"])
    a_log = a["segments.0.pos0.mixer.A_log"]
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= math.log(16.0) + 1e-6
    assert torch.equal(a["segments.0.pos0.mixer.D_skip"], torch.ones(2, 8))


def _trace(**kw):
    base = dict(kernels=[], spans=[], busy_s=0.0, window_s=1.0, local_steps=8, model_flops=0.0,
                np=1_344_053_248, clients=2, outer="fedmom")
    return dict(base, **kw)


def test_roofline_readers_use_the_frozen_bytes_and_stay_silent_without_their_kernel():
    s = ybytes.server_apply_bytes(1_344_053_248, 2, "fedmom") / HBM_BYTES_PER_S
    tr = _trace(kernels=[("server_apply_kernel(float const*)", 0.8 * s),
                         ("reduce_partials_kernel(double const*)", 0.2 * s / 0.8 * 0.25),
                         ("int8_quant_kernel", 0.02), ("int8_dequant_kernel", 0.03),
                         ("ampere_sgemm", 1.0)])
    got = spec.metric_reader("server_apply_roofline")(tr)
    assert got == pytest.approx(100.0 * s / (0.8 * s + 0.0625 * s))
    q = ybytes.int8_codec_bytes(1_344_053_248, 2) / HBM_BYTES_PER_S
    assert spec.metric_reader("int8_codec_roofline")(tr) == pytest.approx(100.0 * 2 * q / 0.05)
    assert spec.metric_reader("int8_codec_roofline")(_trace()) is None
    assert spec.metric_reader("server_apply_roofline")(_trace()) is None


def test_client_step_idle_and_step_mfu_readers():
    tr = _trace(kernels=[("server_apply_kernel", 0.5), ("sm90_gemm", 2.0), ("add", 2.0)],
                busy_s=3.0, window_s=4.0, model_flops=BF16_FLOPS, spans=[
                    {"name": "round", "dur": 3.0}, {"name": "round", "dur": 5.0},
                    {"name": "round", "dur": 4.0}, {"name": "other", "dur": 9.0}])
    assert spec.metric_reader("client_device_ms_per_step")(tr) == pytest.approx(500.0)
    assert spec.metric_reader("device_idle_pct.train")(tr) == pytest.approx(25.0)
    assert spec.metric_reader("step_mfu")(tr) == pytest.approx(25.0)
    assert spec.metric_reader("round_span_s")(tr) == 4.0
    assert spec.metric_reader("round_span_s")(_trace()) is None
    assert spec.metric_reader("step_mfu")(_trace()) is None


class _Ev(SimpleNamespace):
    def device_type(self):
        return self.dev

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def duration_ns(self):
        return self.b - self.a

    def linked_correlation_id(self):
        return self.link

    def correlation_id(self):
        return self.corr

    def is_async(self):
        return False

    def is_user_annotation(self):
        return self.label.startswith("bench::")

    def name(self):
        return self.label


def test_reduce_events_unions_device_time_and_names_gaps_by_host_op():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _Ev(dev=cpu, a=0, b=100, link=0, corr=1, label="aten::mm"),
        _Ev(dev=cpu, a=100, b=400, link=0, corr=2, label="bench::round_tokens"),
        _Ev(dev=cpu, a=150, b=200, link=0, corr=3, label="aten::rand"),
        _Ev(dev=gpu, a=10, b=60, link=1, corr=0, label="sm90_gemm"),
        _Ev(dev=gpu, a=50, b=90, link=1, corr=0, label="sm90_gemm"),
        _Ev(dev=gpu, a=190, b=210, link=3, corr=0, label="philox"),
        _Ev(dev=gpu, a=300, b=310, link=9, corr=0, label="server_apply_kernel"),
        _Ev(dev=gpu, a=100, b=400, link=2, corr=0, label="bench::round_tokens"),  # a range
    ]
    out = reduce_events(events, window_s=1e-6)
    assert out["busy_s"] == pytest.approx(110e-9)
    assert out["breakdown"]["device_ops"][0] == ["aten::mm", pytest.approx(90e-9)]
    assert ["server_apply_kernel", pytest.approx(10e-9)] in out["breakdown"]["device_ops"]
    gaps = dict((k, v) for k, v in out["breakdown"]["idle_gaps"])
    # 90..190: midpoint 140 inside bench::round_tokens only; 210..300: midpoint 255, same
    assert gaps == {"bench::round_tokens": pytest.approx(190e-9)}
