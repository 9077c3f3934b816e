"""The CUDA ``server_apply`` kernel against its plain version, on the card.

Marked ``gpu``: each test skips where torch sees no CUDA device. On a machine
with one, run ``python -m pytest -q -m gpu tests/test_torch_gpu.py`` (builds the
kernel with nvcc first). Tolerances as in ``chip_smoke.py``: params and lanes
abs 1e-6·max(1, max|p|), norms rel 1e-5, and two launches bitwise equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import FederatedConfig, OuterOptConfig, init_federated_state  # noqa: E402
from repro_torch.kernels.fedcore import kernel as K  # noqa: E402
from repro_torch.kernels.fedcore import fused_apply_aggregate  # noqa: E402

pytestmark = pytest.mark.gpu


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and the CUDA toolkit")


def _inputs(opt, c, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = torch.randn((c, n), generator=gen, device="cuda") * 1e-2
    w = torch.rand(c, generator=gen, device="cuda")
    if c > 1:
        w[1] = 0.0  # a zero-weight client
    wn = w / w.sum()
    p = torch.randn(n, generator=gen, device="cuda") * 0.02
    g0 = torch.randn(n, generator=gen, device="cuda") * 5e-3
    lanes = {"fedavg": [], "fedmom": [g0], "fedadam": [0.1 * g0, 0.01 * g0.square()]}[opt]
    noise = torch.randn(n, generator=gen, device="cuda") * 1e-3
    return d, wn, p, lanes, noise


@pytest.mark.parametrize("opt", ["fedavg", "fedmom", "fedadam"])
@pytest.mark.parametrize("c", [1, 4, 5, 32])
@pytest.mark.parametrize("with_noise", [False, True], ids=["clean", "noise"])
def test_cuda_server_apply_matches_plain(opt, c, with_noise):
    _need_cuda()
    n = 8192 * 37 + 4 * 301  # several grid strides and a ragged tail
    d, wn, p, lanes, noise = _inputs(opt, c, n, seed=c)
    hyper = dict(lr=0.7, momentum=0.9, beta2=0.99, eps=1e-8,
                 bias_corr=(1.0 - 0.9 ** 2, 1.0 - 0.99 ** 2) if opt == "fedadam" else None,
                 noise=noise if with_noise else None)
    outs = []
    for fn in (K.server_apply, K.server_apply, K.server_apply_plain):
        pp, ll = p.clone(), [x.clone() for x in lanes]
        norms = fn(d, wn, pp, ll, opt=opt, **hyper)
        torch.cuda.synchronize()
        outs.append((pp, ll, torch.stack([norms[0], norms[1], *norms[2]])))
    (pk, lk, nk), (pk2, lk2, nk2), (pp, lp, npl) = outs
    assert torch.equal(nk, nk2) and torch.equal(pk, pk2)
    assert all(torch.equal(a, b) for a, b in zip(lk, lk2))
    assert float((pk - pp).abs().max()) <= 1e-6 * max(1.0, float(pp.abs().max()))
    for a, b in zip(lk, lp):
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(b.abs().max()))
    rel = ((nk.double() - npl.double()).abs() / npl.double().abs()).max()
    assert float(rel) <= 1e-5


def test_cuda_wrapper_refuses_instead_of_falling_back():
    _need_cuda()
    d, wn, p, _, _ = _inputs("fedavg", 4, 8192, seed=0)
    before = K.server_apply.launches
    with pytest.raises(ValueError):
        K.server_apply(d, wn, p.to(torch.bfloat16), [], opt="fedavg", lr=1.0)
    with pytest.raises(ValueError):
        K.server_apply(torch.zeros((33, 8192), device="cuda"), torch.zeros(33, device="cuda"),
                       p, [], opt="fedavg", lr=1.0)
    assert K.server_apply.launches == before


def test_fused_apply_aggregate_on_cuda_launches_the_kernel():
    _need_cuda()
    fed = FederatedConfig(clients_per_round=3, local_steps=1,
                          outer=OuterOptConfig(name="fedadam", lr=0.1))
    params = {"a": torch.randn(7, 5, device="cuda"), "b": [torch.randn(33, device="cuda")]}
    state = init_federated_state(fed, params, np.asarray([0, 1], np.uint32))
    deltas = {"a": torch.randn(3, 7, 5, device="cuda"), "b": [torch.randn(3, 33, device="cuda")]}
    before = K.server_apply.launches
    new_state, metrics = fused_apply_aggregate(
        fed, state, deltas, client_weights=torch.tensor([1.0, 0.0, 2.0], device="cuda")
    )
    assert K.server_apply.launches == before + 1
    assert new_state["params"]["a"].shape == (7, 5)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
