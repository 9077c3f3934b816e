"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where torch sees no CUDA device. On a machine
with one, run ``python -m pytest -q -m gpu tests/test_torch_gpu.py`` (builds the
kernels with nvcc first). ``server_apply``, as in ``chip_smoke.py``: params and
lanes abs 1e-6·max(1, max|p|), norms rel 1e-5, and two launches bitwise
equal, for cohorts up to 64 clients (chunks of 32). The four codec kernels:
bitwise equal to their plain versions, ties, signed zeros, half-quanta and
non-finite values included (int8_dequant also with a NaN, +inf or ×64 scale
plane; server_apply on a NaN, +inf or ×64 lane, NaN at weight 0 included:
non-finite values at the plain version's positions); a one-tile round is
bitwise the flat round; the async driver launches each fedcore kernel
exactly as often as it counts flushes, client phases and admissions; the
staleness governor's flushes run server_apply at the widths it picks; a
socket run (worker threads on the card) is bitwise the in-process run; the
heterogeneous_federation example's fused top-k rounds launch server_apply
and topk_mask_ef once a round and nothing else. The SSD
scan, flash attention and flash decode: y within one bf16 ulp of the plain
version (f32: 1e-5·max|y|). The causal ALiBi training pair: o and lse within
that tolerance of the float32 oracle, each gradient within 1.25 times the
error of the plain bf16 core (``sdpa_chunked``) against the same oracle, the
same bits twice, no host sync across a photon layer, a tiny
photon's loss and grads through the kernel within the bf16 model tolerance of
the plain core's, and a traced round's route counters. RMSNorm: bf16 within one bf16 ulp, f32 within
2e-6·|y|. Flash decode and RMSNorm also give the same bits on two launches,
and raise rather than fall back when their kernel cannot be built. The
stacked-layer backward at photon-1.3b's widths fills no stack-sized tensor
and peaks no higher than per-layer slicing of the stack.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import FederatedConfig, OuterOptConfig, init_federated_state  # noqa: E402
from repro_torch.core.aggregator import ASYNC_KERNEL_COUNTERS  # noqa: E402
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
@pytest.mark.parametrize("c", [1, 4, 5, 32, 40, 64])
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
    with pytest.raises(ValueError):  # Np not a multiple of 4
        K.server_apply(d[:, :8190].contiguous(), wn, p[:8190].contiguous(), [],
                       opt="fedavg", lr=1.0)
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


# ---------------------------------------------------------------------------
# The uplink codec kernels
# ---------------------------------------------------------------------------

C_CODEC, N_CODEC = 3, 8192 * 5  # several rows, grid strides


def _specials():
    """Values the codecs must get right bit for bit: signed zeros, ±inf, NaNs
    (one with payload only in the low 16 bits), the largest float, tiny
    subnormals."""
    bits = np.asarray([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                       0xFFC00001, 0x7F800001, 0x7F7FFFFF, 0xFF7FFFFF, 0x00000001,
                       0x807FFFFF, 0x3F808000, 0xBF808000, 0x3F80FFFF, 0x7F80FFFF,
                       0xFFFFFFFF], np.uint32)
    return torch.from_numpy(bits.view(np.float32).copy())


def test_cuda_topk_mask_ef_matches_plain_bitwise():
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    xf = torch.randn((C_CODEC, N_CODEC), generator=gen, device="cuda")
    xf[:, :64] = torch.round(xf[:, :64] * 4) / 4  # many exact ties
    xf[0, 64:80] = _specials().cuda()
    xf[1, 100] = -0.0
    # the thresholds sit on tied values, so ties are kept and dropped alike
    thresh = torch.stack([torch.tensor(0.75, device="cuda"), xf[1, :64].abs().max(),
                          torch.tensor(0.0, device="cuda")]).float()
    before = K.topk_mask_ef.launches
    kept, resid = K.topk_mask_ef(xf, thresh)
    torch.cuda.synchronize()
    assert K.topk_mask_ef.launches == before + 1
    kp, rp = K.topk_mask_ef_plain(xf, thresh)
    assert torch.equal(kept.view(torch.int32), kp.view(torch.int32))
    assert torch.equal(resid.view(torch.int32), rp.view(torch.int32))


def test_cuda_sr_bf16_matches_plain_bitwise():
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((C_CODEC, N_CODEC), generator=gen, device="cuda")
    x[0, :16] = _specials().cuda()
    noise = torch.randint(0, 1 << 16, x.shape, generator=gen, device="cuda", dtype=torch.int32)
    noise[0, :4] = 0xFFFF  # carries into the high half
    before = K.sr_bf16.launches
    out = K.sr_bf16(x, noise)
    torch.cuda.synchronize()
    assert K.sr_bf16.launches == before + 1
    assert torch.equal(out.view(torch.int16), K.sr_bf16_plain(x, noise).view(torch.int16))


def _int8_case(gen):
    # leaves of ragged sizes (offsets not multiples of 4) and a padded tail
    offsets = (0, 5, 4101, 4102, 12000, 30001)
    x = torch.randn((C_CODEC, N_CODEC), generator=gen, device="cuda")
    x[:, offsets[-1]:] = 0.0
    scales = torch.rand((C_CODEC, len(offsets) - 1), generator=gen, device="cuda") + 0.1
    # exact half-quanta: round half to even decides
    x[:, 5:133] = scales[:, 1:2] * (torch.arange(128, device="cuda") - 63.5)
    x[2, 7] = float("nan")
    x[2, 8] = float("inf")
    return x, scales, offsets


def test_cuda_int8_quant_and_dequant_match_plain_bitwise():
    _need_cuda()
    x, scales, offsets = _int8_case(torch.Generator(device="cuda").manual_seed(3))
    q0, d0 = K.int8_quant.launches, K.int8_dequant.launches
    q = K.int8_quant(x, scales, offsets)
    out = K.int8_dequant(q, scales, offsets)
    torch.cuda.synchronize()
    assert (K.int8_quant.launches, K.int8_dequant.launches) == (q0 + 1, d0 + 1)
    assert torch.equal(q, K.int8_quant_plain(x, scales, offsets))
    assert torch.equal(out.view(torch.int32),
                       K.int8_dequant_plain(q, scales, offsets).view(torch.int32))


def _hold_nonfinite(got, want, atol=0.0, rtol=0.0):
    """NaN and ±inf (with its sign) at the same positions; finite values
    within atol + rtol·|want|."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    assert bool(((got[fin] - want[fin]).abs() <= atol + rtol * want[fin].abs()).all())


@pytest.mark.parametrize("kind,weights", [("nan", (1.0, 1.0)), ("inf", (1.0, 1.0)),
                                          ("x64", (1.0, 1.0)), ("nan", (1.0, 0.0))],
                         ids=["nan", "inf", "x64", "nan-weight-0"])
def test_cuda_server_apply_on_a_poisoned_lane_matches_plain(kind, weights):
    """A buffer that admitted a Byzantine delta: 0·NaN = NaN, so a NaN lane
    at weight 0 poisons the update in the plain version, and must in the
    kernel too (a kernel that skipped a zero-weight lane would hide it)."""
    _need_cuda()
    d, _, p, _, _ = _inputs("fedavg", 2, 8192 * 5 + 4 * 17, seed=11)
    d[1] = d[1] * 64.0 if kind == "x64" else torch.full_like(
        d[1], float("nan") if kind == "nan" else float("inf"))
    w = torch.tensor(weights, device="cuda")
    outs = []
    for fn in (K.server_apply, K.server_apply_plain):
        pp = p.clone()
        norms = fn(d, w / w.sum(), pp, [], opt="fedavg", lr=1.0)
        torch.cuda.synchronize()
        outs.append((pp, torch.stack([norms[0], norms[1], *norms[2]])))
    (pk, nk), (pp, npl) = outs
    fin = torch.isfinite(pp)
    _hold_nonfinite(pk, pp, atol=1e-6 * max(1.0, float(pp[fin].abs().max()) if bool(fin.any())
                                            else 1.0))
    _hold_nonfinite(nk, npl, rtol=1e-5)
    if kind != "x64":
        assert not bool(torch.isfinite(pk).any())


@pytest.mark.parametrize("kind", ["nan", "inf", "x64"])
def test_cuda_int8_dequant_of_a_poisoned_scale_plane_is_bitwise_plain(kind):
    _need_cuda()
    x, scales, offsets = _int8_case(torch.Generator(device="cuda").manual_seed(5))
    q = K.int8_quant(x, scales, offsets)
    s = scales * 64.0 if kind == "x64" else torch.full_like(
        scales, float("nan") if kind == "nan" else float("inf"))
    got = K.int8_dequant(q, s.contiguous(), offsets)
    want = K.int8_dequant_plain(q, s.contiguous(), offsets)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_one_tile_round_is_bitwise_the_flat_round():
    """Reduced photon-75m on the card: K = 4 in one tile of 4 against the
    flat round, two rounds, loss and params bitwise; no kernel launches."""
    _need_cuda()
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    base = ["--reduced", "--rounds", "2", "--local-steps", "2", "--clients", "4",
            "--population", "8", "--seq-len", "64", "--device", "cuda"]
    counts = {n: f.launches for n, f in K.KERNELS.items()}
    flat = T.run(T.parse_args(base))
    tiled = T.run(T.parse_args(base + ["--cohort-tile", "4"]))
    assert counts == {n: f.launches for n, f in K.KERNELS.items()}
    assert [r["train_loss"] for r in flat["history"]] == \
        [r["train_loss"] for r in tiled["history"]]
    for a, b in zip(tree_leaves(flat["state"]["params"]), tree_leaves(tiled["state"]["params"])):
        assert torch.equal(a, b)


def test_cuda_codec_wrappers_refuse_instead_of_falling_back():
    _need_cuda()
    x = torch.randn((2, 64), device="cuda")
    t = torch.ones(2, device="cuda")
    s = torch.ones((2, 1), device="cuda")
    z = torch.zeros((2, 64), dtype=torch.int32, device="cuda")
    counts = {n: f.launches for n, f in K.KERNELS.items()}
    bad = [
        lambda: K.topk_mask_ef(x.double(), t),  # dtype
        lambda: K.topk_mask_ef(x, t[:1]),  # threshold per row
        lambda: K.topk_mask_ef(x[:, :62].contiguous(), t),  # row length % 4
        lambda: K.topk_mask_ef(x.t().contiguous().t(), t),  # not contiguous
        lambda: K.topk_mask_ef(x, t.cpu()),  # mixed devices
        lambda: K.sr_bf16(x, z.long()),  # noise dtype
        lambda: K.sr_bf16(x[:, 1:61], z[:, 1:61]),  # not contiguous / misaligned
        lambda: K.int8_quant(x, s, (0, 65)),  # offsets past the row
        lambda: K.int8_quant(x, s[:, :0], (0,)),  # no leaves
        lambda: K.int8_dequant(x, s, (0, 64)),  # q must be int8
        lambda: K.int8_quant(x[:, :62].contiguous(), s, (0, 62)),  # row length % 4
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert counts == {n: f.launches for n, f in K.KERNELS.items()}


@pytest.mark.parametrize("scheme", ["topk", "bf16", "int8"])
def test_fused_codecs_on_cuda_launch_the_kernels_and_match_the_cpu(scheme):
    _need_cuda()
    from repro_torch.core.compression import get_codec, init_error_feedback
    from repro_torch.core.federated import uplink_keys
    from repro_torch.tree import tree_leaves, tree_map

    codec = get_codec(scheme, 0.1, fused=True)
    gen = torch.Generator().manual_seed(4)
    deltas = {"a": torch.randn(3, 7, 5, generator=gen),
              "b": [torch.randn(3, 33, generator=gen), torch.randn(3, 2, 2, generator=gen)]}
    res = tree_map(lambda x: 0.1 * x, init_error_feedback(deltas)) if codec.stateful else None
    rngs = uplink_keys({"rng": np.asarray([0, 5], np.uint32), "round": 1}, 3)
    if codec.needs_rng:  # the same bits on both devices
        noise = codec.cohort_noise(tree_leaves(deltas), rngs)
        codec.cohort_noise = lambda leaves, rngs: [z.to(leaves[0].device) for z in noise]
    else:
        rngs = None
    cpu = codec.encode_cohort(deltas, res, rngs)
    on = lambda t: tree_map(lambda x: x.cuda(), t) if t is not None else None  # noqa: E731
    counts = {n: f.launches for n, f in K.KERNELS.items()}
    gpu = codec.encode_cohort(on(deltas), on(res), rngs)
    dec = codec.decode_cohort(gpu[0])
    torch.cuda.synchronize()
    launched = {n for n, f in K.KERNELS.items() if f.launches != counts[n]}
    want = {"topk": {"topk_mask_ef"}, "bf16": {"sr_bf16"},
            "int8": {"int8_quant", "int8_dequant"}}[scheme]
    assert launched == want
    for a, b in zip(tree_leaves([cpu[0], cpu[1] or []]), tree_leaves([gpu[0], gpu[1] or []])):
        assert torch.equal(_bits(a), _bits(b.cpu()))
    for a, b in zip(tree_leaves(codec.decode_cohort(cpu[0])), tree_leaves(dec)):
        assert torch.equal(_bits(a), _bits(b.cpu()))


@pytest.mark.parametrize("uplink", sorted(ASYNC_KERNEL_COUNTERS))
def test_async_driver_on_cuda_launches_what_it_counts(uplink):
    _need_cuda()
    from repro_torch.launch import train as T

    args = T.parse_args(["--reduced", "--rounds", "2", "--local-steps", "2", "--clients", "4",
                         "--population", "8", "--seq-len", "64", "--fused-server",
                         "--aggregation", "async", "--straggler-profile", "heavy",
                         "--dropout-rate", "0.1", "--uplink", uplink, "--device", "cuda"])
    for f in K.KERNELS.values():
        f.launches = 0
    out = T.run(args)
    torch.cuda.synchronize()
    drv = out["driver"]
    assert drv.n_flushes == args.rounds and drv.n_admissions >= 2 * args.rounds
    counters = ASYNC_KERNEL_COUNTERS[uplink]
    want = {name: getattr(drv, counters[name]) if name in counters else 0 for name in K.KERNELS}
    assert {n: f.launches for n, f in K.KERNELS.items()} == want
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_ppl"])
               for r in out["history"])


def _reduced_async(extra):
    from repro_torch.launch import train as T

    return T.parse_args(["--reduced", "--local-steps", "2", "--clients", "4", "--population", "8",
                         "--seq-len", "64", "--fused-server", "--aggregation", "async",
                         "--straggler-profile", "heavy", "--eval-batches", "1",
                         "--device", "cuda"] + extra)


def test_governed_async_run_on_cuda_flushes_at_the_widths_the_governor_picks():
    """``--control staleness``: server_apply runs once per flush at M = 2, 1,
    2, 4, 4 (the widths the governor picks on the CPU), each launch counted."""
    _need_cuda()
    import repro_torch.kernels.fedcore as F
    from repro_torch.launch import train as T

    widths, orig = [], F.fused_apply_aggregate

    def recorded(fed, state, deltas, client_weights=None, codec=None):
        widths.append(int(client_weights.shape[0]))  # the buffer's M
        return orig(fed, state, deltas, client_weights=client_weights, codec=codec)

    F.fused_apply_aggregate = recorded
    try:
        for f in K.KERNELS.values():
            f.launches = 0
        out = T.run(_reduced_async(["--rounds", "5", "--control", "staleness",
                                    "--control-target", "0.5", "--uplink", "int8"]))
    finally:
        F.fused_apply_aggregate = orig
    torch.cuda.synchronize()
    drv = out["driver"]
    assert widths == [2, 1, 2, 4, 4]
    assert K.server_apply.launches == drv.n_flushes == 5
    assert K.int8_quant.launches == drv.n_client_phases
    assert K.int8_dequant.launches == drv.n_admissions == 13


@pytest.mark.parametrize("uplink", ["float32", "int8"])
def test_socket_run_on_cuda_is_bitwise_the_in_process_run(uplink):
    """Worker threads on the card against an in-card server: rows and params
    bitwise the in-process driver's; int8_quant once per executed assignment,
    int8_dequant once per admission, server_apply once per flush."""
    _need_cuda()
    import threading

    from repro_torch.launch import train as T
    from repro_torch.runtime import Backoff, ClientWorker
    from repro_torch.tree import tree_leaves

    args = ["--rounds", "3", "--uplink", uplink]
    ref = T.run(_reduced_async(args))
    import socket as so

    with so.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    base = args + ["--runtime", "sockets", "--port", port]
    done = {}

    class Quick(ClientWorker):
        def __init__(self, *a, **kw):
            super().__init__(*a, backoff=Backoff(give_up_after=5.0), **kw)

    saved, T.ClientWorker = T.ClientWorker, Quick
    threads = [threading.Thread(target=lambda n=n: done.setdefault(n, T.run(_reduced_async(
        base + ["--role", "client", "--worker-id", n]))), daemon=True) for n in ("w0", "w1")]
    try:
        for t in threads:
            t.start()
        for f in K.KERNELS.values():
            f.launches = 0
        out = T.run(_reduced_async(base + ["--role", "server"]))
        for t in threads:
            t.join(timeout=60)
    finally:
        T.ClientWorker = saved
    torch.cuda.synchronize()
    strip = lambda h: [{k: v for k, v in r.items() if k != "seconds"} for r in h]  # noqa: E731
    assert strip(out["history"]) == strip(ref["history"])
    for a, b in zip(tree_leaves(out["state"]["params"]), tree_leaves(ref["state"]["params"])):
        assert torch.equal(a, b)
    drv = out["driver"]
    executed = sum(r["worker"].n_client_phases for r in done.values())
    assert K.server_apply.launches == drv.n_flushes == 3
    if uplink == "int8":
        assert K.int8_quant.launches == executed and K.int8_dequant.launches == drv.n_admissions


def test_heterogeneous_federation_example_on_cuda_launches_once_per_round(monkeypatch):
    """The example's sync ``--fused-server --uplink topk`` run: server_apply
    and topk_mask_ef once per round, no other kernel, finite params; each
    topk_mask_ef launch bitwise its plain version on the inputs it was given."""
    _need_cuda()
    from repro_torch.examples import heterogeneous_federation
    from repro_torch.kernels.fedcore import ops
    from repro_torch.tree import tree_leaves

    given = []

    class Recorded:  # ops.K, with topk_mask_ef's inputs kept
        def __getattr__(self, name):
            return getattr(K, name)

        @staticmethod
        def topk_mask_ef(x, thresh):
            given.append((x.clone(), thresh.clone()))
            return K.topk_mask_ef(x, thresh)

    monkeypatch.setattr(ops, "K", Recorded())
    for f in K.KERNELS.values():
        f.launches = 0
    agg = heterogeneous_federation.main(["--fused-server", "--uplink", "topk", "--rounds", "2",
                                         "--device", "cuda"])
    torch.cuda.synchronize()
    assert {n: f.launches for n, f in K.KERNELS.items()} == {
        n: 2 if n in ("server_apply", "topk_mask_ef") else 0 for n in K.KERNELS}
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(agg.state["params"]))
    assert len(given) == 2
    for x, thresh in given:
        for a, b in zip(K.topk_mask_ef(x, thresh), K.topk_mask_ef_plain(x, thresh)):
            assert torch.equal(_bits(a), _bits(b))


def _bits(t):
    """The tensor's bit patterns (so -0.0 and +0.0, and NaN payloads, differ)."""
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


# ---------------------------------------------------------------------------
# The SSD chunk-scan kernel
# ---------------------------------------------------------------------------

#: (B, S, nh, hd, G, ds, chunk): small shapes with ragged tiles and groups, the
#: reduced mamba2-1.3b layer and mamba2-1.3b's full prefill layer, then shapes
#: inside the tensor-core kernel's domain (bf16 there; f32 takes the CUDA
#: cores): groups of 2, several chunks, hd 128, ds 64
SSD_SHAPES = [
    (1, 64, 2, 32, 1, 16, 16),
    (2, 96, 4, 32, 2, 32, 32),
    (2, 64, 16, 32, 1, 32, 16),
    (1, 256, 4, 64, 1, 128, 64),
    (4, 2048, 64, 64, 1, 128, 64),
    (2, 256, 4, 128, 2, 64, 64),
    (1, 320, 6, 64, 2, 64, 64),
    (2, 192, 4, 128, 1, 128, 64),
    (1, 64, 2, 64, 2, 128, 64),
]


def ssd_inputs(B, S, nh, hd, G, ds, dtype, seed, device="cuda"):
    """Model-like inputs: dt post-softplus, A = -exp(.), a nonzero state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    x = rnd(B, nh, S, hd).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, nh, S) - 1.0)
    A = -torch.exp(0.5 * rnd(nh))
    Bm, Cm = rnd(B, G, S, ds).to(dtype), rnd(B, G, S, ds).to(dtype)
    init = 0.1 * rnd(B, nh, hd, ds)
    return x, dt, A, Bm, Cm, init


def ssd_errors(got, want):
    """(y error in units of the tolerance, state error in units of the
    tolerance). y: |Δ| ≤ rtol·|y| + 1e-5·max|y|, rtol 2⁻⁷ (one bf16 ulp: the
    two f32 sums differ in the last bits and may round to neighbouring bf16
    values) or 0 for f32. State, f32 summed in another order over S/chunk
    chunks: |Δ| ≤ 1e-5·max|S|."""
    (y, s), (y0, s0) = got, want
    y, y0 = y.float(), y0.float()
    rtol = 2.0 ** -7 if got[0].dtype == torch.bfloat16 else 0.0
    y_bound = rtol * y0.abs() + 1e-5 * float(y0.abs().max())
    y_err = float(((y - y0).abs() / y_bound).max())
    s_err = float((s - s0).abs().max()) / (1e-5 * float(s0.abs().max()))
    return y_err, s_err


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_ssd_scan_matches_plain(shape, dtype):
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK

    B, S, nh, hd, G, ds, chunk = shape
    args = ssd_inputs(B, S, nh, hd, G, ds, dtype, seed=S)
    before = SK.ssd_scan_fwd.launches
    got = SK.ssd_scan_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert SK.ssd_scan_fwd.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    want = SK.ssd_scan_plain(*args, chunk=chunk)
    y_err, s_err = ssd_errors(got, want)
    assert y_err <= 1.0 and s_err <= 1.0, (y_err, s_err)
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())


@pytest.mark.parametrize("shape", [(4, 2048, 64, 64, 1, 128, 64), (2, 256, 4, 128, 2, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_ssd_scan_gives_the_same_bits_twice_on_its_route(shape, dtype):
    """Two launches give the same bits, and the profile shows the kernel of
    the route: bf16 at chunk 64 the tensor-core kernel (after the C·Bᵀ
    kernel), f32 the CUDA-core kernel."""
    _need_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import kernel as SK

    B, S, nh, hd, G, ds, chunk = shape
    args = ssd_inputs(B, S, nh, hd, G, ds, dtype, seed=S + hd)
    first = SK.ssd_scan_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = SK.ssd_scan_fwd(*args, chunk=chunk)
        torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    tc = SK.tensor_core_route(dtype, hd, ds, chunk)
    assert tc == (dtype == torch.bfloat16)
    want = ["ssd_cb_kernel", "ssd_scan_tc_kernel"] if tc else ["ssd_scan_kernel"]
    assert len(names) == len(want), names
    assert all(sum(w + "<" in n for n in names) == 1 for w in want), names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_ssd_scan_with_no_steps_returns_the_initial_state(dtype):
    """S = 0 on either route (bf16 at chunk 64 is the tensor-core one): y is
    empty and the final state is init, bit for bit, as in the plain version."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK

    args = ssd_inputs(2, 0, 4, 64, 2, 128, dtype, seed=3)
    before = SK.ssd_scan_fwd.launches
    y, final = SK.ssd_scan_fwd(*args, chunk=64)
    torch.cuda.synchronize()
    assert SK.ssd_scan_fwd.launches == before + 1
    assert y.shape == (2, 4, 0, 64) and torch.equal(final, args[-1])
    assert torch.equal(final, SK.ssd_scan_plain(*args, chunk=64)[1])


def test_cuda_ssd_ops_pads_and_continues():
    """ops.ssd on the card: a ragged S goes through the padding, and two
    halves carried through the state equal the whole, against the plain
    version on the same inputs."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK, ops

    x, dt, A, Bm, Cm, init = ssd_inputs(2, 200, 4, 64, 1, 128, torch.bfloat16, seed=5)
    m = lambda t: t.movedim(1, 2)  # noqa: E731  (B, nh, S, ·) -> (B, S, nh, ·)
    y, s = ops.ssd(m(x), m(dt), A, m(Bm), m(Cm), 64, init)
    assert y.shape == (2, 200, 4, 64)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 56)) if t.ndim == 4 \
        else torch.nn.functional.pad(t, (0, 56))  # noqa: E731
    y0, s0 = SK.ssd_scan_plain(*(pad(t) for t in (x, dt)), A, pad(Bm), pad(Cm), init, chunk=64)
    assert max(ssd_errors((m(y), s), (y0[:, :, :200], s0))) <= 1.0
    y1, s1 = ops.ssd(m(x)[:, :128], m(dt)[:, :128], A, m(Bm)[:, :128], m(Cm)[:, :128], 64, init)
    y2, s2 = ops.ssd(m(x)[:, 128:], m(dt)[:, 128:], A, m(Bm)[:, 128:], m(Cm)[:, 128:], 64, s1)
    assert max(ssd_errors((torch.cat([y1, y2], 1), s2), (y, s))) <= 1.0


def test_cuda_ssd_wrapper_refuses_instead_of_falling_back():
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK

    x, dt, A, Bm, Cm, init = ssd_inputs(1, 64, 2, 32, 1, 16, torch.bfloat16, seed=0)
    before = SK.ssd_scan_fwd.launches
    bad = [
        lambda: SK.ssd_scan_fwd(x, dt, A, Bm.float(), Cm, init, chunk=16),  # dtype
        lambda: SK.ssd_scan_fwd(x.double(), dt, A, Bm, Cm, init, chunk=16),  # dtype
        lambda: SK.ssd_scan_fwd(x, dt.bfloat16(), A, Bm, Cm, init, chunk=16),  # dt f32
        lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, init[:, :1], chunk=16),  # shape
        lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, init, chunk=48),  # S % chunk
        lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, init, chunk=6),  # chunk % 4
        lambda: SK.ssd_scan_fwd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm,
                                Cm, init, chunk=16),  # not contiguous
        lambda: SK.ssd_scan_fwd(x, dt, A, Bm.cpu(), Cm, init, chunk=16),  # mixed devices
        lambda: SK.ssd_scan_fwd(*ssd_inputs(1, 64, 3, 32, 2, 16, torch.float32, seed=1),
                                chunk=16),  # nh % G
        lambda: SK.ssd_scan_fwd(*ssd_inputs(1, 64, 2, 256, 1, 256, torch.float32, seed=1),
                                chunk=64),  # shared memory
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert SK.ssd_scan_fwd.launches == before


# ---------------------------------------------------------------------------
# The flash attention kernel
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset): ragged lengths, GQA grp
#: 2 and 4, causal with q_offset, sliding windows, hd 64 and 128, rows that see
#: no key, and whisper-large-v3's encoder layer
FLASH_CASES = [
    (1, 2, 2, 64, 64, 64, True, None, 0),
    (2, 4, 2, 100, 100, 64, False, None, 0),
    (1, 8, 2, 48, 80, 64, True, None, 32),
    (1, 4, 4, 200, 200, 128, True, 24, 0),
    (2, 4, 1, 40, 72, 64, False, 16, 20),
    (1, 2, 1, 130, 130, 128, False, None, 0),
    (1, 2, 1, 32, 24, 64, True, None, -8),
    (1, 4, 2, 333, 333, 64, True, 100, 0),
    (4, 20, 20, 1500, 1500, 64, False, None, 0),
]


def flash_inputs(B, Hq, Hkv, Sq, Sk, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return rnd(B, Hq, Sq, hd), rnd(B, Hkv, Sk, hd), rnd(B, Hkv, Sk, hd)


def flash_error(got, want):
    """Error in units of the tolerance: |Δ| ≤ rtol·|y| + 1e-5·max|y|, rtol 2⁻⁷
    (one bf16 ulp: both sides sum in f32 in other orders, then round) or 0
    for f32."""
    y, y0 = got.float(), want.float()
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    bound = rtol * y0.abs() + 1e-5 * float(y0.abs().max())
    return float(((y - y0).abs() / bound).max())


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_flash_attention_matches_plain(case, dtype):
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK

    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    q, k, v = flash_inputs(B, Hq, Hkv, Sq, Sk, hd, dtype, seed=Sq + hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = FK.flash_attention_fwd.launches
    got = FK.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FK.flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert flash_error(got, FK.flash_attention_plain(q, k, v, **kw)) <= 1.0
    assert bool(torch.isfinite(got).all())


def test_cuda_flash_attention_ops_in_model_layout():
    """ops.flash_attention on (B, S, H, hd) CUDA tensors launches the kernel
    once and agrees with the plain version in kernel layout."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK, ops

    q, k, v = flash_inputs(2, 4, 2, 100, 100, 64, torch.bfloat16, seed=1)
    m = lambda t: t.transpose(1, 2)  # noqa: E731
    before = FK.flash_attention_fwd.launches
    got = ops.flash_attention(m(q), m(k), m(v), causal=False)
    torch.cuda.synchronize()
    assert FK.flash_attention_fwd.launches == before + 1 and got.shape == (2, 100, 4, 64)
    assert flash_error(m(got), FK.flash_attention_plain(q, k, v, causal=False)) <= 1.0


def model_layout(t):
    """A (B, H, S, hd) tensor's values in the model's (B, S, H, hd) memory."""
    return t.transpose(1, 2).contiguous()


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_flash_attention_ops_reads_the_model_layout_in_place(case, dtype):
    """ops.flash_attention on (B, S, H, hd) CUDA tensors, every case and both
    dtypes: one launch, within the tolerance of the plain version."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK, ops

    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    q, k, v = flash_inputs(B, Hq, Hkv, Sq, Sk, hd, dtype, seed=Sq * hd + 1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = FK.flash_attention_fwd.launches
    got = ops.flash_attention(model_layout(q), model_layout(k), model_layout(v), **kw)
    torch.cuda.synchronize()
    assert FK.flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, Sq, Hq, hd)
    assert flash_error(got.transpose(1, 2), FK.flash_attention_plain(q, k, v, **kw)) <= 1.0


@pytest.mark.parametrize("case", FLASH_CASES[1::3], ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_flash_attention_gives_the_same_bits_twice(case, dtype):
    _need_cuda()
    from repro_torch.kernels.flash_attention import ops

    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    q, k, v = (model_layout(t) for t in flash_inputs(B, Hq, Hkv, Sq, Sk, hd, dtype, seed=7))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    first = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    assert torch.equal(_bits(first), _bits(again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_flash_attention_output_is_contiguous_in_model_layout(dtype):
    """o is written in (B, S, H, hd) memory: ops hands it back contiguous, and
    the kernel-layout entry point returns its (B, H, S, hd) view."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK, ops

    q, k, v = flash_inputs(2, 4, 2, 100, 100, 64, dtype, seed=2)
    got = ops.flash_attention(model_layout(q), model_layout(k), model_layout(v), causal=False)
    assert got.is_contiguous() and got.shape == (2, 100, 4, 64)
    o = FK.flash_attention_fwd(q, k, v, causal=False)
    assert o.shape == q.shape and o.transpose(1, 2).is_contiguous()
    assert torch.equal(o, got.transpose(1, 2))


def test_cuda_flash_attention_wrapper_refuses_instead_of_falling_back():
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v = flash_inputs(1, 4, 2, 64, 64, 64, torch.float32, seed=0)
    before = FK.flash_attention_fwd.launches
    bad = [
        lambda: FK.flash_attention_fwd(q.half(), k.half(), v.half()),  # dtype
        lambda: FK.flash_attention_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                       v[..., :32].contiguous()),  # hd 32
        lambda: FK.flash_attention_fwd(q, k.bfloat16(), v),  # mixed dtypes
        lambda: FK.flash_attention_fwd(q[:, :3].contiguous(), k, v),  # Hq % Hkv
        lambda: FK.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
        lambda: FK.flash_attention_fwd(q, k.cpu(), v),  # mixed devices
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert FK.flash_attention_fwd.launches == before


# ---------------------------------------------------------------------------
# The causal ALiBi training pair
# ---------------------------------------------------------------------------

#: (B, S, Hq, Hkv, hd): photon-1.3b's micro-batch in the s2048 and s512 cells,
#: a ragged tail with GQA at hd 64, a ragged hd 128 case with grp 4
ALIBI_CASES = [(1, 2048, 16, 16, 128), (4, 512, 16, 16, 128), (1, 100, 4, 2, 64),
               (2, 333, 8, 2, 128)]


def alibi_inputs(B, S, Hq, Hkv, hd, seed):
    """bf16 q, k, v (needing grads) and dO in model layout, and the slopes."""
    from repro_torch.models.common import alibi_slopes_on

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(h):
        return torch.randn((B, S, h, hd), generator=gen, device="cuda").bfloat16()

    q, k, v = (rnd(h).requires_grad_(True) for h in (Hq, Hkv, Hkv))
    return q, k, v, rnd(Hq), alibi_slopes_on(Hq, q.device)


def _kl(x):
    return x.detach().transpose(1, 2)


@pytest.mark.parametrize("case", ALIBI_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_flash_alibi_forward_matches_the_oracle(case):
    """o and the log-sum-exp against the float32 oracle on the same bf16
    inputs, within the flash tolerance; one launch."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK, ref

    q, k, v, _, slopes = alibi_inputs(*case, seed=sum(case))
    before = FK.flash_attention_alibi_fwd.launches
    o, o_lo, lse = FK.flash_attention_alibi_fwd(_kl(q), _kl(k), _kl(v), slopes)
    torch.cuda.synchronize()
    assert FK.flash_attention_alibi_fwd.launches == before + 1
    o0, lse0 = ref.attention_alibi_ref(_kl(q), _kl(k), _kl(v), slopes)
    S = q.shape[1]
    assert o.dtype == torch.bfloat16 and o.transpose(1, 2).is_contiguous()
    assert flash_error(o, o0) <= 1.0
    assert flash_error(lse[..., :S], lse0) <= 1.0
    # o + o_lo carries the f32 result to about 16 bits
    err = (o.float() + o_lo.float() - o0).abs()
    assert float((err / (2.0 ** -14 * o0.abs() + 1e-5 * o0.abs().max())).max()) <= 1.0


def _max_err(got, want):
    return float((got.float() - want).abs().max())


@pytest.mark.parametrize("case", ALIBI_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_flash_alibi_gradients_are_no_worse_than_the_plain_cores(case):
    """dq, dk and dv through the kernel pair against the float32 oracle's
    autograd on the same bf16 inputs: each within 1.25 times the error that
    ``sdpa_chunked`` in bf16 shows against the same oracle, plus 1e-5 of the
    largest value. One forward and two backward launches a call."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK, ops, ref
    from repro_torch.models.attention import sdpa_chunked

    q, k, v, do, slopes = alibi_inputs(*case, seed=3 * sum(case))
    xs = (q, k, v)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    o0, _ = ref.attention_alibi_ref(*(t(x.float()) for x in xs), slopes)
    want = torch.autograd.grad(t(o0), xs, do.float())
    before = (FK.flash_attention_alibi_fwd.launches, FK.flash_attention_alibi_bwd.launches)
    got = torch.autograd.grad(ops.flash_attention_alibi(q, k, v, slopes), xs, do)
    torch.cuda.synchronize()
    assert (FK.flash_attention_alibi_fwd.launches,
            FK.flash_attention_alibi_bwd.launches) == (before[0] + 1, before[1] + 2)
    pos = torch.arange(q.shape[1], device="cuda")
    plain = sdpa_chunked(q, k, v, q_pos=pos, k_pos=pos, causal=True, window=None, k_len=None,
                         slopes=slopes)
    chunked = torch.autograd.grad(plain, xs, do)
    for name, g, gc, g0 in zip("qkv", got, chunked, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        err, err_plain = _max_err(g, g0), _max_err(gc, g0)
        assert err <= 1.25 * err_plain + 1e-5 * float(g0.abs().max()), (name, err, err_plain)


@pytest.mark.parametrize("case", ALIBI_CASES[1:3], ids=lambda c: "x".join(map(str, c)))
def test_cuda_flash_alibi_gives_the_same_bits_twice(case):
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v, do, slopes = alibi_inputs(*case, seed=11)
    args = (_kl(q), _kl(k), _kl(v))
    (o, o_lo, lse), (o2, o_lo2, lse2) = (FK.flash_attention_alibi_fwd(*args, slopes)
                                         for _ in range(2))
    assert torch.equal(_bits(o), _bits(o2)) and torch.equal(_bits(o_lo), _bits(o_lo2))
    assert torch.equal(lse, lse2)
    first, again = (FK.flash_attention_alibi_bwd(*args, o, o_lo, lse, _kl(do), slopes)
                    for _ in range(2))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first, again))


def test_cuda_flash_alibi_runs_on_a_thread_with_no_cuda_context():
    """The pair's forward and backward from a fresh thread that has made no
    CUDA runtime call, every output taken from the allocator's cache (as an
    autograd worker whose first work is the backward finds it): the same
    bits as on the main thread."""
    _need_cuda()
    import threading

    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v, do, slopes = alibi_inputs(1, 256, 4, 4, 128, seed=5)
    args = (_kl(q), _kl(k), _kl(v))

    def pair():
        o, o_lo, lse = FK.flash_attention_alibi_fwd(*args, slopes)
        return (o, o_lo, lse, *FK.flash_attention_alibi_bwd(*args, o, o_lo, lse, _kl(do), slopes))

    first = pair()
    want = [x.clone() for x in first]
    del first  # its blocks go back to the cache, for the thread to take
    got, errors = [], []

    def run():
        try:
            got.extend(pair())
        except Exception as e:  # noqa: BLE001 - re-raised on the main thread
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join()
    assert not errors, errors
    torch.cuda.synchronize()
    assert len(got) == 6 and all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_cuda_photon_layer_makes_no_host_sync():
    """One photon-1.3b layer at 2048 (LayerNorm, attention on the kernel
    route, GELU FFN), forward and backward, under
    ``set_sync_debug_mode("error")`` (after one pass that puts the slopes on
    the card)."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import transformer as TR
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_leaves

    cfg = get_config("photon-1.3b")
    kind = cfg.layer_kinds()[0]
    p = init_params(0, TR._layer_desc(cfg, kind), device="cuda")
    for leaf in tree_leaves(p):
        leaf.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn((1, 2048, cfg.d_model), generator=gen, device="cuda").bfloat16()
    h.requires_grad_(True)
    pos = torch.arange(h.shape[1], device="cuda")
    window = torch.tensor(TR.WINDOW_SENTINEL, dtype=torch.int32)  # as the stack gives it

    def run():
        out, _, _ = TR._apply_layer(cfg, kind, p, h, window=window, positions=pos, cache=None,
                                    cache_index=None, enc_out=None, decode=False,
                                    use_pallas=False)
        out.float().sum().backward()

    run()
    torch.cuda.synchronize()
    before = FK.flash_attention_alibi_fwd.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert FK.flash_attention_alibi_fwd.launches == before + 1


def _tiny_photon():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("photon-75m").reduced(), compute_dtype="bfloat16")
    return cfg, build_model(cfg)


def test_cuda_tiny_photon_loss_and_grads_match_through_the_kernel_and_the_plain_core(
        monkeypatch):
    """Reduced photon-75m (hd 64, GQA 4/2) in CUDA bf16: its loss and grads
    through the kernel pair and through ``sdpa_chunked`` (the route turned
    off), within the bf16 tolerance of ``test_loss_and_grads_match_reference``
    (loss 2e-2) and, over all leaves, a relative gradient distance under 5e-2."""
    _need_cuda()
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import attention as A
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg, model = _tiny_photon()
    leaves, treedef = tree_flatten(model.init(0, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))

    def loss_and_grads():
        xs = [x.detach().requires_grad_(True) for x in leaves]
        loss, _ = model.loss(tree_unflatten(treedef, xs), {"tokens": tokens})
        return float(loss), torch.autograd.grad(loss, xs)

    before = FK.flash_attention_alibi_fwd.launches
    loss_k, g_k = loss_and_grads()
    assert FK.flash_attention_alibi_fwd.launches == before + cfg.n_layers
    monkeypatch.setattr(A, "flash_train_route", lambda *a, **kw: False)
    loss_p, g_p = loss_and_grads()
    assert FK.flash_attention_alibi_fwd.launches == before + cfg.n_layers
    assert abs(loss_k - loss_p) <= 2e-2
    diff = sum(float((a.float() - b.float()).square().sum()) for a, b in zip(g_k, g_p))
    norm = sum(float(b.float().square().sum()) for b in g_p)
    print(f"tiny photon bf16: loss {loss_k} vs {loss_p}, grad distance {(diff / norm) ** 0.5}")
    assert (diff / norm) ** 0.5 < 5e-2


def test_cuda_traced_round_counts_every_photon_attention_call_on_the_kernel():
    """A traced sync round of reduced photon-75m in bf16 on the card: every
    attention call (2 layers, C = 2, τ = 2) on the kernel, none on the plain core."""
    _need_cuda()
    import repro_torch.core as T
    import repro_torch.obs as TO

    cfg, model = _tiny_photon()
    C, tau = 2, 2
    tracer = TO.Tracer(proc="server")
    agg = T.SyncAggregator(model.loss, T.FederatedConfig(clients_per_round=C, local_steps=tau),
                           T.ParticipationConfig(population=2 * C, clients_per_round=C),
                           seed=2, tracer=tracer, params=model.init(0, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (tau, C, 2, 128), device="cuda", dtype=torch.int32)
    agg.run_round({"tokens": tokens}, agg.plan(0))
    closed, _ = TO.span_pairs(list(tracer.ring))
    (rnd,) = [s for s in closed if s["name"] == "round"]
    assert rnd["attrs"]["attn_kernel_n"] == cfg.n_layers * C * tau
    assert rnd["attrs"]["attn_plain_n"] == 0


def test_cuda_whisper_generate_matches_the_cpu():
    """Reduced whisper-large-v3, float32 compute, the same weights and inputs:
    ``generate(use_pallas=True)`` on the card (the flash kernel in each of the
    2 encoder layers, once per prefill) gives the CPU's tokens."""
    _need_cuda()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("whisper-large-v3").reduced(), compute_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, dtype=torch.int32)
    audio = torch.randn((2, cfg.n_audio_frames, cfg.d_model), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        before = FK.flash_attention_fwd.launches
        out[dev] = generate(model, model.init(0, device=dev), prompt.to(dev), 8,
                            audio_embed=audio.to(dev), use_pallas=True).cpu()
        launched = FK.flash_attention_fwd.launches - before
        assert launched == (cfg.n_encoder_layers if dev == "cuda" else 0), (dev, launched)
    assert torch.equal(out["cpu"], out["cuda"]), (out["cpu"][:, 40:], out["cuda"][:, 40:])


# ---------------------------------------------------------------------------
# The flash decode kernel
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, S, hd, kv_len per row, window): GQA groups 1, 2, 3, 4 and 8,
#: every head dim, ragged S, empty rows, windows shorter and longer than the
#: cache, one row long enough for many splits
DECODE_CASES = [
    (3, 4, 4, 100, 64, (100, 37, 0), None),
    (2, 4, 2, 200, 128, (200, 150), 64),
    (2, 8, 2, 96, 32, (96, 10), 50),
    (2, 4, 1, 72, 256, (72, 1), None),
    (2, 6, 2, 333, 64, (333, 300), 1),
    (2, 16, 2, 1000, 128, (999, 1000), None),
    (1, 8, 4, 70001, 256, (70001,), None),
    (1, 8, 4, 70001, 256, (65536,), 1024),
    (4, 16, 8, 4097, 128, (4097, 4000, 1, 0), 5000),
]


def decode_inputs(B, Hq, Hkv, S, hd, kv_len, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return (rnd(B, Hq, hd), rnd(B, Hkv, S, hd), rnd(B, Hkv, S, hd),
            torch.tensor(kv_len, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_flash_decode_matches_plain(case, dtype):
    """Within one bf16 ulp of the plain version (f32: 1e-5·max|y|), rows
    that see no key exactly 0, and two launches bitwise equal."""
    _need_cuda()
    from repro_torch.kernels.flash_decode import kernel as DK

    B, Hq, Hkv, S, hd, kv_len, window = case
    q, k, v, kl = decode_inputs(B, Hq, Hkv, S, hd, kv_len, dtype, seed=S + hd)
    before = DK.flash_decode_fwd.launches
    got = DK.flash_decode_fwd(q, k, v, kl, window=window)
    again = DK.flash_decode_fwd(q, k, v, kl, window=window)
    torch.cuda.synchronize()
    assert DK.flash_decode_fwd.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape and torch.equal(got, again)
    want = DK.flash_decode_plain(q, k, v, kl, window=window)
    assert flash_error(got, want) <= 1.0
    empty = [i for i, n in enumerate(kv_len) if n <= 0 or window == 0]
    assert all(bool((got[i] == 0).all()) for i in empty)


@pytest.mark.parametrize("case", [(2, 16, 8, 4097, 128, 4000, None),
                                  (1, 8, 4, 70001, 256, 65536, 1024),
                                  (3, 4, 4, 100, 64, 0, None), (2, 8, 2, 96, 32, 90, 50)],
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_flash_decode_scalar_kv_len_matches_the_tensor_path(case, dtype):
    """A Python int kv_len (a kernel argument, no device tensor) gives the
    same bits as that length in a (B,) int32 tensor on the card."""
    _need_cuda()
    from repro_torch.kernels.flash_decode import kernel as DK

    B, Hq, Hkv, S, hd, n, window = case
    q, k, v, kl = decode_inputs(B, Hq, Hkv, S, hd, (n,) * B, dtype, seed=n + hd)
    before = DK.flash_decode_fwd.launches
    got = DK.flash_decode_fwd(q, k, v, n, window=window)
    want = DK.flash_decode_fwd(q, k, v, kl, window=window)
    torch.cuda.synchronize()
    assert DK.flash_decode_fwd.launches == before + 2
    assert torch.equal(got, want)
    if n > 0:
        assert flash_error(got, DK.flash_decode_plain(q, k, v, n, window=window)) <= 1.0
    else:  # no row sees a key
        assert bool((got == 0).all())


def test_cuda_flash_decode_ops_reads_the_model_layout_cache_in_place():
    """ops.flash_decode on (B, S, Hkv, hd) CUDA caches with a scalar kv_len
    launches the kernel once on strided views and agrees with the plain
    version in kernel layout."""
    _need_cuda()
    from repro_torch.kernels.flash_decode import kernel as DK, ops

    q, k, v, _ = decode_inputs(2, 8, 4, 3000, 128, (0, 0), torch.bfloat16, seed=2)
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    before = DK.flash_decode_fwd.launches
    got = ops.flash_decode(q[:, None], kc, vc, 2900, window=700)
    torch.cuda.synchronize()
    assert DK.flash_decode_fwd.launches == before + 1 and got.shape == (2, 1, 8, 128)
    kl = torch.full((2,), 2900, dtype=torch.int32, device="cuda")
    assert flash_error(got[:, 0], DK.flash_decode_plain(q, k, v, kl, window=700)) <= 1.0


def test_cuda_flash_decode_wrapper_refuses_instead_of_falling_back():
    _need_cuda()
    from repro_torch.kernels.flash_decode import kernel as DK

    q, k, v, kl = decode_inputs(2, 4, 2, 64, 64, (64, 3), torch.float32, seed=0)
    shifted = torch.empty(k.numel() + 1, device="cuda")[1:].view(k.shape)  # 4-byte aligned
    before = DK.flash_decode_fwd.launches
    bad = [
        lambda: DK.flash_decode_fwd(q.half(), k.half(), v.half(), kl),  # dtype
        lambda: DK.flash_decode_fwd(q, k.bfloat16(), v, kl),  # mixed dtypes
        lambda: DK.flash_decode_fwd(q, k, v, kl.long()),  # kv_len dtype
        lambda: DK.flash_decode_fwd(q, k, v, kl.cpu()),  # mixed devices
        lambda: DK.flash_decode_fwd(q, shifted, v, kl),  # rows not 16-byte aligned
        lambda: DK.flash_decode_fwd(q, k[:, :, :, :48].contiguous(),
                                    v[:, :, :, :48].contiguous(), kl),  # hd 48
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert DK.flash_decode_fwd.launches == before


# ---------------------------------------------------------------------------
# The RMSNorm kernel
# ---------------------------------------------------------------------------

#: (shape, dtype): mamba2-1.3b's serve prefill rows, rows kept in registers and
#: rows read twice, rows with no 16-byte access (D 1000 bf16, D 4101 f32),
#: one element, and a width above 8192
RMS_CASES = [
    ((8192, 2048), torch.bfloat16),
    ((3, 5, 7, 1000), torch.bfloat16),
    ((7, 4096), torch.bfloat16),
    ((3, 8192), torch.bfloat16),
    ((4, 12288), torch.bfloat16),
    ((9, 2048), torch.float32),
    ((5, 4100), torch.float32),
    ((6, 4101), torch.float32),
    ((1, 1), torch.float32),
    ((33, 64), torch.float32),
]


def rms_error(got, want):
    """Error in units of the tolerance: f32 |Δ| ≤ 2e-6·|y| elementwise (the
    sum of squares taken in another order); bf16 |Δ| ≤ one bf16 ulp of y."""
    y, y0 = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        bound = torch.ldexp(torch.ones_like(y0), torch.frexp(y0.abs())[1] - 8)
    else:
        bound = 2e-6 * y0.abs()
    err = (y - y0).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


@pytest.mark.parametrize("shape,dtype", RMS_CASES, ids=lambda c: str(c))
def test_cuda_rmsnorm_matches_plain(shape, dtype):
    _need_cuda()
    from repro_torch.kernels.rmsnorm import kernel as RK, ops

    gen = torch.Generator(device="cuda").manual_seed(shape[-1])
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    scale = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
    before = RK.rmsnorm_fwd.launches
    got = ops.rmsnorm(x, scale)
    again = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert RK.rmsnorm_fwd.launches == before + 2
    assert got.dtype == dtype and got.shape == x.shape and torch.equal(got, again)
    want = RK.rmsnorm_plain(x.reshape(-1, shape[-1]), scale).reshape(shape)
    assert rms_error(got, want) <= 1.0


def test_cuda_rmsnorm_wrapper_refuses_instead_of_falling_back():
    _need_cuda()
    from repro_torch.kernels.rmsnorm import kernel as RK

    x = torch.randn((4, 64), device="cuda")
    s = torch.ones(64, device="cuda")
    before = RK.rmsnorm_fwd.launches
    bad = [
        lambda: RK.rmsnorm_fwd(x.half(), s),  # dtype
        lambda: RK.rmsnorm_fwd(x, s.cpu()),  # mixed devices
        lambda: RK.rmsnorm_fwd(x.t(), s[:4]),  # not contiguous
        lambda: RK.rmsnorm_fwd(x, s[:32]),  # scale shape
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert RK.rmsnorm_fwd.launches == before


def test_cuda_wrappers_raise_when_their_kernel_cannot_be_built(monkeypatch):
    """No fallback to the plain version: with the build broken, a CUDA tensor
    makes each new wrapper raise, and nothing is counted."""
    _need_cuda()
    from repro_torch.kernels.flash_decode import kernel as DK
    from repro_torch.kernels.rmsnorm import kernel as RK

    def broken():
        raise RuntimeError("nvcc failed")

    q, k, v, kl = decode_inputs(1, 2, 1, 16, 64, (16,), torch.float32, seed=0)
    x, s = torch.randn((2, 64), device="cuda"), torch.ones(64, device="cuda")
    for mod, call in ((DK, lambda: DK.flash_decode_fwd(q, k, v, kl)),
                      (RK, lambda: RK.rmsnorm_fwd(x, s))):
        monkeypatch.setattr(mod, "_library", broken)
        counts = (DK.flash_decode_fwd.launches, RK.rmsnorm_fwd.launches)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
        assert (DK.flash_decode_fwd.launches, RK.rmsnorm_fwd.launches) == counts


# ---------------------------------------------------------------------------
# The mesh tooling on the card's one-device host mesh
# ---------------------------------------------------------------------------


#: the round the host-mesh step's update is held from: past the inner
#: cosine's 100-step warmup at τ = 2 (at round 0 the rates are 0 and 3e-6)
PAST_WARMUP = 100


@pytest.mark.parametrize("uplink", ["float32", "int8"])
def test_cuda_host_mesh_step_launches_the_fedcore_kernels_once_a_run_and_matches_the_cpu(uplink):
    """Reduced mamba2-1.3b's federated step from ``launch/steps`` at float32
    compute with ``fused_server``: one ``server_apply`` per run (and one
    ``int8_quant`` and one ``int8_dequant`` under int8), counted by
    ``roofline.analysis.measure``; the card's new params within 1e-4 of the
    CPU's from the same inputs; the measured peak within the card. Then from
    round ``PAST_WARMUP`` with a seeded FedMom lane, where the step moves the
    params by ~1e-3: the card's update of the params and of the lane within
    1e-3 of the CPU's, relative to the CPU update's norm."""
    _need_cuda()
    import dataclasses

    from torch_parity import update_rel_err

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.autobatch import verify_micro_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, materialize
    from repro_torch.roofline.analysis import measure
    from repro_torch.tree import params_to_numpy, tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(), compute_dtype="float32")
    shape = InputShape("train_4k", 64, 4, "train")
    outs, updates = {}, {}
    for dev in ("cpu", "cuda"):
        step = build_train_step(cfg, shape, make_host_mesh(device=dev), tau_lowered=2,
                                fused_server=True, uplink=uplink)
        m = measure(step.fn, materialize(step, dev, seed=0), dev, keep_output=True)
        outs[dev] = (m, tree_leaves(m.output[0]["params"]))
        args = materialize(step, dev, seed=0)
        gen = torch.Generator().manual_seed(3)
        args[0]["round"] = PAST_WARMUP
        args[0]["outer"]["momentum"] = tree_map(
            lambda x: (torch.randn(x.shape, generator=gen) * 3e-4).to(dev), args[0]["params"])
        lanes = lambda s: {"params": s["params"], "momentum": s["outer"]["momentum"]}  # noqa
        start = {k: params_to_numpy(v) for k, v in lanes(args[0]).items()}
        new_state = step.fn(*args)[0]
        updates[dev] = (start, {k: params_to_numpy(v) for k, v in lanes(new_state).items()})
    m = outs["cuda"][0]
    want = {"server_apply": 1} if uplink == "float32" else {
        "server_apply": 1, "int8_quant": 1, "int8_dequant": 1}
    assert m.kernels_not_counted == want and outs["cpu"][0].kernels_not_counted == {}
    assert m.flops > 0 and m.bytes > 0 and verify_micro_batch(m)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(outs["cuda"][1], outs["cpu"][1]))
    assert err <= 1e-4, err
    (start, got), (_, ref) = updates["cuda"], updates["cpu"]
    errs = {k: update_rel_err(got[k], ref[k], start[k]) for k in ("params", "momentum")}
    assert all(e <= 1e-3 for e in errs.values()), errs


def test_cuda_host_dryrun_cli_measures_a_serve_step(tmp_path, monkeypatch, capsys):
    """The host-mesh dry run on the card at reduced mamba2-1.3b's long_500k:
    a measured peak, no kernel launched."""
    _need_cuda()
    import json

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch).reduced())
    dryrun.main(["--mesh", "host", "--arch", "mamba2-1.3b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    assert "done; failures: 0" in capsys.readouterr().out
    with open(tmp_path / "mamba2-1.3b__long_500k__host.json") as f:
        r = json.load(f)
    assert r["peak_memory_per_device"] > 0 and r["measured"]["kernels_not_counted"] == {}


# ---------------------------------------------------------------------------
# The stacked-layer backward
# ---------------------------------------------------------------------------


def _stacked_backward(model, params, tokens, stack_shapes):
    """One forward and backward of ``model.loss`` from a reset peak: the peak
    bytes allocated above the params, the device ms (median of five), and the
    count of ``fill_`` calls on a tensor of a stacked leaf's shape in one
    more, profiled."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]

    def once():
        loss, _ = model.loss(tree_unflatten(treedef, leaves), {"tokens": tokens})
        torch.autograd.grad(loss, leaves)

    once()  # warm the allocator and the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    once()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        once()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        once()
        torch.cuda.synchronize()
    fills = sum(e.name == "aten::fill_" and tuple(e.input_shapes[0]) in stack_shapes
                for e in prof.events())
    return peak, sorted(times)[2], fills


def test_cuda_stacked_backward_fills_no_stack_and_holds_no_more_memory(monkeypatch, capsys):
    """photon-1.3b's widths at 4 layers (one body repeated 4 times), B 1 × S
    2048: the backward through ``layer_views`` fills no stack-sized tensor,
    and its peak allocation is at most that of per-layer ``x[r]`` slicing,
    which fills one stack-sized zero gradient per leaf and layer."""
    _need_cuda()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    from repro_torch.tree import tree_flatten, tree_map

    cfg = dataclasses.replace(get_config("photon-1.3b"), n_layers=4)
    (seg,) = transformer.plan_segments(cfg.layer_kinds())
    assert seg.n_repeat == 4
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    stack_shapes = {tuple(x.shape) for x in tree_flatten(params["segments"][0])[0]}
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen).cuda()

    peak, ms, fills = _stacked_backward(model, params, tokens, stack_shapes)
    monkeypatch.setattr(transformer, "layer_views", lambda tree, n: (
        [tree] if n == 1 else [tree_map(lambda x: x[r], tree) for r in range(n)]))
    peak_s, ms_s, fills_s = _stacked_backward(model, params, tokens, stack_shapes)
    with capsys.disabled():
        print(f"\nstacked backward, photon-1.3b widths, 4 layers, 1x2048: layer_views peak "
              f"{peak} B, {ms:.3f} ms, {fills} stack-sized fill_; x[r] peak {peak_s} B, "
              f"{ms_s:.3f} ms, {fills_s} stack-sized fill_")
    assert fills == 0
    assert fills_s >= len(stack_shapes)
    assert peak <= peak_s, (peak, peak_s)
