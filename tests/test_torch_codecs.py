"""The port's uplink codecs against ``repro.core.compression`` and the fused
codecs of ``repro.kernels.fedcore``, on the CPU, all BITWISE:

- each plain version of the four codec kernels (``topk_mask_ef``,
  ``sr_bf16``, ``int8_quant``, ``int8_dequant``) against the Pallas kernel run
  in interpret mode, on inputs with ties at the threshold, signed zeros,
  exact half-quanta and non-finite values;
- the per-leaf primitives and codecs, and the fused codecs, on the same
  trees; the bf16 ones given the same noise bits (torch cannot draw JAX's);
- the byte accounting (``uplink_bytes``, ``nbytes``, ``payload_nbytes``).

What non-finite inputs give, in both packages: top-k drops a NaN (|NaN| ≥ t
is false) and keeps it in the residual; ``sr_bf16`` keeps a NaN whose payload
reaches the high half as the canonical quiet NaN with its sign (±0x7FC0),
while one whose payload lies only in the low 16 bits may round to ±inf or
wrap; int8 sends a NaN to 0 and ±inf to ±127.
"""
import numpy as np
import pytest

from torch_parity import jax_to_torch

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.kernels.fedcore import FusedBf16Codec as JFusedBf16  # noqa: E402
from repro.kernels.fedcore import FusedInt8Codec as JFusedInt8  # noqa: E402
from repro.kernels.fedcore import FusedTopKCodec as JFusedTopK  # noqa: E402
from repro.kernels.fedcore import kernel as JK  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402
from repro_torch.kernels.fedcore import FusedBf16Codec as TFusedBf16  # noqa: E402
from repro_torch.kernels.fedcore import FusedInt8Codec as TFusedInt8  # noqa: E402
from repro_torch.kernels.fedcore import FusedTopKCodec as TFusedTopK  # noqa: E402
from repro_torch.kernels.fedcore import kernel as TK  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map  # noqa: E402

BLOCK = 128
N = 8 * BLOCK

# signed zeros, ±inf, NaNs (one with payload only in the low 16 bits), the
# largest float, subnormals, values whose SR rounding carries
SPECIAL_BITS = np.asarray(
    [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F800001,
     0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x807FFFFF, 0x3F808000, 0xBF808000, 0x3F80FFFF,
     0x7F80FFFF, 0xFFFFFFFF], np.uint32)


def _bits(a) -> np.ndarray:
    """Bit patterns of a numpy array or tensor (so ±0 and NaN payloads count)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.dtype.itemsize])


def _assert_bitwise(got, want, what=""):
    g, w = _bits(got), _bits(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    bad = np.nonzero(np.atleast_1d(g != w))
    assert not len(bad[0]), f"{what}: {len(bad[0])} differ, first at {bad[0][:5]}"


def _flat_t(tree):
    """``{keystr: tensor}``, each leaf in its own dtype (bf16 stays bf16)."""
    return dict(flatten_with_paths(tree))


def _flat_j(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_bitwise(torch_tree, jax_tree):
    got, want = _flat_t(torch_tree), _flat_j(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_bitwise(got[k], want[k], k)


def _tie_heavy(rng, n, specials=True):
    x = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    x[: n // 2] = np.round(x[: n // 2] * 400) / 400  # many exact ties
    x[n // 2: n // 2 + 8] = 0.0
    x[n // 2 + 8: n // 2 + 12] = -0.0
    if specials:
        x[-len(SPECIAL_BITS):] = SPECIAL_BITS.view(np.float32)
    return x


# ---------------------------------------------------------------------------
# (a) the plain versions against the Pallas kernels, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_mask_ef_plain_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    xf = _tie_heavy(rng, N)
    finite = np.abs(xf[np.isfinite(xf)])
    # a threshold on a tied value (so ties are kept), one between values, and 0
    t = np.float32([np.sort(finite)[N // 2], 0.0123, 0.0][seed])
    j_kept, j_res = JK.topk_mask_ef(jnp.asarray(xf), jnp.float32(t), block=BLOCK, interpret=True)
    t_kept, t_res = TK.topk_mask_ef(torch.from_numpy(xf)[None], torch.tensor([t]))
    _assert_bitwise(t_kept[0], j_kept, "kept")
    _assert_bitwise(t_res[0], j_res, "resid")
    assert int((t_kept[0] != 0).sum()) == int(((np.abs(xf) >= t) & (xf != 0)).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sr_bf16_plain_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(N) * 10.0 ** rng.integers(-6, 6, N)).astype(np.float32)
    x[:len(SPECIAL_BITS)] = SPECIAL_BITS.view(np.float32)
    noise = rng.integers(0, 1 << 16, N).astype(np.uint32)
    noise[:4] = 0xFFFF
    j = JK.sr_bf16(jnp.asarray(x), jnp.asarray(noise), block=BLOCK, interpret=True)
    t = TK.sr_bf16(torch.from_numpy(x), torch.from_numpy(noise.astype(np.int32)))
    _assert_bitwise(t, j, "sr_bf16")


@pytest.mark.parametrize("scale", [2.0 ** -7, 3.7e-4, 1e-12 / 127.0], ids=["pow2", "rand", "floor"])
def test_int8_quant_and_dequant_plain_match_pallas(scale):
    rng = np.random.default_rng(3)
    scale = np.float32(scale)
    x = (rng.standard_normal(N) * 60 * scale).astype(np.float32)
    # exact half-quanta (x/scale = k + 0.5 exactly when scale is a power of 2)
    x[:256] = ((np.arange(256) - 127.5) * scale).astype(np.float32)
    x[256:270] = [0.0, -0.0, np.inf, -np.inf, np.nan, 200 * scale, -200 * scale,
                  127.5 * scale, -127.5 * scale, 126.5 * scale, 0.5 * scale, -0.5 * scale,
                  1.5 * scale, -1.5 * scale]
    j_q = JK.int8_quant(jnp.asarray(x), jnp.float32(scale), block=BLOCK, interpret=True)
    t_scale = torch.tensor([[scale]])
    t_q = TK.int8_quant(torch.from_numpy(x)[None], t_scale, (0, N))
    _assert_bitwise(t_q[0], j_q, "int8_quant")
    q = rng.integers(-128, 128, N).astype(np.int8)
    j_d = JK.int8_dequant(jnp.asarray(q), jnp.float32(scale), block=BLOCK, interpret=True)
    t_d = TK.int8_dequant(torch.from_numpy(q)[None], t_scale, (0, N))
    _assert_bitwise(t_d[0], j_d, "int8_dequant")


def test_int8_plain_on_ragged_leaves_matches_per_leaf_reference():
    """The cohort layout (a scale table and leaf offsets that are not multiples
    of 4, a padded tail) is the per-leaf reference leaf by leaf."""
    rng = np.random.default_rng(4)
    sizes, C = [5, 4096, 1, 7898, 3], 3
    n = sum(sizes)
    offsets = tuple(np.concatenate([[0], np.cumsum(sizes)]).tolist())
    x = np.zeros((C, 16384), np.float32)
    x[:, :n] = rng.standard_normal((C, n)).astype(np.float32)
    scales = np.stack([[np.float32(JC.int8_compress(jnp.asarray(x[c, a:b]))["scale"])
                        for a, b in zip(offsets, offsets[1:])] for c in range(C)])
    q = TK.int8_quant(torch.from_numpy(x), torch.from_numpy(scales), offsets)
    d = TK.int8_dequant(q, torch.from_numpy(scales), offsets)
    assert not q[:, n:].any() and not d[:, n:].any()
    for c in range(C):
        for l, (a, b) in enumerate(zip(offsets, offsets[1:])):
            ref = JC.int8_compress(jnp.asarray(x[c, a:b]))
            _assert_bitwise(q[c, a:b], ref["q"], f"q[{c}, leaf {l}]")
            _assert_bitwise(d[c, a:b], JC.int8_decompress(ref), f"deq[{c}, leaf {l}]")


# ---------------------------------------------------------------------------
# (b) primitives and codecs, per-leaf and fused, bitwise
# ---------------------------------------------------------------------------


def _tree(seed, tie_heavy=False):
    rng = np.random.default_rng(seed)
    make = (lambda n: _tie_heavy(rng, n, specials=False)) if tie_heavy else \
        (lambda n: (rng.standard_normal(n) * 1e-2).astype(np.float32))
    return {"a": make(40).reshape(8, 5), "b": {"c": make(63).reshape(9, 7), "d": make(5)},
            "e": [make(300)]}


def _jt(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _tt(t):
    return jax_to_torch(_jt(t))


@pytest.mark.parametrize("k_fraction", [0.05, 0.25, 1.0])
def test_topk_compress_and_codec_match_reference(k_fraction):
    delta, err = _tree(5, tie_heavy=True), _tree(6, tie_heavy=True)
    j_sparse, j_err = JC.topk_compress(_jt(delta), k_fraction, _jt(err))
    t_sparse, t_err = TC.topk_compress(_tt(delta), k_fraction, _tt(err))
    _assert_trees_bitwise(t_sparse, j_sparse)
    _assert_trees_bitwise(t_err, j_err)
    for x in tree_leaves(t_sparse):  # never more than k, ties notwithstanding
        assert int((x != 0).sum()) <= max(1, int(x.numel() * k_fraction))
    j_codec, t_codec = JC.TopKCodec(k_fraction), TC.TopKCodec(k_fraction)
    jp, jr = j_codec.encode(_jt(delta), _jt(err))
    tp, tr = t_codec.encode(_tt(delta), _tt(err))
    _assert_trees_bitwise(tp, jp)
    _assert_trees_bitwise(tr, jr)
    _assert_trees_bitwise(t_codec.decode(tp), j_codec.decode(jp))


def test_topk_compress_keeps_exactly_k_on_ties():
    """An all-tied leaf: the k kept are the k lowest flat indices."""
    x = np.full(40, 0.5, np.float32)
    j_sparse, _ = JC.topk_compress({"w": jnp.asarray(x)}, 0.1)
    t_sparse, _ = TC.topk_compress({"w": torch.from_numpy(x)}, 0.1)
    _assert_bitwise(t_sparse["w"], j_sparse["w"])
    np.testing.assert_array_equal(np.nonzero(t_sparse["w"].numpy())[0], np.arange(4))


def _ref_sr_noise(tree, key):
    """The reference's per-leaf SR noise for ``key`` (cast_compress's draw)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    noise = [np.asarray(jax.random.randint(k, l.shape, 0, 1 << 16)).astype(np.int32)
             for k, l in zip(keys, leaves)]
    return jax_to_torch(jax.tree_util.tree_unflatten(treedef, [jnp.asarray(z) for z in noise]))


def test_bf16_cast_and_codecs_match_reference_given_the_noise():
    delta = _tree(7)
    key = jax.random.PRNGKey(11)
    noise = _ref_sr_noise(_jt(delta), key)
    want = JC.cast_compress(_jt(delta), jnp.bfloat16, rng=key)
    _assert_trees_bitwise(TC.cast_compress(_tt(delta), torch.bfloat16, noise=noise), want)
    _assert_trees_bitwise(TC.Bf16Codec().encode(_tt(delta), noise=noise)[0], want)
    j_fused, _ = JFusedBf16(use_pallas=True, interpret=True, block=BLOCK).encode(
        _jt(delta), rng=key)
    _assert_trees_bitwise(j_fused, want)
    fused = TFusedBf16()  # the fused codec takes given bits through its cohort draw
    fused.cohort_noise = lambda leaves, rngs: [z[None] for z in tree_leaves(noise)]
    _assert_trees_bitwise(fused.encode(_tt(delta), rng=np.asarray(key))[0], j_fused)
    # without an rng: the deterministic round-to-nearest cast, no kernel
    det = JC.cast_compress(_jt(delta), jnp.bfloat16)
    launches = TK.sr_bf16.launches
    _assert_trees_bitwise(TFusedBf16().encode(_tt(delta))[0], det)
    _assert_trees_bitwise(TC.Bf16Codec().encode(_tt(delta))[0], det)
    assert TK.sr_bf16.launches == launches
    _assert_trees_bitwise(TC.Bf16Codec().decode(TC.cast_compress(_tt(delta), noise=noise)),
                          JC.Bf16Codec().decode(want))


def test_bf16_cohort_noise_is_per_client_and_unbiased():
    """The port's own draw: per-client keys give different bits, the cohort
    encode equals the per-client encode, and SR stays unbiased."""
    from repro_torch.core.federated import uplink_keys

    x = torch.full((2, 20000), 1.0 + 2.0 ** -10)  # a quarter of a bf16 ulp above 1
    rngs = uplink_keys({"rng": np.asarray([0, 3], np.uint32), "round": 2}, 2)
    codec = TFusedBf16()
    out, _ = codec.encode_cohort({"w": x}, rngs=rngs)
    one, _ = codec.encode({"w": x[1]}, rng=rngs[1])
    assert torch.equal(out["w"][1].view(torch.int16), one["w"].view(torch.int16))
    per_leaf, _ = TC.Bf16Codec().encode_cohort({"w": x}, rngs=rngs)
    assert torch.equal(out["w"].view(torch.int16), per_leaf["w"].view(torch.int16))
    assert not torch.equal(out["w"][0], out["w"][1])
    mean = out["w"].float().mean(dim=1)
    assert torch.all((mean - x[:, 0]).abs() < 3e-4)


def test_int8_codecs_match_reference():
    delta = _tree(8)
    want = JC.int8_compress(_jt(delta))
    j_fused, _ = JFusedInt8(use_pallas=True, interpret=True, block=BLOCK).encode(_jt(delta))
    for codec in (TC.Int8Codec(), TFusedInt8()):
        payload, _ = codec.encode(_tt(delta))
        _assert_trees_bitwise(payload, want)
        _assert_trees_bitwise(payload, j_fused)
        _assert_trees_bitwise(codec.decode(payload), JC.int8_decompress(want))


def test_fused_topk_codec_matches_reference():
    """One global budget over the flat buffer; ties at the threshold are all
    kept, as in the reference's mask."""
    delta, err = _tree(9, tie_heavy=True), _tree(10, tie_heavy=True)
    j_codec = JFusedTopK(k_fraction=0.1, use_pallas=True, interpret=True, block=BLOCK)
    jp, jr = j_codec.encode(_jt(delta), _jt(err))
    t_codec = TFusedTopK(k_fraction=0.1)
    tp, tr = t_codec.encode(_tt(delta), _tt(err))
    _assert_trees_bitwise(tp, jp)
    _assert_trees_bitwise(tr, jr)
    kept = sum(int((x != 0).sum()) for x in tree_leaves(tp))
    n = sum(x.numel() for x in tree_leaves(tp))
    assert kept >= max(1, int(n * 0.1))
    # mass conservation: kept + residual is delta + error, exactly
    for p, r, d, e in zip(tree_leaves(tp), tree_leaves(tr), tree_leaves(_tt(delta)),
                          tree_leaves(_tt(err))):
        assert torch.equal(p + r, d + e)


def test_cohort_encode_equals_per_client_encode():
    """``encode_cohort`` (the reference's vmap, written out) is each client's
    ``encode``, for every codec, fused and per-leaf."""
    from repro_torch.core.federated import uplink_keys

    C = 3
    rng = np.random.default_rng(12)
    deltas = tree_map(lambda x: torch.from_numpy(
        (rng.standard_normal((C,) + tuple(x.shape)) * 1e-2).astype(np.float32)), _tt(_tree(0)))
    res = tree_map(lambda x: 0.5 * x, deltas)
    rngs = uplink_keys({"rng": np.asarray([1, 2], np.uint32), "round": 0}, C)
    for codec in (TC.TopKCodec(0.1), TFusedTopK(0.1), TC.Int8Codec(),
                  TFusedInt8(), TC.Bf16Codec(), TFusedBf16()):
        payload, new_res = codec.encode_cohort(deltas, res if codec.stateful else None,
                                               rngs if codec.needs_rng else None)
        decoded = codec.decode_cohort(payload)
        for c in range(C):
            one = lambda t: tree_map(lambda x: x[c], t)  # noqa: E731
            p1, r1 = codec.encode(one(deltas), one(res) if codec.stateful else None,
                                  rng=rngs[c] if codec.needs_rng else None)
            assert [_bits(a).tolist() for a in tree_leaves(one(payload))] == \
                [_bits(a).tolist() for a in tree_leaves(p1)], codec
            if codec.stateful:
                assert all(torch.equal(a, b) for a, b in zip(tree_leaves(one(new_res)),
                                                             tree_leaves(r1)))
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(one(decoded)),
                                                         tree_leaves(codec.decode(p1))))


@pytest.mark.parametrize("scheme", ["float32", "bf16", "int8", "topk"])
@pytest.mark.parametrize("fused", [False, True], ids=["per-leaf", "fused"])
def test_byte_accounting_matches_reference(scheme, fused):
    tree = _tree(13)
    for kf in (0.01, 0.05, 0.3):
        assert TC.uplink_bytes(_tt(tree), scheme, kf) == JC.uplink_bytes(_jt(tree), scheme, kf)
        jc = JC.get_codec(scheme, kf, fused=fused)
        tc = TC.get_codec(scheme, kf, fused=fused)
        assert type(tc).__name__ == type(jc).__name__
        assert (tc.name, tc.stateful, tc.needs_rng) == (jc.name, jc.stateful, jc.needs_rng)
        assert tc.nbytes(_tt(tree)) == jc.nbytes(_jt(tree))
        payload, _ = tc.encode(_tt(tree), tc.init_residual(_tt(tree)))
        j_payload, _ = jc.encode(_jt(tree), jc.init_residual(_jt(tree)))
        assert tc.payload_nbytes(payload) == jc.payload_nbytes(j_payload) == tc.nbytes(_tt(tree))
    assert TC._topk_index_nbytes(1 << 16) == 2.0 and TC._topk_index_nbytes((1 << 16) + 1) == 4.0


def test_byte_models_match_reference():
    from repro.kernels.fedcore import server_apply_bytes as j_sab
    from repro.kernels.fedcore import topk_encode_bytes as j_teb
    from repro_torch.kernels.fedcore import server_apply_bytes as t_sab
    from repro_torch.kernels.fedcore import topk_encode_bytes as t_teb

    for n, c, opt, noise, fused in [(74_104_832, 4, "fedavg", False, True),
                                    (1000, 3, "fedmom", True, False),
                                    (4096, 40, "fedadam", True, True)]:
        assert t_sab(n, c, opt, noise, fused) == j_sab(n, c, opt, noise, fused)
    for fused in (False, True):
        assert t_teb(74_104_832, fused) == j_teb(74_104_832, fused)
