"""The port has every public name of the reference, and each name added for
the examples' slice computes what the reference's does.

The name diff reads both packages with ``ast`` (importing neither): a
module's public names are its top-level functions, classes and assignments
and the names it imports from its own package, less those starting with
``_``. Every reference module must have a counterpart in ``repro_torch``
holding all of them, apart from an allowlist of what the port lacks by
design. The member diff does the same one level down: every public
function's parameters and every public class's fields, methods and method
parameters, again with an allowlist of what differs by design. Both
allowlists are held tight: each entry must still be missing.

Per-name parity, on the same numpy inputs: ``effective_clients`` and
``weight_entropy`` bitwise (the round's own in-device monitor agrees within
float32 rounding); ``cross_entropy`` with ignored labels and
``z_loss`` within 1e-6; ``activation_l2_probe`` on reduced photon-75m at
float32 compute within ``FAMILY_TOL`` (1e-5) relative; ``pack_flat`` /
``unpack_flat`` bitwise, layout and round trip; ``empty_cache_desc``'s keys,
shapes and dtypes; ``AsyncBufferAggregator.checkpoint_state`` key path by
key path against the reference's on the same run (values to 1e-6, but
the rng lane, which the port advances by its own rule);
``SegmentPlan.n_layers`` and ``int8_decompress(..., like=)``."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from torch_parity import FAMILY_TOL, assert_close, family_tokens, jax_flat, jax_to_torch

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: the reference names the port lacks by design: whole modules, then names
#: by the module that defines them (wherever the reference imports them)
ALLOWED_MODULES = (
    # parses XLA's optimized HLO text, which a torch program has none of; the
    # port's counterpart is the dispatch counter of roofline/analysis.py
    "roofline/hlo_analyzer.py",
)
ALLOWED_NAMES = {
    # its HLO collective parser and the HLO cost analyzer, as above
    "repro.roofline.analysis": {"parse_collectives"},
    "repro.roofline.hlo_analyzer": {"analyze_hlo_text"},
    # a TPU v5e's memory: the port states no TPU memory size
    "repro.launch.autobatch": {"TPU_V5E_HBM"},
    # a layout hint for an ambient mesh: the port runs one card per program,
    # where every layout is the whole tensor, so it could only be the
    # identity; no module of the port would call it
    "repro.models.common": {"shard_hint"},
    # the reference's module-level os.environ["XLA_FLAGS"] assignment (512
    # placeholder host devices for XLA); the port plans with no devices
    "repro.launch.dryrun": {"os"},
}

#: members (function parameters, class fields, methods and their parameters,
#: as ``members`` names them) the port lacks by design, by ``module::name``
ALLOWED_MEMBERS = {
    # buffer donation is XLA's; the port's round builds new state and drops
    # the old (core/aggregator.py's round docstring)
    "core/aggregator.py::SyncAggregator": {"__init__(donate)", "__init__(shard_clients)"},
    # the client-stacked layout hook (``shard_clients=``): on the one card
    # the port runs it could only be the identity, so no caller would pass
    # it; the mesh steps refuse a wider mesh instead (Mesh.require_one_device)
    "core/federated.py::run_clients": {"shard_clients"},
    "core/federated.py::federated_round": {"shard_clients"},
    "core/federated.py::federated_round_with_uplink": {"shard_clients"},
    "core/federated.py::run_client_tile": {"shard_clients"},
    # the inner optimizer works on flat leaf lists, not trees
    "core/inner_opt.py::clip_by_global_norm": {"tree"},
    "core/inner_opt.py::init_inner_state": {"params"},
    # the Pallas switches (block sizes, interpret mode, the use_pallas
    # toggle of the fused codecs): a CUDA kernel has no interpret mode and
    # picks its own blocks; the int8 wrappers take the packed cohort's
    # (C, L) scale table (``scales``) where the reference's take one scale
    "kernels/fedcore/kernel.py::server_apply": {"block", "interpret"},
    "kernels/fedcore/kernel.py::topk_mask_ef": {"block", "interpret"},
    "kernels/fedcore/kernel.py::sr_bf16": {"block", "interpret"},
    "kernels/fedcore/kernel.py::int8_quant": {"block", "interpret", "scale"},
    "kernels/fedcore/kernel.py::int8_dequant": {"block", "interpret", "scale"},
    "kernels/fedcore/ops.py::fused_apply_aggregate": {"block", "interpret", "use_pallas"},
    "kernels/fedcore/ops.py::FusedTopKCodec": {"block", "interpret", "use_pallas"},
    "kernels/fedcore/ops.py::FusedBf16Codec": {"__init__()", "__init__(block)",
                                               "__init__(interpret)", "__init__(use_pallas)"},
    "kernels/fedcore/ops.py::FusedInt8Codec": {"__init__()", "__init__(block)",
                                               "__init__(interpret)", "__init__(use_pallas)"},
    "kernels/flash_attention/kernel.py::flash_attention_fwd": {"block_k", "block_q", "interpret"},
    "kernels/flash_attention/ops.py::flash_attention": {"interpret"},
    "kernels/flash_decode/kernel.py::flash_decode_fwd": {"block_k", "interpret"},
    "kernels/flash_decode/ops.py::flash_decode": {"interpret"},
    "kernels/rmsnorm/kernel.py::rmsnorm_fwd": {"block_rows", "interpret"},
    "kernels/rmsnorm/ops.py::rmsnorm": {"interpret"},
    "kernels/ssd_scan/kernel.py::ssd_scan_fwd": {"interpret"},
    "kernels/ssd_scan/ops.py::ssd": {"interpret"},
    # the port reads a measured run (roofline.analysis.Measured), not XLA's
    # compiled object
    "launch/autobatch.py::verify_micro_batch": {"compiled"},
    "roofline/analysis.py::analyze_compiled": {"compiled"},
    # the port seeds with an int, the reference with a PRNG key
    "models/common.py::init_params": {"rng"},
    # Model.init's key (as above); Model.loss's use_pallas: no kernel of
    # either package has a backward pass
    "models/model.py::Model": {"init(rng)", "loss(use_pallas)"},
}


def public_names(path: Path, package: str) -> dict:
    """``{name: origin module}`` of a module's public top-level names (see the
    module docstring); a definition's origin is the module itself."""
    rel = path.relative_to(ROOT / "src" / package)
    here = ".".join((package,) + rel.with_suffix("").parts)
    if here.endswith(".__init__"):
        here = here[: -len(".__init__")]
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = here
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out[n.id] = here
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level or module == package or module.startswith(package + "."):
                for a in node.names:
                    out[a.asname or a.name] = module
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _allowed_module(rel: str) -> bool:
    return any(rel == a or (a.endswith("/") and rel.startswith(a)) for a in ALLOWED_MODULES)


def _name_diff():
    missing_modules, missing_names = [], {}
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        twin = PORT / rel
        if not twin.exists():
            missing_modules.append(rel)
            continue
        want = public_names(path, "repro")
        have = public_names(twin, "repro_torch")
        lost = {n: want[n] for n in want if n not in have}
        if lost:
            missing_names[rel] = lost
    return missing_modules, missing_names


def test_port_has_every_public_name_but_the_mesh_tooling():
    """Every public name but ``ALLOWED_MODULES`` / ``ALLOWED_NAMES`` (the
    mesh tooling's by-design gaps, now that it is ported)."""
    missing_modules, missing_names = _name_diff()
    assert [m for m in missing_modules if not _allowed_module(m)] == []
    unexpected = {rel: sorted(n for n, origin in lost.items()
                              if n not in ALLOWED_NAMES.get(origin, ()))
                  for rel, lost in missing_names.items()}
    assert {rel: n for rel, n in unexpected.items() if n} == {}


def test_the_allowlist_is_still_missing_from_the_port():
    missing_modules, missing_names = _name_diff()
    for entry in ALLOWED_MODULES:
        hits = [m for m in missing_modules if _allowed_module(m) and m.startswith(entry)]
        assert hits, f"{entry} exists in the port now: take it off the allowlist"
    still = {(origin, n) for lost in missing_names.values() for n, origin in lost.items()
             if n in ALLOWED_NAMES.get(origin, ())}
    assert still == {(origin, n) for origin, names in ALLOWED_NAMES.items() for n in names}


def members(path: Path) -> dict:
    """``{name: {member}}`` of a module's public top-level functions and
    classes: a function's parameter names; a class's annotated fields, its
    public methods and ``__init__`` as ``"m()"``, each method parameter as
    ``"m(arg)"``."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if node.name.startswith("_") if hasattr(node, "name") else True:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            out[node.name] = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
        elif isinstance(node, ast.ClassDef):
            got = set()
            for b in node.body:
                if isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    got.add(b.target.id)
                elif isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not b.name.startswith("_") or b.name == "__init__"):
                    got.add(f"{b.name}()")
                    a = b.args
                    got.update(f"{b.name}({x.arg})" for x in a.posonlyargs + a.args + a.kwonlyargs
                               if x.arg not in ("self", "cls"))
            out[node.name] = got
    return out


def _member_diff():
    diff = {}
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        twin = PORT / rel
        if not twin.exists():
            continue
        want, have = members(path), members(twin)
        for name in want:
            lost = want[name] - have.get(name, want[name])
            if lost:
                diff[f"{rel}::{name}"] = lost
    return diff


def test_port_has_every_member_and_keyword_but_the_allowlist():
    diff = _member_diff()
    unexpected = {k: sorted(v - ALLOWED_MEMBERS.get(k, set())) for k, v in diff.items()}
    assert {k: v for k, v in unexpected.items() if v} == {}


def test_the_member_allowlist_is_still_missing_from_the_port():
    diff = _member_diff()
    for key, allowed in ALLOWED_MEMBERS.items():
        assert allowed <= diff.get(key, set()), f"{key}: {sorted(allowed - diff.get(key, set()))}"


def test_members_reads_parameters_fields_and_methods():
    got = members(REF / "core" / "federated.py")
    assert {"pre_split_micro", "grad_accum"} <= got["FederatedConfig"]
    assert {"shard_clients", "codec", "loss_fn"} <= got["run_clients"]
    assert {"n_layers()", "window_array()", "window_array(all_kinds)"} <= \
        members(REF / "models" / "transformer.py")["SegmentPlan"]


def test_public_names_reads_definitions_and_package_imports():
    names = public_names(REF / "models" / "model.py", "repro")
    assert names["cross_entropy"] == "repro.models.model"
    assert names["param_axes"] == "repro.models.common"
    assert "jnp" not in names and "jax" not in names
    assert public_names(PORT / "kernels" / "ssd_scan" / "__init__.py",
                        "repro_torch")["ops"] == "repro_torch.kernels.ssd_scan"


# ---------------------------------------------------------------------------
# The new functions against the reference's
# ---------------------------------------------------------------------------

WEIGHTS = [
    [0.0, 2.0, 0.0, 1.0],
    [1.0, 1.0, 1.0, 1.0],
    [5.0, 0.0, 0.0],
    [],
    [0.0, 0.0],
    [3.0, 1e-30, 7.5, 0.25, 0.0, 12.0],
]


@pytest.mark.parametrize("w", WEIGHTS, ids=lambda w: str(len(w)))
def test_effective_clients_and_weight_entropy_are_the_references(w):
    from repro.metrics import effective_clients as j_eff
    from repro.metrics import weight_entropy as j_ent
    from repro_torch.metrics import effective_clients, weight_entropy

    assert effective_clients(w) == j_eff(w)
    assert type(effective_clients(w)) is type(j_eff(w)) is int
    assert weight_entropy(np.asarray(w)) == j_ent(np.asarray(w))  # bitwise: same f64 ops
    assert type(weight_entropy(w)) is type(j_ent(w)) is float


def test_round_metrics_read_the_weight_monitors():
    """The round's in-device weighted monitors (``aggregation_metrics``)
    agree with the two host functions on the finite clients' weights: the
    count exactly, the entropy to float32 rounding."""
    from repro_torch.core.federated import aggregation_metrics
    from repro_torch.metrics import effective_clients, weight_entropy

    w = torch.tensor([0.5, 0.0, 2.0, 1.5, 3.0])
    norms = torch.tensor([1.0, 2.0, float("nan"), 0.5, 4.0])
    m = aggregation_metrics(norms, torch.tensor(1.25), w)
    finite_w = torch.where(torch.isfinite(norms), w, torch.zeros_like(w)).numpy()
    assert float(m["effective_clients"]) == effective_clients(finite_w) == 3
    assert_close(float(m["weight_entropy"]), weight_entropy(finite_w), atol=1e-6, rtol=1e-6,
                 what="entropy")


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_the_reference(z_loss):
    import jax.numpy as jnp

    from repro.models import cross_entropy as j_ce
    from repro_torch.models import cross_entropy

    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 17, 101)) * 4).astype(np.float32)
    labels = rng.integers(0, 101, (3, 17)).astype(np.int32)
    labels[0, :5] = -1  # ignored positions
    labels[2, -1] = -1
    jl, jm = j_ce(jnp.asarray(logits), jnp.asarray(labels), z_loss)
    tl, tm = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_loss)
    assert sorted(tm) == sorted(jm)
    assert ("z_loss" in tm) == bool(z_loss)
    assert_close(float(tl), float(jl), atol=1e-6, rtol=1e-6, what="loss")
    for k in jm:
        assert_close(float(tm[k]), float(jm[k]), atol=1e-6, rtol=1e-6, what=k)
    assert float(tm["n_tokens"]) == float(jm["n_tokens"]) == 3 * 17 - 6


def test_cross_entropy_with_every_label_ignored_is_zero_over_one_token():
    import jax.numpy as jnp

    from repro.models import cross_entropy as j_ce
    from repro_torch.models import cross_entropy

    logits = np.random.default_rng(0).standard_normal((1, 4, 9)).astype(np.float32)
    labels = -np.ones((1, 4), np.int32)
    _, jm = j_ce(jnp.asarray(logits), jnp.asarray(labels))
    _, tm = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    for k in jm:
        assert float(tm[k]) == float(jm[k]), k


def test_activation_l2_probe_matches_the_reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_cfg
    from repro.metrics import activation_l2_probe as j_probe
    from repro.models import build_model as j_build
    from repro_torch.configs import get_config as t_cfg
    from repro_torch.metrics import activation_l2_probe
    from repro_torch.models import build_model as t_build

    jm = j_build(dataclasses.replace(j_cfg("photon-75m").reduced(), compute_dtype="float32"))
    tm = t_build(dataclasses.replace(t_cfg("photon-75m").reduced(), compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    toks = family_tokens(jm.cfg, 2, 40, seed=5)
    want = j_probe(jm, jp, {"tokens": jnp.asarray(toks)})
    got = activation_l2_probe(tm, jax_to_torch(jp), {"tokens": torch.from_numpy(toks)})
    assert isinstance(got, float) and got > 0
    assert_close(got, want, rtol=FAMILY_TOL, what="activation_l2_probe")


def _tree(rng):
    return {
        "a": rng.standard_normal((3, 5)).astype(np.float32),
        "b": [rng.standard_normal(7).astype(np.float32),
              {"c": rng.standard_normal((2, 2, 2)).astype(np.float32)}],
        "d": np.asarray(rng.standard_normal(), np.float32),
    }


@pytest.mark.parametrize("pad", [1, 8, 64])
def test_pack_flat_and_unpack_flat_match_the_reference(pad):
    import jax.numpy as jnp

    from repro.kernels.fedcore import pack_flat as j_pack
    from repro.kernels.fedcore import unpack_flat as j_unpack
    from repro_torch.kernels.fedcore import pack_flat, unpack_flat
    from repro_torch.tree import tree_leaves

    tree = _tree(np.random.default_rng(pad))
    jt = {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(tree["b"][0]),
                                             {"c": jnp.asarray(tree["b"][1]["c"])}],
          "d": jnp.asarray(tree["d"])}
    tt = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0]),
                                                  {"c": torch.from_numpy(tree["b"][1]["c"])}],
          "d": torch.from_numpy(tree["d"])}
    j_flat, j_def, j_spec = j_pack(jt, pad)
    t_flat, t_def, t_spec = pack_flat(tt, pad)
    assert (t_spec.shapes, t_spec.n, t_spec.n_pad, t_spec.offsets) == (
        j_spec.shapes, j_spec.n, j_spec.n_pad, j_spec.offsets)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))  # the layout, bitwise
    back = unpack_flat(t_flat, t_def, t_spec)
    for got, want in zip(tree_leaves(back), tree_leaves(tt)):
        assert got.shape == want.shape and torch.equal(got, want)
    j_back = j_unpack(j_flat, j_def, j_spec)
    np.testing.assert_array_equal(np.asarray(j_back["b"][1]["c"]), back["b"][1]["c"].numpy())


@pytest.mark.parametrize("arch", ["photon-75m", "qwen3-1.7b", "gemma3-4b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_empty_cache_desc_matches_the_reference(arch, dtype):
    import jax.numpy as jnp

    from repro.configs import get_config as j_cfg
    from repro.models.attention import empty_cache_desc as j_empty
    from repro_torch.configs import get_config as t_cfg
    from repro_torch.models.attention import empty_cache_desc

    want = j_empty(j_cfg(arch).reduced(), 3, 11, getattr(jnp, dtype))
    got = empty_cache_desc(t_cfg(arch).reduced(), 3, 11, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(want) == ["k", "v"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert got[k].device.type == "cpu" and not bool(got[k].any())


# ---------------------------------------------------------------------------
# The members the member diff found missing, against the reference's
# ---------------------------------------------------------------------------


def test_segment_plan_n_layers_is_the_references():
    from repro.configs import get_config as j_cfg
    from repro.models.transformer import plan_segments as j_plan
    from repro_torch.configs import get_config as t_cfg
    from repro_torch.models.transformer import plan_segments

    for arch in ("jamba-v0.1-52b", "deepseek-moe-16b", "gemma3-4b", "mamba2-1.3b"):
        want = [s.n_layers for s in j_plan(j_cfg(arch).layer_kinds())]
        got = [s.n_layers for s in plan_segments(t_cfg(arch).layer_kinds())]
        assert got == want and sum(got) == t_cfg(arch).n_layers, arch


def test_int8_decompress_takes_the_references_like_argument():
    import jax.numpy as jnp

    from repro.core.compression import int8_compress as j_comp
    from repro.core.compression import int8_decompress as j_dec
    from repro_torch.core.compression import int8_compress, int8_decompress

    x = {"a": np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)}
    want = j_dec(j_comp({"a": jnp.asarray(x["a"])}), like={"a": None})
    tc = int8_compress({"a": torch.from_numpy(x["a"])})
    for like in (None, {"a": torch.zeros(5, 3)}):
        got = int8_decompress(tc, like=like)
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))


def _quad(torch_side):
    if torch_side:
        def loss(params, batch):
            v = torch.mean(torch.square(batch["x"] @ params["w"] - batch["y"]))
            return v, {"loss": v}
    else:
        import jax.numpy as jnp

        def loss(params, batch):
            v = jnp.mean(jnp.square(batch["x"] @ params["w"] - batch["y"]))
            return v, {"loss": v}
    return loss


def test_checkpoint_state_is_the_references_dense_schema():
    """Both packages' async drivers on a quadratic model with the per-leaf
    top-k uplink, three updates: ``checkpoint_state`` has the reference's
    key paths and shapes, the residual lane dense over the population (rows
    of never-dispatched clients zero), values within 1e-6; it is a copy."""
    import jax
    import jax.numpy as jnp

    import repro.core as J
    import repro_torch.core as T
    from repro_torch.tree import params_to_numpy

    rng = np.random.default_rng(0)
    w = {"w": rng.standard_normal((4, 4)).astype(np.float32)}
    batches = {c: {"x": rng.standard_normal((2, 1, 8, 4)).astype(np.float32),
                   "y": rng.standard_normal((2, 1, 8, 4)).astype(np.float32)} for c in range(6)}
    drivers = []
    for mod, torch_side in ((J, False), (T, True)):
        sgd = mod.InnerOptConfig(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9,
                                 warmup_steps=0, total_steps=100, alpha=1.0)
        fed = mod.FederatedConfig(clients_per_round=3, local_steps=2, inner=sgd)
        pcfg = mod.ParticipationConfig(population=6, clients_per_round=3,
                                       straggler=mod.STRAGGLER_PROFILES["heavy"])
        conv = (lambda t: torch.from_numpy(t)) if torch_side else jnp.asarray
        drv = mod.AsyncFederationDriver(
            _quad(torch_side), fed, mod.AsyncAggConfig(buffer_size=2, staleness_alpha=0.5),
            pcfg, lambda c, conv=conv: {k: conv(v) for k, v in batches[c].items()}, seed=2,
            params={"w": conv(w["w"])}, rng=jax.random.PRNGKey(1) if not torch_side
            else T.prng_key(1), codec=mod.get_codec("topk", 0.25))
        drv.run_updates(3)
        drivers.append(drv)
    jdrv, tdrv = drivers
    want, got = jax_flat(jdrv.checkpoint_state()), params_to_numpy(tdrv.checkpoint_state())
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k != "['rng']":  # the port advances its rng lane by its own rule
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    res = got["['uplink_residuals']['w']"]
    assert res.shape == (6, 4, 4)
    never = sorted(set(range(6)) - set(tdrv.residuals.ids()))
    assert all(not res[c].any() for c in never)
    snap = tdrv.checkpoint_state()
    tdrv.run_updates(1)
    assert np.array_equal(params_to_numpy(snap)["['params']['w']"], got["['params']['w']"])
