"""The port has every public name of the reference, and each name added for
the examples' slice computes what the reference's does.

The name diff reads both packages with ``ast`` (importing neither): a
module's public names are its top-level functions, classes and assignments
and the names it imports from its own package, less those starting with
``_``. Every reference module must have a counterpart in ``repro_torch``
holding all of them, apart from an allowlist that is exactly the mesh
tooling still to port (ROADMAP queue A item 4). The allowlist is held tight
as well: each entry must still be missing, so it shrinks when item 4 lands.

Per-name parity, on the same numpy inputs: ``effective_clients`` and
``weight_entropy`` bitwise (the round's own in-device monitor agrees within
float32 rounding); ``cross_entropy`` with ignored labels and
``z_loss`` within 1e-6; ``activation_l2_probe`` on reduced photon-75m at
float32 compute within ``FAMILY_TOL`` (1e-5) relative; ``pack_flat`` /
``unpack_flat`` bitwise, layout and round trip; ``empty_cache_desc``'s keys,
shapes and dtypes."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from torch_parity import FAMILY_TOL, assert_close, family_tokens, jax_to_torch

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: ROADMAP queue A item 4 (the mesh tooling), the only reference names the
#: port may lack: whole modules or packages, then models/common.py's names
#: (wherever the reference defines them or imports them from there)
ALLOWED_MODULES = ("launch/steps.py", "launch/dryrun.py", "launch/mesh.py",
                   "launch/autobatch.py", "sharding/", "roofline/")
ALLOWED_NAMES = {"repro.models.common": {"param_axes", "param_shapes", "shard_hint"}}


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
    still = {n for lost in missing_names.values() for n, origin in lost.items()
             if n in ALLOWED_NAMES.get(origin, ())}
    assert still == ALLOWED_NAMES["repro.models.common"]


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
