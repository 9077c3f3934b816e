"""Step builders shared by the dry run and the host-mesh runs, the counterpart
of ``repro.launch.steps``.

For every (architecture × input shape × mesh) this module produces:
  - the step function (federated round / cohort tile / centralized step /
    prefill / decode) on real tensors,
  - its plan: abstract inputs as ``meta`` tensors (shapes and dtypes, no
    memory) with a parallel tree of PartitionSpecs (``sharding.specs``), the
    ``input_specs()`` contract.

The plan of a production mesh is never run: the port has no compile that
spans cards, so it reports per-device argument bytes from the specs
(:func:`arg_bytes_per_device`) where the reference reads XLA's memory
analysis. On the host mesh (one card) :func:`materialize` makes real inputs
and the step runs.

``donate_argnums`` has no counterpart. The port's steps replace nothing in
place: the federated round, the tile and the centralized step leave their
input state as it was and return a new one (the fused server phase writes
over packed copies), and the decode step writes a new cache (the old one is
cloned, never written). A caller that drops its old state or cache frees
it, which is what donation buys the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.core import (
    FederatedConfig,
    InnerOptConfig,
    OuterOptConfig,
    centralized_step,
    federated_round,
    get_codec,
    init_uplink_residuals,
    prng_key,
    run_client_tile,
)
from repro_torch.core.outer_opt import init_outer_state
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import P
from repro_torch.tree import tree_leaves, tree_map


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _like_meta(tree):
    return tree_map(lambda x: _meta(x.shape, x.dtype), tree)


# ---------------------------------------------------------------------------
# Abstract parameter / state trees: (meta tensors, PartitionSpecs)
# ---------------------------------------------------------------------------


def abstract_params(model, mesh: Mesh, fsdp_axes: Tuple[str, ...] = (), dtype=None):
    """``(params, pspecs)``: the params as meta tensors and their specs."""
    params = model.abstract_params(dtype)
    return params, sh.params_pspecs(mesh, model.axes(), model.shapes(), fsdp_axes)


def _serve_fsdp_axes(cfg: ModelConfig, mesh: Mesh) -> Tuple[str, ...]:
    """Weight-gathered serving for models whose bf16 weights overflow one
    model-parallel slice (>20B params): shard params over the batch axes too."""
    return sh.client_axes(mesh) if cfg.param_count() > 20e9 else ()


def abstract_fed_state(model, mesh: Mesh, fed: FederatedConfig,
                       fsdp_axes: Tuple[str, ...] = ()):
    """``(state, state_specs, pspecs)`` of the server state: params and the
    outer lanes as meta tensors with the params' specs; the round counters
    int32 scalars and the rng lane a (2,) uint32 key, replicated."""
    params, pspecs = abstract_params(model, mesh, fsdp_axes)
    outer, outer_specs = {}, {}
    for key, val in init_outer_state(fed.outer, params).items():
        if key == "round":
            outer[key], outer_specs[key] = _meta((), torch.int32), P()
        else:
            outer[key], outer_specs[key] = _like_meta(val), pspecs
    state = {"params": params, "outer": outer, "round": _meta((), torch.int32),
             "rng": _meta((2,), torch.uint32)}
    specs = {"params": pspecs, "outer": outer_specs, "round": P(), "rng": P()}
    return state, specs, pspecs


# ---------------------------------------------------------------------------
# input_specs()
# ---------------------------------------------------------------------------


def input_specs(
    cfg: ModelConfig,
    shape: InputShape,
    mesh: Mesh,
    *,
    tau_lowered: int = 4,
    mode: str = "federated",  # 'federated' | 'centralized' (train shapes only)
):
    """``(inputs, specs)``: the model inputs of an input shape as meta
    tensors, and their PartitionSpecs.

    Training batches are PRE-SPLIT into micro-batches: federated
    (τ, C, grad_accum, B_micro, ...) with the client dim over the client axes and the
    micro-batch dim over the within-client FSDP/DDP axes; centralized
    (grad_accum, B_micro, ...).
    """
    ca = sh.client_axes(mesh)
    bf16 = torch.bfloat16
    if shape.kind == "train":
        client_ax, fsdp_ax, C = sh.choose_client_mapping(mesh, cfg.param_count())
        b_loc = shape.global_batch // C
        fsdp_div = sh.axes_size(mesh, fsdp_ax)
        ga = default_grad_accum(b_loc, shape.seq_len, fsdp_div,
                                target_tokens=_target_tokens(cfg))
        if mode == "federated":
            b_mb = b_loc // ga
            cspec = client_ax if client_ax else None
            bspec = fsdp_ax if fsdp_ax else None
            lead = (tau_lowered, C, ga, b_mb)
            out = {"tokens": _meta(lead + (shape.seq_len,), torch.int32)}
            specs = {"tokens": P(None, cspec, None, bspec, None)}
            if cfg.enc_dec:
                out["audio_embed"] = _meta(lead + (cfg.n_audio_frames, cfg.d_model), bf16)
                specs["audio_embed"] = P(None, cspec, None, bspec, None, None)
            return out, specs
        # centralized per-step batch, micro-batches pre-split
        ga_c = default_grad_accum(
            shape.global_batch, shape.seq_len,
            fsdp_div=mesh.size // mesh.shape["model"],
            target_tokens=_target_tokens(cfg),
        )
        b_mb = shape.global_batch // ga_c
        out = {"tokens": _meta((ga_c, b_mb, shape.seq_len), torch.int32)}
        specs = {"tokens": P(None, ca, None)}
        if cfg.enc_dec:
            out["audio_embed"] = _meta((ga_c, b_mb, cfg.n_audio_frames, cfg.d_model), bf16)
            specs["audio_embed"] = P(None, ca, None, None)
        return out, specs

    bspec = ca if shape.global_batch >= sh.n_clients(mesh) else None
    if shape.kind == "prefill":
        out = {"tokens": _meta((shape.global_batch, shape.seq_len), torch.int32)}
        specs = {"tokens": P(bspec, None)}
        if cfg.enc_dec:
            out["audio_embed"] = _meta((shape.global_batch, cfg.n_audio_frames, cfg.d_model),
                                       bf16)
            specs["audio_embed"] = P(bspec, None, None)
        return out, specs
    if shape.kind == "decode":
        return ({"tokens": _meta((shape.global_batch, 1), torch.int32),
                 "cache_index": _meta((), torch.int32)},
                {"tokens": P(bspec, None), "cache_index": P()})
    raise ValueError(shape.kind)


def abstract_cache(cfg: ModelConfig, shape: InputShape, mesh: Mesh, model=None):
    """``(cache, specs)``: the KV/SSM cache as meta tensors with the serving
    specs (sequence-sharded KV)."""
    model = model or build_model(cfg)
    long_ctx = shape.seq_len > 100_000
    cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16, device="meta")
    base_ndim = {"kv": 4, "conv": 3, "ssd": 4, "cross": 4}

    def specs(node, keys):
        if isinstance(node, dict):
            return {k: specs(v, keys + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [specs(v, keys + [i]) for i, v in enumerate(node)]
        name = keys[-1]
        kind = ("cross" if "cross" in keys else "kv") if name in ("k", "v") else name
        extra = node.ndim - base_ndim[kind]
        core = sh.decode_cache_pspec(mesh, tuple(node.shape[extra:]), kind, long_ctx)
        return P(*([None] * extra), *core)

    return _like_meta(cache), specs(cache, [])


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


@dataclass
class BuiltStep:
    name: str
    fn: Callable  # the step on real tensors: fn(*materialize(step))
    args: Tuple  # abstract args: trees of meta tensors
    model_flops: float  # 6·N_active·D equivalent for the roofline
    meta: Dict[str, Any]
    arg_specs: Tuple = ()  # PartitionSpec trees parallel to args
    mesh: Optional[Mesh] = None
    model: Any = None
    #: what each arg is, for :func:`materialize`: fed_state | tile_state |
    #: central_state | params | batch | weights | residuals | tau_steps |
    #: cache | tokens | cache_index
    arg_kinds: Tuple[str, ...] = field(default_factory=tuple)


def arg_bytes_per_device(step: BuiltStep) -> int:
    """Bytes of one device's block of every argument (the reference's
    ``shard_shape`` sums over its inputs)."""
    total = 0
    for arg, specs in zip(step.args, step.arg_specs):
        leaves = tree_leaves(arg)
        spec_leaves = _spec_leaves(specs)
        assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
        for x, spec in zip(leaves, spec_leaves):
            block = sh.shard_shape(step.mesh, tuple(x.shape), spec)
            total += int(np.prod(block, dtype=np.int64)) * x.element_size()
    return total


def _spec_leaves(tree):
    """Spec leaves in the tensors' flatten order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _spec_leaves(t)]
    return [tree]


def default_fed_config(C: int, tau_lowered: int, grad_accum: int = 1) -> FederatedConfig:
    return FederatedConfig(
        clients_per_round=C,
        local_steps=tau_lowered,
        inner=InnerOptConfig(lr_max=3e-4, total_steps=60_000),
        outer=OuterOptConfig(name="fedmom", lr=0.7, momentum=0.9),
        grad_accum=grad_accum,
    )


def _target_tokens(cfg: ModelConfig) -> int:
    """Per-device tokens per micro-batch: activation carries scale with the model's
    widest live buffer (d_model; or the MoE expert dispatch width), so wide models
    get smaller micro-batches."""
    width = max(cfg.d_model, (cfg.moe_d_ff or 0) // 2)
    if cfg.n_heads % 16:
        # head_dim-fallback sharding replicates score blocks across the model axis;
        # scale micro-batches down to compensate (whisper 20H, coder 56H, llama4 40H)
        width *= 4
    return max(4096, 16_384 * 2048 // width)


def default_grad_accum(
    b_loc: int, seq_len: int, fsdp_div: int = 1, target_tokens: int = 16_384
) -> int:
    """Micro-batches per local step so one micro-batch is ~target_tokens per DEVICE of
    the within-client group, with the micro-batch divisible by the FSDP width."""
    rows_per_dev = max(1, target_tokens // seq_len)
    b_mb = min(b_loc, max(1, fsdp_div) * rows_per_dev)
    ga = max(1, b_loc // b_mb)
    while ga > 1 and (b_loc % ga or (b_loc // ga) % max(1, fsdp_div)):
        ga -= 1
    return ga


def build_train_step(
    cfg: ModelConfig,
    shape: InputShape,
    mesh: Mesh,
    *,
    tau_lowered: int = 4,
    remat: bool = True,
    mode: str = "federated",
    fed: Optional[FederatedConfig] = None,
    pseudo_grad_dtype: str = "float32",
    elastic: bool = True,
    uplink: str = "float32",
    topk_fraction: float = 0.05,
    partial_progress: bool = False,
    fused_server: bool = False,
    cohort_tile: Optional[int] = None,
) -> BuiltStep:
    model = build_model(cfg)
    loss_fn = lambda p, b: model.loss(p, b, remat=remat)  # noqa: E731

    if mode == "federated":
        client_ax, fsdp_ax, C = sh.choose_client_mapping(mesh, cfg.param_count())
        b_loc = shape.global_batch // C
        fsdp_div = sh.axes_size(mesh, fsdp_ax)
        ga = default_grad_accum(b_loc, shape.seq_len, fsdp_div,
                                target_tokens=_target_tokens(cfg))
        fed = replace(fed or default_fed_config(C, tau_lowered, ga), pre_split_micro=True)
        if pseudo_grad_dtype != "float32":
            fed = replace(fed, pseudo_grad_dtype=pseudo_grad_dtype)
        state, state_specs, pspecs = abstract_fed_state(model, mesh, fed, fsdp_ax)
        client_pspecs = sh.clientize_tree(mesh, pspecs, client_ax)

        # the fused flat-buffer server phase consumes the whole (C, N) delta
        # buffer in one kernel, which cannot span a sharded client axis: on a
        # multi-device mesh the flag keeps the reference server phase (plans,
        # shardings and footprint identical with or without it); only a
        # one-device mesh swaps the fused pass in
        fused_active = fused_server and mesh.size == 1
        codec = (get_codec(uplink, topk_fraction, fused=fused_active)
                 if uplink != "float32" else None)
        stateful = codec is not None and codec.stateful
        if (stateful or partial_progress) and not elastic:
            raise ValueError(
                "stateful uplink codecs and partial progress require the elastic round"
            )
        apply_fn = None
        if fused_active:
            from repro_torch.kernels.fedcore import fused_apply_aggregate

            apply_fn = fused_apply_aggregate
        batches, batch_specs = input_specs(cfg, shape, mesh, tau_lowered=tau_lowered,
                                           mode="federated")

        if cohort_tile is not None:
            # ONE TILE of a streamed round (run_client_tile), client width =
            # cohort_tile: the population and the cohort never enter the plan
            if not elastic:
                raise ValueError("cohort tiling requires the elastic round: "
                                 "pad slots ride as zero-weight clients")
            if fused_server:
                raise ValueError(
                    "--fused-server consumes the full (C, N) delta buffer "
                    "with pre-normalized weights, not the tiled partial-sum layout"
                )
            client_width = sh.axes_size(mesh, client_ax)
            if cohort_tile % client_width:
                raise ValueError(
                    f"cohort_tile={cohort_tile} must be a multiple of the "
                    f"mesh client-axis width {client_width} (axes "
                    f"{list(client_ax)}): a sharded client dim must divide evenly"
                )
            fed_tile = replace(fed, clients_per_round=cohort_tile)
            batches = tree_map(
                lambda x: _meta((x.shape[0], cohort_tile) + tuple(x.shape[2:]), x.dtype),
                batches)
            tile_state = {k: state[k] for k in ("params", "round", "rng")}
            tile_specs = {k: state_specs[k] for k in ("params", "round", "rng")}
            args = (tile_state, batches, _meta((cohort_tile,), torch.float32))
            specs = (tile_specs, batch_specs, P())
            kinds = ("tile_state", "batch", "weights")
            if stateful:
                args += (init_uplink_residuals(codec, state["params"], cohort_tile),)
                specs += (client_pspecs,)
                kinds += ("residuals",)
            if partial_progress:
                args += (_meta((cohort_tile,), torch.int32),)
                specs += (P(),)
                kinds += ("tau_steps",)

            def _tile(s, b, w, *rest):
                mesh.require_one_device()
                kw = dict(zip(kinds[3:], rest))
                return run_client_tile(loss_fn, fed_tile, s, b, w, codec=codec, **kw)

            tokens_per_tile = tau_lowered * cohort_tile * (
                shape.global_batch // C) * shape.seq_len
            return BuiltStep(
                name=f"{cfg.name}:{shape.name}:federated-tile",
                fn=_tile, args=args, arg_specs=specs, mesh=mesh, model=model,
                arg_kinds=kinds,
                model_flops=6.0 * cfg.active_param_count() * tokens_per_tile,
                meta={
                    "tau_lowered": tau_lowered,
                    "tokens_per_call": tokens_per_tile,
                    "clients": cohort_tile,
                    "cohort_tile": cohort_tile,
                    "grad_accum": ga,
                    "client_axes": list(client_ax),
                    "fsdp_axes": list(fsdp_ax),
                    "elastic": elastic,
                    "uplink": uplink,
                    "partial_progress": partial_progress,
                    "fused_server": False,
                    "fused_server_requested": fused_server,
                },
            )
        # elastic participation: the (C,) weight vector is an input of the
        # round; the partial-progress τ-mask rides the same way
        args, specs, kinds = (state, batches), (state_specs, batch_specs), ("fed_state", "batch")
        if elastic:
            args += (_meta((C,), torch.float32),)
            specs += (P(),)
            kinds += ("weights",)
        if stateful:
            # per-client error-feedback residuals ride the mesh like the
            # client-stacked params: the same clientized specs
            args += (init_uplink_residuals(codec, state["params"], C),)
            specs += (client_pspecs,)
            kinds += ("residuals",)
        if partial_progress:
            args += (_meta((C,), torch.int32),)
            specs += (P(),)
            kinds += ("tau_steps",)
        names = {"weights": "client_weights", "residuals": "residuals", "tau_steps": "tau_steps"}

        def _round(s, b, *rest):
            mesh.require_one_device()
            kw = {names[k]: v for k, v in zip(kinds[2:], rest)}
            return federated_round(loss_fn, fed, s, b, codec=codec, apply_fn=apply_fn, **kw)

        tokens_per_round = tau_lowered * shape.global_batch * shape.seq_len
        return BuiltStep(
            name=f"{cfg.name}:{shape.name}:federated",
            fn=_round, args=args, arg_specs=specs, mesh=mesh, model=model, arg_kinds=kinds,
            model_flops=6.0 * cfg.active_param_count() * tokens_per_round,
            meta={
                "tau_lowered": tau_lowered,
                "tokens_per_call": tokens_per_round,
                "clients": C,
                "grad_accum": ga,
                "client_axes": list(client_ax),
                "fsdp_axes": list(fsdp_ax),
                "elastic": elastic,
                "uplink": uplink,
                "partial_progress": partial_progress,
                "fused_server": fused_active,
                "fused_server_requested": fused_server,
            },
        )

    # centralized baseline: per-step gradient sync (the paper's comparison).
    # Big models ZeRO-shard params + optimizer over the batch axes (FSDP) when
    # 12 B/param overflow 55% of one model-parallel slice's memory.
    inner = InnerOptConfig(lr_max=3e-4, total_steps=60_000)
    cen_fsdp = (
        sh.client_axes(mesh)
        if cfg.param_count() * 12 > 0.55 * mesh.hbm_bytes * mesh.shape["model"]
        else ()
    )
    params, pspecs = abstract_params(model, mesh, cen_fsdp)
    abs_p = model.abstract_params()
    state = {"params": params,
             "inner": {"m": _like_meta(abs_p), "v": _like_meta(abs_p),
                       "count": _meta((), torch.int32)},
             "step": _meta((), torch.int32)}
    state_specs = {"params": pspecs, "inner": {"m": pspecs, "v": pspecs, "count": P()},
                   "step": P()}
    ga_c = default_grad_accum(
        shape.global_batch, shape.seq_len, fsdp_div=mesh.size // mesh.shape["model"],
        target_tokens=_target_tokens(cfg),
    )

    def _central(s, b):
        return centralized_step(loss_fn, inner, s, b, grad_accum=ga_c, pre_split=True)

    batch, batch_specs = input_specs(cfg, shape, mesh, mode="centralized")
    tokens = shape.global_batch * shape.seq_len
    return BuiltStep(
        name=f"{cfg.name}:{shape.name}:centralized",
        fn=_central, args=(state, batch), arg_specs=(state_specs, batch_specs), mesh=mesh,
        model=model, arg_kinds=("central_state", "batch"),
        model_flops=6.0 * cfg.active_param_count() * tokens,
        meta={"tokens_per_call": tokens, "grad_accum": ga_c, "fsdp_axes": list(cen_fsdp)},
    )


def build_prefill_step(cfg: ModelConfig, shape: InputShape, mesh: Mesh) -> BuiltStep:
    model = build_model(cfg)
    params, pspecs = abstract_params(model, mesh, _serve_fsdp_axes(cfg, mesh),
                                     dtype=torch.bfloat16)
    batch, batch_specs = input_specs(cfg, shape, mesh)
    tokens = shape.global_batch * shape.seq_len
    return BuiltStep(
        name=f"{cfg.name}:{shape.name}:prefill",
        fn=lambda p, b: model.prefill(p, b),
        args=(params, batch), arg_specs=(pspecs, batch_specs), mesh=mesh, model=model,
        arg_kinds=("params", "batch"),
        model_flops=2.0 * cfg.active_param_count() * tokens,
        meta={"tokens_per_call": tokens},
    )


def build_decode_step(cfg: ModelConfig, shape: InputShape, mesh: Mesh) -> BuiltStep:
    model = build_model(cfg)
    params, pspecs = abstract_params(model, mesh, _serve_fsdp_axes(cfg, mesh),
                                     dtype=torch.bfloat16)
    cache, cache_specs = abstract_cache(cfg, shape, mesh, model)
    inputs, in_specs = input_specs(cfg, shape, mesh)

    def serve_step(params, cache, tokens, cache_index):
        return model.decode_step(params, cache, tokens, cache_index)

    tokens = shape.global_batch  # one new token per sequence
    return BuiltStep(
        name=f"{cfg.name}:{shape.name}:decode",
        fn=serve_step,
        args=(params, cache, inputs["tokens"], inputs["cache_index"]),
        arg_specs=(pspecs, cache_specs, in_specs["tokens"], in_specs["cache_index"]),
        mesh=mesh, model=model, arg_kinds=("params", "cache", "tokens", "cache_index"),
        model_flops=2.0 * cfg.active_param_count() * tokens,
        meta={"tokens_per_call": tokens, "kv_len": shape.seq_len},
    )


def build_step(cfg: ModelConfig, shape_name: str, mesh: Mesh, **kw) -> BuiltStep:
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    return build_decode_step(cfg, shape, mesh)


# ---------------------------------------------------------------------------
# Real inputs for a host-mesh run
# ---------------------------------------------------------------------------


def materialize(step: BuiltStep, device=None, seed: int = 0) -> Tuple:
    """Real inputs for ``step.fn`` on ``device`` (the host mesh's by
    default): params from ``Model.init(seed)`` in the plan's dtype, outer and
    inner lanes, residuals and caches zeros, counters 0, the rng lane the key
    of ``seed``, full participation weights and τ budgets, tokens drawn from
    a ``torch.Generator`` seeded with ``seed``, audio frames from its normal
    draw, and the decode position the last slot of the cache."""
    device = torch.device(device) if device is not None else step.mesh.device
    if device is None:
        raise ValueError(f"{step.name}: a production mesh's plan is not run; "
                         "materialize a host-mesh step or pass device=")
    model, cfg = step.model, step.model.cfg
    gen = torch.Generator().manual_seed(seed)

    def zeros(tree):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=device), tree)

    def params_like(tree):
        return model.init(seed, device=device, dtype=tree_leaves(tree)[0].dtype)

    def batch(tree):
        out = {}
        for k, x in tree.items():
            if k == "tokens":
                out[k] = torch.randint(0, cfg.vocab_size, tuple(x.shape), generator=gen,
                                       dtype=torch.int32).to(device)
            else:
                out[k] = torch.randn(tuple(x.shape), generator=gen).to(x.dtype).to(device)
        return out

    out = []
    for kind, arg in zip(step.arg_kinds, step.args):
        if kind in ("fed_state", "tile_state"):
            params = params_like(arg["params"])
            s = {"params": params, "round": 0, "rng": prng_key(seed)}
            if kind == "fed_state":
                s["outer"] = {k: 0 if k == "round" else zeros(v) for k, v in arg["outer"].items()}
            out.append(s)
        elif kind == "central_state":
            out.append({"params": params_like(arg["params"]),
                        "inner": {"m": zeros(arg["inner"]["m"]), "v": zeros(arg["inner"]["v"]),
                                  "count": 0},
                        "step": 0})
        elif kind == "params":
            out.append(params_like(arg))
        elif kind == "batch":
            out.append(batch(arg))
        elif kind == "weights":
            out.append(torch.ones(tuple(arg.shape), dtype=torch.float32, device=device))
        elif kind == "tau_steps":
            out.append(np.full(tuple(arg.shape), step.meta["tau_lowered"], np.int32))
        elif kind in ("residuals", "cache"):
            out.append(zeros(arg))
        elif kind == "tokens":
            out.append(batch({"tokens": arg})["tokens"])
        elif kind == "cache_index":
            out.append(step.meta["kv_len"] - 1)
        else:
            raise ValueError(kind)
    return tuple(out)
