"""Analytic executed-FLOP model per (arch x shape) cell, and the planner's
cost view of the paper's serving pair.

The arch-level model (``fwd_flops_per_token``, ``whisper_encoder_flops``,
``analytic_bytes``, ``analytic_flops``) is the JAX package's, plain
arithmetic over the configs: a matmul-exact count of the executed FLOPs and
a streaming floor of the HBM bytes of one step of a cell.

Conventions: one MAC = 2 flops; train executes fwd(2F) + bwd(4F) + remat
recompute(+2F) = 8F-per-fwd-flop-pair (i.e. x4 the forward). Causal
attention averages (S+1)/2 visible keys; sliding-window layers see
min(window, S_avg).

``graph_cost_rows`` tabulates a layer graph's per-layer times under a
``CostProvider``; ``main`` prints the graph totals and the N-model schedule
of Pix2Pix + YOLOv8 under the selected provider (``--cost measured``
counts each layer from the port's ops, ``core.profiler``).
"""
from __future__ import annotations

from ..configs import SHAPES, ArchSpec
from ..models import HymbaConfig, LMConfig, Mamba2Config, WhisperConfig


def _attn_gqa_per_token(cfg, avg_keys: float) -> float:
    proj = 2 * cfg.d_model * cfg.head_dim * (cfg.n_q + 2 * cfg.n_kv)
    out = 2 * cfg.n_q * cfg.head_dim * cfg.d_model
    sdpa = 4 * cfg.n_q * cfg.head_dim * avg_keys  # qk + av
    return proj + out + sdpa


def _attn_mla_per_token(cfg, avg_keys: float) -> float:
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    proj = 2 * cfg.d_model * (cfg.n_q * qd + cfg.kv_lora + cfg.qk_rope_dim)
    expand = 2 * cfg.kv_lora * cfg.n_q * (cfg.qk_nope_dim + cfg.v_head_dim)
    out = 2 * cfg.n_q * cfg.v_head_dim * cfg.d_model
    sdpa = 2 * cfg.n_q * (qd + cfg.v_head_dim) * avg_keys
    return proj + expand + out + sdpa


def _mlp_per_token(d_model, d_ff, gated=True) -> float:
    return (6 if gated else 4) * d_model * d_ff


def _moe_per_token(cfg) -> float:
    router = 2 * cfg.d_model * cfg.n_experts
    shared = 6 * cfg.d_model * cfg.d_ff_expert * cfg.n_shared
    routed = 6 * cfg.d_model * cfg.d_ff_expert * cfg.top_k * cfg.capacity_factor
    return router + shared + routed


def _mamba_per_token(blk) -> float:
    d, di = blk.d_model, blk.d_inner
    gn = blk.n_groups * blk.d_state
    proj = 2 * d * (2 * di + 2 * gn + blk.n_heads)
    conv = 2 * blk.d_conv * blk.conv_dim
    # SSD: intra-chunk scores/apply (avg chunk/2 keys) + state in/out
    intra = (blk.chunk / 2) * (2 * gn + 2 * blk.n_heads * blk.head_dim)
    states = 4 * blk.d_state * blk.n_heads * blk.head_dim
    out = 2 * di * d
    return proj + conv + intra + states + out


def _avg_keys(S, window, kind):
    full = (S + 1) / 2 if kind != "decode" else S
    if window and window > 0:
        return min(window, full)
    return full


def fwd_flops_per_token(cfg, S: int, kind: str) -> float:
    """Average forward flops per token at context length S."""
    if isinstance(cfg, LMConfig):
        total = 2 * cfg.d_model * cfg.vocab  # head (tied or not)
        for w in cfg.windows():
            ak = _avg_keys(S, w, kind)
            attn = (
                _attn_mla_per_token(cfg, ak)
                if cfg.attn_type == "mla"
                else _attn_gqa_per_token(cfg, ak)
            )
            total += attn
        n_moe = cfg.n_layers - cfg.first_k_dense if cfg.moe else 0
        n_dense = cfg.n_layers - n_moe
        total += n_dense * _mlp_per_token(cfg.d_model, cfg.d_ff)
        total += n_moe * _moe_per_token(cfg)
        return total
    if isinstance(cfg, Mamba2Config):
        blk = cfg.block()
        return 2 * cfg.d_model * cfg.vocab + cfg.n_layers * _mamba_per_token(blk)
    if isinstance(cfg, HymbaConfig):
        blk = cfg.mamba()
        total = 2 * cfg.d_model * cfg.vocab
        for w in cfg.windows():
            total += _attn_gqa_per_token(cfg, _avg_keys(S, w, kind))
            total += _mamba_per_token(blk)
            total += _mlp_per_token(cfg.d_model, cfg.d_ff)
        return total
    if isinstance(cfg, WhisperConfig):
        # decoder per-token costs; encoder handled separately
        ak = _avg_keys(S, 0, kind)
        dec = cfg.n_dec_layers * (
            _attn_gqa_per_token(cfg_attn(cfg), ak)
            + _attn_gqa_per_token(cfg_attn(cfg), cfg.n_frames)  # cross
            + _mlp_per_token(cfg.d_model, cfg.d_ff, gated=False)
        )
        return 2 * cfg.d_model * cfg.vocab + dec
    raise TypeError(type(cfg))


def cfg_attn(cfg: "WhisperConfig"):
    class _A:  # minimal attr view for the gqa formula
        d_model = cfg.d_model
        n_q = cfg.n_heads
        n_kv = cfg.n_heads
        head_dim = cfg.head_dim

    return _A


def whisper_encoder_flops(cfg: WhisperConfig, B: int) -> float:
    F = cfg.n_frames
    per_tok = cfg.n_enc_layers * (
        _attn_gqa_per_token(cfg_attn(cfg), F)  # bidirectional: all F keys
        + _mlp_per_token(cfg.d_model, cfg.d_ff, gated=False)
    )
    return B * F * per_tok


def _cache_bytes_per_layer_token(cfg) -> float:
    """KV/state bytes appended per token per layer (bf16)."""
    if isinstance(cfg, LMConfig):
        if cfg.attn_type == "mla":
            return 2.0 * (cfg.kv_lora + cfg.qk_rope_dim)
        return 2.0 * 2 * cfg.n_kv * cfg.head_dim
    if isinstance(cfg, HymbaConfig):
        return 2.0 * 2 * cfg.n_kv * cfg.head_dim  # + O(1) ssm state
    if isinstance(cfg, WhisperConfig):
        return 2.0 * 2 * cfg.n_heads * cfg.head_dim
    return 0.0  # mamba: O(1) state


def analytic_bytes(spec: ArchSpec, shape_name: str, n_chips: int) -> float:
    """Per-device HBM traffic floor for one step (bytes).

    Streaming model: every resident parameter is read once per forward
    pass (weights >> cache reuse at these batch sizes); train adds the
    remat re-read, gradient write and Adam state read+write (12B/param
    fp32 m,v + master-ish); activations stream layers x tokens x d twice
    per pass; decode adds the full KV/state cache read + append.
    """
    cfg = spec.config
    sh = SHAPES[shape_name]
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    n_params = cfg.n_params()
    n_layers = getattr(cfg, "n_layers", None) or (cfg.n_enc_layers + cfg.n_dec_layers)
    d = cfg.d_model
    act_bytes = 2.0

    if kind == "train":
        tokens_local = B * S / n_chips
        # params fp32: fwd read + remat re-read + bwd read + grad write + m/v r/w
        param_traffic = n_params / n_chips * (3 * 4 + 4 + 4 * 4)
        act_traffic = tokens_local * d * n_layers * act_bytes * 6  # w+r fwd, recompute, bwd
        return param_traffic + act_traffic
    if kind == "prefill":
        tokens_local = B * S / n_chips
        param_traffic = n_params / n_chips * 2.0  # bf16 read once
        act_traffic = tokens_local * d * n_layers * act_bytes * 2
        cache_traffic = B * S / n_chips * n_layers * _cache_bytes_per_layer_token(cfg)
        return param_traffic + act_traffic + cache_traffic
    # decode: params once + cache read (window-limited for local layers)
    param_traffic = n_params / n_chips * 2.0
    cache = 0.0
    windows = cfg.windows() if hasattr(cfg, "windows") else [0] * n_layers
    per_tok = _cache_bytes_per_layer_token(cfg)
    for w in windows:
        span = min(S, w) if w else S
        cache += B * span * per_tok
    if isinstance(cfg, (Mamba2Config, HymbaConfig)):
        blk = cfg.block() if isinstance(cfg, Mamba2Config) else cfg.mamba()
        cache += B * n_layers * blk.n_heads * blk.head_dim * blk.d_state * 4.0 * 2
    return param_traffic + cache / n_chips


def analytic_flops(spec: ArchSpec, shape_name: str, remat: bool = True) -> float:
    """Total executed flops for one step of the cell (global)."""
    cfg = spec.config
    sh = SHAPES[shape_name]
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    if kind == "decode":
        tokens = B  # one new token per sequence
        fwd = tokens * fwd_flops_per_token(cfg, S, "decode")
        if isinstance(cfg, WhisperConfig):
            pass  # encoder already ran at prefill; decode reuses cross KV
        return fwd
    tokens = B * S
    fwd = tokens * fwd_flops_per_token(cfg, S, kind)
    if isinstance(cfg, WhisperConfig):
        fwd += whisper_encoder_flops(cfg, B)
    if kind == "train":
        policy = getattr(cfg, "remat_policy", "full")
        if not getattr(cfg, "remat", True):
            factor = 3.0
        elif policy == "dots":
            factor = 3.1  # matmuls saved; only elementwise recomputed
        else:
            factor = 4.0
        return fwd * factor
    return fwd


def graph_cost_rows(graph, engines, provider=None) -> list[dict]:
    """Per-layer timing table for a layer graph under a ``CostProvider`` —
    the layer-graph analogue of the arch-level analytic model above, and
    the quickest way to see where measured costs diverge from analytic
    ones (``python -m repro_torch.launch.analytic --cost measured``)."""
    from ..core.cost_model import ANALYTIC

    provider = provider or ANALYTIC
    rows = []
    for l in graph:
        row = {"layer": l.name, "kind": l.kind, "flops": l.flops}
        for e in engines:
            row[f"t_{e.name}_us"] = provider.layer_time(l, e) * 1e6
        row["measured"] = provider.available(l)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    """Planner-view cost report for the paper's serving pair: graph totals
    and the N-model schedule under the selected provider.

      PYTHONPATH=src python -m repro_torch.launch.analytic --cost measured --per-layer
    """
    import argparse
    import json

    from ..core.constraints import DLA_ANALOGUE_CONSTRAINTS
    from ..core.cost_model import make_cost_provider
    from ..core.engine import jetson_orin_engines
    from ..core.scheduler import _nmodel_schedule_impl as nmodel_schedule
    from ..models import Pix2PixConfig, Pix2PixGenerator, YOLOv8, YOLOv8Config

    ap = argparse.ArgumentParser()
    ap.add_argument("--cost", choices=("analytic", "measured", "blended"), default="analytic")
    ap.add_argument("--cost-cache", default=None, help="JSON cache for measured layer timings")
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--per-layer", action="store_true", help="dump the per-layer table")
    ap.add_argument(
        "--granularity",
        choices=("coarse", "fine"),
        default="coarse",
        help="plan at composite-node or expanded (primitive) granularity",
    )
    ap.add_argument("--stride", type=int, default=1, help="keep every k-th legal cut point")
    ap.add_argument(
        "--max-cuts",
        type=int,
        default=1,
        help="per-model cut budget: k-segment routes ping-pong each model across engines",
    )
    ap.add_argument(
        "--impl",
        choices=("auto", "xla", "pallas"),
        default="xla",
        help="implementation planning: xla (the plain torch ops), pallas (the fused CUDA serving "
        "kernels), or auto (per-segment argmin over both)",
    )
    args = ap.parse_args(argv)

    provider = make_cost_provider(args.cost, cache_path=args.cost_cache)
    gpu, dla = jetson_orin_engines(constraints_dla=DLA_ANALOGUE_CONSTRAINTS)
    g_pix = Pix2PixGenerator(Pix2PixConfig(img_size=args.img, deconv_mode="cropping")).layer_graph()
    g_yolo = YOLOv8(YOLOv8Config(img_size=args.img)).layer_graph()
    if args.granularity == "fine":
        g_pix, g_yolo = g_pix.expand(), g_yolo.expand()
    plan = nmodel_schedule(
        [g_pix, g_yolo], [dla, gpu], provider=provider, stride=args.stride,
        max_cuts=args.max_cuts, impl=args.impl,
    )
    if args.cost_cache and hasattr(provider, "save"):
        provider.save()  # measured AND blended both persist their timings
    print(
        f"[analytic] cost={plan.cost_provider} search={plan.search} "
        f"cuts={plan.cuts} cycle={plan.cycle_time*1e3:.3f} ms "
        f"aggregate={plan.schedule.aggregate_fps:.1f} FPS"
    )
    if args.impl != "xla":
        print(f"[analytic] impl={args.impl} bindings={plan.ir.impl_bindings()}")
    print(plan.schedule.ascii_timeline())
    if args.per_layer:
        for graph in (g_pix, g_yolo):
            print(f"\n# {graph.model_name}")
            print(json.dumps(graph_cost_rows(graph, (dla, gpu), provider), indent=2))


if __name__ == "__main__":
    main()
