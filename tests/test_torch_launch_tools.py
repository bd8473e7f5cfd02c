"""PyTorch port, the dry-run tools (``repro_torch.launch.specs``,
``dryrun``, ``report`` and ``mesh``'s roofline) against the JAX package's
``launch/specs.py`` and ``launch/dryrun.py``:

* ``fit_spec`` equals the JAX one on ``test_launch_tools.py``'s cases and
  on every parameter leaf of every config at the (16, 16) mesh;
* ``model_flops`` equals the JAX one for every arch x shape;
* the argument bytes at tp 1 (params, bank, cache; the AdamW moments) of
  every arch x shape, on meta tensors at the published widths, equal the
  JAX ``abstract_params`` / ``abstract_bank`` / ``init_cache`` /
  ``adamw_init`` bytes under ``jax.eval_shape`` (no memory either side);
* ``flop_count`` on llama-7b-paper's smoke prefill and decode: its
  products equal a dot-only walk of the JAX jaxpr (scans times their
  length), kernel B5's work is 4 hd a kept (query, key) pair where the
  JAX chunked attention counts the whole square; on the other smoke
  configs the products equal too (the scans of Mamba2 and RWKV-6 counted
  once times their trip count) and the other ops count 75-100% of the
  JAX count (``jaxpr_flops`` less its products; the ops that differ:
  torch's one ``silu`` and ``_softmax`` where JAX counts ``logistic``
  and ``mul``, and ``exp``/``sub``/``div``/``reduce_*``), and B5's work
  falls short of the JAX attention's by the masked half of each causal
  self-attention;
* ``collective_bytes`` at tp 2 on a 2-layer llama smoke decode equals
  the analytic count; a refused width is "refused (C5)";
* the CLI on the smoke configs writes the JAX keys, ``report.py`` renders
  both tables, and the roofline table holds the H100's data sheet.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.launch import specs as jspecs
from repro.lora.adapter import init_bank as jinit_bank
from repro.models import model as JM
from repro.models.common import param_pspecs
from repro.training.optimizer import adamw_init as jadamw_init
from repro_torch.configs import (ARCH_IDS, ASSIGNED_ARCH_IDS, INPUT_SHAPES,
                                 get_config, get_smoke_config)
from repro_torch.launch import dryrun, mesh, report, specs
from repro_torch.models import model as M

H100 = "NVIDIA H100 80GB HBM3"


def _jax_dryrun():
    # the JAX dry-run module sets XLA_FLAGS when imported; conftest has
    # pinned the backend already, so it only reads its functions here
    from repro.launch import dryrun as jdry
    return jdry


class FakeMesh:
    shape = {"model": 16, "data": 4}


@pytest.mark.parametrize("spec,shape", [
    (P(None, "model"), (10, 64)), (P(None, "model"), (10, 8)),
    (P(("data", "model"), None), (64, 8)),
    (P(("data", "model"), None), (32, 8)), (P("data"), (6, 3, 5))])
def test_fit_spec_equals_the_jax_one(spec, shape):
    assert specs.fit_spec(FakeMesh(), tuple(spec), shape) == \
        tuple(jspecs.fit_spec(FakeMesh(), spec, shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fit_spec_equals_the_jax_one_on_every_leaf(arch):
    mesh16 = specs.MeshShape(16, 16)
    params = jspecs.abstract_params(jget(arch))
    pspecs = param_pspecs(params)
    leaves = jax.tree.leaves(params)
    spec_leaves = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves) > 0
    for leaf, spec in zip(leaves, spec_leaves):
        assert specs.fit_spec(mesh16, tuple(spec), leaf.shape) == \
            tuple(jspecs.fit_spec(mesh16, spec, leaf.shape))


def test_model_flops_equal_the_jax_ones():
    jdry = _jax_dryrun()
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            assert dryrun.model_flops(
                specs.effective_config(get_config(arch), name), shape) == \
                jdry.model_flops(jspecs.effective_config(jget(arch), name),
                                 JSHAPES[name]), (arch, name)


def test_assigned_arch_ids_and_windows_equal_the_jax_ones():
    from repro.configs import ASSIGNED_ARCH_IDS as JA
    assert ASSIGNED_ARCH_IDS == JA
    for arch in ARCH_IDS:
        assert specs.needs_window(get_config(arch)) == \
            jspecs.needs_window(jget(arch))
        assert dataclasses.asdict(specs.effective_config(
            get_config(arch), "long_500k")) == dataclasses.asdict(
            jspecs.effective_config(jget(arch), "long_500k"))


def _jax_bytes(tree) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


def _jax_arg_bytes(arch, shape_name):
    """The JAX dry-run's params / bank / cache / moments bytes at one
    device (its ``build_case`` stand-ins, unsharded)."""
    shape = JSHAPES[shape_name]
    cfg = jspecs.effective_config(jget(arch), shape_name)
    params = jspecs.abstract_params(cfg)
    out = {"params": _jax_bytes(params)}
    if shape.mode == "train":
        opt = jax.eval_shape(lambda: jadamw_init(params))
        out["opt"] = _jax_bytes(opt)
        return out
    bank = jspecs.abstract_bank(cfg)
    if bank is not None:
        out["bank"] = _jax_bytes(bank)
    if shape.mode == "decode":
        S, B = shape.seq_len, shape.global_batch
        cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
        enc_len = (cfg.encoder.n_frames if cfg.encoder else
                   (cfg.n_frontend_tokens or None))
        out["cache"] = _jax_bytes(jax.eval_shape(
            lambda: JM.init_cache(cfg, B, cache_len, jnp.bfloat16,
                                  enc_len=enc_len)))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_at_tp1_equal_the_jax_ones(arch):
    for name in INPUT_SHAPES:
        case = specs.build_case(get_config(arch), name, (1, 1),
                                device="meta")
        want = _jax_arg_bytes(arch, name)
        got = {k: case.arg_bytes[k] for k in want}
        assert got == want, (arch, name)
        assert case.rows == INPUT_SHAPES[name].global_batch


def _walk(jaxpr, mult=1.0, acc=None, attn=False):
    """The JAX jaxpr's FLOPs as its ``jaxpr_flops`` counts them (a scan's
    body times its length), split into the products (2 M N K a
    ``dot_general``), the chunked attention's products (rank-6 outputs:
    ``bqckgz``/``bqckgh``), the attention scan's other ops, and the
    other ops (one a output element; shape-only prims none)."""
    shape_only = _jax_dryrun()._SHAPE_ONLY_PRIMS
    acc = acc if acc is not None else dict.fromkeys(
        ("dot", "attn", "attn_other", "other"), 0.0)
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            k = 1
            for i in lc:
                k *= eqn.invars[0].aval.shape[i]
            out = eqn.outvars[0].aval
            key = "attn" if len(out.shape) == 6 else "dot"
            acc[key] += mult * 2.0 * out.size * k
        elif prim == "scan":
            body = eqn.params["jaxpr"].jaxpr
            is_attn = attn or any(
                e.primitive.name == "dot_general" and
                len(e.outvars[0].aval.shape) == 6 for e in body.eqns)
            _walk(body, mult * eqn.params["length"], acc, is_attn)
        else:
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if inner is not None:
                _walk(getattr(inner, "jaxpr", inner), mult, acc, attn)
            elif prim not in shape_only:
                acc["attn_other" if attn else "other"] += mult * float(sum(
                    v.aval.size for v in eqn.outvars
                    if hasattr(v.aval, "size")))
    return acc


B_SMOKE, S_SMOKE = 2, 32


def _jax_smoke_jaxprs(arch):
    """(prefill, decode) jaxprs of the JAX smoke model as its dry-run
    builds them: bf16, the 8 rank-64 adapters on the einsum path."""
    cfg = jsmoke(arch)
    B, S = B_SMOKE, S_SMOKE
    params = jax.eval_shape(lambda: JM.init_params(
        cfg, jax.random.PRNGKey(0), jnp.bfloat16))
    bank = None if cfg.family == "vlm" else jax.eval_shape(
        lambda: jinit_bank(cfg, [64] * 8, jax.random.PRNGKey(0),
                           n_layers=1 if cfg.family == "hybrid"
                           else cfg.n_layers, dtype=jnp.bfloat16))
    idx = jax.ShapeDtypeStruct((B,), jnp.int32)
    n_fe = (cfg.n_frontend_tokens if cfg.family == "vlm" else
            cfg.encoder.n_frames if cfg.family == "audio" else 0)
    fe = jax.ShapeDtypeStruct((B, n_fe, cfg.d_model), jnp.bfloat16) \
        if n_fe else None

    def lora(b, i):
        return {} if b is None else {"bank": b, "lora_idx": i}
    pre = jax.make_jaxpr(lambda p, t, b, i, f: JM.prefill(
        cfg, p, t, frontend=f, cache_dtype=jnp.bfloat16, **lora(b, i)))(
        params, jax.ShapeDtypeStruct((B, S), jnp.int32), bank, idx, fe)
    enc = cfg.encoder.n_frames if cfg.encoder else \
        (cfg.n_frontend_tokens or None)
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, B, S, jnp.bfloat16,
                                                 enc_len=enc))
    dec = jax.make_jaxpr(lambda p, c, t, b, i: JM.decode_step(
        cfg, p, c, t, **lora(b, i)))(
        params, cache, jax.ShapeDtypeStruct((B,), jnp.int32), bank, idx)
    return pre.jaxpr, dec.jaxpr


def _port_count(arch, mode):
    case = specs.build_case(get_smoke_config(arch), specs.InputShape(
        mode, S_SMOKE, B_SMOKE, mode), (1, 1), device="meta")
    with torch.no_grad():
        counter, _ = dryrun.flop_count(case.fn, *case.args)
    return counter


def _b5_work(cfg, S, B, causal_pairs):
    return 4 * cfg.resolved_head_dim * B * cfg.n_heads * causal_pairs


def test_flop_count_equals_the_jax_dots_on_llama_smoke():
    cfg = get_smoke_config("llama-7b-paper")
    pre, dec = _jax_smoke_jaxprs("llama-7b-paper")
    S, B = S_SMOKE, B_SMOKE
    j = _walk(pre)
    port = _port_count("llama-7b-paper", "prefill")
    assert port.dots == j["dot"] > 0
    # B5: 4 hd a kept pair, S (S + 1) / 2 a head (one layer a case of
    # n_layers); the JAX chunked attention counts every pair
    assert port.by_op["flash_mha"] == cfg.n_layers * _b5_work(
        cfg, S, B, S * (S + 1) // 2)
    assert j["attn"] == cfg.n_layers * _b5_work(cfg, S, B, S * S)
    j = _walk(dec)
    port = _port_count("llama-7b-paper", "decode")
    assert port.dots == j["dot"] + j["attn"] > 0
    assert "flash_mha" not in port.by_op


# the MLA config is left out: the JAX bank pads its k adapter's B (d_out
# 40 at smoke widths) below rank 64 as an A and cannot build (ROADMAP C10)
OTHER = [a for a in ARCH_IDS if a not in ("llama-7b-paper",
                                          "deepseek-v2-lite-16b")]


@pytest.mark.parametrize("arch", OTHER)
def test_flop_count_within_tolerance_of_the_jax_count(arch):
    jdry = _jax_dryrun()
    cfg = get_smoke_config(arch)
    for mode, jaxpr in zip(("prefill", "decode"), _jax_smoke_jaxprs(arch)):
        j = _walk(jaxpr)
        assert sum(j.values()) == jdry.jaxpr_flops(jaxpr)
        port = _port_count(arch, mode)
        b5 = port.by_op.get("flash_mha", 0.0)
        other = j["other"]
        if b5:         # MHA prefill on B5: its work is the attention's
            assert port.dots == j["dot"], (arch, mode)
            # B5 counts the kept pairs; the JAX chunks every pair: they
            # differ by the masked half of each causal self-attention
            # (the encoder's and the cross-attention's keep every pair)
            S = S_SMOKE
            assert j["attn"] - b5 == M.n_attn_applications(cfg) * \
                _b5_work(cfg, S, B_SMOKE, S * S - S * (S + 1) // 2)
        else:
            assert port.dots == j["dot"] + j["attn"], (arch, mode)
            other += j["attn_other"]
        # torch counts one silu and one _softmax where JAX counts
        # logistic and mul, and exp, sub, div, reduce_max and reduce_sum
        p_other = port.total - port.dots - b5
        assert 0.75 * other <= p_other <= other, (arch, mode)


def test_collective_bytes_at_tp2_equal_the_analytic_count():
    """llama smoke, 2 layers, decode of 4 rows at tp 2 (bf16): per layer
    one all-reduce of the attention output and one of the FFN's (4 x d
    each), the LoRA intermediate of q, k, v and o (4 x r each); the
    vocabulary-split embedding's all-reduce (4 x d) and the logits'
    all-gather (4 x V fp32)."""
    cfg = dataclasses.replace(get_smoke_config("llama-7b-paper"),
                              n_layers=2)
    rows, d, r, V = 4, cfg.d_model, specs.DRYRUN_MAX_RANK, cfg.vocab_size
    case = specs.build_case(cfg, specs.InputShape("d", 64, rows, "decode"),
                            (1, 2), device="meta")
    with torch.no_grad():
        case.fn(*case.args)
    per_layer = 2 * rows * d * 2 + 4 * rows * r * 2
    assert case.collectives.bytes == {
        "all-reduce": 2 * per_layer + rows * d * 2,
        "all-gather": rows * V * 4}
    assert case.collectives.calls == {"all-reduce": 2 * 6 + 1,
                                      "all-gather": 1}


def test_a_width_tp_does_not_divide_is_refused_c5():
    case = specs.build_case(get_smoke_config("llama-7b-paper"),
                            "decode_32k", (16, 16), device="meta")
    assert case.refused and case.refused.startswith("refused (C5)")
    assert case.fn is None


def test_params_per_rank_follow_the_ports_split():
    """At tp 2 a rank holds half of every split weight and all of every
    replicated one: the whole model's bytes are the rank's split bytes
    twice plus its replicated bytes."""
    from repro_torch.serving.sharding import PARAM_SPLIT
    cfg = get_config("llama-7b-paper")
    whole = dict(specs.abstract_params(cfg, device="meta")
                 .named_parameters())
    rank = dict(specs.abstract_params(cfg, tp=2, device="meta")
                .named_parameters())
    assert whole.keys() == rank.keys()
    for name, p in whole.items():
        q = rank[name]
        leaf = name.rsplit(".", 1)[-1]
        split = PARAM_SPLIT.get(leaf)
        if split is None:
            assert q.shape == p.shape, name
        else:
            want = list(p.shape)
            want[split] //= 2
            assert list(q.shape) == want, name
        assert q.is_meta


def test_cli_on_the_smoke_configs_and_the_report(tmp_path, capsys):
    out = tmp_path / "dry"
    rc = dryrun.main(["--arch", "llama-7b-paper,rwkv6-7b", "--shape",
                      "decode_32k,train_4k", "--mesh", "single", "--config",
                      "smoke", "--out", str(out), "--part", H100])
    assert rc == 0
    text = capsys.readouterr().out
    assert "all dry-runs passed" in text
    ok = sorted(p.name for p in out.glob("*.json"))
    refused = sorted(p.name for p in (out / "refused").glob("*.json"))
    # the smoke widths (4 heads) do not split 16 ways: decode is refused;
    # a train case runs as one replica at tp 1
    assert refused == ["llama-7b-paper__decode_32k__single.json",
                       "rwkv6-7b__decode_32k__single.json"]
    assert ok == ["llama-7b-paper__train_4k__single.json",
                  "rwkv6-7b__train_4k__single.json"]
    d = json.loads((out / ok[0]).read_text())
    for key in ("arch", "shape", "mesh", "chips", "compile_s", "hlo_flops",
                "hlo_bytes", "collective_bytes", "collectives",
                "model_flops", "useful_flops_frac", "memory", "t_compute",
                "t_memory", "t_collective", "bottleneck"):
        assert key in d, key
    assert d["mesh"] == "16x16" and d["chips"] == 256 and d["rows"] == 16
    assert d["case_tp"] == 1 and "replica at tp 1" in d["note"]
    assert d["hlo_flops"] == d["rank_flops"] * 16
    assert d["roofline"]["part"] == H100
    assert d["t_compute"] == d["rank_flops"] / 989e12
    arts = report.load(str(out))
    assert "| llama-7b-paper | train_4k |" in report.roofline_table(
        arts, mesh="16x16")
    assert "| rwkv6-7b | train_4k | 16x16 |" in report.dryrun_table(arts)


def test_roofline_holds_the_data_sheet_and_refuses_other_parts():
    roof = mesh.roofline_of(H100)
    assert roof.hbm_bytes_per_s == 3.35e12
    assert roof.flops(torch.bfloat16) == 989e12
    assert roof.flops(torch.float32) == 67e12
    assert roof.tf32_flops == 495e12
    assert roof.link_bytes_per_s == 900e9 and "NVLink" in roof.link
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        mesh.roofline_of("NVIDIA A100-SXM4-80GB")


def test_card_readings_refuse_the_cpu():
    with pytest.raises((RuntimeError, ValueError)):
        mesh.roofline("cpu")
    with pytest.raises((RuntimeError, ValueError)):
        mesh.device_limits("cpu")
