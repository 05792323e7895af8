"""The port's scan decode path (`stack_layers`, `forward_stacked` over a
per-layer or pooled cache, kv/cache.py's pooled layout) against the JAX
package's on the same weights (JAX synthetic params carried across by
`params_from_jax`; its Pallas kernels in interpret mode), against the
port's own unrolled `forward`, and its entry point
(koboldcpp_tpu_torch/tools/profile_scan.py), on the CPU."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.kv.cache import init_pool_cache as j_init_pool_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models import synthetic as jsyn
from koboldcpp_tpu.models.config import ModelConfig as JCfg
from koboldcpp_tpu_torch.kv import cache as tcache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import ModelConfig
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.tools import profile_scan

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

NEAR_TIE = 2 ** -6  # as tests/test_torch_batch_engine.py


def _cfg(**kw):
    base = dict(arch="llama", vocab_size=256, hidden_size=128, n_layers=3,
                n_heads=4, n_kv_heads=2, head_dim=32, intermediate_size=256,
                rope_dim=32)
    base.update(kw)
    return ModelConfig(**base)


def _jcfg(cfg):
    return JCfg(**{f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(cfg)})


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _both(cfg, kind, seed):
    """JAX synthetic params, the JAX stack of them, and the port's
    conversion of the stack."""
    jp = jsyn.synthetic_params(_jcfg(cfg), kind=kind, seed=seed)
    jsp = jllama.stack_layers(jp)
    assert "layers_stacked" in jsp
    return jp, jsp, params_from_jax(_np_tree(jsp))


def _assert_same_params(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_params(a[k], b[k])
        elif isinstance(a[k], tlinear.QTensor):
            assert (a[k].kind, tuple(a[k].shape)) == (b[k].kind,
                                                      tuple(b[k].shape))
            assert set(a[k].data) == set(b[k].data), k
            for n in a[k].data:
                assert torch.equal(a[k].data[n], b[k].data[n]), (k, n)
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["dense", "q4_k"])
def test_stack_layers_matches_the_converted_jax_stack(kind):
    """The port's stack_layers of the converted per-layer tree equals the
    conversion of the JAX stack_layers tree, field for field; the result
    has no "layers"."""
    cfg = _cfg(hidden_size=256, intermediate_size=512)
    jp, _, tsp = _both(cfg, kind, seed=3)
    mine = tllama.stack_layers(params_from_jax(_np_tree(jp)))
    assert "layers" not in mine and "layers" not in tsp
    _assert_same_params(mine, tsp)
    assert mine["layers_stacked"]["attn_norm"].shape == (3, 256)


def test_stack_layers_keeps_mixed_kinds_unstacked():
    """Layers that differ in a weight's kind (as a Q4_K_M file's q4_k and
    q6_k layers do) stay unstacked in both packages: the input comes
    back."""
    cfg = _cfg(hidden_size=256, intermediate_size=512)
    jp = jsyn.synthetic_params(_jcfg(cfg), kind="q4_k", seed=4)
    assert jp["layers"][0]["w_down"].kind == "q4_k"
    jp["layers"][1]["w_down"] = jsyn._rand_dense(np.random.default_rng(0),
                                                 (256, 512))
    assert jllama.stack_layers(jp) is jp
    tp = params_from_jax(_np_tree(jp))
    assert tllama.stack_layers(tp) is tp


def _jax_fwd(cfg, stacked, last_only=False):
    fn = jllama.forward_stacked if stacked else jllama.forward
    f = jax.jit(lambda p, t, q, c: fn(p, _jcfg(cfg), t, q, c,
                                      last_only=last_only))

    def run(params, tok, pos, cache):
        lg, cache = f(params, jnp.asarray(tok, jnp.int32),
                      jnp.asarray(pos, jnp.int32), cache)
        return np.asarray(lg, np.float32), cache
    return run


def _port_fwd(cfg, stacked, last_only=False):
    fn = tllama.forward_stacked if stacked else tllama.forward

    def run(params, tok, pos, cache):
        with torch.inference_mode():
            lg, cache = fn(params, cfg, torch.as_tensor(tok),
                           torch.as_tensor(pos), cache, last_only=last_only)
        return lg.float().numpy(), cache
    return run


@pytest.mark.parametrize("kind", ["dense", "q4_k"])
def test_forward_stacked_matches_jax(kind):
    """T=6, B=2 over an f32 per-layer cache (tests/test_scan_forward.py's
    case): the port's forward_stacked against JAX's on the same weights,
    logits within 2e-2, and the written cache rows within 2e-2."""
    cfg = _cfg(hidden_size=256 if kind == "q4_k" else 128,
               intermediate_size=512 if kind == "q4_k" else 256)
    _, jsp, tsp = _both(cfg, kind, seed=7)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 256, (2, 6))
    pos = np.broadcast_to(np.arange(6), (2, 6)).copy()
    jc = j_init_cache(3, 2, 16, 2, 32, dtype=jnp.float32)
    tc = tcache.init_cache(3, 2, 16, 2, 32, dtype=torch.float32)
    want, jc = _jax_fwd(cfg, True)(jsp, tok, pos, jc)
    got, tc = _port_fwd(cfg, True)(tsp, tok, pos, tc)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    for li in range(3):
        np.testing.assert_allclose(tc.k[li].numpy(), np.asarray(jc.k[li]),
                                   rtol=2e-2, atol=2e-2)


def test_forward_stacked_incremental_decode():
    """The non-pooled path decodes step by step over an f32 per-layer cache
    as the JAX forward_stacked does (tests/test_scan_forward.py's
    incremental case): each step's logits within 2e-2 of JAX's, and of the
    port's own full-sequence logits."""
    cfg = _cfg(n_layers=2)
    _, jsp, tsp = _both(cfg, "dense", seed=8)
    toks = np.random.default_rng(1).integers(0, 256, 6)
    jf, tf = _jax_fwd(cfg, True), _port_fwd(cfg, True)
    full, _ = tf(tsp, toks[None], np.arange(6)[None],
                 tcache.init_cache(2, 1, 16, 2, 32, dtype=torch.float32))
    jc = j_init_cache(2, 1, 16, 2, 32, dtype=jnp.float32)
    tc = tcache.init_cache(2, 1, 16, 2, 32, dtype=torch.float32)
    _, jc = jf(jsp, toks[None, :3], np.arange(3)[None], jc)
    _, tc = tf(tsp, toks[None, :3], np.arange(3)[None], tc)
    for t in range(3, 6):
        want, jc = jf(jsp, [[toks[t]]], [[t]], jc)
        got, tc = tf(tsp, [[toks[t]]], [[t]], tc)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got[0, 0], full[0, t], rtol=2e-2,
                                   atol=2e-2)


def _greedy(lg):
    return lg[:, -1].argmax(-1)


def _same_or_near_tie(lg, got, want, what):
    """Greedy tokens equal, or a near-tie: the two tokens' logits within
    NEAR_TIE of each other in the port's own logits."""
    for b, (g, w) in enumerate(zip(got, want)):
        if g != w:
            row = lg[b, -1]
            assert abs(row[g] - row[w]) <= NEAR_TIE, (what, b, g, w)


@pytest.mark.parametrize("kind,B,tol", [("dense", 2, 3e-2),
                                        ("q4_k", 1, 4e-2)])
def test_pooled_scan_decode_matches_jax(kind, B, tol):
    """A 6-token prefill and 5 greedy steps over a pooled bf16 cache
    (tests/test_scan_forward.py / test_stacked_matvec.py's pooled cases):
    the port's forward_stacked (prefill through the per-layer views, then
    K17c and, for q4_k at in_f 512, K17a plain) against JAX's, logits
    within `tol`, the same greedy tokens (near-ties apart); and against the
    port's unrolled forward over a per-layer cache on the same steps."""
    cfg = _cfg(hidden_size=128 if kind == "dense" else 256, head_dim=64,
               rope_dim=64, intermediate_size=256 if kind == "dense" else 512)
    jp, jsp, tsp = _both(cfg, kind, seed=11 if kind == "dense" else 13)
    tp = params_from_jax(_np_tree(jp))
    S = 32
    jpool = j_init_pool_cache(3, B, S, 2, 64)
    tpool = tcache.init_pool_cache(3, B, S, 2, 64)
    tunr = tcache.init_cache(3, B, S, 2, 64)
    assert tcache.is_pooled(tpool) and not tcache.is_pooled(tunr)
    jf, tf = _jax_fwd(cfg, True, True), _port_fwd(cfg, True, True)
    uf = _port_fwd(cfg, False, True)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 256, (B, 6))
    pos = np.broadcast_to(np.arange(6), (B, 6)).copy()
    want, jpool = jf(jsp, tok, pos, jpool)
    got, tpool = tf(tsp, tok, pos, tpool)
    unr, tunr = uf(tp, tok, pos, tunr)
    assert tcache.is_pooled(tpool)
    for i in range(6):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, unr, rtol=tol, atol=tol)
        tj, tt = _greedy(want), _greedy(got)
        _same_or_near_tie(got, tt, tj, f"step {i}")
        _same_or_near_tie(got, tt, _greedy(unr), f"step {i} unrolled")
        if i == 5:
            break
        p = np.full((B, 1), 6 + i)
        want, jpool = jf(jsp, tt[:, None], p, jpool)
        got, tpool = tf(tsp, tt[:, None], p, tpool)
        unr, tunr = uf(tp, tt[:, None], p, tunr)
    # the pool holds the per-layer cache's rows at l B + b
    views = tcache.unpool_cache(tpool, 3)
    for li in range(3):
        np.testing.assert_allclose(views.k[li].float().numpy(),
                                   tunr.k[li].float().numpy(), rtol=tol,
                                   atol=tol)


def test_pool_layout_round_trip():
    """pool_cache / unpool_cache / stack_cache / unstack_cache: row l B + b
    of the pool is layer l, sequence b; unpool_cache gives contiguous views
    (writes land in the pool); pool_cache copies once."""
    per = tcache.init_cache(3, 2, 8, 2, 16)
    for li in range(3):
        per.k[li].copy_(torch.randn(2, 8, 32).bfloat16())
        per.v[li].copy_(torch.randn(2, 8, 32).bfloat16())
    pool = tcache.pool_cache(per)
    assert tcache.is_pooled(pool) and pool.max_seq == 8
    assert pool.k.shape == (6, 8, 32)
    views = tcache.unpool_cache(pool, 3)
    for li in range(3):
        assert views.k[li].is_contiguous()
        assert torch.equal(views.k[li], per.k[li])
        assert torch.equal(pool.v[li * 2 + 1], per.v[li][1])
    views.k[2][1, 5] = 7.0
    assert bool((pool.k[5, 5] == 7.0).all())
    st = tcache.stack_cache(per)
    assert st.k.shape == (3, 2, 8, 2, 16) and st.max_seq == 8
    back = tcache.unstack_cache(st)
    assert all(torch.equal(a, b) for a, b in zip(back.k, per.k))


def test_forward_stacked_refuses_what_jax_drops():
    """JAX's forward_stacked has no output bias and its pooled path takes a
    bf16 KVCache: the port raises NotImplementedError for `bo` and for a
    QuantKVCache rather than compute another function."""
    cfg = _cfg(n_layers=2)
    _, _, tsp = _both(cfg, "dense", seed=2)
    tok, pos = torch.tensor([[1]]), torch.tensor([[0]])
    qc = tcache.init_cache(2, 1, 8, 2, 32, quantized=True)
    with pytest.raises(NotImplementedError, match="quantized"):
        tllama.forward_stacked(tsp, cfg, tok, pos, qc)
    tsp["layers_stacked"]["bo"] = torch.zeros(2, 128)
    with pytest.raises(NotImplementedError, match="bo"):
        tllama.forward_stacked(tsp, cfg, tok, pos,
                               tcache.init_pool_cache(2, 1, 8, 2, 32))


def test_profile_scan_tool_scan_equals_unroll():
    """The entry point's decode loop on a 2-layer q4_k model (hidden 512:
    the projections take K17a's plain version) on the CPU: scan and unroll
    give the same 4 greedy tokens; without --device it needs a GPU."""
    cfg = _cfg(hidden_size=512, n_layers=2, n_heads=8, head_dim=64,
               rope_dim=64, intermediate_size=1024)
    from koboldcpp_tpu_torch.models.synthetic import synthetic_params

    params = synthetic_params(cfg, "q4_k", seed=0, device="cpu")
    scan = profile_scan.decode_n("scan", cfg, 4, "cpu", params)
    unroll = profile_scan.decode_n("unroll", cfg, 4, "cpu", params)
    assert len(scan) == 4 and scan == unroll
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_scan.main(["scan", "--steps", "1"])


def test_device_rows_reads_the_raw_device_events():
    """`profile_scan.device_rows` (the kernel rows the smoke script and
    the tool sum) on a real CPU session (no device event: no row) and on
    a stand-in session: device events only, hidden and user-annotation
    events left out, time and launches summed by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).add_(1)
    assert profile_scan.device_rows(prof) == {}

    def ev(name, dev, ns, hidden=False, note=False):
        return SimpleNamespace(
            name=lambda: name, device_type=lambda: dev,
            duration_ns=lambda: ns, is_hidden_event=lambda: hidden,
            is_user_annotation=lambda: note)

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [ev("k1", cuda, 1500), ev("k1", cuda, 500), ev("k2", cuda, 250),
              ev("aten::mm", cpu, 9e6), ev("k3", cuda, 7e3, hidden=True),
              ev("note", cuda, 8e3, note=True)]
    stand_in = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert profile_scan.device_rows(stand_in) == {"k1": (2.0, 2),
                                                  "k2": (0.25, 1)}
