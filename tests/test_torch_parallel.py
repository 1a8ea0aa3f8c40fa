"""The port's mesh and sequence-parallel chains (``parallel/``) against the
JAX package's on its 8-virtual-device CPU mesh and against the port's
unsharded functions.

The ranks are four spawned CPU processes of one gloo group
(``parallel/launch.RankPool``), started once for the module; each case
runs on all four, on a (2, 2) mesh (k = 2 on the tp axis) or a (1, 4)
mesh (k = 4). Every rank must return the whole result, equal on all
ranks. The JAX references run ``parallel/sp`` on its default mesh (dp 2,
tp 4). Tolerance: rtol 1e-5, atol 1e-6, as ``tests/test_parallel.py``
(the sharded chains sum in another order), 1e-4 relative for DETR's
capture path (as that test's ``generate_ours`` case).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.models import detr as jdetr
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.models import vit as jvit
from transformer_mm_explainability_tpu.parallel import mesh as jpmesh
from transformer_mm_explainability_tpu.parallel import sp as jsp
from transformer_mm_explainability_tpu_torch.examples import sharded_relevancy
from transformer_mm_explainability_tpu_torch.explain import detr as texpl
from transformer_mm_explainability_tpu_torch.models import detr as tdetr
from transformer_mm_explainability_tpu_torch.models import vit as tvit
from transformer_mm_explainability_tpu_torch.ops import relevancy as trl
from transformer_mm_explainability_tpu_torch.parallel import mesh as tpmesh
from transformer_mm_explainability_tpu_torch.parallel import sp as tsp
from transformer_mm_explainability_tpu_torch.parallel.launch import (
    MeshArg, RankPool)

TOL = dict(rtol=1e-5, atol=1e-6)
K_MESH = {2: MeshArg(dp=2, tp=2), 4: MeshArg(dp=1, tp=4)}


@pytest.fixture(scope="module")
def pool():
    """Four gloo ranks for the whole module; each rendezvous, call and join
    has a 300 s bound (a case takes seconds), and after a timeout every
    later case fails at once."""
    with RankPool(4, "gloo", "cpu", timeout_s=300) as p:
        yield p


def on_ranks(pool, fn, *args, **kwargs):
    """``fn`` on every rank → the first rank's result, after checking that
    every rank returned the same whole result."""
    outs = pool.run(fn, *args, **kwargs)
    first = outs[0]
    for other in outs[1:]:
        for a, b in zip(first if isinstance(first, tuple) else (first,),
                        other if isinstance(other, tuple) else (other,)):
            assert torch.equal(a, b)
    return first


@functools.lru_cache(maxsize=None)
def jax_mesh():
    return jpmesh.make_mesh(jax.devices())


# ---------------------------------------------------------------------------
# The mesh and the layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_factorisation_equals_jax(n):
    want = jpmesh.make_mesh(jax.devices()[:n]).shape
    assert tpmesh.mesh_shape(n) == (want["dp"], want["tp"])
    assert tpmesh.mesh_shape(n, tp=1) == (n, 1)
    with pytest.raises(ValueError):
        tpmesh.mesh_shape(n, dp=n + 1, tp=1)


def test_make_mesh_needs_an_initialised_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpmesh.make_mesh()


def _jax_trees():
    vit_cfg = jvit.ViTConfig(image_size=32, patch_size=8, width=64, depth=2,
                             num_heads=4, mlp_ratio=4, num_classes=16)
    lx_cfg = jlx.LxmertConfig(hidden_size=32, num_attention_heads=2,
                              intermediate_size=64, l_layers=2, x_layers=1,
                              r_layers=1, vocab_size=64, num_qa_labels=5)
    detr_cfg = jdetr.DETRConfig(num_classes=7, num_queries=6, d_model=32,
                                nheads=4, num_encoder_layers=2,
                                num_decoder_layers=2, dim_feedforward=64)
    key = jax.random.PRNGKey(0)
    return {
        "vit": jax.eval_shape(lambda: jvit.init_params(key, vit_cfg)),
        "lxmert": jax.eval_shape(lambda: jlx.init_params(key, lx_cfg)),
        "detr": jax.eval_shape(lambda: jdetr.init_params(key, detr_cfg)),
    }


@pytest.mark.parametrize("family", ["vit", "lxmert", "detr"])
def test_spec_for_path_equals_jax(family):
    tree = _jax_trees()[family]
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = {p: tpmesh.spec_for_path(p) for p in paths}
    want = {p: tuple(jpmesh._spec_for_path(p)) for p in paths}
    assert got == want
    assert any(s for s in got.values())


def test_spec_for_path_on_the_port_vit_names():
    """The port's per-layer ViT tensors take the JAX spec without its layer
    axis: qkv and w1 split on the output axis, w_out and w2 on the input
    axis, everything else replicated."""
    model = tvit.init_params(0, sharded_relevancy.TINY, "cpu")
    got = {n.split(".")[-1]: tpmesh.spec_for_path(n)[1:]
           for n, _ in model.named_parameters() if n.startswith("blocks.0")}
    assert got == {"ln1_scale": (), "ln1_bias": (), "w_qkv": (None, "tp"),
                   "b_qkv": ("tp",), "w_out": ("tp", None), "b_out": (),
                   "ln2_scale": (), "ln2_bias": (), "w1": (None, "tp"),
                   "b1": ("tp",), "w2": ("tp", None), "b2": ()}


@pytest.mark.parametrize("k,r", [(2, 0), (2, 1), (4, 3)])
def test_split_takes_whole_heads_of_q_k_and_v(k, r):
    D = 8
    w = torch.arange(D * 3 * D, dtype=torch.float32).reshape(D, 3 * D)
    got = tpmesh._split(w, 1, k, r, groups=3)
    n = D // k
    want = torch.cat([w[:, j * D + r * n:j * D + (r + 1) * n]
                      for j in range(3)], dim=1)
    assert torch.equal(got, want)
    assert torch.equal(tpmesh._split(w, 0, k, r), w[r * n:(r + 1) * n])


# ---------------------------------------------------------------------------
# Sequence-parallel chains
# ---------------------------------------------------------------------------

def _caps(seed, L, H, S, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (np.abs(rng.randn(L, H, S, S)).astype(dtype),
            rng.randn(L, H, S, S).astype(dtype))


@functools.lru_cache(maxsize=None)
def _jax_sp_chain(S, start_layer):
    cams, grads = _caps(0, 4, 3, S)
    return np.asarray(jax.jit(lambda c, g: jsp.sp_self_attention_relevancy(
        c, g, jax_mesh(), axis="tp", start_layer=start_layer))(cams, grads))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("S,start_layer", [(16, 0), (37, 0), (37, 2)])
def test_sp_self_attention_relevancy(pool, k, S, start_layer):
    cams, grads = _caps(0, 4, 3, S)
    got = on_ranks(pool, tsp.sp_self_attention_relevancy,
                   torch.from_numpy(cams), torch.from_numpy(grads),
                   K_MESH[k], axis="tp", start_layer=start_layer).numpy()
    np.testing.assert_allclose(got, _jax_sp_chain(S, start_layer), **TOL)
    want = trl.self_attention_relevancy(torch.from_numpy(cams),
                                        torch.from_numpy(grads), start_layer)
    np.testing.assert_allclose(got, want.numpy(), **TOL)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("normalize", [True, False])
def test_sp_rollout_attention(pool, k, normalize):
    mats = np.abs(np.random.RandomState(1).randn(5, 23, 23)).astype(
        np.float32)
    got = on_ranks(pool, tsp.sp_rollout_attention, torch.from_numpy(mats),
                   K_MESH[k], axis="tp", start_layer=1,
                   normalize=normalize).numpy()
    want_jax = jax.jit(lambda m: jsp.sp_rollout_attention(
        m, jax_mesh(), axis="tp", start_layer=1, normalize=normalize))(mats)
    np.testing.assert_allclose(got, np.asarray(want_jax), **TOL)
    want = trl.compute_rollout_attention(torch.from_numpy(mats), 1,
                                         normalize)
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def _update_inputs(bf16):
    if bf16:   # as tests/test_parallel.py: bf16 captures and carries
        rng = np.random.RandomState(3)
        L, H, S, Q = 3, 2, 21, 5
        to = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16)
                                  .astype(jnp.float32))
        return (to(np.eye(S)), to(rng.rand(S, Q)),
                to(np.abs(rng.randn(L, H, S, S))), to(rng.randn(L, H, S, S)))
    rng = np.random.RandomState(2)
    L, H, S, Q = 3, 2, 19, 7
    cams = np.abs(rng.randn(L, H, S, S)).astype(np.float32)
    grads = rng.randn(L, H, S, S).astype(np.float32)
    return (np.eye(S, dtype=np.float32), rng.rand(S, Q).astype(np.float32),
            cams, grads)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("aggregate,bf16", [(True, False), (False, False),
                                            (True, True)])
def test_sp_self_attention_update(pool, k, aggregate, bf16):
    """Rules 6+7 sharded (the DETR carry), S not divisible by k; bf16
    captures (carried here as their exact fp32 values, and to the port as
    bfloat16 tensors) give fp32 carries on both sides."""
    R_ss, R_sq, cams, grads = _update_inputs(bf16)
    to_t = ((lambda a: torch.from_numpy(a).to(torch.bfloat16)) if bf16
            else torch.from_numpy)
    got_ss, got_sq = on_ranks(pool, tsp.sp_self_attention_update,
                              to_t(R_ss), to_t(R_sq), to_t(cams),
                              to_t(grads), K_MESH[k], axis="tp",
                              aggregate=aggregate)
    assert got_ss.dtype == torch.float32 and got_sq.dtype == torch.float32
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if bf16 else \
        jnp.asarray
    want = jax.jit(lambda a, b, c, g: jsp.sp_self_attention_update(
        a, b, c, g, jax_mesh(), axis="tp", aggregate=aggregate))(
        cast(R_ss), cast(R_sq), cast(cams), cast(grads))
    ref = trl.self_attention_relevancy_update(
        to_t(R_ss), to_t(R_sq), to_t(cams), to_t(grads), aggregate=aggregate)
    for g, w, r in zip((got_ss, got_sq), want, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)


def _detr_taps():
    rng = np.random.RandomState(5)
    K, Le, Ld, H, S, Q = 2, 3, 2, 2, 19, 5
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    mkp = lambda *s: np.abs(rng.randn(*s)).astype(np.float32)
    taps = (mkp(K, Le, H, S, S), mk(K, Le, H, S, S), mkp(K, Ld, H, Q, Q),
            mk(K, Ld, H, Q, Q), mkp(K, Ld, H, Q, S), mk(K, Ld, H, Q, S))
    return taps, np.r_[np.ones(S - 3), np.zeros(3)].astype(np.float32)


DETR_VARIANTS = {   # (normalize, self in rule 10, aggregate)
    "ours_no_lrp": (True, True, True),
    "ours_no_lrp_no_norm": (False, True, True),
    "ablation_no_self_in_10": (True, False, True),
    "ablation_no_aggregation": (False, True, False),
}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("variant", list(DETR_VARIANTS))
def test_sp_detr_relevancy(pool, k, variant):
    normalize, self10, aggregate = DETR_VARIANTS[variant]
    kw = dict(normalize_self_attention=normalize,
              apply_self_in_rule_10=self10, aggregate=aggregate)
    taps, tv = _detr_taps()
    got = on_ranks(pool, tsp.sp_detr_relevancy,
                   *map(torch.from_numpy, taps), K_MESH[k], axis="tp",
                   token_valid=torch.from_numpy(tv), **kw).numpy()
    want_jax = jax.jit(lambda *t: jsp.sp_detr_relevancy(
        *t, mesh=jax_mesh(), axis="tp", token_valid=jnp.asarray(tv),
        **kw))(*taps)
    np.testing.assert_allclose(got, np.asarray(want_jax), **TOL)
    # the port's unsharded chain takes [L, K, H, ...] leaves
    ec, eg, dsc, dsg, dxc, dxg = (torch.from_numpy(t).movedim(1, 0)
                                  for t in taps)
    want = texpl.relevancy_from_capture(
        tdetr.DETRTaps(ec, dsc, dxc), tdetr.DETRTaps(eg, dsg, dxg),
        token_valid=torch.from_numpy(tv), **kw)
    np.testing.assert_allclose(got, want.numpy(), **TOL)
    if variant == "ours_no_lrp_no_norm":
        assert np.abs(got).max() > 1e-3


# ---------------------------------------------------------------------------
# DETR's mesh parameter, the ViT tp and dp paths, the example
# ---------------------------------------------------------------------------

DETR_TINY = dict(num_classes=7, num_queries=6, d_model=32, nheads=4,
                 num_encoder_layers=2, num_decoder_layers=2,
                 dim_feedforward=64)


@functools.lru_cache(maxsize=None)
def _detr_model():
    cfg = tdetr.DETRConfig(**DETR_TINY)
    image = np.random.RandomState(0).randn(64, 96, 3).astype(np.float32)
    return tdetr.init_params(0, cfg, "cpu"), cfg, torch.from_numpy(image)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("method", ["ours_no_lrp_no_norm", "ours_no_lrp",
                                    "ablation_no_aggregation",
                                    "ours_with_lrp"])
def test_detr_generate_with_mesh_equals_without(pool, k, method):
    """``explain/detr.generate(mesh=...)`` through the real capture path
    (tiny DETR, random weights) equals the unsharded call, as
    ``tests/test_parallel.py::test_generate_ours_sp_end_to_end`` holds the
    JAX package's; with a pad mask over the last feature column."""
    params, cfg, image = _detr_model()
    pad = torch.ones(64, 96)
    pad[:, 64:] = 0
    tq, tc = np.array([0, 3]), np.array([1, 2])
    got = on_ranks(pool, texpl.generate, method, params, image, tq, tc, cfg,
                   pad, mesh=K_MESH[k], sp_axis="tp").numpy()
    want = texpl.generate(method, params, image, tq, tc, cfg, pad).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * max(1.0, np.abs(want).max()))
    if method == "ours_no_lrp_no_norm":
        assert np.abs(want).sum() > 1e-4, "vacuous: the rows are zero"


@functools.lru_cache(maxsize=None)
def _vit_inputs():
    model = tvit.init_params(0, sharded_relevancy.TINY, "cpu")
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(8, 32, 32, 3).astype(np.float32))
    return model, images, torch.zeros(8, dtype=torch.long)


@pytest.mark.parametrize("path,mesh", [
    ("relevancy", MeshArg(2, 2)), ("relevancy_streamed_row", MeshArg(2, 2)),
    ("relevancy", MeshArg(1, 4)), ("relevancy_fused", MeshArg(2, 2)),
    ("relevancy_fused_block", MeshArg(4, 1))])
def test_vit_paths_on_a_mesh_equal_unsharded(pool, path, mesh):
    """tp-sharded weights (``relevancy``, ``relevancy_streamed_row``: heads
    and the MLP split, one all-reduce per branch) and ``dp_shard_map`` over
    replicated weights (the kernel paths, their plain versions here) give
    the unsharded maps."""
    model, images, targets = _vit_inputs()
    got = on_ranks(pool, sharded_relevancy.sharded_maps, model, images,
                   targets, mesh, path=path).numpy()
    want = getattr(tvit, path)(model, images, targets).numpy()
    assert got.shape == (8, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_rank_pool_stops_after_close():
    pool = RankPool(1, "gloo", "cpu", timeout_s=60)
    assert pool.run(tpmesh.mesh_shape, 6) == [(3, 2)]
    pool.close()
    with pytest.raises(RuntimeError, match="stopped"):
        pool.run(tpmesh.mesh_shape, 6)


def test_shard_batch_splits_over_dp(pool):
    x = torch.arange(8.0).reshape(4, 2)
    parts = pool.run(tpmesh.shard_batch, {"x": x}, MeshArg(2, 2))
    assert [p["x"].tolist() for p in parts] == [x[:2].tolist()] * 2 + [
        x[2:].tolist()] * 2
    with pytest.raises(RuntimeError, match="does not split over dp"):
        pool.run(tpmesh.shard_batch, x[:3], MeshArg(2, 2))


def test_sharded_example_on_four_cpu_ranks(capsys):
    assert sharded_relevancy.main(["--devices", "4", "--batch", "8"]) == 0
    out = capsys.readouterr().out
    assert "mesh dp=2 tp=2" in out and "(8, 16) whole on every rank" in out
    assert out.strip().endswith("OK")
