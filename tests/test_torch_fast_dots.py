"""The port's bf16-product mode (``fast_dots``) and bf16 tensors against the
JAX package's ``fast=True`` kernel bodies, on the CPU.

The JAX wrappers run ``fast = fast_dots and not interpret``, so the
references are the same ``pallas_call``s rebuilt with ``fast=True`` in
interpret mode (``tests/_jax_fast.py``). The inputs come from numpy with a
seed (the builders of ``tests/test_torch_kernels_cuda.py``) at B=2, S=17,
D=64, H=4 (dh = 16), I=256; the whole-path tests run a 2-layer width-64
ViT carried from a JAX tree by ``utils/convert.vit_from_jax_numpy``. On
the CPU each wrapper runs its plain version, which rounds every product
operand to bf16 as the kernels of ``csrc/attn_block_bf16.cu`` do (those
are held to the plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Bars, each against max|ref| of the output:
  * float32 outputs (and maps): the median over the elements of |Δ| at
    most 5e-6 · max|ref|, and max|Δ| at most 2⁻⁸ · max|ref|. The two
    sides' fp32 values before a bf16 rounding differ by an ulp now and then
    (XLA's CPU rsqrt and exp against torch's), which flips the rounding of
    an operand that sits on a bf16 rounding edge; one flip moves the
    outputs it feeds by up to a bf16 rounding of one term (seeds 0-7 of
    these builders: max|Δ| up to 1.8e-3 · max|ref| on 4 of the 13
    outputs, where it is ≤ 2e-7 without a flip), while the median stays
    ≤ 4.6e-7 · max|ref|;
  * bfloat16 outputs: max|Δ| ≤ 2⁻⁷ · max|ref| (one bf16 rounding at an
    operand boundary, i.e. one ulp of the largest element);
  * the switch: the same call with ``fast_dots=False`` must lie at least
    10 × farther from the JAX fast reference than the median bar, at the
    largest ratio over the test's float32 outputs, and beyond it on every
    output that the switch can move (seeds 0-7: ≥ 8.6e-5 · max|ref|). A
    path that ignores the switch fails. A bf16 output cannot show it: one
    ulp is as large as the whole fast/fp32 difference. So a bf16-tensor
    test runs the float32 call on the same bf16 values against JAX's
    float32 fast body (the float32 bars and the switch), and holds the
    bf16 call to that float32 call rounded to bf16, exactly, which it is
    only if the bf16 storage takes the same arithmetic (and to JAX's bf16
    call at the bf16 bar). With bf16 values the flash wrappers' e_row is
    the same with and without ``fast_dots``: its products take the inputs
    themselves, exact either way.
The whole paths with a bf16 model, ``relevancy_fused`` and
``relevancy_fused_block``, keep plain PyTorch MLPs in bf16, whose GELU and
its VJP round elsewhere than XLA's (its erfc in bf16 steps, √½ rounded to
bf16): their maps are held at the bf16 bar, and the switch is shown by the
kernel wrappers each receiving ``fast_dots=True``.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_fast as jf
from transformer_mm_explainability_tpu.models import vit as jvit
from transformer_mm_explainability_tpu.ops import attn_block_pallas as jab
from transformer_mm_explainability_tpu.ops import flash_attention as jfa
from transformer_mm_explainability_tpu_torch.models import vit as tvit
from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import attn_block as tab
from transformer_mm_explainability_tpu_torch.ops import flash_attention as tfa
from _train_helpers import JVIT, TVIT, vit_weights
from test_torch_kernels_cuda import (EPS, attn_inputs, flash_inputs,
                                     mlp_inputs)

B, S, D, H, I = 2, 17, 64, 4, 256
MEDIAN_BAR = 5e-6
FP32_MAX_BAR = 2.0 ** -8
BF16_BAR = 2.0 ** -7
SWITCH = 10.0

CALLS = {
    "attn_block_fwd": ("attn", lambda m, t, **kw: m.attn_block_fwd(
        t["x"], t["wqkv"], t["bqkv"], t["wout"], t["bout"], t["g1"], t["b1"],
        H, EPS, **kw)),
    "attn_block_bwd": ("attn", lambda m, t, **kw: m.attn_block_bwd(
        t["x"], t["cot"], t["r"], t["wqkv"], t["bqkv"], t["wout"], t["g1"],
        t["b1"], H, EPS, **kw)),
    "mlp_block_fwd": ("mlp", lambda m, t, **kw: m.mlp_block_fwd(
        t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["g2"], t["bb2"], EPS,
        chunks=4, **kw)),
    "mlp_block_bwd": ("mlp", lambda m, t, **kw: m.mlp_block_bwd(
        t["x"], t["cot"], t["w1"], t["b1"], t["w2"], t["g2"], t["bb2"], EPS,
        chunks=4, **kw)),
    "flash_fwd": ("flash", lambda m, t, **kw: m.flash_fwd(
        t["q"], t["k"], t["v"], **kw)),
    "flash_bwd_ehat": ("flash", lambda m, t, **kw: m.flash_bwd_ehat(
        t["q"], t["k"], t["v"], t["dout"], t["r"], **kw)),
    "flash_fwd_qkv": ("flash", lambda m, t, **kw: m.flash_fwd_qkv(
        t["qkv"], H, **kw)),
    "flash_bwd_ehat_qkv": ("flash", lambda m, t, **kw: m.flash_bwd_ehat_qkv(
        t["qkv"], t["dmerged"], t["r"], H, **kw)),
}
INPUTS = {"attn": lambda seed: attn_inputs(B, S, D, seed),
          "mlp": lambda seed: mlp_inputs(B, S, D, I, seed),
          "flash": lambda seed: flash_inputs(B, H, S, D // H, seed)}
# the seeds of the fp32 parity tests of the same wrappers
# (tests/test_torch_attn_block.py, tests/test_torch_flash_attention.py)
SEEDS = {"attn_block_bwd": 1, "mlp_block_bwd": 2, "flash_bwd_ehat": 1,
         "flash_bwd_ehat_qkv": 1}


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _dist(got, want):
    """(max|Δ|, median |Δ|) over max|ref|."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    top = float(np.abs(w).max())
    assert top > 0
    d = np.abs(g - w)
    return float(d.max()) / top, float(np.median(d)) / top


def _hold(name, got, slow, want, unmoved=()):
    """Every float32 output of ``got`` within the float32 bars of ``want``;
    those of ``slow`` (fast_dots=False) beyond the median bar, by SWITCH at
    the largest ratio."""
    ratios = []
    for i, (g, s, w) in enumerate(zip(got, slow, want)):
        assert g.dtype == s.dtype == torch.float32
        top, med = _dist(g, w)
        assert top <= FP32_MAX_BAR and med <= MEDIAN_BAR, (name, i, top, med)
        if i not in unmoved:
            ratios.append(_dist(s, w)[1] / MEDIAN_BAR)
    assert min(ratios) > 1.0 and max(ratios) >= SWITCH, (name, ratios)


def _bf16_values(arrays):
    """The inputs rounded to bf16 (r stays float32), as float32 arrays."""
    return {k: v if k == "r" else np.asarray(
        jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
            for k, v in arrays.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CALLS))
def test_wrapper_fast_dots_matches_jax_fast_body(name, dtype):
    """Each of the eight wrappers (the flash ones in both layouts) with
    ``fast_dots=True`` against the JAX ``fast=True`` body on the same
    values, on float32 tensors and on bfloat16 ones (r float32): bfloat16
    outputs stay bfloat16, e_row float32 (module doc for the bars)."""
    kind, call = CALLS[name]
    arrays = INPUTS[kind](SEEDS.get(name, 0))
    bf16 = dtype == "bfloat16"
    if bf16:
        arrays = _bf16_values(arrays)
    mod = tab if kind in ("attn", "mlp") else tfa
    want = _tuple(call(jf, {k: jnp.asarray(v) for k, v in arrays.items()}))
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    got = _tuple(call(mod, t, fast_dots=True))
    slow = _tuple(call(mod, t, fast_dots=False))
    unmoved = (len(got) - 1,) if bf16 and name.startswith("flash_bwd") else ()
    _hold(name, got, slow, want, unmoved)
    if not bf16:
        return
    want16 = _tuple(call(jf, {k: jnp.asarray(v, jnp.float32 if k == "r"
                                              else jnp.bfloat16)
                              for k, v in arrays.items()}))
    t16 = {k: v if k == "r" else v.bfloat16() for k, v in t.items()}
    got16 = _tuple(call(mod, t16, fast_dots=True))
    slow16 = _tuple(call(mod, t16, fast_dots=False))
    for i, (g16, g, s16, s, w16) in enumerate(zip(got16, got, slow16, slow,
                                                  want16)):
        out = torch.float32 if w16.dtype == jnp.float32 else torch.bfloat16
        assert g16.dtype == s16.dtype == out
        assert torch.equal(g16, g.to(out)) and torch.equal(s16, s.to(out))
        bar = FP32_MAX_BAR if out == torch.float32 else BF16_BAR
        assert _dist(g16, w16)[0] <= bar, (name, i, _dist(g16, w16))
        if i not in unmoved:
            assert not torch.equal(s16, g16)


def test_gemm_plain_fast_dots_rounds_operands():
    """``gemm_plain(fast_dots=True)``: the product of the bf16-rounded
    operands in fp32, with the epilogue in fp32; bf16 operands are the
    same values as their fp32 copies."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(5, 33).astype(np.float32))
    b = torch.from_numpy(rng.randn(7, 33).astype(np.float32))
    bias = torch.from_numpy(rng.randn(7).astype(np.float32))
    round_ = lambda t: t.to(torch.bfloat16).float()
    want = round_(a) @ round_(b).T + bias
    got = tab.gemm_plain(a, b, trans_b=True, bias=bias, fast_dots=True)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got16 = tab.gemm_plain(a.bfloat16(), b.bfloat16(), trans_b=True,
                           bias=bias, fast_dots=True)
    torch.testing.assert_close(got16, want, rtol=0, atol=0)
    assert not torch.equal(tab.gemm_plain(a, b, trans_b=True, bias=bias),
                           want)


# ---------------------------------------------------------------------------
# the whole slice: a 2-layer width-64 ViT
# ---------------------------------------------------------------------------

JCFG, TCFG = JVIT, TVIT
PATHS = ["relevancy_fused_block2", "relevancy_fused"]
JAX_FAST = {jab: ("attn_block_fwd", "attn_block_bwd", "mlp_block_fwd",
                  "mlp_block_bwd"),
            jfa: ("flash_fwd_qkv", "flash_bwd_ehat_qkv")}


@pytest.fixture(scope="module")
def weights():
    """The JAX tree (numpy draws over the JAX init's shapes: nothing
    compiled) and the port's model with the same weights."""
    return vit_weights(seed=0)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 32, 32, 3).astype(np.float32),
            np.array([1, 13], np.int32))


@pytest.fixture(scope="module")
def jax_fast_maps(weights, batch):
    """JAX's maps of each path with its kernel wrappers swapped for the
    ``fast=True`` builds, on float32 and on bfloat16 params and images."""
    mp = pytest.MonkeyPatch()
    for mod, names in JAX_FAST.items():
        for name in names:
            mp.setattr(mod, name, getattr(jf, name))
    try:
        im, tg = batch
        out = {}
        for dtype in ("float32", "bfloat16"):
            dt = getattr(jnp, dtype)
            p = jax.tree.map(lambda x: jnp.asarray(x, dt), weights[0])
            for path in PATHS:
                fn = jax.jit(functools.partial(getattr(jvit, path), cfg=JCFG,
                                               interpret=True))
                out[path, dtype] = np.asarray(fn(p, jnp.asarray(im, dt),
                                                 jnp.asarray(tg)))
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def model(weights):
    return weights[1]


class _Spy:
    """Records the ``fast_dots`` argument of each call of a wrapper."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, *args, fast_dots=False, **kw):
        self.seen.append(fast_dots)
        return self.fn(*args, fast_dots=fast_dots, **kw)


def _spy_kernels(monkeypatch) -> dict:
    """Every kernel wrapper of ``ops/attn_block`` and ``ops/flash_attention``
    replaced by a ``_Spy``; returns them by name."""
    spies = {}
    for mod in (tab, tfa):
        for fn in mod.KERNELS:
            spies[fn.__name__] = _Spy(fn)
            monkeypatch.setattr(mod, fn.__name__, spies[fn.__name__])
    return spies


def _all_fast(spies) -> bool:
    called = {n: s.seen for n, s in spies.items() if s.seen}
    return bool(called) and all(all(seen) for seen in called.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", PATHS)
def test_path_fast_dots_matches_jax(path, dtype, model, batch, jax_fast_maps,
                                    monkeypatch):
    """``relevancy_fused_block2`` and ``relevancy_fused`` with
    ``fast_dots=True``, on the float32 model and on a bfloat16 copy with
    bfloat16 images (the JAX bench's throughput mode), against JAX's same
    path on its fast kernel bodies. The maps are float32 either way. Every
    kernel wrapper on the path receives ``fast_dots=True``."""
    im, tg = batch
    bf16 = dtype == "bfloat16"
    m = copy.deepcopy(model).to(torch.bfloat16) if bf16 else model
    images = torch.from_numpy(im).to(getattr(torch, dtype))
    targets = torch.from_numpy(tg)
    spies = _spy_kernels(monkeypatch)
    fn = getattr(tvit, path)
    got = fn(m, images, targets, fast_dots=True)
    assert _all_fast(spies)
    slow = fn(m, images, targets, fast_dots=False)
    want = jax_fast_maps[path, dtype]
    assert got.dtype == slow.dtype == torch.float32
    assert got.shape == want.shape == (2, TCFG.seq_len - 1)
    if bf16 and path != "relevancy_fused_block2":
        # plain bf16 MLPs on both sides round differently (module doc)
        assert _dist(got, want)[0] <= BF16_BAR, _dist(got, want)
        assert not torch.equal(got, slow)
        return
    _hold(path, (got,), (slow,), (want,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", [
    "relevancy_fused_block", "relevancy_fused_forward_probe",
    "relevancy_fused_block_forward_probe",
    "relevancy_fused_block2_forward_probe"])
def test_other_entry_points_pass_fast_dots(fn, dtype, model, batch,
                                           monkeypatch):
    """``relevancy_fused_block`` (the attention kernels of the block path,
    held to JAX through ``test_path_fast_dots_matches_jax``'s wrappers) and
    the three forward probes hand ``fast_dots`` to every kernel they run,
    on float32 and bfloat16 models; their outputs are finite and differ
    from ``fast_dots=False``'s."""
    im, tg = batch
    m = copy.deepcopy(model).to(getattr(torch, dtype))
    args = (m, torch.from_numpy(im).to(getattr(torch, dtype)))
    if not fn.endswith("probe"):
        args += (torch.from_numpy(tg),)
    spies = _spy_kernels(monkeypatch)
    got = getattr(tvit, fn)(*args, fast_dots=True)
    assert _all_fast(spies)
    assert torch.isfinite(got.float()).all()
    assert not torch.equal(got, getattr(tvit, fn)(*args, fast_dots=False))


def test_bf16_tensors_without_fast_dots_raise_before_cuda_launch():
    """On CUDA, bfloat16 storage runs with either value of ``fast_dots``
    (without it, the fp32 kernels read and write bf16: fp32 products, as
    the JAX kernels upcast on load); float16 and float64 still raise, and
    the check runs before anything is built (here on a dtype alone)."""
    t = torch.zeros(2, dtype=torch.bfloat16)
    assert tfa.storage_dtype(t, False) == torch.bfloat16
    assert tfa.storage_dtype(t, True) == torch.bfloat16
    for dt in (torch.float16, torch.float64):
        for fast in (False, True):
            with pytest.raises(RuntimeError, match=str(dt)[6:]):
                tfa.storage_dtype(t.to(dt), fast)


def test_cpu_fast_dots_launches_nothing():
    """CPU tensors take the plain versions with ``fast_dots`` too: no
    launch is counted, fp32 or bf16."""
    tab.reset_launch_counts()
    tfa.reset_launch_counts()
    for name, (kind, call) in CALLS.items():
        arrays = {k: torch.from_numpy(v) for k, v in INPUTS[kind](0).items()}
        call(tab if kind in ("attn", "mlp") else tfa, arrays, fast_dots=True)
    counts = {**tab.launch_counts(), **tab.bf16_launch_counts(),
              **tfa.launch_counts(), **tfa.bf16_launch_counts()}
    assert len(counts) == 16 and set(counts.values()) == {0}


class _FakeLibrary:
    """Stands in for a built library: records each C call, returns 0 (and
    what the size queries need)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        answers = {"tmx_max_dh": 128, "tmx_smem_optin": 232448,
                   "tmx_attn_smem": 1000, "tmx_attn_smem_bf16": 1000}

        def call(*args):
            self.calls.append((name, args))
            return answers.get(name, 0)
        return call


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_branch_marshals_the_bf16_mode(dtype, monkeypatch):
    """The wrappers' CUDA branch run on CPU tensors with a stand-in library
    (nothing is built): with fast_dots the block wrappers call the bf16
    library's LayerNorm, GEMM and attention entry points, with the bits of
    the GEMM's bfloat16 tensors (a 1, b 2, out 4, bias 8, res 16) that keep
    every product-only intermediate in bf16 and the rest in the tensors'
    dtype; the GEMM's operands a and b always reach it in bf16, each
    float32 one (the weights and cotangents of a float32 model) rounded
    first by ``tmx_round_bf16``; outputs come back in the tensors' dtype,
    e_row float32; tensors without fast_dots call the fp32 library only
    (bf16 ones with its bf16 flags: bf16 storage, fp32 products)."""
    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "on_cpu", lambda x: False)
    monkeypatch.setattr(_build, "load", lambda name, signatures: fake)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tfa, "_libs", {})
    monkeypatch.setattr(tfa, "_accepted", set())
    tfa.reset_launch_counts()
    tdt = getattr(torch, dtype)
    a = {k: v if k == "r" else v.to(tdt) for k, v in
         ((k, torch.from_numpy(v)) for k, v in
          attn_inputs(2, 17, 64).items())}
    m = {k: torch.from_numpy(v).to(tdt) for k, v in
         mlp_inputs(2, 17, 64, 256).items()}
    cot_x, e_row = CALLS["attn_block_bwd"][1](tab, a, fast_dots=True)
    cot_mid = CALLS["mlp_block_bwd"][1](tab, m, fast_dots=True)
    assert cot_x.dtype == cot_mid.dtype == tdt and e_row.dtype == torch.float32
    bf = int(dtype == "bfloat16")
    gemms = [(args[6], args[10], args[11]) for name, args in fake.calls
             if name == "tmx_gemm_bf16"]   # (trans_b, act, dtypes)
    # attn_block_bwd: qkv, cot·W_outᵀ, dqkv·W_qkvᵀ; mlp_block_bwd: a1,
    # cot·W2ᵀ × GELU'(a1), da·W1ᵀ
    assert gemms == [(0, 0, 1 | 2 | 4 | bf * 8), (1, 0, 1 | 2 | 4),
                     (1, 0, 1 | 2), (0, 0, 1 | 2 | bf * 8),
                     (1, 2, 1 | 2 | 4), (1, 0, 1 | 2)]
    names = [name for name, _ in fake.calls]
    # float32 a or b operands, rounded before their GEMM: W_qkv (twice),
    # the cotangent and W_out; W1 (twice), the cotangent and W2
    assert names.count("tmx_round_bf16") == (1 - bf) * 8
    assert names.count("tmx_attn_bwd_bf16") == 1
    assert names.count("tmx_layer_norm_bf16") == 2
    assert names.count("tmx_layer_norm_vjp_any") == 2
    assert not {"tmx_gemm", "tmx_attn_bwd", "tmx_layer_norm"} & set(names)
    attn = next(args for name, args in fake.calls
                if name == "tmx_attn_bwd_bf16")
    assert attn[-2] == 1   # qkv and dqkv stored in bf16 for the attention
    # the merged bf16 qkv and cotangent are read in place: no packed slot;
    # the scratch carved in order stats, dq_part, e_part from one allocation
    plan = tfa.bwd16_plan(2, H, 17, 64 // H, True, attn[:4], list(attn[13]))
    assert len(attn) == 21 and attn[11] is None and not any(plan.packs)
    stats, e_part, dq_part = attn[8:11]
    assert dq_part - stats == 4 * plan.stats
    assert e_part - dq_part == 4 * plan.dq_part
    assert (tfa.attn_bwd_launch.copies, tfa.attn_bwd_launch.rounded,
            tfa.attn_bwd_launch.dq_partial_sums) == (0, 0, 1)
    fake.calls.clear()
    out = CALLS["attn_block_fwd"][1](tab, a)
    assert out.dtype == tdt
    assert {name for name, _ in fake.calls} >= {"tmx_gemm", "tmx_attn_fwd",
                                                "tmx_layer_norm"}
    assert not any(name.endswith(("_bf16", "_any"))
                   for name, _ in fake.calls)
    ln = next(args for name, args in fake.calls if name == "tmx_layer_norm")
    assert ln[9] == bf   # the LayerNorm rows read bf16 x, γ, β in place
    # qkv (W_qkv, b_qkv) and the out-projection (W_out, b_out, res x, out)
    assert [args[11] for name, args in fake.calls if name == "tmx_gemm"] \
        == [bf * (2 | 8), bf * (2 | 4 | 8 | 16)]


def _fake_cuda(monkeypatch) -> _FakeLibrary:
    """The wrappers' CUDA branch on CPU tensors with a stand-in library (as
    ``test_cuda_branch_marshals_the_bf16_mode``)."""
    fake = _FakeLibrary()
    monkeypatch.setattr(_build, "on_cpu", lambda x: False)
    monkeypatch.setattr(_build, "load", lambda name, signatures: fake)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tfa, "_libs", {})
    monkeypatch.setattr(tfa, "_accepted", set())
    return fake


# (layout, dtype, dh, packed operands): float32 tensors are rounded into
# packed slots, all four; bfloat16 ones are read in place where every row
# starts on a 16-byte boundary: per-head copies and the merged qkv at dh =
# 16 and 40, not at dh = 20 (rows of 40 bytes), nor a dout view one
# element off its buffer's start
BWD16_CASES = [("heads", "float32", 16, 4), ("qkv", "float32", 40, 4),
               ("heads", "bfloat16", 16, 0), ("qkv", "bfloat16", 40, 0),
               ("qkv", "bfloat16", 20, 4), ("heads", "bfloat16", 16, 1)]


@pytest.mark.parametrize("layout,dtype,dh,packed", BWD16_CASES)
def test_cuda_branch_marshals_the_bf16_backward(layout, dtype, dh, packed,
                                                monkeypatch):
    """``flash_bwd_ehat`` / ``flash_bwd_ehat_qkv`` with fast_dots through
    the CUDA branch (stand-in library): one ``tmx_attn_bwd_bf16`` call of
    the 14 pointers and 7 scalars of its C signature, its scratch carved
    from one allocation as ``bwd16_plan`` sizes it, a packed slot for each
    operand TMA cannot read in place (counted as copies for bfloat16, as
    rounded for float32) and none else, every call counted as one through
    the dq partial sums."""
    fake = _fake_cuda(monkeypatch)
    tdt = getattr(torch, dtype)
    f = {k: torch.from_numpy(v) for k, v in flash_inputs(2, 3, 17, dh).items()}
    f = {k: v if k == "r" else v.to(tdt) for k, v in f.items()}
    tfa.reset_launch_counts()
    if layout == "qkv":
        dqkv, e_row = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"],
                                             3, fast_dots=True)
        assert dqkv.dtype == tdt and dqkv.shape == f["qkv"].shape
    else:
        dout = f["dout"]
        if packed == 1:   # a view whose rows start 2 bytes past the grid
            wide = torch.zeros(dout.shape[:-1] + (dh + 8,), dtype=tdt)
            wide[..., 1:dh + 1] = dout
            dout = wide[..., 1:dh + 1]
        *grads, e_row = tfa.flash_bwd_ehat(f["q"], f["k"], f["v"], dout,
                                           f["r"], fast_dots=True)
        assert all(g.dtype == tdt and g.shape == f["q"].shape for g in grads)
    assert e_row.dtype == torch.float32 and e_row.shape == (2, 17)
    (name, args), = fake.calls[-1:]
    assert name == "tmx_attn_bwd_bf16" and len(args) == 21
    assert args[14:19] == (2, 17, 3, dh, pytest.approx(dh ** -0.5))
    assert args[19] == int(dtype == "bfloat16")
    plan = tfa.bwd16_plan(2, 3, 17, dh, dtype == "bfloat16", args[:4],
                          list(args[13]))
    assert sum(plan.packs) == packed
    assert (args[11] is None) == (packed == 0)
    stats, e_part, dq_part = args[8:11]
    assert dq_part - stats == 4 * plan.stats
    assert e_part - dq_part == 4 * plan.dq_part
    if packed:
        assert args[11] - e_part == 4 * plan.e_part
        assert plan.packed == packed * 2 * 3 * 17 * (-(-dh // 8) * 8)
    counts = (tfa.attn_bwd_launch.copies, tfa.attn_bwd_launch.rounded)
    assert counts == ((packed, 0) if dtype == "bfloat16" else (0, packed))
    assert tfa.attn_bwd_launch.dq_partial_sums == 1
    assert tfa.bf16_launch_counts()[
        "flash_bwd_ehat_qkv_bf16" if layout == "qkv"
        else "flash_bwd_ehat_bf16"] == 1


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 197, 257, 513,
                               1100, 2000, 4000])
def test_bwd16_plan_covers_every_shape(S):
    """Every (S, dh, B·H) gets a plan: 64-row tiles covering S, one partial
    dq sum per 64 keys, dq partial rows of dh padded to 64 or 128, and
    scratch of the sizes the C side's comment states; aligned bfloat16
    operands are read in place, float32 ones always packed."""
    for dh in (8, 16, 20, 40, 64, 72, 100, 128):
        for B, H in ((1, 1), (1, 12), (8, 12), (32, 12)):
            aligned = [0, 128, 256, 384]
            rows = [H * S * 64, 64 * S, 64] * 4
            for bf16 in (True, False):
                plan = tfa.bwd16_plan(B, H, S, dh, bf16, aligned, rows)
                assert plan.s_pad % 64 == 0 and S <= plan.s_pad < S + 64
                assert plan.n_sub * 64 == plan.s_pad
                assert plan.dp == (64 if dh <= 64 else 128)
                assert plan.stats == B * H * plan.s_pad * 4
                assert plan.dq_part == plan.n_sub * B * H * plan.s_pad * plan.dp
                assert B * H * S <= plan.e_part < B * H * S + 64
                assert plan.packs == (not bf16 or dh % 8 != 0,) * 4
                dh8 = -(-dh // 8) * 8
                assert plan.packed == sum(plan.packs) * B * H * S * dh8


def test_bwd16_plan_ignores_strides_of_unit_dimensions():
    """A stride of a dimension of size 1 is never stepped, so it does not
    make an operand packed; an odd stride of a longer one does."""
    odd = [3, 5, 8] * 4
    assert not any(tfa.bwd16_plan(1, 1, 9, 8, True, [0] * 4, odd).packs)
    assert all(tfa.bwd16_plan(2, 1, 9, 8, True, [0] * 4, odd).packs)
    assert all(tfa.bwd16_plan(1, 1, 9, 8, True, [8] * 4, [0] * 12).packs)


# (layout, dtype, dh, packed operands): float32 tensors are rounded into
# packed slots, all three; bfloat16 ones are read in place where every row
# starts on a 16-byte boundary (per-head copies and the merged qkv at dh =
# 16, 40, 64 and 128), not at dh = 20 (rows of 40 bytes), nor a q view one
# element off its buffer's start
FWD16_CASES = [("heads", "float32", 16, 3), ("qkv", "float32", 40, 3),
               ("heads", "float32", 128, 3), ("heads", "bfloat16", 16, 0),
               ("qkv", "bfloat16", 40, 0), ("heads", "bfloat16", 64, 0),
               ("qkv", "bfloat16", 128, 0), ("qkv", "bfloat16", 20, 3),
               ("heads", "bfloat16", 16, 1)]


@pytest.mark.parametrize("layout,dtype,dh,packed", FWD16_CASES)
def test_cuda_branch_marshals_the_bf16_forward(layout, dtype, dh, packed,
                                               monkeypatch):
    """``flash_fwd`` / ``flash_fwd_qkv`` with fast_dots through the CUDA
    branch (stand-in library): one ``tmx_attn_fwd_bf16`` call of the 6
    pointers and 7 scalars of its C signature, a bfloat16 scratch of one
    [B, H, S, dh8] slot for each operand TMA cannot read in place (as
    ``fwd16_plan`` sizes it; counted as copies for bfloat16, as rounded for
    float32) and none else, the output in the inputs' dtype."""
    fake = _fake_cuda(monkeypatch)
    made = []
    real_empty = torch.empty

    def empty(*args, **kw):
        made.append(real_empty(*args, **kw))
        return made[-1]
    monkeypatch.setattr(torch, "empty", empty)
    tdt = getattr(torch, dtype)
    f = {k: torch.from_numpy(v).to(tdt)
         for k, v in flash_inputs(2, 3, 17, dh).items() if k != "r"}
    tfa.reset_launch_counts()
    if layout == "qkv":
        out = tfa.flash_fwd_qkv(f["qkv"], 3, fast_dots=True)
        assert out.shape == (2, 17, 3 * dh)
    else:
        q = f["q"]
        if packed == 1:   # a view whose rows start 2 bytes past the grid
            wide = torch.zeros(q.shape[:-1] + (dh + 8,), dtype=tdt)
            wide[..., 1:dh + 1] = q
            q = wide[..., 1:dh + 1]
        out = tfa.flash_fwd(q, f["k"], f["v"], fast_dots=True)
        assert out.shape == (2, 3, 17, dh)
    assert out.dtype == tdt
    (name, args), = fake.calls[-1:]
    assert name == "tmx_attn_fwd_bf16" and len(args) == 13
    assert args[6:10] == (2, 17, 3, dh)
    assert args[10] == pytest.approx(dh ** -0.5)
    assert args[11] == int(dtype == "bfloat16")
    assert args[3] == out.data_ptr()
    plan = tfa.fwd16_plan(2, 3, 17, dh, dtype == "bfloat16", args[:4],
                          list(args[5]))
    assert sum(plan.packs) == packed
    assert plan.packed == packed * 2 * 3 * 17 * (-(-dh // 8) * 8)
    if packed:
        slot, = (t for t in made if t.data_ptr() == args[4])
        assert slot.dtype == torch.bfloat16 and slot.numel() == plan.packed
    else:
        assert args[4] is None
    counts = (tfa.attn_fwd_launch.copies, tfa.attn_fwd_launch.rounded)
    assert counts == ((packed, 0) if dtype == "bfloat16" else (0, packed))
    assert tfa.bf16_launch_counts()[
        "flash_fwd_qkv_bf16" if layout == "qkv" else "flash_fwd_bf16"] == 1


@pytest.mark.parametrize("S", [1, 63, 64, 65, 197, 256, 257, 1100, 4000])
def test_fwd16_plan_covers_every_shape(S):
    """Every (S, dh, B·H) gets a forward plan: aligned bfloat16 operands read
    in place, float32 ones (and dh off the multiple of 8) packed, slots of
    the size the C side's comment states; the pack rule is the backward's
    (``tma_packs``), operand for operand."""
    for dh in (8, 16, 20, 40, 64, 72, 100, 128):
        for B, H in ((1, 1), (1, 12), (8, 12), (32, 12)):
            aligned = [0, 128, 256, 384]
            rows = [H * S * 64, 64 * S, 64] * 4
            for bf16 in (True, False):
                plan = tfa.fwd16_plan(B, H, S, dh, bf16, aligned, rows)
                assert plan.packs == (not bf16 or dh % 8 != 0,) * 3
                dh8 = -(-dh // 8) * 8
                assert plan.packed == sum(plan.packs) * B * H * S * dh8
                assert plan.packs == tfa.bwd16_plan(
                    B, H, S, dh, bf16, aligned, rows).packs[:3]
    # strides of dimensions of size 1 are never stepped
    odd = [3, 5, 8] * 4
    assert not any(tfa.fwd16_plan(1, 1, S, 8, True, [0] * 4, odd).packs)
