"""The RoIPool kernel's walk over a box, emulated on the CPU.

csrc/roi_pool.cu runs one block per (box, chunk of channels, group of bin
rows), its threads in four bands of up to 4 column bins. Each thread
computes the bins it walks itself (floor(x · scale + 0.5) as an fp32
multiply, then an fp32 add, then integer arithmetic). Each thread walks
its group's rows once: bin row by bin row, each row read pixel by pixel
across its band's column bins (the pixel two bins share read once) and
folded into the band's column maxima; a bin row's last row is written
with it and starts the next bin row's maxima, so the row two bin rows
share is read once, also where roi < P puts one row or column in several
bins. A pixel is read once per (group, band) that holds it: only the row
where the two groups meet and the columns where bands meet twice.

This file runs that walk in numpy, counting the reads of every pixel, and
holds its output to the bit against the JAX package's Pallas kernel in
interpret mode and its ``frcnn.roi_pool``, on the edge cases of the bin
arithmetic: boxes past the map's edge, degenerate and inverted boxes,
roi < P, C not a multiple of 4, K = 1, corners on the ``.5`` rounding edge,
and NaN and ±inf entries. The card's kernel is held to the plain version by
tests/test_torch_kernels_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.models import frcnn as jfrcnn
from transformer_mm_explainability_tpu.ops import roi_pool_pallas as jrpool
from transformer_mm_explainability_tpu_torch.ops import roi_pool_pallas as trpool
from test_torch_kernels_cuda import roi_edge_boxes, roi_inputs

BANDS = 4          # kBands of csrc/roi_pool.cu: bands of column bins
BAND_BINS = 4      # kBandBins: column bins per band and pass
ROW_GROUPS = 2     # kRowGroups: groups of bin rows, one block each
SCALE = 1 / 16


def kernel_bins(boxes: np.ndarray, P: int, scale: float, H: int, W: int):
    """The kernel's bin bounds: ``__fmul_rn`` then ``__fadd_rn`` in fp32,
    floor, then C integer arithmetic (non-negative operands, so ``/`` is
    floor division). Returns (hs, he, ws, we), int32 [K, P]."""
    prod = boxes.astype(np.float32) * np.float32(scale)   # fp32, rounded
    q = np.floor(prod + np.float32(0.5)).astype(np.int32)  # fp32 add
    assert prod.dtype == np.float32
    x0, y0, x1, y1 = (q[:, i:i + 1] for i in range(4))
    roi_w = np.maximum(x1 - x0 + 1, 1)
    roi_h = np.maximum(y1 - y0 + 1, 1)
    p = np.arange(P, dtype=np.int32)[None]
    hs = np.clip(p * roi_h // P + y0, 0, H)
    he = np.clip(((p + 1) * roi_h + P - 1) // P + y0, 0, H)
    ws = np.clip(p * roi_w // P + x0, 0, W)
    we = np.clip(((p + 1) * roi_w + P - 1) // P + x0, 0, W)
    return tuple(t.astype(np.int32) for t in (hs, he, ws, we))


def take_max(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The kernel's max: v where v > m or v is NaN (a NaN taken stays)."""
    return np.where((v > m) | np.isnan(v), v, m)


def blocks(P: int):
    """[(bin rows, column bins)] of the kernel's blocks and bands for one
    box and chunk of channels: min(ROW_GROUPS, P) groups of bin rows; per
    pass of up to BANDS · BAND_BINS column bins, BANDS bands."""
    groups = min(ROW_GROUPS, P)
    passes = -(-P // (BANDS * BAND_BINS))
    out = []
    for z in range(groups):
        rows = range(z * P // groups, (z + 1) * P // groups)
        for q in range(passes):
            p0, n = q * P // passes, (q + 1) * P // passes - q * P // passes
            for b in range(BANDS):
                out.append((rows, range(p0 + n * b // BANDS,
                                        p0 + n * (b + 1) // BANDS)))
    return out


def walk(feats: np.ndarray, boxes: np.ndarray, P: int, scale: float):
    """The kernel's order for one channel vector of each band: per bin row
    of the block's group, each row not read yet, pixel by pixel across the
    band's column bins (the pixel two bins share read once); the bin row's
    last row is written with it and starts the next bin row's maxima, so
    the row two bin rows of a group share is read once. Returns the
    [K, P, P, C] output and the reads of each pixel, [K, H, W]; every bin
    is written once."""
    H, W, C = feats.shape
    K = boxes.shape[0]
    hs, he, ws, we = kernel_bins(boxes, P, scale, H, W)
    out = np.empty((K, P, P, C), np.float32)
    writes = np.zeros((K, P, P), np.int64)
    reads = np.zeros((K, H, W), np.int64)
    neg = np.full(C, -np.inf, np.float32)
    for k in range(K):
        for rows, cols in blocks(P):
            acc, carried = {pw: neg for pw in cols}, -1
            for ph in rows:
                h, h1 = hs[k, ph], he[k, ph]
                if h >= h1:                          # an empty bin row
                    for pw in cols:
                        out[k, ph, pw] = 0
                        writes[k, ph, pw] += 1
                    continue
                if h == carried:
                    h += 1                           # acc holds that row
                else:
                    acc = {pw: neg for pw in cols}
                for h in range(h, h1):
                    prev, w_prev = None, -1
                    for pw in cols:
                        w, w1 = ws[k, pw], we[k, pw]
                        m = neg
                        if w < w1 and w == w_prev:   # shared with the bin before
                            m, w = prev, w + 1
                        for w in range(w, w1):
                            reads[k, h, w] += 1
                            prev = feats[h, w]
                            m = take_max(m, prev)
                        if ws[k, pw] < w1:
                            w_prev = w1 - 1
                        if h == h1 - 1:              # written, then carried
                            out[k, ph, pw] = take_max(acc[pw], m)
                            writes[k, ph, pw] += 1
                            acc[pw] = m
                        else:
                            acc[pw] = take_max(acc[pw], m)
                if carried == h1 - 1:                # the carried row alone
                    for pw in cols:
                        out[k, ph, pw] = acc[pw]
                        writes[k, ph, pw] += 1
                carried = h1 - 1
    assert (writes == 1).all()                   # every bin, once
    return np.where(np.isfinite(out), out, 0).astype(np.float32), reads


def block_reads(boxes, P, scale, H, W) -> np.ndarray:
    """[K, H, W]: how many of the kernel's (bin-row group, band) windows
    hold each pixel: the rows of the group's bin rows × the columns of the
    band's bins."""
    hs, he, ws, we = kernel_bins(boxes, P, scale, H, W)
    out = np.zeros((len(boxes), H, W), np.int64)
    for k in range(len(boxes)):
        for rows, cols in blocks(P):
            r = np.zeros(H, bool)
            c = np.zeros(W, bool)
            for ph in rows:
                r[hs[k, ph]:he[k, ph]] = True
            for pw in cols:
                c[ws[k, pw]:we[k, pw]] = True
            out[k] += r[:, None] & c[None, :]
    return out


def box_window(boxes, P, scale, H, W) -> np.ndarray:
    """[K, H, W]: 1 on the pixels that some bin of the box covers."""
    hs, he, ws, we = kernel_bins(boxes, P, scale, H, W)
    win = np.zeros((len(boxes), H, W), np.int64)
    for k in range(len(boxes)):
        rows = np.zeros(H, bool)
        cols = np.zeros(W, bool)
        for p in range(P):
            rows[hs[k, p]:he[k, p]] = True
            cols[ws[k, p]:we[k, p]] = True
        win[k] = rows[:, None] & cols[None, :]
    return win


def roi_cases():
    """(name, map, channels of the map, boxes, P): every edge case of the
    module docstring. The edge cases share one 16-channel map and the
    random ones one box set, so that JAX computes each reference once per
    (map, boxes, P) and a case takes its channels and boxes of it."""
    rng = np.random.RandomState(11)
    edges = rng.randn(14, 18, 16).astype(np.float32)
    cases = []
    for c0, C in ((0, 8), (8, 3), (11, 5)):    # C % 4 != 0 takes float loads
        for P in (14, 4, 3):
            cases.append((f"edges C{C} P{P}", "edges", slice(c0, c0 + C),
                          slice(None), P))
    cases.append(("random P14", "random", slice(None), slice(None), 14))
    cases.append(("K=1", "random", slice(None), slice(0, 1), 14))
    maps = {"edges": (edges, roi_edge_boxes(14, 18)),
            "random": roi_inputs(25, 38, 4, 9, seed=5)}
    return cases, maps


CASES, MAPS = roi_cases()


@functools.lru_cache(maxsize=None)
def _references(name: str, P: int):
    """JAX's Pallas kernel in interpret mode and ``frcnn.roi_pool`` on one
    whole map and box set."""
    feats, boxes = (jnp.asarray(t) for t in MAPS[name])
    return (np.asarray(jrpool.roi_pool_pallas(feats, boxes, P, SCALE,
                                              interpret=True)),
            np.asarray(jfrcnn.roi_pool(feats, boxes, P, SCALE)))


@functools.lru_cache(maxsize=None)
def _case(case: int):
    """(feats, boxes, P, the walk's output, its reads, the Pallas
    reference, the frcnn reference) of one case."""
    _, name, ch, ks, P = CASES[case]
    feats, boxes = MAPS[name]
    feats, boxes = np.ascontiguousarray(feats[..., ch]), boxes[ks]
    got, reads = walk(feats, boxes, P, SCALE)
    pallas, gathered = (r[ks][..., ch] for r in _references(name, P))
    return feats, boxes, P, got, reads, pallas, gathered


def nonfinite_case():
    """A map with a NaN, a row of +inf, a column of -inf, a whole bin of
    -inf and a NaN beside a +inf, under the edge boxes."""
    bad = np.random.RandomState(12).randn(12, 13, 6).astype(np.float32)
    bad[3, 4, 0] = np.nan
    bad[5, :, 1] = np.inf
    bad[:, 7, 2] = -np.inf
    bad[2:6, 2:6, 3] = -np.inf
    bad[8, 9, 4] = np.nan
    bad[8, 10, 4] = np.inf
    return bad, roi_edge_boxes(12, 13), 5


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_walk_equals_pallas_and_reads_each_pixel_once(case):
    feats, boxes, P, got, reads, want, _ = _case(case)
    H, W, _ = feats.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        trpool.roi_pool_plain(torch.from_numpy(feats),
                              torch.from_numpy(boxes), P, SCALE).numpy(),
        want)
    # every pixel a bin covers is read once per (bin-row group, band) that
    # holds it, no other pixel at all
    np.testing.assert_array_equal(reads, block_reads(boxes, P, SCALE, H, W))
    np.testing.assert_array_equal(reads > 0, box_window(boxes, P, SCALE, H, W))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_walk_equals_frcnn_roi_pool(case):
    """JAX's chunked-gather path; its candidate window covers every bin of
    these boxes."""
    *_, got, _, _, want = _case(case)
    np.testing.assert_array_equal(got, want)


def test_walk_with_nan_and_inf_equals_frcnn_roi_pool():
    """NaN and ±inf: a bin whose max is NaN or ±inf gives 0, every other
    bin its max, as JAX's ``frcnn.roi_pool`` and the plain version give.
    JAX's Pallas kernel is not the reference here: it adds 0/-inf masks,
    and inf + -inf is NaN, so a non-finite entry anywhere in a channel of
    the map's rows zeroes bins that do not hold it."""
    feats, boxes, P = nonfinite_case()
    got, reads = walk(feats, boxes, P, SCALE)
    want = np.asarray(jfrcnn.roi_pool(jnp.asarray(feats), jnp.asarray(boxes),
                                      P, SCALE))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        trpool.roi_pool_plain(torch.from_numpy(feats),
                              torch.from_numpy(boxes), P, SCALE).numpy(),
        want)
    np.testing.assert_array_equal(reads, block_reads(boxes, P, SCALE, 12, 13))
    assert np.isfinite(got).all() and got[..., 0].any()
    masked = np.asarray(jrpool.roi_pool_pallas(
        jnp.asarray(feats), jnp.asarray(boxes), P, SCALE, interpret=True))
    assert not masked[..., 0].any() and (got[..., 5] == masked[..., 5]).all()


@pytest.mark.parametrize("P", [20, 1])
def test_walk_at_other_output_sizes(P):
    """P = 20 > BANDS · BAND_BINS: two passes of bands over the columns;
    P = 1: one group of bin rows, one band."""
    rng = np.random.RandomState(3)
    feats = rng.randn(18, 24, 4).astype(np.float32)
    boxes = np.concatenate([np.array([[16, 16, 380, 280], [0, 0, 100, 60]],
                                     np.float32), roi_edge_boxes(18, 24)])
    got, reads = walk(feats, boxes, P, SCALE)
    want = np.asarray(jrpool.roi_pool_pallas(
        jnp.asarray(feats), jnp.asarray(boxes), P, SCALE, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reads, block_reads(boxes, P, SCALE, 18, 24))


def test_blocks_cover_every_bin_once():
    """The groups of bin rows and the bands of column bins tile the P × P
    bins, each band at most BAND_BINS wide."""
    for P in range(1, 70):
        seen = np.zeros((P, P), np.int64)
        for rows, cols in blocks(P):
            assert len(cols) <= BAND_BINS
            for ph in rows:
                for pw in cols:
                    seen[ph, pw] += 1
        assert (seen == 1).all()


def test_the_protocol_reads_under_half_of_the_bins():
    """At the protocol's box law ([50, 76] map, 1,000 boxes up to 0.6 of
    the image, P = 14), the walk reads about 1.14 times the box pixels,
    against 2.6 times for every bin's window."""
    rng = np.random.RandomState(0)
    u = rng.rand(1000, 4).astype(np.float32)
    x0, y0 = u[:, 0] * 1216 * 0.9, u[:, 1] * 800 * 0.9
    boxes = np.stack([x0, y0, x0 + u[:, 2] * 1216 * 0.6,
                      y0 + u[:, 3] * 800 * 0.6], 1).astype(np.float32)
    hs, he, ws, we = kernel_bins(boxes, 14, SCALE, 50, 76)
    bins = ((he - hs)[:, :, None] * (we - ws)[:, None, :]).sum()
    window = box_window(boxes, 14, SCALE, 50, 76).sum()
    walked = block_reads(boxes, 14, SCALE, 50, 76).sum()
    assert walked < 0.5 * bins and walked < 1.2 * window, \
        (bins / window, walked / window)


@pytest.mark.parametrize("P", [14, 7, 2])
def test_kernel_bins_equal_roi_bin_bounds(P):
    """fp32 multiply, then add, then integer arithmetic: the bins of torch's
    ``roi_bin_bounds`` and of JAX's, on the edge boxes and on corners one
    fp32 ulp either side of every ``.5`` rounding edge of the map."""
    H, W = 20, 24
    edges = (np.arange(-2, 2 * W + 2, dtype=np.float32) * 16 + 8) / 2
    near = np.concatenate([np.nextafter(edges, -np.inf), edges,
                           np.nextafter(edges, np.inf)]).astype(np.float32)
    rng = np.random.RandomState(0)
    corners = rng.permutation(np.resize(near, 4 * 64)).reshape(64, 4)
    boxes = np.concatenate([roi_edge_boxes(H, W), corners]).astype(np.float32)
    got = kernel_bins(boxes, P, SCALE, H, W)
    want = trpool.roi_bin_bounds(torch.from_numpy(boxes), P, SCALE, H, W)
    jwant = jrpool.roi_bin_bounds(jnp.asarray(boxes), P, SCALE, H, W)
    for g, w, jw in zip(got, want, jwant):
        np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(g, np.asarray(jw))


@pytest.mark.parametrize("scale", [1 / 3, 1 / 16])
def test_kernel_bins_round_where_an_fma_would_not(scale):
    """Corners one fp32 ulp around (k + 0.5) / scale, where x · s + 0.5
    rounded once (a fused multiply-add, exact here in float64) floors to
    another integer than the product and the sum rounded each to fp32.
    The kernel's __fmul_rn and __fadd_rn give torch's bins."""
    s = np.float32(scale)
    x = (np.arange(64) + 0.5) / np.float64(s)
    x = x.astype(np.float32)
    x = np.concatenate([np.nextafter(x, -np.inf), x, np.nextafter(x, np.inf)])
    fused = np.floor(x.astype(np.float64) * np.float64(s) + 0.5)
    split = np.floor(x * s + np.float32(0.5))
    x = x[fused != split]
    assert len(x) >= 1
    boxes = np.stack([x, x, x + 30, x + 30], 1).astype(np.float32)
    H = W = 10 ** 4
    got = kernel_bins(boxes, 7, scale, H, W)
    want = trpool.roi_bin_bounds(torch.from_numpy(boxes), 7, scale, H, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    # an FMA's corners would differ from these bins
    fma_x0 = np.floor(boxes[:, 0].astype(np.float64) * np.float64(s) + 0.5)
    assert (fma_x0 != np.floor(boxes[:, 0] * s + np.float32(0.5))).all()
