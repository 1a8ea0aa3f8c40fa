"""The port's ``utils/profiling`` and ``utils/download`` against the JAX
package's: the cases of ``tests/test_aux.py`` run on the port's modules,
the zoo held equal to the JAX zoo, and the port's own timing and memory
contracts checked on the CPU."""

import json
import logging

import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.utils import download as jdownload
from transformer_mm_explainability_tpu_torch.utils import download, profiling


def test_profiling_tools():
    t = profiling.Timer()
    assert t.elapsed() >= 0
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record)

    lg = logging.getLogger("tmmx")
    handler = _Capture(level=logging.DEBUG)
    old_level = lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.DEBUG)
    try:
        with profiling.profile_section("unit"):
            pass
    finally:
        lg.removeHandler(handler)
        lg.setLevel(old_level)
    assert any("unit:" in r.getMessage() for r in records)


def test_sustained_seconds_per_call_warms_once_and_reads_every_output():
    """One warm call outside the timer, then ``iters`` calls; every output
    (a tensor, a dict, a tuple) reaches the host."""
    calls, read = [], []

    def fn(x):
        calls.append(1)
        y = x * len(calls)
        return {"y": y, "pair": (y, y + 1)}

    orig = profiling._host

    def host(out):
        if isinstance(out, dict) and "y" in out:   # a whole output
            read.append(1)
        return orig(out)

    profiling._host = host
    try:
        s = profiling.sustained_seconds_per_call(fn, (torch.ones(3),),
                                                 iters=5, depth=3)
    finally:
        profiling._host = orig
    assert s > 0
    assert len(calls) == 6 and len(read) == 6
    assert orig({"a": (torch.ones(2),)})["a"][0].tolist() == [1.0, 1.0]


def test_peak_memory_on_the_cpu_runs_once_and_measures_nothing():
    calls = []
    assert profiling.peak_memory(calls.append, 7, device="cpu") is None
    assert calls == [7]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert events["traceEvents"]


def test_enable_nan_debugging_toggles_anomaly_detection():
    was = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        profiling.enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_zoo_equals_jax():
    assert set(download.ZOO) == set(jdownload.ZOO)
    for name, want in jdownload.ZOO.items():
        got = download.ZOO[name]
        assert (got.name, got.url, got.sha256, got.loader) == (
            want.name, want.url, want.sha256, want.loader)
        assert download._embedded_prefix(got.url) == \
            jdownload._embedded_prefix(want.url)


@pytest.mark.parametrize("impl", [download, jdownload],
                         ids=["port", "jax"])
def test_zoo_resolve_local(tmp_path, impl):
    # torch.hub-style names embed sha256[:8]; a fake payload must fail
    f = tmp_path / "detr-r50-e632da11.pth"
    f.write_bytes(b"fake")
    with pytest.raises(IOError):
        impl.resolve("detr_r50", cache_dir=str(tmp_path),
                     allow_download=False)
    # no digest available at all → resolves, but warns loudly
    g = tmp_path / "pytorch_model.bin"
    g.write_bytes(b"fake lxmert")
    with pytest.warns(UserWarning, match="WITHOUT integrity"):
        path = impl.resolve("lxmert_vqa", cache_dir=str(tmp_path),
                            allow_download=False)
    assert path == str(g)
    with pytest.raises(FileNotFoundError):
        impl.resolve("clip_vit_b32", cache_dir=str(tmp_path / "empty"),
                     allow_download=False)


@pytest.mark.parametrize("impl", [download, jdownload],
                         ids=["port", "jax"])
def test_zoo_checksum(tmp_path, impl):
    f = tmp_path / "ViT-B-32.pt"
    f.write_bytes(b"not the real clip weights")
    with pytest.raises(IOError):
        impl.resolve("clip_vit_b32", cache_dir=str(tmp_path),
                     allow_download=False)


def test_verify_accepts_a_matching_digest(tmp_path):
    """A local file whose sha256 matches (in full, or the torch.hub name's
    8-hex prefix) resolves, the explicit path before the cache."""
    payload = b"some weights"
    f = tmp_path / "w.bin"
    f.write_bytes(payload)
    digest = download.sha256_of(str(f))
    entry = download.ZooEntry("x", "https://example.invalid/w.bin",
                              sha256=digest)
    download.verify(str(f), entry)
    hub = download.ZooEntry("y", f"https://example.invalid/y-{digest[:8]}.pth")
    download.verify(str(f), hub)
    bad = download.ZooEntry("z", "https://example.invalid/z-00000000.pth")
    with pytest.raises(IOError, match="prefix"):
        download.verify(str(f), bad)
    local = tmp_path / "elsewhere.pth"
    local.write_bytes(b"fake")
    with pytest.warns(UserWarning, match="WITHOUT integrity"):
        got = download.resolve("lxmert_vqa", cache_dir=str(tmp_path / "c"),
                               local_path=str(local), allow_download=False)
    assert got == str(local)
    assert np.array_equal(np.frombuffer(f.read_bytes(), np.uint8),
                          np.frombuffer(payload, np.uint8))
