"""The port's host-trace analyzer (utils/tracing.py ``analyze``, the JAX
package's pure-Python path) against the JAX package's ``analyze`` on the
same bytes: tests/test_trace_analyzer.py's cases, and the logger's
round trip on the port."""

import struct

import numpy as np
import pytest

from gpu_ecs_madrona_tpu.utils import tracing as jtracing
from gpu_ecs_madrona_tpu_torch.utils import tracing

from test_trace_analyzer import check, sample_records, write_trace


def jax_analyze(path, monkeypatch):
    """JAX's analyze on its Python path (its native analyzer hidden)."""
    try:
        from gpu_ecs_madrona_tpu import _native
        if hasattr(_native, "analyze_trace"):
            monkeypatch.delattr(_native, "analyze_trace")
    except ImportError:
        pass
    return jtracing.analyze(path)


def random_records(seed, n=400):
    """Interleaved, unpaired and repeated events of every kind."""
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.integers(1, 50_000, n))
    return [(int(e), int(t)) for e, t in zip(rng.integers(0, 8, n), ts)]


@pytest.mark.parametrize("records", ["sample", "random_1", "random_2", "empty", "ragged"])
def test_analyze_matches_jax(tmp_path, monkeypatch, records):
    p = tmp_path / "t.bin"
    if records.startswith("random"):
        recs = random_records(int(records[-1]))
    else:
        recs = [] if records == "empty" else sample_records()
    write_trace(p, recs)
    if records == "ragged":           # a truncated last record is ignored
        with open(p, "ab") as f:
            f.write(b"\x00" * 7)
    mine = tracing.analyze(str(p))
    assert mine == jax_analyze(str(p), monkeypatch)
    if records == "sample":
        check(mine)


def test_roundtrip_with_logger(tmp_path, monkeypatch):
    """log() -> dump() -> analyze() on the port (env-gated logger)."""
    monkeypatch.setattr(tracing, "_ENABLED", True)
    monkeypatch.setattr(tracing, "_all_logs", [])
    tracing._local.events = None
    tracing.log(tracing.HostEvent.STEP_START)
    tracing.log(tracing.HostEvent.STEP_END)
    tracing.log(tracing.HostEvent.RENDER_START)
    path = tracing.dump(str(tmp_path / "rt.bin"))
    out = tracing.analyze(path)
    assert out["spans"]["step"]["count"] == 1
    assert out["event_counts"] == {0: 1, 1: 1, 2: 1}
    assert "render" not in out["spans"]
    assert len(open(path, "rb").read()) == 3 * struct.calcsize("<IQ")
