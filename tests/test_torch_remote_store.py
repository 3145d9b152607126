"""The port's remote tier (the cases of ``tests/test_remote_store.py``):
retry policy, circuit breaker, latency tracker, the simulated service's
multipart and ranged protocol, hedged GETs, the three-tier remote3
composition (degraded commits, healing, re-warming a lost disk copy), and
parity with the JAX package: equal retry delays for one seed, and one
sequence of single-threaded ops on both packages' ``RemoteBackend`` with
one seed and error rate giving equal counters and byte-identical buckets.

No test sleeps more than ~50 ms (the hedging test holds its slow primary
on an event); every backend a test opens is closed.
"""
import threading
import time

import numpy as np
import pytest

from repro.checkpoint import CircuitBreaker as JaxBreaker
from repro.checkpoint import RemoteBackend as JaxRemote
from repro.checkpoint import RetryPolicy as JaxRetry
from repro.checkpoint import SimulatedObjectService as JaxService
from repro_torch.checkpoint.backends import (CircuitBreaker, LatencyTracker,
                                             RemoteBackend,
                                             RemoteUnavailable, RetryPolicy,
                                             SimulatedObjectService)
from repro_torch.checkpoint.backends.remote import split_parts
from repro_torch.checkpoint.chunk_store import ChunkStore


def _svc(tmp_path, **kw):
    return SimulatedObjectService(tmp_path / "remote", **kw)


def _fast_policy(**kw):
    kw.setdefault("attempts", 3)
    kw.setdefault("base_delay", 0.001)
    kw.setdefault("max_delay", 0.002)
    return RetryPolicy(**kw)


def _items(n=64):
    a = np.arange(n, dtype=np.float32)
    return a, [("w", (n,), "float32", memoryview(a.tobytes()))]


def _read_w(store, digest):
    items, _ = store.read_items(digest)
    (_, shape, _, raw), = items
    return np.frombuffer(bytes(raw), np.float32).reshape(shape)


# ------------------------------------------------------------ retry policy
def test_retry_policy_bounded_and_deterministic():
    pol = _fast_policy(attempts=4)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    retries = []
    out = pol.run(flaky, key="k", on_retry=lambda a, e: retries.append(a),
                  sleep=lambda s: None)
    assert out == "ok" and len(calls) == 3 and len(retries) == 2
    assert pol.delay("k", 1) == pol.delay("k", 1)
    assert pol.delay("k", 1) != pol.delay("other", 1)
    with pytest.raises(OSError):
        pol.run(lambda: (_ for _ in ()).throw(OSError("down")),
                key="k", sleep=lambda s: None)


def test_retry_policy_never_retries_not_found_or_corruption():
    pol = _fast_policy()
    calls = []

    def absent():
        calls.append(1)
        raise FileNotFoundError("no such key")

    with pytest.raises(FileNotFoundError):
        pol.run(absent, key="k", sleep=lambda s: None)
    assert len(calls) == 1, "absence is an answer, not a transient"


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_delays_equal_the_jax_policy(seed):
    kw = dict(attempts=6, base_delay=0.003, max_delay=0.04, jitter=0.5,
              seed=seed)
    ours, theirs = RetryPolicy(**kw), JaxRetry(**kw)
    for key in ("get:ab12", "put_part:cd34", ""):
        for attempt in range(1, 7):
            assert ours.delay(key, attempt) == theirs.delay(key, attempt)


def test_circuit_breaker_opens_and_half_open_probe():
    t = [0.0]
    br = CircuitBreaker(failures=3, cooldown=1.0, clock=lambda: t[0])
    assert br.state == "closed" and br.allow()
    for _ in range(3):
        br.record_failure()
    assert br.state == "open" and br.opens == 1
    assert not br.allow(), "open circuit fails fast"
    t[0] = 1.5
    assert br.allow() and br.state == "half-open"
    br.record_failure()
    assert br.state == "open" and br.opens == 2
    t[0] = 3.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_latency_tracker_percentile_needs_min_samples():
    lt = LatencyTracker(min_samples=4)
    for v in (0.01, 0.02):
        lt.record(v)
    assert lt.percentile(95) is None
    for v in (0.01, 0.015):
        lt.record(v)
    p = lt.percentile(95)
    assert p is not None and 0.01 <= p <= 0.02


# ------------------------------------------------- simulated object service
def test_split_parts_cuts_the_concatenation():
    data = [b"abc", memoryview(b"defgh"), bytearray(b""), b"ij"]
    parts = split_parts(data, 4)
    assert [b"".join(bytes(v) for v in p) for p in parts] == [
        b"abcd", b"efgh", b"ij"]
    assert split_parts([b""], 4) == []


def test_service_multipart_put_ranged_get(tmp_path):
    svc = _svc(tmp_path)
    be = RemoteBackend(svc, policy=_fast_policy(), part_size=8,
                       range_bytes=8, hedge=False)
    try:
        data = bytes(range(20))
        be.write("aabbcc", [data[:5], data[5:13], data[13:]])
        assert svc.ops["put_part"] == 3  # ceil(20/8) parts
        assert bytes(be.read_into("aabbcc", bytearray)) == data
        assert svc.ops["get"] == 3  # ranged reads
        assert be.size("aabbcc") == 20
        be.write("dd0000", b"")
        assert bytes(be.read_into("dd0000", bytearray)) == b""
        with pytest.raises(FileNotFoundError):
            be.read_into("ee0000", bytearray)
        assert be.delete("aabbcc") == 20
        assert not be.has("aabbcc")
    finally:
        be.close()


def test_service_abandoned_upload_never_torn_and_swept(tmp_path,
                                                       monkeypatch):
    svc = _svc(tmp_path)
    be = RemoteBackend(svc, policy=_fast_policy(attempts=1), part_size=4,
                       hedge=False)
    real = svc.put_part

    def dying(upload, index, data, **kw):
        if index == 1:
            raise OSError("writer died")
        return real(upload, index, data, **kw)

    monkeypatch.setattr(svc, "put_part", dying)
    with pytest.raises(OSError):
        be.write("aa1111", b"0123456789")
    assert not be.has("aa1111"), "a partial upload never publishes"
    monkeypatch.setattr(svc, "put_part", real)
    stage = svc.root / "uploads" / "aa1111.fffff-1-1"
    stage.mkdir(parents=True)
    (stage / "part-000000").write_bytes(b"zzzz")
    assert svc.sweep_uploads() == 4
    assert not stage.exists()


def test_remote_retries_absorb_seeded_faults_clean_path_free(tmp_path):
    svc = _svc(tmp_path, error_rate=0.3, seed=11)
    be = RemoteBackend(svc, policy=_fast_policy(attempts=6),
                       breaker=CircuitBreaker(failures=50), hedge=False)
    data = b"x" * 64
    for i in range(4):
        be.write(f"aa{i:04d}", data)
        assert bytes(be.read_into(f"aa{i:04d}", bytearray)) == data
    assert be.tier_stats()["remote_retries"] > 0
    svc.error_rate = 0.0
    before = be.tier_stats()["remote_retries"]
    be.write("bb0000", data)
    assert bytes(be.read_into("bb0000", bytearray)) == data
    assert be.tier_stats()["remote_retries"] == before


def test_remote_breaker_opens_on_outage_then_fast_fails(tmp_path):
    svc = _svc(tmp_path)
    be = RemoteBackend(svc, policy=_fast_policy(attempts=2),
                       breaker=CircuitBreaker(failures=2, cooldown=60.0),
                       hedge=False)
    be.write("aa0001", b"payload")
    svc.set_outage(True)
    with pytest.raises(OSError):
        be.read_into("aa0001", bytearray)
    assert be.tier_stats()["remote_breaker_state"] == "open"
    with pytest.raises(RemoteUnavailable):
        be.read_into("aa0001", bytearray)
    stats = be.tier_stats()
    assert stats["remote_fast_fails"] >= 1
    assert stats["remote_breaker_opens"] == 1
    assert be.has("aa0001") is False
    assert be.delete("aa0001") == 0
    assert list(be.keys()) == []
    assert stats["remote_soft_fails"] < be.tier_stats()["remote_soft_fails"]


def test_remote_outage_marker_is_cross_instance(tmp_path):
    svc1 = _svc(tmp_path)
    svc2 = SimulatedObjectService(tmp_path / "remote")
    svc1.set_outage(True)
    be2 = RemoteBackend(svc2, policy=_fast_policy(attempts=1), hedge=False)
    with pytest.raises(OSError):
        be2.read_into("aa0001", bytearray)
    svc1.heal()
    be2.write("aa0001", b"ok")
    assert bytes(be2.read_into("aa0001", bytearray)) == b"ok"


def test_remote_hedged_get_races_slow_primary(tmp_path, monkeypatch):
    """A GET that outlives the hedge delay gets a second GET beside it,
    each into a buffer of its own, and the first to land wins.  The
    primary is held on an event until the hedged read has returned (no
    timing race), and the hedge delay is pinned on either side of a fast
    read."""
    svc = _svc(tmp_path)
    be = RemoteBackend(svc, policy=_fast_policy(), hedge=True)
    allocs = []

    def alloc(n):
        buf = bytearray(n)
        allocs.append(buf)
        return buf

    try:
        be.write("aa0001", b"payload")
        for _ in range(6):  # the tracker past min_samples
            assert bytes(be.read_into("aa0001", bytearray)) == b"payload"
        after = RemoteBackend._hedge_after(be)
        assert after is not None and after >= be.hedge_min_delay
        monkeypatch.setattr(be, "_hedge_after", lambda: 5.0)
        assert bytes(be.read_into("aa0001", bytearray)) == b"payload"
        assert be.tier_stats()["remote_hedges"] == 0, \
            "a read faster than the hedge delay does not hedge"

        gate, lock, n = threading.Event(), threading.Lock(), [0]
        real = svc.get_into

        def get_into(*a, **kw):
            with lock:
                n[0] += 1
                first = n[0] == 1
            if first:    # the primary stalls until the hedge has won
                assert gate.wait(5)
            return real(*a, **kw)

        monkeypatch.setattr(svc, "get_into", get_into)
        monkeypatch.setattr(be, "_hedge_after", lambda: 0.001)
        try:
            got = be.read_into("aa0001", alloc)
        finally:
            gate.set()
        assert bytes(got) == b"payload"
        stats = be.tier_stats()
        assert stats["remote_hedges"] == 1
        assert stats["remote_hedge_wins"] == 1
        be.close()   # the released primary ends, into a buffer of its own
        assert len(allocs) == 2
        assert got.obj is allocs[0]   # the hedge's, allocated first
    finally:
        be.close()


def test_remote_per_op_timeout_is_transient(tmp_path):
    svc = _svc(tmp_path, latency=0.02)
    be = RemoteBackend(svc, policy=_fast_policy(attempts=2, timeout=0.005),
                       hedge=False)
    with pytest.raises(OSError):
        be.write("aa0001", b"payload")  # every op exceeds the budget
    assert be.tier_stats()["remote_retries"] >= 1


# -------------------------------------------------------- parity with JAX
def _ops(be, read):
    """One single-threaded sequence of puts, gets, heads and deletes."""
    rng = np.random.RandomState(3)
    out = []
    for i in range(24):
        key = f"{i % 7:02x}{i:038x}"
        n = int(rng.randint(0, 3 * 64 + 5))
        data = rng.bytes(n)
        try:
            be.write(key, data)
            out.append(("put", key, True))
        except OSError:
            out.append(("put", key, False))
        try:
            got = read(be, key)
            out.append(("get", key, bytes(got) == data))
        except OSError:
            out.append(("get", key, None))
        out.append(("has", key, be.has(key)))
        if i % 5 == 4:
            out.append(("del", key, be.delete(key)))
    out.append(("keys", tuple(be.keys())))
    return out


def _bucket(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.glob("*/*.blob"))}


@pytest.mark.parametrize("error_rate,ranged", [(0.0, False), (0.15, False),
                                               (0.15, True)])
def test_fault_schedule_and_bucket_equal_the_jax_tier(tmp_path, error_rate,
                                                      ranged):
    kw = dict(part_size=64, range_bytes=48 if ranged else None, hedge=False)
    pol = dict(attempts=4, base_delay=0.0005, max_delay=0.001, seed=2)
    ours = RemoteBackend(
        SimulatedObjectService(tmp_path / "port", error_rate=error_rate,
                               seed=5),
        policy=RetryPolicy(**pol), breaker=CircuitBreaker(failures=100),
        **kw)
    theirs = JaxRemote(
        JaxService(tmp_path / "jax", error_rate=error_rate, seed=5),
        policy=JaxRetry(**pol), breaker=JaxBreaker(failures=100), **kw)
    try:
        a = _ops(ours, lambda be, k: be.read_into(k, bytearray))
        b = _ops(theirs, lambda be, k: be.read(k))
    finally:
        ours.close()
        theirs.close()
    assert a == b
    assert ours.tier_stats() == theirs.tier_stats()
    if error_rate:
        assert ours.tier_stats()["remote_retries"] > 0
    assert _bucket(tmp_path / "port") == _bucket(tmp_path / "jax")


# ------------------------------------------------------ remote3 composition
def test_remote3_three_tier_labels_and_durability(tmp_path):
    store = ChunkStore(tmp_path, backend="remote3",
                       remote_opts={"latency": 0.0, "seed": 1})
    try:
        a, items = _items(64)
        ref = store.write(1, "u", "weights", items)
        tb = store.backend.tier_backends()
        assert list(tb) == ["hot", "durable", "remote"]
        store.drain_spill()
        d = store.durability()
        assert d["durable_on"] == "remote" and not d["degraded"]
        assert d["tiers"] == {"hot": 0, "durable": 0}
        assert all(t.has(ref.digest) for t in tb.values())
        assert store.locate(ref.digest) == "hot"
    finally:
        store.close()


def test_remote3_outage_degrades_then_heals(tmp_path):
    store = ChunkStore(tmp_path, backend="remote3",
                       remote_opts={"latency": 0.0, "seed": 1,
                                    "attempts": 2, "base_delay": 0.001,
                                    "failures": 2, "cooldown": 0.02})
    try:
        svc = store.backend.tier_backends()["remote"].service
        svc.set_outage(True)
        a, items = _items(32)
        ref = store.write(1, "u", "weights", items)
        store.drain_spill()  # no raise: the remote tier is best effort
        d = store.durability()
        assert d["durable_on"] == "durable" and d["degraded"]
        assert d["pending_spill"] == 1
        assert store.backend.tier_backends()["durable"].has(ref.digest)
        svc.heal()
        time.sleep(0.03)  # past the breaker's cooldown
        store.drain_spill()
        d = store.durability()
        assert d["durable_on"] == "remote" and not d["degraded"]
        assert store.backend.tier_backends()["remote"].has(ref.digest)
    finally:
        store.close()


def test_remote3_restart_reads_from_remote_and_rewarms_disk(tmp_path):
    store = ChunkStore(tmp_path, backend="remote3",
                       remote_opts={"latency": 0.0, "seed": 1})
    a, items = _items(48)
    try:
        ref = store.write(1, "u", "weights", items)
        store.drain_spill()
    finally:
        store.close()
    for p in (tmp_path / "objects").glob("*/*.chunk"):
        p.unlink()   # only the bucket survives
    store2 = ChunkStore(tmp_path, backend="remote3",
                        remote_opts={"latency": 0.0, "seed": 1})
    try:
        assert store2.locate(ref.digest) == "remote"
        np.testing.assert_array_equal(_read_w(store2, ref.digest), a)
        assert store2.backend.tier_backends()["durable"].has(ref.digest), \
            "the read re-warms the disk tier from the bucket"
    finally:
        store2.close()
