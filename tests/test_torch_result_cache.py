"""The ingress result cache's native probe sweeps
(``kernels/csrc/result_cache.cpp``) against the plain numpy sweeps
(``kernels.ref.result_cache_lookup_ref`` / ``result_cache_insert_ref``),
on the CPU:

  * hypothesis sequences of lookups, inserts (``assume_unique`` both ways),
    ``drop_model``, compaction, generation bumps, stale inserts and
    load-limit flushes, for 1, 3 and 17 key words and tables of 2^7 to
    2^16 slots: after every call both caches answer the same, hold the
    same table and read the same counters, probe counters included, and
    the JAX reference's ``ResultCache`` answers the same (where JAX is
    installed: the file runs on the card's machine too, which has none);
  * a tiny table filled to chain exhaustion: every hit returns the value
    last inserted for its key, and ``len`` never exceeds what was inserted;
  * the build: the host source builds under a name hashed from it, an
    edited source rebuilds, a library already built is loaded with no
    compile; with no C++ compiler found the cache runs the plain sweeps,
    ``cache_native`` reads 0 and a server's answers are the same.
"""

import contextlib
import hashlib
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.ingress import ResultCache, hash_words
from repro_torch.core.packet import encode_packets_np
from repro_torch.kernels import _build
from repro_torch.kernels import result_cache as rc
from repro_torch.launch.serve import PacketServer

try:
    from repro.core.ingress import ResultCache as JCache
except ImportError:  # no JAX: the native and plain sweeps alone
    JCache = None

torch.set_num_threads(1)

N_MODELS = 4
COUNTERS = ("tombstones", "hits", "misses", "insertions", "flushes",
            "compactions", "stale_inserts_dropped")


@contextlib.contextmanager
def no_compiler():
    """What a machine without ``c++``/``g++`` sees: no host library."""
    with mock.patch.object(_build, "_cxx", return_value=None), \
            mock.patch.object(_build, "_libs", {}):
        yield


def _pair(*args, **kw):
    """A native cache and a plain one of the same shape."""
    native = ResultCache(*args, **kw)
    with no_compiler():
        plain = ResultCache(*args, **kw)
    assert native.native and not plain.native
    return native, plain


def _counters(c):
    return (len(c),) + tuple(getattr(c, k) for k in COUNTERS)


def _same_table(a, b):
    for name in ("_state", "_keys", "_vals", "_model"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert (a.probe_keys, a.probe_slots) == (b.probe_keys, b.probe_slots)


OPS = ("lookup", "insert", "insert_unique", "drop", "compact", "bump",
       "stale")


@settings(max_examples=60, deadline=None)
@given(data=st.data(), key_words=st.sampled_from([1, 3, 17]),
       cap_pow2=st.integers(7, 16), val_bytes=st.sampled_from([1, 8, 132]),
       load_limit=st.sampled_from([0.5, 0.7]),
       tombstone_limit=st.sampled_from([0.05, 0.25]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_native_sweeps_equal_plain_sweeps(data, key_words, cap_pow2,
                                          val_bytes, load_limit,
                                          tombstone_limit, seed):
    rng = np.random.default_rng(seed)
    cap = 1 << cap_pow2
    kw = dict(capacity_pow2=cap_pow2, load_limit=load_limit,
              tombstone_limit=tombstone_limit)
    caches = [*_pair(key_words, val_bytes, **kw)]
    if JCache is not None:
        caches.append(JCache(key_words, val_bytes, **kw))
    native, plain = caches[:2]
    # a pool smaller than the table repeats keys; a larger one fills it
    pool = rng.integers(0, 2 ** 63, (data.draw(st.sampled_from(
        [cap // 4, cap, 3 * cap])), key_words), dtype=np.uint64)
    gen = 0
    ops = data.draw(st.lists(st.sampled_from(OPS), min_size=1, max_size=12))
    for op in ops:
        n = data.draw(st.integers(0, min(cap, 700)))
        words = pool[rng.integers(0, pool.shape[0], n)]
        hashes = hash_words(words) if data.draw(st.booleans()) else None
        # the model id lives in the key, as on the wire
        mids = (words[:, 0] % np.uint64(N_MODELS)).astype(np.int64)
        if op == "lookup":
            got = [c.lookup(words, gen, hashes) for c in caches]
            for mask, vals in got[1:]:
                np.testing.assert_array_equal(mask, got[0][0])
                np.testing.assert_array_equal(vals, got[0][1])
            assert got[0][1].shape == (int(got[0][0].sum()), val_bytes)
        elif op in ("insert", "insert_unique", "stale"):
            vals = rng.integers(0, 256, (n, val_bytes), dtype=np.uint8)
            g = gen - 1 if op == "stale" else gen
            admitted = {c.insert(words, vals, mids, g, hashes,
                                 assume_unique=op == "insert_unique")
                        for c in caches}
            assert len(admitted) == 1
        elif op == "drop":
            mid = data.draw(st.integers(0, N_MODELS - 1))
            assert len({c.drop_model(mid) for c in caches}) == 1
        elif op == "compact":
            for c in caches:
                c._compact()
        else:
            gen += 1
        assert len({_counters(c) for c in caches}) == 1, op
        _same_table(native, plain)
        assert native.probe_slots >= native.probe_keys


@pytest.mark.parametrize("seed", range(4))
def test_chain_exhaustion_keeps_the_last_value(seed):
    """Eight slots, two probes a chain, no load limit: chains run out and
    rows are dropped, but a hit always returns the value last inserted for
    its key, and the table never holds more than was inserted."""
    rng = np.random.default_rng(seed)
    native, plain = _pair(3, 8, capacity_pow2=3, max_probe=2,
                          load_limit=1.0)
    pool = rng.integers(0, 2 ** 63, (20, 3), dtype=np.uint64)
    last = {}
    since_flush = 0
    dropped = 0
    for step in range(200):
        pick = rng.choice(20, rng.integers(1, 5), replace=False)
        words = pool[pick]
        (mask, vals), (pmask, pvals) = (c.lookup(words, 0)
                                        for c in (native, plain))
        np.testing.assert_array_equal(mask, pmask)
        np.testing.assert_array_equal(vals, pvals)
        for key, row in zip(pick[mask], vals):
            assert row.tobytes() == last[key], step
        vals = rng.integers(0, 256, (pick.size, 8), dtype=np.uint8)
        flushes = native.flushes
        admitted = {c.insert(words, vals, np.zeros(pick.size, np.int64), 0)
                    for c in (native, plain)}
        assert len(admitted) == 1
        if native.flushes != flushes:
            since_flush = 0
            last = {}
        else:
            dropped += int((~mask).sum()) - admitted.pop()
        since_flush += pick.size
        last.update((k, v.tobytes()) for k, v in zip(pick, vals))
        assert len(native) <= since_flush
        assert len(native) == int((native._state == 1).sum())
        _same_table(native, plain)
    assert dropped > 0  # chains did run out


def test_host_source_builds_under_its_hash_and_rebuilds(tmp_path,
                                                        monkeypatch):
    text = (_build.CSRC / "result_cache.cpp").read_text()
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "result_cache.cpp").write_text(text)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_libs", {})
    lib = rc.load_library()
    digest = hashlib.sha1((text + " ".join(_build.CXX_FLAGS)).encode()
                          ).hexdigest()[:12]
    assert [p.name for p in out.iterdir()] == [f"libresult_cache-{digest}.so"]
    assert rc.load_library() is lib  # loaded once per process

    # a library already built is loaded with no compile
    monkeypatch.setattr(_build, "_libs", {})
    with mock.patch.object(subprocess, "Popen",
                           side_effect=AssertionError("compiled again")):
        assert rc.load_library() is not None

    (csrc / "result_cache.cpp").write_text(text + "// edited\n")
    monkeypatch.setattr(_build, "_libs", {})
    rc.load_library()
    assert len(list(out.glob("libresult_cache-*.so"))) == 2


def _server():
    srv = PacketServer(device="cpu", max_models=4, max_layers=2,
                       max_width=8, ingress_batch=64)
    rng = np.random.default_rng(3)
    for m in range(1, 5):
        srv.install(m, [(rng.normal(size=(8, 8)).astype(np.float32) * 0.5,
                         rng.normal(size=(8,)).astype(np.float32) * 0.1)],
                    [], final_activation="sigmoid")
    return srv


def test_without_a_compiler_the_plain_sweeps_answer_the_same():
    rng = np.random.default_rng(4)
    uniq = encode_packets_np(rng.integers(0, 6, 300).astype(np.int32), 8,
                             rng.integers(-400, 400, (300, 8)
                                          ).astype(np.int32))
    rows = uniq[rng.integers(0, 300, 2000)]   # most rows repeat
    native = _server()
    outs, snaps = [], []
    with no_compiler():   # the native cache keeps the library it loaded
        plain = _server()
        for srv in (native, plain):
            out = []
            for i in range(0, rows.shape[0], 97):
                srv.submit_packets(rows[i: i + 97])
                if i % 485 == 0:   # retire, so later repeats hit the cache
                    out += srv.drain_packets()
            outs.append(np.stack(out + srv.drain_packets()))
            snaps.append(srv.obs.registry.snapshot())
    np.testing.assert_array_equal(outs[0], outs[1])
    assert native.ingress.cache.hits > 0
    assert [s["cache_native"] for s in snaps] == [{'shard="0"': 1.0},
                                                  {'shard="0"': 0.0}]
    for name in ("cache_probe_slots_total", "cache_probe_keys_total",
                 "cache_hits_total", "cache_insertions_total"):
        assert snaps[0][name] == snaps[1][name], name
    probes = snaps[0]["cache_probe_keys_total"]
    assert sorted(probes) == ['shard="0",table="pending"',
                              'shard="0",table="result"']
    assert min(probes.values()) > 0
