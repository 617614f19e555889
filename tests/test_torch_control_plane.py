"""The port's MLP control plane against the JAX reference: after the same
install/remove sequence the host tables are equal array for array, slots
and versions agree, writes are all-or-nothing, snapshots are cached per
generation and device, and ``tables_from_numpy`` carries the reference's
tables across."""

import numpy as np
import pytest
import torch

from repro.core.control_plane import ControlPlane as JCP
from repro_torch.core.control_plane import ControlPlane as TCP
from repro_torch.core.control_plane import tables_from_numpy
from repro_torch.serve.faults import FaultPlan, FaultSpec, InjectedFault

torch.set_num_threads(1)

FIELDS = ("w", "b", "act", "layer_on", "out_dim", "id_map")


def _model(rng, dims, scale=0.7):
    return [(rng.normal(size=(a, b)).astype(np.float32) * scale,
             rng.normal(size=(b,)).astype(np.float32) * scale)
            for a, b in zip(dims[:-1], dims[1:])]


def _assert_same(tcp, jcp):
    t = tcp.tables("cpu")
    for name in FIELDS:
        got, want = getattr(t, name).numpy(), getattr(jcp, "_" + name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tcp.version == jcp.version
    assert tcp.installed_ids() == jcp.installed_ids()


@pytest.mark.parametrize("weight_bits,frac_bits", [(16, 8), (8, 6), (32, 12)])
def test_install_remove_sequence_matches(weight_bits, frac_bits):
    kw = dict(max_models=4, max_layers=3, max_width=12,
              weight_bits=weight_bits, frac_bits=frac_bits)
    tcp, jcp = TCP(**kw), JCP(**kw)
    rng = np.random.default_rng(weight_bits)
    acts = ["relu", "sigmoid", "leaky_relu", "hard_sigmoid", "none"]
    steps = [("install", 7, [12, 12, 4]), ("install", 300, [5, 3]),
             ("install", 65535, [12, 8, 8, 2]), ("remove", 300, None),
             ("install", 9, [12, 12]), ("install", 7, [3, 12, 1]),
             ("remove", 42, None), ("install", 300, [12, 6, 6])]
    for i, (op, mid, dims) in enumerate(steps):
        if op == "install":
            layers = _model(rng, dims, scale=40.0 if i == 2 else 0.7)
            hidden = [acts[(i + j) % 5] for j in range(len(layers) - 1)]
            fin = acts[i % 5]
            assert tcp.install(mid, layers, hidden, final_activation=fin) \
                == jcp.install(mid, layers, hidden, final_activation=fin)
        else:
            tcp.remove(mid)
            jcp.remove(mid)
        _assert_same(tcp, jcp)


def test_table_full_and_bad_models_leave_tables_untouched():
    tcp, jcp = TCP(max_models=2, max_layers=2, max_width=4), \
        JCP(max_models=2, max_layers=2, max_width=4)
    rng = np.random.default_rng(1)
    for mid in (1, 2):
        layers = _model(rng, [4, 4])
        tcp.install(mid, layers, [])
        jcp.install(mid, layers, [])
    bad = [_model(rng, [4, 4, 4, 4]), _model(rng, [5, 4]), _model(rng, [4, 4])]
    for layers, acts in ((bad[0], []), (bad[1], []), (bad[2], ["bogus"])):
        for cp in (tcp, jcp):
            with pytest.raises((ValueError, KeyError)):
                cp.install(1, layers, acts, final_activation="bogus"
                           if acts == ["bogus"] else "none")
    for cp in (tcp, jcp):
        with pytest.raises(ValueError, match="full"):
            cp.install(3, _model(rng, [4, 1]), [])
    _assert_same(tcp, jcp)


def test_fault_at_commit_point_rolls_back_and_events_record_swaps():
    from repro_torch.obs import Observability
    obs = Observability()
    tcp = TCP(max_models=2, max_layers=2, max_width=4)
    tcp.events = obs.events
    seen = []
    tcp.install_listeners.append(lambda kind, mid: seen.append((kind, mid)))
    rng = np.random.default_rng(2)
    tcp.install(1, _model(rng, [4, 4]), [])
    before = {k: v.clone() for k, v in vars(tcp.tables()).items()}
    FaultPlan([FaultSpec(site="install", every=1, count=1)]).install(tcp)
    with pytest.raises(InjectedFault):
        tcp.install(2, _model(rng, [4, 4]), [])
    after = vars(tcp.tables())
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert tcp.version == 1 and tcp.installed_ids() == frozenset({1})
    tcp.remove(1)
    assert seen == [("install", 1), ("remove", 1)]
    kinds = [e["kind"] for e in obs.events.snapshot()]
    assert kinds.count("install") == 1 and kinds.count("remove") == 1


def test_snapshots_are_cached_per_generation_and_copy_on_write():
    tcp = TCP(max_models=2, max_layers=2, max_width=4)
    rng = np.random.default_rng(3)
    tcp.install(1, _model(rng, [4, 4]), [])
    s1 = tcp.tables("cpu")
    assert tcp.tables(torch.device("cpu")) is s1
    w_before = s1.w.clone()
    tcp.install(1, _model(rng, [4, 4]), [])
    s2 = tcp.tables("cpu")
    assert s2 is not s1
    assert torch.equal(s1.w, w_before)  # the old generation is untouched
    tcp.remove(1)
    assert int(s2.id_map[1]) == 0 and int(tcp.tables().id_map[1]) == -1
    assert not tcp.forest_active and not tcp.slo_active \
        and not tcp.reflex_active


def test_tables_from_numpy_carries_reference_tables():
    jcp = JCP(max_models=3, max_layers=2, max_width=8)
    rng = np.random.default_rng(4)
    jcp.install(11, _model(rng, [8, 8, 2]), ["sigmoid"])
    jcp.install(12, _model(rng, [8, 3]), [])
    jt = jcp.tables()
    tt = tables_from_numpy(*(np.asarray(getattr(jt, k)) for k in FIELDS),
                           device="cpu")
    tcp = TCP(max_models=3, max_layers=2, max_width=8)
    rng = np.random.default_rng(4)
    tcp.install(11, _model(rng, [8, 8, 2]), ["sigmoid"])
    tcp.install(12, _model(rng, [8, 3]), [])
    own = tcp.tables("cpu")
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
        assert torch.equal(getattr(tt, k), getattr(own, k)), k


def _forests(seed):
    """One small trained forest in each package, on the same data."""
    from repro.data.packets import anomaly_dataset
    from repro.forest import compile as jcompile
    from repro_torch.forest import compile as tcompile
    X, y = anomaly_dataset(np.random.default_rng(seed), 256, 8)
    kw = dict(n_trees=4, max_depth=3, seed=seed)
    return tcompile.train_forest(X, y, **kw), jcompile.train_forest(X, y, **kw)


@pytest.mark.parametrize("max_nodes", [64, 128])
def test_table_bytes_matches_reference(max_nodes):
    """The same host buffers counted after the same installs: the MLP and
    forest families, and the range tables only where the plane has them
    (max_nodes 64; not at 128, past the 32-leaf mask)."""
    kw = dict(max_models=4, max_layers=3, max_width=12, max_forests=3,
              max_trees=8, max_nodes=max_nodes)
    tcp, jcp = TCP(**kw), JCP(**kw)
    assert tcp.range_available == jcp.range_available == (max_nodes == 64)
    assert tcp.table_bytes() == jcp.table_bytes()
    rng = np.random.default_rng(5)
    layers = _model(rng, [12, 8, 2])
    tcp.install(3, layers, ["relu"])
    jcp.install(3, layers, ["relu"])
    tf, jf = _forests(6)
    tcp.install_forest(9, tf)
    jcp.install_forest(9, jf)
    assert tcp.table_bytes() == jcp.table_bytes() > 0


def test_invalidate_snapshot_forces_a_fresh_upload():
    """Cached snapshots of all three families are dropped: the next read
    builds new ones from the host buffers, equal to the old ones; without
    a write or an invalidation the cache is kept."""
    tcp = TCP(max_models=2, max_layers=2, max_width=8, max_forests=2,
              max_trees=8, max_nodes=64)
    tcp.install(1, _model(np.random.default_rng(7), [8, 4]), [])
    tcp.install_forest(2, _forests(8)[0])
    reads = (tcp.tables, tcp.forest_tables, tcp.range_tables)
    before = [read("cpu") for read in reads]
    assert all(read("cpu") is b for read, b in zip(reads, before))
    version = tcp.version
    tcp.invalidate_snapshot()
    after = [read("cpu") for read in reads]
    assert tcp.version == version
    for old, new in zip(before, after):
        assert new is not old
        for f in old.__dataclass_fields__:
            assert torch.equal(getattr(old, f), getattr(new, f)), f
    assert all(read("cpu") is a for read, a in zip(reads, after))
