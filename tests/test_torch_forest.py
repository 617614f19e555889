"""The port's tree-ensemble (forest) lane against the JAX reference, on the
CPU at small sizes, with exact equality (integer codes, zero tolerance):

  * datasets, the CART trainer and ``pack_forest`` give the reference's
    arrays, including the node-budget overshoot (ROADMAP R3);
  * ``pack_forest_ranges`` gives the reference's arrays (leaf masks as
    int32 bit patterns) and the same errors on malformed trees;
  * all four plain traversal versions (gather and masked, chase and range)
    equal the scalar oracle ``repro.kernels.ref.forest_traverse_numpy`` and
    the reference's Pallas kernels in interpret mode; on tables that
    ``install_forest`` rejects, the masked forms equal the reference's
    masked forms;
  * the forest control plane, the carry-across of the reference's tables,
    ``serve_lanes`` and the whole ``PacketServer`` slice on a mixed
    MLP+forest trace with a mid-trace ``install_forest``;
  * the forest example runs on the CPU.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.control_plane import ControlPlane as JCP
from repro.core.packet import HEADER_BYTES, encode_packets_np
from repro.data import packets as jdata
from repro.forest import PackedForest as JPacked
from repro.forest import compile as jcompile
from repro.forest import ranges as jranges
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.serve import PacketServer as JServer
from repro_torch.core.control_plane import ControlPlane as TCP
from repro_torch.core.control_plane import (forest_tables_from_numpy,
                                            range_tables_from_numpy,
                                            tables_from_numpy)
from repro_torch.core.inference import DataPlaneEngine
from repro_torch.data import packets as tdata
from repro_torch.forest import PackedForest as TPacked
from repro_torch.forest import compile as tcompile
from repro_torch.forest import ranges as tranges
from repro_torch.forest.synthetic import (random_forest_tables,
                                          rejected_tables, stack_ranges)
from repro_torch.kernels import forest_traversal as tft
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.fused_serve import LaneConfig, serve_lanes
from repro_torch.launch.serve import PacketServer as TServer
from repro_torch.serve.faults import FaultPlan, FaultSpec, InjectedFault

torch.set_num_threads(1)

FRAC = 8
WIDTH = 8
I32 = np.iinfo(np.int32)
TREE_FIELDS = ("feature", "threshold", "left", "right", "value")
F_FIELDS = ("nodes", "tree_on", "mode", "out_dim", "id_map")


def _train(mod, rng_seed, task, n=400, d=WIDTH, **kw):
    data = mod.anomaly_dataset if task == "classify" else mod.qos_dataset
    X, y = data(np.random.default_rng(rng_seed), n, d)
    return X, y


def _forest_pair(task, seed, n_trees=4, max_depth=4, max_nodes=31):
    """The same forest trained by the port and by the reference."""
    X, y = _train(tdata, seed, task)
    kw = dict(task=task, n_trees=n_trees, max_depth=max_depth,
              max_nodes=max_nodes, seed=seed + 1)
    return (tcompile.train_forest(X, y, **kw),
            jcompile.train_forest(X, y, **kw))


def _assert_same_forest(tf, jf):
    assert tf.task == jf.task and tf.n_classes == jf.n_classes
    assert tf.n_trees == jf.n_trees
    for tt, jt in zip(tf.trees, jf.trees):
        for name in TREE_FIELDS:
            a, b = getattr(tt, name), getattr(jt, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_same_packed(tp, jp):
    np.testing.assert_array_equal(tp.nodes, jp.nodes)
    np.testing.assert_array_equal(tp.tree_on, jp.tree_on)
    assert (tp.mode, tp.out_dim, tp.depth, tp.frac_bits) == \
        (jp.mode, jp.out_dim, jp.depth, jp.frac_bits)


# ---------------------------------------------------------------------------
# datasets, trainer, packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [("flow_features", {}),
                                     ("anomaly_dataset", {}),
                                     ("anomaly_dataset", {"drift": 0.35}),
                                     ("qos_dataset", {})])
def test_datasets_bit_identical(name, kw):
    args = (np.random.default_rng(5), 300, 11)
    got = getattr(tdata, name)(*args, **kw)
    want = getattr(jdata, name)(np.random.default_rng(5), 300, 11, **kw)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("task", ["classify", "regress"])
@pytest.mark.parametrize("frac", [8, 5])
def test_train_and_pack_match_reference(task, frac):
    tf, jf = _forest_pair(task, 11 if task == "classify" else 12)
    _assert_same_forest(tf, jf)
    _assert_same_packed(tcompile.pack_forest(tf, frac_bits=frac),
                        jcompile.pack_forest(jf, frac_bits=frac))
    X, _ = _train(tdata, 13, task)
    np.testing.assert_array_equal(tcompile.predict_float(tf, X),
                                  jcompile.predict_float(jf, X))


def test_from_arrays_and_tree_helpers_match_reference():
    tf, jf = _forest_pair("classify", 14)
    cols = [[getattr(t, n) for t in tf.trees] for n in TREE_FIELDS]
    tim = tcompile.Forest.from_arrays(*cols, task="classify", n_classes=2)
    jim = jcompile.Forest.from_arrays(*cols, task="classify", n_classes=2)
    _assert_same_forest(tim, jim)
    assert [t.depth() for t in tim.trees] == [t.depth() for t in jim.trees]
    with pytest.raises(ValueError, match="n_classes"):
        tcompile.Forest(trees=[], task="classify", n_classes=1)
    with pytest.raises(ValueError, match="empty"):
        tcompile.pack_forest(tcompile.Forest(trees=[], task="regress"),
                             frac_bits=FRAC)


def test_node_budget_overshoot_r3_matches_reference():
    """ROADMAP R3: with max_nodes=63 the trainer grows a 65-node, 33-leaf
    tree 0, on both sides, and both range compilers and both control
    planes refuse it."""
    X, y = tdata.anomaly_dataset(np.random.default_rng(102), 2048, 32)
    kw = dict(task="classify", n_trees=1, max_depth=6, max_nodes=63,
              seed=202)
    tf, jf = (tcompile.train_forest(X, y, **kw),
              jcompile.train_forest(X, y, **kw))
    _assert_same_forest(tf, jf)
    tree = tf.trees[0]
    assert tree.n_nodes == 65 and int((tree.left < 0).sum()) == 33
    tp = tcompile.pack_forest(tf, frac_bits=FRAC)
    jp = jcompile.pack_forest(jf, frac_bits=FRAC)
    _assert_same_packed(tp, jp)
    for mod, p in ((tranges, tp), (jranges, jp)):
        with pytest.raises(ValueError, match="more than 32 leaves"):
            mod.pack_forest_ranges(p.nodes, p.tree_on, max_depth=6)
    for cp, forest in ((TCP(max_width=32), tf), (JCP(max_width=32), jf)):
        with pytest.raises(ValueError, match="-node trees > max 64"):
            cp.install_forest(1, forest)


# ---------------------------------------------------------------------------
# range compilation
# ---------------------------------------------------------------------------


def _assert_same_ranges(tr, jr):
    np.testing.assert_array_equal(tr.feat, jr.feat)
    np.testing.assert_array_equal(tr.thresh, jr.thresh)
    assert tr.lmask.dtype == np.int32 and jr.lmask.dtype == np.uint32
    np.testing.assert_array_equal(tr.lmask, jr.lmask.view(np.int32))
    np.testing.assert_array_equal(tr.payload, jr.payload)
    assert tr.depth == jr.depth


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_forest_ranges_matches_reference(seed):
    rng = np.random.default_rng(seed)
    nodes, tree_on, _ = random_forest_tables(rng, 1, WIDTH, 4, n_trees=5,
                                             n_nodes=15)
    tree_on[0, 2] = 0  # a dead tree stays padding
    _assert_same_ranges(
        tranges.pack_forest_ranges(nodes[0], tree_on[0], max_depth=4),
        jranges.pack_forest_ranges(nodes[0], tree_on[0], max_depth=4))
    tf, jf = _forest_pair("regress", 20 + seed)
    tp = tcompile.pack_forest(tf, frac_bits=FRAC)
    _assert_same_ranges(
        tranges.pack_forest_ranges(tp.nodes, tp.tree_on, max_depth=4),
        jranges.pack_forest_ranges(tp.nodes, tp.tree_on, max_depth=4))
    assert tranges.range_bounds(64) == jranges.range_bounds(64) == (31, 32)


def _malformed():
    leaf = lambda i, v=0: (0, 0, i, i, v)  # noqa: E731
    cyc = [(0, 10, 1, 2, 0), (1, 20, 0, 2, 0), leaf(2, 5)]
    dangling = [(0, 10, 1, 7, 0), leaf(1)]
    half = [(0, 10, 0, 1, 0), leaf(1)]
    deep = [(0, 1, 1, 2, 0), (0, 1, 3, 4, 0), leaf(2), leaf(3), leaf(4)]
    # 33 leaves: a left-leaning comb of 32 splits
    comb = []
    for i in range(32):
        comb.append((0, i, 2 * i + 2, 2 * i + 1, 0))
        comb.append(leaf(2 * i + 1))
    comb[-2:] = [(0, 31, 64, 63, 0), leaf(63)]
    comb.append(leaf(64))
    return [("cycle", cyc, 4), ("dangling", dangling, 4),
            ("half_loop", half, 4), ("too_deep", deep, 1),
            ("leaves", comb, 40)]


@pytest.mark.parametrize("name,rows,depth", _malformed(),
                         ids=[m[0] for m in _malformed()])
def test_pack_forest_ranges_rejects_like_reference(name, rows, depth):
    nodes = np.asarray(rows, np.int32)[None]
    on = np.ones(1, np.int32)
    with pytest.raises(ValueError) as want:
        jranges.pack_forest_ranges(nodes, on, max_depth=depth)
    with pytest.raises(ValueError) as got:
        tranges.pack_forest_ranges(nodes, on, max_depth=depth)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# traversals: the four plain versions against the oracle and the Pallas
# kernels (interpret mode)
# ---------------------------------------------------------------------------


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _plain_versions(x, slot, nodes, tree_on, mode, ranges, depth,
                    gather=True):
    """The port's masked forms of both traversals, and their gather forms
    unless ``gather`` is False (they index the tables directly, so they
    take valid tables only)."""
    feat, th, lm, pay = (_t(a) for a in ranges)
    xs, ss = _t(x), _t(slot)
    ns, ts, ms = _t(nodes), _t(tree_on), _t(mode)
    out = {
        "chase_masked": tops.forest_traverse(
            xs, ss, ns, ts, ms, max_depth=depth, frac=FRAC, backend="ref"),
        "range_masked": tops.forest_traverse(
            xs, ss, ns, ts, ms, max_depth=depth, frac=FRAC, backend="ref",
            variant="range", ranges=(feat, th, lm, pay)),
    }
    if gather:
        out["chase_gather"] = tref.forest_traverse_gather_ref(
            xs, ss, ns, ts, ms, max_depth=depth, frac=FRAC)
        out["range_gather"] = tref.forest_range_gather_ref(
            xs, ss, feat, th, lm, pay, ts, ms, frac=FRAC)
    return out


def _check_against_reference(x, slot, nodes, tree_on, mode, depth):
    want = jref.forest_traverse_numpy(x, slot, nodes, tree_on, mode,
                                      max_depth=depth, frac=FRAC)
    ranges = stack_ranges(nodes, tree_on, depth)
    for name, got in _plain_versions(x, slot, nodes, tree_on, mode, ranges,
                                     depth).items():
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    jranges_u32 = ranges[:2] + (ranges[2].view(np.uint32),) + ranges[3:]
    args = [jnp.asarray(a) for a in (x, slot, nodes, tree_on, mode)]
    for variant in ("chase", "range"):
        pallas = np.asarray(jops.forest_traverse(
            *args, max_depth=depth, frac=FRAC, backend="pallas",
            variant=variant,
            ranges=jranges_u32 if variant == "range" else None))
        np.testing.assert_array_equal(pallas, want, err_msg=variant)


@pytest.mark.parametrize("seed,n_forests,depth,n_batch",
                         [(0, 1, 1, 131), (1, 3, 4, 131), (2, 2, 3, 37),
                          (3, 3, 5, 200)])
def test_plain_versions_random_tables(seed, n_forests, depth, n_batch):
    rng = np.random.default_rng(seed)
    nodes, tree_on, mode = random_forest_tables(rng, n_forests, WIDTH, depth)
    x = rng.integers(-1000, 1000, (n_batch, WIDTH)).astype(np.int32)
    slot = rng.integers(0, n_forests, n_batch).astype(np.int32)
    _check_against_reference(x, slot, nodes, tree_on, mode, depth)


@pytest.mark.parametrize("task", ["classify", "regress"])
def test_plain_versions_trained_forests(task):
    tf, _ = _forest_pair(task, 30, n_trees=4, max_depth=4, max_nodes=16)
    p = tcompile.pack_forest(tf, frac_bits=FRAC)
    rng = np.random.default_rng(31)
    x = rng.integers(-800, 800, (131, WIDTH)).astype(np.int32)
    _check_against_reference(x, np.zeros(131, np.int32), p.nodes[None],
                             p.tree_on[None],
                             np.asarray([p.mode], np.int32), max(p.depth, 1))


def test_plain_versions_saturating_thresholds_and_codes():
    """INT32_MAX thresholds always go left, INT32_MIN ones only at exactly
    INT32_MIN; codes span the whole int32 range."""
    rng = np.random.default_rng(7)
    nodes, tree_on, mode = random_forest_tables(rng, 2, WIDTH, 3)
    for f in range(nodes.shape[0]):
        for t in range(nodes.shape[1]):
            internal = np.nonzero(nodes[f, t, :, 2]
                                  != np.arange(nodes.shape[2]))[0]
            for k, i in enumerate(internal):
                nodes[f, t, i, 1] = I32.max if k % 2 == 0 else I32.min
    x = np.concatenate([
        rng.integers(I32.min, I32.max, (60, WIDTH), endpoint=True),
        np.full((2, WIDTH), I32.min), np.full((2, WIDTH), I32.max)]
    ).astype(np.int32)
    slot = rng.integers(0, 2, x.shape[0]).astype(np.int32)
    _check_against_reference(x, slot, nodes, tree_on, mode, 3)


def test_plain_versions_stumps_and_padded_trees():
    rng = np.random.default_rng(8)
    n_trees = 4
    nodes = np.zeros((2, n_trees, 5, 5), np.int32)
    for t in range(n_trees):  # depth-1 stumps, then two self-loop pads
        nodes[:, t, 0] = (int(rng.integers(0, WIDTH)),
                          int(rng.integers(-500, 500)), 1, 2, 0)
        nodes[:, t, 1] = (0, 0, 1, 1, int(rng.integers(-900, 900)))
        nodes[:, t, 2] = (0, 0, 2, 2, int(rng.integers(-900, 900)))
        nodes[:, t, 3:, 2:4] = np.arange(3, 5)[:, None]
    nodes[1, :, 1:3, 4] %= 3  # forest 1 classifies into 3 lanes
    nodes[1, :, 1:3, 4] = np.abs(nodes[1, :, 1:3, 4])
    tree_on = np.asarray([[1, 1, 1, 0], [1, 0, 1, 1]], np.int32)
    mode = np.asarray([tref.FOREST_REGRESS, tref.FOREST_CLASSIFY], np.int32)
    x = rng.integers(-1000, 1000, (131, WIDTH)).astype(np.int32)
    slot = rng.integers(0, 2, 131).astype(np.int32)
    _check_against_reference(x, slot, nodes, tree_on, mode, 1)


@pytest.mark.parametrize("seed", [40, 41])
def test_masked_forms_match_reference_masked_forms_off_contract(seed):
    """Where install_forest would refuse the tables, the port's masked
    forms (what the kernels are held to on the card) still equal the
    reference's masked forms operand for operand."""
    rng = np.random.default_rng(seed)
    nodes, tree_on, mode, ranges = rejected_tables(rng, 3, 4, 9, WIDTH, 3,
                                                   4, 5)
    mode[:] = [1, 0, 1]
    x = rng.integers(-900, 900, (131, WIDTH)).astype(np.int32)
    slot = rng.integers(-2, 5, 131).astype(np.int32)
    got = _plain_versions(x, slot, nodes, tree_on, mode, ranges, 3,
                          gather=False)
    n_forests, n_trees, n_nodes, _ = nodes.shape
    nodes_t = np.transpose(nodes, (1, 0, 3, 2)).reshape(
        n_trees, n_forests, 5 * n_nodes)
    on_t = np.transpose(tree_on)[:, :, None]
    want_chase = jref.forest_traverse_ref(
        jnp.asarray(x), jnp.asarray(slot)[:, None], jnp.asarray(nodes_t),
        jnp.asarray(on_t), jnp.asarray(mode)[:, None], max_depth=3,
        frac=FRAC)
    np.testing.assert_array_equal(got["chase_masked"].numpy(),
                                  np.asarray(want_chase))
    rng_t = np.concatenate([np.transpose(a, (1, 0, 2)) for a in ranges],
                           axis=2)
    want_range = jref.forest_range_ref(
        jnp.asarray(x), jnp.asarray(slot)[:, None], jnp.asarray(rng_t),
        jnp.asarray(on_t), jnp.asarray(mode)[:, None], n_entries=4,
        n_leaves=5, frac=FRAC)
    np.testing.assert_array_equal(got["range_masked"].numpy(),
                                  np.asarray(want_range))
    assert not got["chase_masked"].numpy()[(slot < 0) | (slot >= 3)].any()


def test_wrappers_cpu_path_and_argument_checks():
    """On CPU tensors the kernel wrappers are their gather forms and count
    no launch; the kernel backend refuses CPU tensors; bad arguments
    raise."""
    rng = np.random.default_rng(9)
    nodes, tree_on, mode = random_forest_tables(rng, 2, WIDTH, 3)
    ranges = [_t(a) for a in stack_ranges(nodes, tree_on, 3)]
    x = _t(rng.integers(-900, 900, (50, WIDTH)).astype(np.int32))
    slot = _t(rng.integers(0, 2, 50).astype(np.int32))
    ns, ts, ms = _t(nodes), _t(tree_on), _t(mode)
    before = dict(tft.launches)
    got = tft.forest_traverse(x, slot, ns, ts, ms, max_depth=3, frac=FRAC)
    assert torch.equal(got, tref.forest_traverse_gather_ref(
        x, slot, ns, ts, ms, max_depth=3, frac=FRAC))
    got = tft.forest_range(x, slot, *ranges, ts, ms, frac=FRAC)
    assert torch.equal(got, tref.forest_range_gather_ref(
        x, slot, *ranges, ts, ms, frac=FRAC))
    assert tft.launches == before
    with pytest.raises(ValueError, match="kernel"):
        tops.forest_traverse(x, slot, ns, ts, ms, max_depth=3, frac=FRAC,
                             backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        tops.forest_traverse(x, slot, ns, ts, ms, max_depth=3, frac=FRAC,
                             backend="pallas")
    with pytest.raises(ValueError, match="variant"):
        tops.forest_traverse(x, slot, ns, ts, ms, max_depth=3, frac=FRAC,
                             variant="walk")
    with pytest.raises(ValueError, match="range tables"):
        tops.forest_traverse(x, slot, ns, ts, ms, max_depth=3, frac=FRAC,
                             variant="range")
    big = torch.zeros((2, 1, 33), dtype=torch.int32)
    with pytest.raises(ValueError, match="32"):
        tref.forest_range_gather_ref(x, slot, *ranges[:3], big, ts[:, :1],
                                     ms, frac=FRAC)


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------


def _assert_same_planes(tcp, jcp):
    ft = tcp.forest_tables("cpu")
    for name in F_FIELDS:
        np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                      getattr(jcp, "_f_" + name),
                                      err_msg=name)
    rt = tcp.range_tables("cpu")
    for name, ref_name in (("feat", "_r_feat"), ("thresh", "_r_th"),
                           ("payload", "_r_payload")):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      getattr(jcp, ref_name), err_msg=name)
    np.testing.assert_array_equal(rt.lmask.numpy(),
                                  jcp._r_mask.view(np.int32))
    mt = tcp.tables("cpu")
    for name in ("w", "layer_on", "id_map"):
        np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                      getattr(jcp, "_" + name), err_msg=name)
    assert tcp.version == jcp.version
    assert tcp.installed_ids() == jcp.installed_ids()
    assert tcp.forest_active == jcp.forest_active
    ids = np.arange(0, 40)
    np.testing.assert_array_equal(tcp.is_forest_id(ids),
                                  jcp.is_forest_id(ids))


def _mlp(rng, width=WIDTH):
    return [(rng.normal(size=(width, width)).astype(np.float32) * 0.3,
             np.zeros(width, np.float32)),
            (rng.normal(size=(width, 2)).astype(np.float32) * 0.3,
             np.zeros(2, np.float32))]


def _planes(**kw):
    kw = dict(dict(max_models=4, max_width=WIDTH, frac_bits=FRAC,
                   max_forests=3, max_trees=6, max_nodes=31,
                   max_tree_depth=4), **kw)
    return TCP(**kw), JCP(**kw)


def test_install_remove_install_forest_sequence_matches():
    tcp, jcp = _planes()
    rng = np.random.default_rng(50)
    forests = [_forest_pair(t, 51 + i, n_trees=3 + i)
               for i, t in enumerate(["classify", "regress", "classify"])]
    steps = [("mlp", 1, None), ("forest", 5, 0), ("forest", 6, 1),
             ("remove", 5, None), ("forest", 7, 2), ("forest", 6, 0),
             ("remove", 1, None), ("forest", 1, 1), ("remove", 404, None),
             ("remove", 6, None), ("mlp", 6, None)]
    for op, mid, k in steps:
        if op == "mlp":
            layers = _mlp(rng)
            assert tcp.install(mid, layers, ["relu"]) == \
                jcp.install(mid, layers, ["relu"])
        elif op == "forest":
            assert tcp.install_forest(mid, forests[k][0]) == \
                jcp.install_forest(mid, forests[k][1])
        else:
            tcp.remove(mid)
            jcp.remove(mid)
        _assert_same_planes(tcp, jcp)


def test_namespace_table_full_and_monotone_latch():
    tcp, jcp = _planes(max_forests=1)
    tf, jf = _forest_pair("classify", 60)
    rng = np.random.default_rng(61)
    layers = _mlp(rng)
    for cp, f in ((tcp, tf), (jcp, jf)):
        assert not cp.forest_active
        cp.install(9, layers, ["relu"])
        with pytest.raises(ValueError, match="installed as an MLP"):
            cp.install_forest(9, f)
        cp.install_forest(3, f)
        with pytest.raises(ValueError, match="installed as a forest"):
            cp.install(3, layers, ["relu"])
        with pytest.raises(ValueError, match="forest table full"):
            cp.install_forest(4, f)
        cp.remove(3)
        assert cp.forest_active  # latched
        cp.install(3, layers, ["relu"])  # the freed id serves the other family
    _assert_same_planes(tcp, jcp)


def _bad_packed(cls, name):
    """A PackedForest each validation of install_forest rejects."""
    leafy = [[1, 0, 1, 2, 0], [0, 0, 1, 1, 0], [0, 0, 2, 2, 1]]
    rows, kw = leafy, dict(mode=1, out_dim=2, depth=1, frac_bits=FRAC)
    if name == "feature":
        rows = [[WIDTH + 3, 0, 1, 2, 0]] + leafy[1:]
    elif name == "child":
        rows = [[1, 0, 1, 5, 0]] + leafy[1:]
    elif name == "leaf_label":
        rows = [leafy[0], [0, 0, 1, 1, 7], leafy[2]]
    elif name == "out_dim":
        kw["out_dim"], kw["mode"] = WIDTH + 1, 0
    elif name == "depth":
        kw["depth"] = 9
    elif name == "frac":
        kw["frac_bits"] = FRAC - 1
    elif name == "cycle":
        rows = [[0, 10, 1, 2, 0], [1, 20, 0, 2, 0], [0, 0, 2, 2, 1]]
    nodes = np.asarray(rows, np.int32)[None]
    if name == "trees":
        nodes = np.repeat(nodes, 7, axis=0)
    if name == "nodes":
        nodes = np.zeros((1, 32, 5), np.int32)
    return cls(nodes=nodes, tree_on=np.ones(nodes.shape[0], np.int32), **kw)


@pytest.mark.parametrize("name", ["feature", "child", "leaf_label", "out_dim",
                                  "depth", "frac", "cycle", "trees", "nodes"])
def test_install_forest_rejects_like_reference(name):
    tcp, jcp = _planes()
    with pytest.raises(ValueError) as want:
        jcp.install_forest(1, _bad_packed(JPacked, name))
    with pytest.raises(ValueError) as got:
        tcp.install_forest(1, _bad_packed(TPacked, name))
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        tcp.install_forest(1, "forest")
    _assert_same_planes(tcp, jcp)


def test_fault_at_commit_point_rolls_back_forest_install():
    from repro_torch.obs import Observability
    obs = Observability()
    tcp, _ = _planes()
    tcp.events = obs.events
    tf, _ = _forest_pair("classify", 70)
    tcp.install_forest(2, tf)
    f_before = {k: v.clone() for k, v in vars(tcp.forest_tables()).items()}
    r_before = {k: v.clone() for k, v in vars(tcp.range_tables()).items()}
    FaultPlan([FaultSpec(site="install", every=1, count=1)]).install(tcp)
    with pytest.raises(InjectedFault):
        tcp.install_forest(3, _forest_pair("regress", 71)[0])
    for before, after in ((f_before, vars(tcp.forest_tables())),
                          (r_before, vars(tcp.range_tables()))):
        for k in before:
            assert torch.equal(before[k], after[k]), k
    assert tcp.version == 1 and tcp.installed_ids() == frozenset({2})
    kinds = [e["kind"] for e in obs.events.snapshot()]
    assert kinds == ["install_forest"]


def test_snapshots_per_generation_and_range_family_bounds():
    tcp, _ = _planes()
    tf, _ = _forest_pair("classify", 72)
    tcp.install_forest(2, tf)
    f1, r1 = tcp.forest_snapshots(True)
    assert tcp.forest_tables() is f1 and tcp.range_tables() is r1
    assert tcp.forest_snapshots(False) == (f1, None)
    m1 = tcp.tables()
    tcp.install(1, _mlp(np.random.default_rng(73)), ["relu"])
    assert tcp.forest_tables() is f1  # an MLP swap leaves forests cached
    tcp.install_forest(2, tf)
    assert tcp.forest_tables() is not f1 and tcp.tables() is not m1
    big = TCP(max_nodes=127)
    assert not big.range_available
    with pytest.raises(RuntimeError, match="range tables unavailable"):
        big.range_tables()
    with pytest.raises(ValueError, match="range"):
        DataPlaneEngine(big, forest_variant="range", device="cpu")
    assert DataPlaneEngine(big, device="cpu").forest_variant == "chase"
    assert DataPlaneEngine(tcp, device="cpu").forest_variant == "chase"


# ---------------------------------------------------------------------------
# carry-across and serve_lanes
# ---------------------------------------------------------------------------


def _reference_plane_with_traffic(rng):
    jcp = JCP(max_models=3, max_width=WIDTH, frac_bits=FRAC, max_forests=3,
              max_trees=5, max_nodes=31, max_tree_depth=4)
    jcp.install(1, _mlp(rng), ["relu"])
    for mid, task, seed in ((4, "classify", 80), (5, "regress", 81)):
        jcp.install_forest(mid, _forest_pair(task, seed, n_trees=5)[1])
    mids = rng.choice([1, 4, 5, 0, 77, -65532], 200).astype(np.int32)
    x0 = rng.integers(-900, 900, (200, WIDTH)).astype(np.int32)
    return jcp, mids, x0


@pytest.mark.parametrize("variant", ["chase", "range"])
@pytest.mark.parametrize("use_mlp", [True, False])
def test_carry_across_tables_serve_identically(variant, use_mlp):
    """The reference control plane's arrays, carried across with the
    ``*_from_numpy`` functions, serve through the port's ``serve_lanes``
    exactly as through the reference's (negative ids count from the end of
    the id map)."""
    from repro.kernels.fused_serve import LaneConfig as JCfg
    from repro.kernels.fused_serve import serve_lanes as jserve
    from repro_torch.core.taylor import scaled_constants
    rng = np.random.default_rng(82)
    jcp, mids, x0 = _reference_plane_with_traffic(rng)
    sig = tuple(int(c) for c in scaled_constants("sigmoid", 3, FRAC))
    jt, jft, jrt = jcp.tables(), *jcp.forest_snapshots(True)
    want = np.asarray(jserve(
        jnp.asarray(x0), jnp.asarray(mids), jt, jft, jrt,
        JCfg(frac=FRAC, sig_coeffs=sig, leaky_alpha_q=3, max_features=WIDTH,
             max_tree_depth=4, forest_variant=variant),
        use_mlp=use_mlp, use_forest=True))
    tt = tables_from_numpy(*(np.asarray(getattr(jt, k)) for k in
                             ("w", "b", "act", "layer_on", "out_dim",
                              "id_map")))
    tft_ = forest_tables_from_numpy(*(np.asarray(getattr(jft, k))
                                      for k in F_FIELDS))
    trt = range_tables_from_numpy(*(np.asarray(getattr(jrt, k)) for k in
                                    ("feat", "thresh", "lmask", "payload")))
    assert trt.lmask.dtype == torch.int32
    got = serve_lanes(_t(x0), _t(mids), tt, tft_, trt,
                      LaneConfig(frac=FRAC, sig_coeffs=sig, leaky_alpha_q=3,
                                 max_features=WIDTH, max_tree_depth=4,
                                 forest_variant=variant),
                      use_mlp=use_mlp, use_forest=True)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the whole slice: PacketServer on a mixed MLP + forest trace
# ---------------------------------------------------------------------------


def _install_zoo(servers, forest_pairs, rng):
    for m in range(3):
        layers = _mlp(rng)
        for s in servers:
            s.install(1 + m, layers, ["sigmoid"], final_activation="relu")
    for k, (tf, jf) in enumerate(forest_pairs):
        servers[0].install_forest(4 + k, tf)
        servers[1].install_forest(4 + k, jf)


def _mixed_trace(rng, n, ids):
    n_uniq = int(n * 0.7)
    feats = rng.integers(-700, 700, (n_uniq, WIDTH)).astype(np.int32)
    mids = rng.choice(np.asarray(ids + [9, 999], np.int32), n_uniq)
    uniq = encode_packets_np(mids, FRAC, feats)
    pick = np.concatenate([np.arange(n_uniq),
                           rng.integers(0, n_uniq, n - n_uniq)])
    rows = uniq[rng.permutation(pick)]
    cuts = np.unique(np.cumsum(rng.integers(1, 90, n // 8)))
    return np.split(rows, cuts[cuts < n])


@pytest.mark.parametrize("variant", ["chase", "range"])
def test_packet_server_mixed_trace_matches_reference(variant):
    kw = dict(max_models=4, max_layers=2, max_width=WIDTH, frac_bits=FRAC,
              max_forests=3, max_trees=5, max_nodes=31, max_tree_depth=4,
              ingress_batch=64, forest_variant=variant)
    servers = [TServer(device="cpu", **kw), JServer(**kw)]
    assert servers[0].engine.forest_variant == variant
    rng = np.random.default_rng(90)
    pairs = [_forest_pair(t, 91 + k, n_trees=3 + k)
             for k, t in enumerate(["classify", "regress", "classify"])]
    _install_zoo(servers, pairs, rng)
    for s in servers:
        # all three lane programs up front: batches staged before the
        # mid-trace install dispatch on the "both" program
        s.engine.warm(64, HEADER_BYTES + 4 * WIDTH,
                      lanes=("mlp", "forest", "both"))
    chunks = _mixed_trace(rng, 1500, [1, 2, 3, 4, 5, 6])
    retrained = _forest_pair("classify", 99, n_trees=5)
    outs, rcs = [], []
    for i, s in enumerate(servers):
        for c, chunk in enumerate(chunks):
            if c == len(chunks) // 2:
                rc = s.stats()["recompiles"]
                s.install_forest(4, retrained[i])
            s.submit_packets(chunk)
        outs.append(s.drain_packets())
        rcs.append((rc, s.stats()["recompiles"]))
    assert all(isinstance(o, np.ndarray) for o in outs[0])
    np.testing.assert_array_equal(np.stack(outs[0]), np.stack(outs[1]))
    assert rcs[0] == rcs[1] and rcs[0][0] == rcs[0][1]
    lanes = [s.ingress.stats["lane_batches"] for s in servers]
    assert dict(lanes[0]) == dict(lanes[1])
    assert lanes[0]["mlp"] > 0 and lanes[0]["forest"] > 0
    assert servers[0].stats()["table_generation"] == \
        servers[1].stats()["table_generation"]
    # removing a forest drops its cached rows: its packets egress zeros
    for s in servers:
        s.remove(5)
        s.submit_packets(chunks[0])
    np.testing.assert_array_equal(np.stack(servers[0].drain_packets()),
                                  np.stack(servers[1].drain_packets()))


def test_mlp_only_deployment_never_runs_the_forest_lane():
    srv = TServer(device="cpu", max_models=2, max_layers=2, max_width=WIDTH,
                  ingress_batch=32)
    srv.install(1, _mlp(np.random.default_rng(95)), ["relu"])
    rows = encode_packets_np(np.ones(100, np.int32), FRAC,
                             np.zeros((100, WIDTH), np.int32) + 5)
    before = dict(tft.launches)
    srv.submit_packets(rows)
    srv.drain_packets()
    lanes = srv.ingress.stats["lane_batches"]
    assert lanes["forest"] == 0 and lanes["mlp"] > 0
    assert tft.launches == before
    assert all(cfg[3] is False for cfg in srv.engine._configs)


def test_forest_example_runs_on_cpu():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "pt_forest_anomaly.py"
    spec = importlib.util.spec_from_file_location("pt_forest_anomaly", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main("cpu")
    assert res["recompiles"] == 1 and res["acc"] > 0.9
    assert res["acc_re"] > res["acc_drift"] + 0.03
