"""Configurations: the deployment a cell serves, read from
``portbench/configs/<name>.json``, its models and forests made from the
seed, and the PacketServer of the program built and filled with them.

A configuration file states the server's settings, the models (structure
and weight scale per Model ID), the forests (task, tree count and shape),
the FeatureSpecs and the input ranges forest thresholds are drawn from.
The seed gives the float weights and the trees; the program installs them
through its control plane and the reference quantizes them itself.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WIDTH = 32


def load_config(name: str) -> dict:
    path = ROOT / "configs" / f"{name}.json"
    with open(path) as f:
        cfg = json.load(f)
    if cfg.get("name") != name:
        raise ValueError(f"{path} names itself {cfg.get('name')!r}")
    return cfg


def streams(seed: int, n: int) -> list:
    """Independent generators for the parts of a run (weights, forests,
    traffic, sample, ...) from one seed."""
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(int(seed)).spawn(n)]


def make_mlps(cfg: dict, rng: np.random.Generator) -> dict:
    """Model ID → (layers [(W (in, out) float32, b float32)], hidden
    activations, final activation), drawn in two calls for all models."""
    specs = cfg["mlps"]
    n, depth = len(specs), max(len(m["dims"]) - 1 for m in specs)
    w_all = rng.standard_normal((n, depth, WIDTH, WIDTH), np.float32)
    b_all = rng.standard_normal((n, depth, WIDTH), np.float32)
    out = {}
    for k, m in enumerate(specs):
        dims = m["dims"]
        layers = []
        for j, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            w = w_all[k, j, :din, :dout] * np.float32(
                m["scale"] / np.sqrt(din))
            b = b_all[k, j, :dout] * np.float32(0.1)
            layers.append((np.ascontiguousarray(w), np.ascontiguousarray(b)))
        out[int(m["id"])] = (layers, list(m["acts"]), m["final"])
    return out


def _threshold(rng, kind: str, lo: float, hi: float) -> float:
    if kind == "log":
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    return float(rng.uniform(lo, hi))


def make_tree(rng, n_leaves: int, max_depth: int, spec, ranges) -> dict:
    """A random binary tree in the sklearn flat convention with
    ``n_leaves`` leaves and depth at most ``max_depth``: random leaves are
    split until the count is reached; each split tests a random input
    column against a threshold drawn from that column's flow-feature
    range."""
    left, right, depth = [-1], [-1], [0]
    feature, threshold = [0], [0.0]
    leaves = [0]
    while len(leaves) < n_leaves:
        cand = [i for i in leaves if depth[i] < max_depth]
        node = cand[int(rng.integers(len(cand)))]
        col = int(rng.integers(WIDTH))
        kind, lo, hi = ranges[str(spec[col])]
        feature[node], threshold[node] = col, _threshold(rng, kind, lo, hi)
        for side in (left, right):
            side[node] = len(left)
            left.append(-1)
            right.append(-1)
            depth.append(depth[node] + 1)
            feature.append(0)
            threshold.append(0.0)
        leaves.remove(node)
        leaves += [left[node], right[node]]
    return dict(feature=np.asarray(feature, np.int32),
                threshold=np.asarray(threshold, np.float32),
                left=np.asarray(left, np.int32),
                right=np.asarray(right, np.int32))


def make_forests(cfg: dict, rng: np.random.Generator) -> dict:
    """Model ID → forest dict (trees in the sklearn convention, task,
    classes)."""
    out = {}
    for f in cfg.get("forests", []):
        spec = cfg["feature_specs"][str(f["id"])]
        trees = []
        for _ in range(f["n_trees"]):
            n_leaves = int(rng.integers(f["leaves"][0], f["leaves"][1] + 1))
            t = make_tree(rng, n_leaves, f["max_depth"], spec,
                          cfg["threshold_ranges"])
            leaf = t["left"] < 0
            if f["task"] == "classify":
                v = rng.integers(0, f["n_classes"], leaf.size)
            else:
                v = rng.random(leaf.size)
            t["value"] = np.where(leaf, v, 0).astype(np.float32)
            trees.append(t)
        out[int(f["id"])] = dict(trees=trees, task=f["task"],
                                 n_classes=f.get("n_classes", 0))
    return out


def installed_ids(cfg: dict) -> list:
    return [int(m["id"]) for m in cfg["mlps"]] + [
        int(f["id"]) for f in cfg.get("forests", [])]


def build_server(cfg: dict, mlps: dict, forests: dict, device: str,
                 **override):
    """The program's PacketServer at the configuration's settings, with
    every model, forest and FeatureSpec installed."""
    from repro_torch.forest import Forest
    from repro_torch.launch.serve import PacketServer

    kw = dict(cfg["server"])
    kw.update(override)
    srv = PacketServer(device=device, **kw)
    for mid, (layers, acts, final) in mlps.items():
        srv.install(mid, layers, acts, final_activation=final)
    for mid, f in forests.items():
        t = f["trees"]
        srv.install_forest(mid, Forest.from_arrays(
            [x["feature"] for x in t], [x["threshold"] for x in t],
            [x["left"] for x in t], [x["right"] for x in t],
            [x["value"] for x in t], task=f["task"],
            n_classes=f["n_classes"]))
    for mid, cols in cfg.get("feature_specs", {}).items():
        srv.install_feature_spec(int(mid), tuple(cols))
    return srv


def reference_tables(mlps: dict, forests: dict) -> tuple:
    """The reference's own quantization of the same floats."""
    from portbench.reference import dataplane as ref

    return ({m: ref.quantize_mlp(*v) for m, v in mlps.items()},
            {m: ref.quantize_forest(f) for m, f in forests.items()})
