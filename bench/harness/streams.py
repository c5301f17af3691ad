"""The stream pool: synthetic temporal graphs with the paper's Table III
statistics, generated from a run's seed.

The generator follows the port's ``graph/synthetic.py`` (preferential
attachment over a global node pool of ``6 * max_nodes``, unit-normal edge
and node features), with its sizes taken from Table III's mean and
maximum, where the port draws lognormals of a fixed spread:

* a dataset's T snapshot sizes (nodes, edges) are the quantiles
  ``(i + 0.5) / T`` of a lognormal whose spread is solved so that the T
  sizes average Table III's mean and the largest is Table III's maximum;
  nodes and edges rise together, so every stream holds one snapshot at
  the dataset's maximum node and edge count at once. The sizes are the
  same for every stream and every seed; the run's seed permutes their
  order;
* every node of a snapshot is an end of at least one edge (the first
  edges pair the nodes off), so a snapshot has its planned node count;
  the other edges join two distinct nodes uniformly.

The run's seed draws everything else: the order, the nodes, the edges,
the features.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

SEED_MOD = 2 ** 63


@dataclass
class Snapshot:
    """One snapshot as the benchmark made it: COO edges in global node ids
    (self-pairs never occur) and their features."""

    src: np.ndarray   # (e,) int64
    dst: np.ndarray   # (e,) int64
    ef: np.ndarray    # (e, edge_dim) float32


@dataclass
class Stream:
    """One independent dynamic graph: its snapshots, its global node
    feature table and the size of its global node space."""

    name: str
    dataset: str
    n_global: int
    feat: np.ndarray          # (n_global, in_dim) float32
    snaps: list

    @property
    def T(self) -> int:
        return len(self.snaps)


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator keyed by the run's seed (any whole number) and
    further non-negative keys."""
    return np.random.default_rng([int(seed) % SEED_MOD, *keys])


def plan_sizes(T: int, avg: float, top: int, low: int) -> np.ndarray:
    """T whole sizes, ascending: the quantiles ``(i + 0.5) / T`` of a
    lognormal whose largest is ``top``, its spread solved (by bisection)
    so that the sizes, rounded and at least ``low``, average ``avg``."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / T) for i in range(T)])
    below = z - z[-1]

    def sizes(sigma):
        return np.maximum(low, np.rint(top * np.exp(sigma * below)))

    lo, hi = 0.0, 16.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if sizes(mid).mean() > avg else (lo, mid)
    return sizes(hi).astype(np.int64)


def size_plan(ds: dict) -> tuple:
    """(edges, nodes) of each of the dataset's snapshots, ascending
    together: Table III's average and maximum of each (``plan_sizes``)."""
    T = ds["snapshots"]
    return (plan_sizes(T, ds["avg_edges"], ds["max_edges"], 1),
            plan_sizes(T, ds["avg_nodes"], ds["max_nodes"], 2))


def snapshot_edges(rng: np.random.Generator, n: int, e: int) -> tuple:
    """(src, dst) of ``e`` edges over nodes 0..n-1, no self-pair: the
    first ``ceil(n / 2)`` pair the nodes off in a random order (the last
    node of an odd count with the first), so each is an end of one; the
    rest join two distinct nodes uniformly. In a random order."""
    cover = rng.permutation(n)
    if n % 2:
        cover = np.append(cover, cover[0])
    k = min(e, cover.size // 2)
    si = rng.integers(0, n, e - k)
    di = rng.integers(0, n - 1, e - k)
    di = di + (di >= si)
    src = np.concatenate([cover[0:2 * k:2], si])
    dst = np.concatenate([cover[1:2 * k:2], di])
    order = rng.permutation(e)
    return src[order], dst[order]


def generate_stream(ds: dict, slot: int, seed: int, in_dim: int,
                    edge_dim: int, key: int = 0) -> Stream:
    """Stream ``slot`` of dataset ``ds`` (a traffic file's pool entry, the
    ``key``-th of the pool) for the run's ``seed``."""
    e_all, n_all = size_plan(ds)
    rng = rng_for(seed, key, slot)
    order = rng.permutation(ds["snapshots"])
    n_global = ds["max_nodes"] * 6
    pop = np.ones(n_global, np.float64)
    snaps = []
    for t in order:
        e, n = int(e_all[t]), int(n_all[t])
        cand = rng.choice(n_global, size=n, replace=False, p=pop / pop.sum())
        si, di = snapshot_edges(rng, n, e)
        src, dst = cand[si].astype(np.int64), cand[di].astype(np.int64)
        np.add.at(pop, src, 1.0)
        np.add.at(pop, dst, 1.0)
        ef = rng.standard_normal((e, edge_dim), dtype=np.float32)
        snaps.append(Snapshot(src, dst, ef))
    feat = rng.standard_normal((n_global, in_dim), dtype=np.float32)
    return Stream(f"{ds['dataset']}.{slot}", ds["dataset"], n_global, feat,
                  snaps)


def generate_pool(traffic: dict, seed: int, in_dim: int,
                  edge_dim: int) -> list:
    """Every stream of the traffic's pool, in call order: with
    ``order == "alternate"`` the datasets take turns (one stream of each in
    turn), otherwise dataset by dataset."""
    groups = []
    for k, ds in enumerate(traffic["pool"]):
        groups.append([generate_stream(ds, slot, seed, in_dim, edge_dim, k)
                       for slot in range(ds["streams"])])
    if traffic.get("order") == "alternate":
        depth = max(len(g) for g in groups)
        return [g[i] for i in range(depth) for g in groups if i < len(g)]
    return [s for g in groups for s in g]


def snapshot_dims(snap: Snapshot) -> tuple:
    """(nodes, directed edges with self-loops, largest in-degree) of a
    snapshot under the GCN's symmetric adjacency with self-loops: what the
    padding bucket has to hold."""
    nodes = np.unique(np.concatenate([snap.src, snap.dst]))
    n = nodes.size
    dst = np.searchsorted(nodes, np.concatenate([snap.dst, snap.src]))
    deg = np.bincount(dst, minlength=n) + 1
    return n, 2 * snap.src.size + n, int(deg.max())


def check_fits(pool: list, bucket: dict) -> dict:
    """Raise where a snapshot exceeds the bucket; return the largest
    nodes, edges and in-degree per dataset."""
    most: dict = {}
    for s in pool:
        for t, snap in enumerate(s.snaps):
            n, e, k = snapshot_dims(snap)
            if n > bucket["n_pad"] or e > bucket["e_pad"] or k > bucket["k_max"]:
                raise ValueError(
                    f"{s.name} snapshot {t}: {n} nodes, {e} directed edges, "
                    f"in-degree {k} exceed the bucket {bucket}")
            m = most.setdefault(s.dataset, [0, 0, 0])
            most[s.dataset] = [max(m[0], n), max(m[1], e), max(m[2], k)]
    return most
