"""Re-compression builders: hybrid -> meta / diff / meta-diff indexes.

Reference L6 (include/builders/{meta,differential,meta_differential}_builder.hpp,
tools/build.cpp:247-303 `fulgor color`). Pipeline per tier:

  meta      permute COLORS: exact pooled co-occurrence features per color
            -> divisive k-means -> colors grouped by cluster (partitions);
            sets re-expressed over permuted ids; filenames permuted to match.
            Set ids / u2c / dictionary unchanged. (The reference sketches
            with HLLs because its merges are per-pair scalar adds; our
            vectorized bincount affords exact features.)
  diff      cluster COLOR SETS: exact pooled membership features, sliced
            by density quartiles, k-means per slice; within each cluster
            sets form similarity CHAINS and delta-code the symmetric
            difference vs their chain parent (core/colorstores.DiffStore).
            Set ids stay stable (no unitig permutation / dictionary rebuild
            as the reference does — the device layout gathers, not ranks).
  meta_diff meta partitioning (finer grain than the meta tier), then the
            per-set GLOBAL partial-id lists are chain-diff coded by the
            same DiffStore (core/colorstores.MetaDiffStore).
"""

from __future__ import annotations

import numpy as np

from ..constants import KIND_DIFF, KIND_META, KIND_META_DIFF
from ..core import sketch as SK
from ..core.colorstores import DiffStore, MetaDiffStore, MetaStore
from ..index import Index

KMEANS_PARAMS = dict(min_delta=1e-4, max_iter=10, min_cluster_size=50, seed=0)
DENSITY_SLICES = (0.0, 0.25, 0.5, 0.75, 1.0)  # differential_builder.hpp:14
POOLED_DIMS = 128  # HLL registers sum-pooled before k-means (8x less work
# per distance; register noise dominates well below this resolution)


def color_features(idx: Index) -> np.ndarray:
    """Exact pooled co-occurrence features per color -> (C, POOLED_DIMS)
    f32: feature[c, h(s)] += sqrt(#unitigs of set s) for every set s
    containing color c.

    Replaces the reference's HLL-per-color-over-unitigs sketches
    (build_util.hpp:8-146): colors contained in the same sets get
    near-identical rows — precisely the similarity the partitioner needs —
    and one weighted bincount over the (set, color) incidences costs
    seconds where the register-row merge of 2^p-wide HLLs costs minutes at
    half a million sets."""
    from ..native import lib as _native

    cat, offs = idx.color_sets_decoded()
    S = idx.num_color_sets
    w = np.sqrt(
        np.bincount(idx.u2c_csid.astype(np.int64), minlength=S).astype(np.float64)
    )
    # 20-bit fixed point keeps the accumulation integer: order-independent
    # (thread-count-invariant) and exact to ~1e-6 relative
    wq = np.round(w * float(1 << 20)).astype(np.uint64)
    hs = (
        SK._splitmix64(np.arange(S, dtype=np.uint64)) % np.uint64(POOLED_DIMS)
    ).astype(np.uint16)
    feat = _native.color_features_fp(cat, offs, wq, hs, POOLED_DIMS, idx.num_colors)
    return (feat.astype(np.float64) / float(1 << 20)).astype(np.float32)


def set_features(cat, offs, num_colors) -> np.ndarray:
    """Exact pooled membership features per color set -> (S, POOLED_DIMS)
    f32: feature[s, block(c)] += 1 for every member color (blocks =
    contiguous color ranges). Two sets with a small symmetric difference
    get near-identical rows; replaces per-set HLL sketches of the members
    (reference build_util.hpp:148-253) with an exact one-pass bincount."""
    from ..native import lib as _native

    feat = _native.pooled_features(cat, offs, max(1, num_colors), POOLED_DIMS)
    return feat.astype(np.float32)


def permute_colors(idx: Index, min_cluster_size: int | None = None):
    """-> (perm new_id_of_old (C,), partition_bounds (P+1,)).

    Reference permuter (meta_builder.hpp:14-124): cluster color features;
    colors ordered by (cluster, old id); partitions = cluster extents.
    min_cluster_size: the meta tier keeps the reference's 50; the
    meta-diff tier passes a finer grain (its chain diffs live on partial
    ids, and fine partitions are what make partials deduplicate)."""
    params = dict(KMEANS_PARAMS)
    if min_cluster_size is not None:
        params["min_cluster_size"] = min_cluster_size
    labels = SK.kmeans_divisive(color_features(idx), **params)
    order = np.lexsort((np.arange(idx.num_colors), labels))  # (cluster, old id)
    perm = np.empty(idx.num_colors, dtype=np.int64)
    perm[order] = np.arange(idx.num_colors)
    sizes = np.bincount(labels[order])
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return perm, bounds


def _permuted_sets(idx: Index, perm: np.ndarray):
    cat, offs = idx.color_sets_decoded()
    # apply the permutation and re-sort within each set (native, parallel
    # over segments — no global combined-key sort)
    from ..native import lib as _native

    return _native.permute_sort_segments(cat, offs, perm.astype(np.uint32)), offs


def cluster_color_sets(cat, offs, num_colors, feats=None) -> np.ndarray:
    """Set clustering for diff coding (reference differential_permuter,
    differential_builder.hpp:7-197): exact pooled membership features per
    set, sliced by density, k-means per slice; labels globally unique."""
    n = len(offs) - 1
    sizes = (offs[1:] - offs[:-1]).astype(np.float64)
    frac = sizes / max(1, num_colors)
    if feats is None:
        feats = set_features(cat, offs, num_colors)
    labels = np.zeros(n, dtype=np.int64)
    next_label = 0
    for lo, hi in zip(DENSITY_SLICES[:-1], DENSITY_SLICES[1:]):
        sel = np.flatnonzero((frac > lo) & (frac <= hi))
        if len(sel) == 0:
            continue
        sub = SK.kmeans_divisive(feats[sel], **KMEANS_PARAMS)
        labels[sel] = sub.astype(np.int64) + next_label
        next_label += int(sub.astype(np.int64).max()) + 1
    return labels


def meta_color(idx: Index) -> Index:
    """hybrid -> meta: permuted colors + partitioned store; reuses the
    dictionary / unitigs / u2c untouched (reference meta_builder.hpp:356-366)."""
    perm, bounds = permute_colors(idx)
    cat, offs = _permuted_sets(idx, perm)
    store = MetaStore.build(cat, offs, idx.num_colors, bounds)
    filenames = [idx.filenames[old] for old in np.argsort(perm)]
    return Index(
        kind=KIND_META,
        k=idx.k,
        m=idx.m,
        num_kmers=idx.num_kmers,
        num_colors=idx.num_colors,
        filenames=filenames,
        dict_table=idx.dict_table,
        unitig_seq=idx.unitig_seq,
        unitig_offs=idx.unitig_offs,
        u2c_csid=idx.u2c_csid,
        color_store=store,
        dict_kind=idx.dict_kind,
        mini_slots=idx.mini_slots,
        mini_sec=idx.mini_sec,
        mini_num_slots=idx.mini_num_slots,
    )


def diff_color(idx: Index) -> Index:
    """hybrid -> differential: clustered sets, symmetric-diff coding."""
    cat, offs = idx.color_sets_decoded()
    feats = set_features(cat, offs, idx.num_colors)
    labels = cluster_color_sets(cat, offs, idx.num_colors, feats=feats)
    store = DiffStore.build(cat, offs, idx.num_colors, labels,
                            order_features=feats)
    return Index(
        kind=KIND_DIFF,
        k=idx.k,
        m=idx.m,
        num_kmers=idx.num_kmers,
        num_colors=idx.num_colors,
        filenames=list(idx.filenames),
        dict_table=idx.dict_table,
        unitig_seq=idx.unitig_seq,
        unitig_offs=idx.unitig_offs,
        u2c_csid=idx.u2c_csid,
        color_store=store,
        dict_kind=idx.dict_kind,
        mini_slots=idx.mini_slots,
        mini_sec=idx.mini_sec,
        mini_num_slots=idx.mini_num_slots,
    )


def meta_diff_color(idx: Index) -> Index:
    """hybrid (or meta) -> meta-differential. If a meta index is given its
    permutation is reused (reference builds .mdfur from .mfur,
    tools/build.cpp:79-134)."""
    if idx.kind == KIND_META:
        cat, offs = idx.color_sets_decoded()  # already permuted space
        bounds = idx.color_store.partition_bounds
        filenames = list(idx.filenames)
    else:
        perm, bounds = permute_colors(
            idx, min_cluster_size=max(8, min(50, idx.num_colors // 16))
        )
        cat, offs = _permuted_sets(idx, perm)
        filenames = [idx.filenames[old] for old in np.argsort(perm)]

    # cluster the (permuted) SETS: the meta-level chain diff orders similar
    # sets adjacently so their global partial-id lists differ in few
    # entries; the chain-order features must live in COLOR space (partial
    # ids carry no locality)
    feats = set_features(cat, offs, idx.num_colors)
    set_labels = cluster_color_sets(cat, offs, idx.num_colors, feats=feats)
    store = MetaDiffStore.build(
        cat, offs, idx.num_colors, bounds, set_labels, order_features=feats
    )
    return Index(
        kind=KIND_META_DIFF,
        k=idx.k,
        m=idx.m,
        num_kmers=idx.num_kmers,
        num_colors=idx.num_colors,
        filenames=filenames,
        dict_table=idx.dict_table,
        unitig_seq=idx.unitig_seq,
        unitig_offs=idx.unitig_offs,
        u2c_csid=idx.u2c_csid,
        color_store=store,
        dict_kind=idx.dict_kind,
        mini_slots=idx.mini_slots,
        mini_sec=idx.mini_sec,
        mini_num_slots=idx.mini_num_slots,
    )


# (meta?, diff?) -> output index kind, for output-path checks before loading
KIND_TARGET = {
    (True, True): KIND_META_DIFF,
    (True, False): KIND_META,
    (False, True): KIND_DIFF,
}


def _mem_available() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def convert(idx: Index, meta: bool, diff: bool) -> Index:
    from ..native import lib as _native

    # converters stream through ~12x the decoded color-set bytes in numpy
    # temporaries; pre-fault that much reusable heap with all cores instead
    # of paying serial demand faults mid-pipeline (slow on this host)
    cat, _offs = idx.color_sets_decoded()
    _native.warm_heap(min(12 * max(cat.nbytes, 1), int(0.4 * _mem_available())))
    if meta and diff:
        return meta_diff_color(idx)
    if meta:
        return meta_color(idx)
    if diff:
        return diff_color(idx)
    raise ValueError("need --meta and/or --diff")


def check_conversion(base: Index, converted: Index) -> bool:
    """Cross-validate: every set of the converted index must equal the base
    set modulo the color permutation (reference per-builder ::check)."""
    bcat, boffs = base.color_sets_decoded()
    ccat, coffs = converted.color_sets_decoded()
    if converted.kind in (KIND_META, KIND_META_DIFF):
        # recover permutation from filenames order
        pos = {fn: i for i, fn in enumerate(converted.filenames)}
        perm = np.array([pos[fn] for fn in base.filenames], dtype=np.int64)
    else:
        perm = np.arange(base.num_colors, dtype=np.int64)
    if base.num_color_sets != converted.num_color_sets:
        print("CHECK FAILED: set count mismatch")
        return False
    bs = (boffs[1:] - boffs[:-1]).astype(np.int64)
    cs = (coffs[1:] - coffs[:-1]).astype(np.int64)
    if not np.array_equal(bs, cs):
        s = int(np.flatnonzero(bs != cs)[0])
        print(f"CHECK FAILED: set {s} size mismatch")
        return False
    # permute+sort the base side per segment (native, parallel), sort the
    # converted side per segment, then compare wholesale
    from ..native import lib as _native

    pb = _native.permute_sort_segments(bcat, boffs, perm.astype(np.uint32))
    cc = _native.permute_sort_segments(
        ccat, coffs, np.arange(converted.num_colors, dtype=np.uint32)
    )
    bad = pb != cc
    if bad.any():
        from ..core.colorstores import seg_ids

        s = int(seg_ids(bs)[np.flatnonzero(bad)[0]])
        print(f"CHECK FAILED: set {s} mismatch")
        return False
    return True
