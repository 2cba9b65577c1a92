"""Device-side color-set algebra (replaces the reference's iterator leapfrog
machinery, src/ps_full_intersection.cpp / ps_threshold_union.cpp).

Device formulation: distinct color sets live as a dense bitset matrix
(num_sets, ceil(C/32)) uint32 in device memory. Per read batch (B, W
windows):

  full intersection  = gather the bit row of EVERY positive window and
                       AND-reduce over windows (misses contribute all-ones).
                       Intersection is idempotent, so the reference's
                       sort+unique dedup (a CPU optimization to avoid
                       re-decoding sets) is unnecessary — skipping it removes
                       all sorts/scatters from the hot path and makes the
                       result exact for every read (no overflow path).
  threshold union    = scores[b,c] = sum_w bit(set(w), c) over positive
                       windows — chunked (unpack bits -> f32 matmul).
                       Summing duplicate windows directly equals the
                       reference's per-unitig multiplicity aggregation
                       (src/ps_threshold_union.cpp:329-387).

Every count matmul runs at lax.Precision.HIGHEST: its operands are 0/1 or
small window counts and its sums are window counts, which f32 holds exactly
up to 2^24. A backend's default precision may be lower (TF32 on NVIDIA
tensor cores keeps 10 mantissa bits, exact only below 2^11), so the
precision is pinned rather than inherited.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import INVALID_U32

INV = jnp.uint32(INVALID_U32)

# Exact f32 counting: see the module docstring.
COUNT_PRECISION = jax.lax.Precision.HIGHEST


# The one-hot threshold: with S distinct sets, the per-window gather can be
# replaced by a comparison-reduce (B,W,S+1) fused into its reduction + one
# matmul — no gathers at all. Worth it while the B*W*S compare work stays
# small; beyond that the per-window gather path takes over.
ONEHOT_MAX_SETS = 2048


def set_presence_counts(hit: jax.Array, csid: jax.Array, num_sets: int):
    """P[b, s] = number of positive windows of read b whose color-set id is
    s (misses fold into a pad slot that is sliced off). Gather/scatter-free:
    a broadcast compare fused into a reduction. -> (B, S) float32."""
    B, W = csid.shape
    sid = jnp.where(hit, csid, jnp.uint32(num_sets)).astype(jnp.int32)
    sids = jnp.arange(num_sets + 1, dtype=jnp.int32)
    P = jnp.sum(
        (sid[:, :, None] == sids[None, None, :]).astype(jnp.float32), axis=1
    )
    return P[:, :num_sets]


def unpacked_bits_f32(dense_bits: jax.Array) -> jax.Array:
    """(S, C32) uint32 -> (S, 32*C32) float32 of {0,1}."""
    S, C32 = dense_bits.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = ((dense_bits[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.float32)
    return b.reshape(S, C32 * 32)


def pack_bool_bits(mask: jax.Array) -> jax.Array:
    """(B, 32*C32) bool -> (B, C32) uint32."""
    B, C = mask.shape
    assert C % 32 == 0
    m = mask.reshape(B, C // 32, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(m << shifts, axis=-1, dtype=jnp.uint32)


def full_intersection_onehot(dense_bits: jax.Array, hit: jax.Array, csid: jax.Array):
    """color c survives iff NO positive window's set misses c:
    (P @ (1 - bits))[b, c] == 0. One matmul, zero gathers; exact at
    COUNT_PRECISION (sums are window counts < 2^24)."""
    S, C32 = dense_bits.shape
    P = set_presence_counts(hit, csid, S)
    notbits = 1.0 - unpacked_bits_f32(dense_bits)
    missing = jnp.einsum("bs,sc->bc", P, notbits,
                         precision=COUNT_PRECISION,
                         preferred_element_type=jnp.float32)
    mapped = jnp.any(hit, axis=1)
    keep = (missing == 0.0) & mapped[:, None]
    return pack_bool_bits(keep)


def threshold_union_scores_onehot(
    dense_bits: jax.Array, hit: jax.Array, csid: jax.Array, num_colors: int
):
    """scores = P @ bits, exact at COUNT_PRECISION (counts <= W < 2^24)."""
    S, C32 = dense_bits.shape
    P = set_presence_counts(hit, csid, S)
    bitsf = unpacked_bits_f32(dense_bits)
    scores = jnp.einsum("bs,sc->bc", P, bitsf, precision=COUNT_PRECISION,
                        preferred_element_type=jnp.float32)
    return scores[:, :num_colors]


def full_intersection_windows(dense_bits: jax.Array, hit: jax.Array, csid: jax.Array):
    """AND of bit rows over all positive windows.

    dense_bits: (S, C32) uint32; hit: (B, W) bool; csid: (B, W) uint32.
    -> (B, C32) uint32; reads with no positive window are all-zero (unmapped,
    reference semantics: empty iterator list -> empty intersection).
    """
    safe = jnp.where(hit, csid, 0).astype(jnp.int32)
    rows = jnp.take(dense_bits, safe, axis=0)  # (B, W, C32)
    rows = jnp.where(hit[:, :, None], rows, jnp.uint32(0xFFFFFFFF))
    out = jnp.bitwise_and.reduce(rows, axis=1)
    mapped = jnp.any(hit, axis=1)
    return jnp.where(mapped[:, None], out, jnp.uint32(0))


def threshold_union_scores_windows(
    dense_bits: jax.Array,
    hit: jax.Array,
    csid: jax.Array,
    num_colors: int,
    chunk: int = 16,
):
    """scores[b, c] = #positive windows whose color set contains c.

    Chunked over windows: gather (B, chunk, C32) rows, unpack to bits,
    accumulate with a matmul against the per-window positivity weights.
    Exact at COUNT_PRECISION (scores <= W < 2^24). -> (B, C) float32.
    """
    B, W = csid.shape
    C32 = dense_bits.shape[1]
    safe = jnp.where(hit, csid, 0).astype(jnp.int32)
    w8 = hit.astype(jnp.float32)

    pad = (-W) % chunk
    if pad:
        safe = jnp.pad(safe, ((0, 0), (0, pad)))
        w8 = jnp.pad(w8, ((0, 0), (0, pad)))
    nchunks = safe.shape[1] // chunk
    ids_c = safe.reshape(B, nchunks, chunk).transpose(1, 0, 2)
    w_c = w8.reshape(B, nchunks, chunk).transpose(1, 0, 2)

    shifts = jnp.arange(32, dtype=jnp.uint32)

    def step(acc, mc):
        ids, w = mc
        rows = jnp.take(dense_bits, ids, axis=0)  # (B, chunk, C32)
        bits = ((rows[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.float32)
        bits = bits.reshape(B, chunk, C32 * 32)
        return acc + jnp.einsum("bm,bmc->bc", w, bits,
                                precision=COUNT_PRECISION,
                                preferred_element_type=jnp.float32), None

    acc0 = jnp.zeros((B, C32 * 32), dtype=jnp.float32)
    acc, _ = jax.lax.scan(step, acc0, (ids_c, w_c))
    return acc[:, :num_colors]


# ---------------------------------------------------------------------------
# Compaction utilities (kept for the mesh path / future compressed decode:
# exchanging compact run lists between devices beats shipping every window).
# ---------------------------------------------------------------------------


def mask_positions(mask: jax.Array, R: int):
    """Window positions of the first R set lanes of each row — the scatter-
    free compaction primitive (popcount rank + tiny take_along gathers in
    place of data-dependent scatters everywhere on the hot path).

    mask: (B, W) bool -> (total (B,) i32, pos (B, R) i32; slots past total
    hold 0)."""
    B, W = mask.shape
    pad = (-W) % 32
    if pad:
        mask = jnp.pad(mask, ((0, 0), (0, pad)))
    bits = pack_bool_bits(mask)
    return first_set_bits(bits, R)


def _run_bounds(hit: jax.Array, csid: jax.Array, max_runs: int):
    """Start/end window positions of the first max_runs (hit, equal-csid)
    runs per read. -> (total, spos, epos, valid)."""
    B, W = csid.shape
    prev = jnp.concatenate(
        [jnp.full((B, 1), INVALID_U32, dtype=jnp.uint32), csid[:, :-1]], axis=1
    )
    prev_hit = jnp.concatenate([jnp.zeros((B, 1), dtype=bool), hit[:, :-1]], axis=1)
    is_new = hit & ((csid != prev) | ~prev_hit)
    nxt = jnp.concatenate(
        [csid[:, 1:], jnp.full((B, 1), INVALID_U32, dtype=jnp.uint32)], axis=1
    )
    nxt_hit = jnp.concatenate([hit[:, 1:], jnp.zeros((B, 1), dtype=bool)], axis=1)
    is_end = hit & ((csid != nxt) | ~nxt_hit)
    total, spos = mask_positions(is_new, max_runs)
    _, epos = mask_positions(is_end, max_runs)
    valid = jnp.arange(max_runs, dtype=jnp.int32)[None, :] < total[:, None]
    return total, spos, epos, valid


def compact_runs(hit: jax.Array, csid: jax.Array, max_runs: int):
    """Collapse ADJACENT runs of equal csid (no sort, no scatter): the
    streaming structure of reads means consecutive windows share unitigs
    (the reference exploits the same locality,
    src/ps_full_intersection.cpp:346). Runs are ranked with popcount math
    (mask_positions) and their csids gathered back.

    -> run_csid (B, R) uint32 INVALID-padded, run_cnt (B, R) int32,
       overflow (B,) bool. A csid may appear in multiple runs; downstream
       consumers must be duplicate-tolerant (AND is; score-sum is).
    """
    total, spos, epos, valid = _run_bounds(hit, csid, max_runs)
    rc = jnp.take_along_axis(csid, spos, axis=1)
    rc = jnp.where(valid, rc, jnp.uint32(INVALID_U32))
    cnt = jnp.where(valid, epos - spos + 1, 0)
    return rc, cnt, total > max_runs


def compact_runs_starts(hit: jax.Array, csid: jax.Array, max_runs: int):
    """compact_runs + per-run start window indices (the kmer-conservation
    output triples (start, len, csid) computed on device — the fetch then
    carries ~R small records per read instead of every window's csid).

    -> (run_csid (B,R) u32 INVALID-padded, run_start (B,R) i32,
        run_len (B,R) i32, overflow (B,) bool)."""
    total, spos, epos, valid = _run_bounds(hit, csid, max_runs)
    rc = jnp.take_along_axis(csid, spos, axis=1)
    rc = jnp.where(valid, rc, jnp.uint32(INVALID_U32))
    ln = jnp.where(valid, epos - spos + 1, 0)
    return rc, jnp.where(valid, spos, 0), ln, total > max_runs


def first_set_bits(bits: jax.Array, T: int):
    """First T set-bit positions of each row, ascending (the device-side
    result-list compaction: a read's color list ships as <=T ints instead of
    the C-bit row; rows with more survivors fall back to a row fetch).

    bits: (B, C32) uint32 -> (total (B,) i32, colors (B, T) i32; slots past
    total are 0)."""
    B, C32 = bits.shape
    pc = jax.lax.population_count(bits).astype(jnp.int32)
    cum = jnp.cumsum(pc, axis=1)
    total = cum[:, -1]
    excl = cum - pc
    t = jnp.arange(T, dtype=jnp.int32)
    # widx[b, t] = index of the word holding the t-th set bit
    widx = jnp.sum((cum[:, :, None] <= t[None, None, :]).astype(jnp.int32), axis=1)
    wclip = jnp.clip(widx, 0, C32 - 1)
    word = jnp.take_along_axis(bits, wclip, axis=1)
    j = t[None, :] - jnp.take_along_axis(excl, wclip, axis=1)
    # position of the (j+1)-th set bit of word: 5-step binary search
    posn = jnp.zeros(word.shape, dtype=jnp.int32)
    w = word
    jj = j
    for width in (16, 8, 4, 2, 1):
        lowmask = jnp.uint32((1 << width) - 1)
        c = jax.lax.population_count(w & lowmask).astype(jnp.int32)
        go_hi = jj >= c
        jj = jnp.where(go_hi, jj - c, jj)
        posn = posn + jnp.where(go_hi, width, 0)
        w = jnp.where(go_hi, w >> width, w & lowmask)
    colors = wclip * 32 + posn
    valid = t[None, :] < total[:, None]
    return total, jnp.where(valid, colors, 0)


def full_intersection_runs(dense_bits: jax.Array, run_csid: jax.Array, any_hit: jax.Array):
    """AND over compacted runs (INVALID entries contribute all-ones)."""
    valid = run_csid != INV
    safe = jnp.where(valid, run_csid, 0).astype(jnp.int32)
    rows = jnp.take(dense_bits, safe, axis=0)
    rows = jnp.where(valid[:, :, None], rows, jnp.uint32(0xFFFFFFFF))
    out = jnp.bitwise_and.reduce(rows, axis=1)
    return jnp.where(any_hit[:, None], out, jnp.uint32(0))


def threshold_union_scores_runs(
    dense_bits: jax.Array,
    run_csid: jax.Array,
    run_cnt: jax.Array,
    num_colors: int,
    chunk: int = 8,
):
    """Scores over compacted runs (weights = run window counts; exact at
    COUNT_PRECISION, scores <= W < 2^24)."""
    B, R = run_csid.shape
    C32 = dense_bits.shape[1]
    valid = run_csid != INV
    safe = jnp.where(valid, run_csid, 0).astype(jnp.int32)
    w = jnp.where(valid, run_cnt, 0).astype(jnp.float32)
    pad = (-R) % chunk
    if pad:
        safe = jnp.pad(safe, ((0, 0), (0, pad)))
        w = jnp.pad(w, ((0, 0), (0, pad)))
    nchunks = safe.shape[1] // chunk
    ids_c = safe.reshape(B, nchunks, chunk).transpose(1, 0, 2)
    w_c = w.reshape(B, nchunks, chunk).transpose(1, 0, 2)
    shifts = jnp.arange(32, dtype=jnp.uint32)

    def step(acc, mc):
        ids, wt = mc
        rows = jnp.take(dense_bits, ids, axis=0)
        bits = ((rows[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.float32)
        bits = bits.reshape(B, chunk, C32 * 32)
        return acc + jnp.einsum("bm,bmc->bc", wt, bits,
                                precision=COUNT_PRECISION,
                                preferred_element_type=jnp.float32), None

    acc, _ = jax.lax.scan(step, jnp.zeros((B, C32 * 32), dtype=jnp.float32), (ids_c, w_c))
    return acc[:, :num_colors]
