"""Multi-device query sharding (the reference is single-node shared-memory;
this is the device scale-out per SURVEY.md §2.3 / §5).

Mesh axes:
  'data'  — reads data-parallel (the reference's worker threads)
  'color' — the color dimension of the dense bitset matrix, sharded like a
            tensor-parallel weight: each device holds C32/cp of every set's
            bit words.

One query step over a (D, P) mesh:
  phase 1  every device runs k-mer lookup on its OWN slice of the batch
           (global batch sharded over BOTH axes -> the expensive dictionary
           gather runs exactly once per read globally) and collapses
           adjacent windows into compact (csid, count) runs;
  phase 2  `all_gather` of the compact runs along 'color' (tiny: R uint32
           per read over the device interconnect — vs shipping every
           window);
  phase 3  each device ANDs / matmuls its color-word shard for the gathered
           row-batch -> output sharded ('data', 'color').

Reads whose run count exceeds the static budget report an overflow flag for
the host's exact fallback (rare: a read must cross >max_runs unitig/color
boundaries).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.intersect import (
    compact_runs,
    compact_runs_starts,
    full_intersection_runs,
    pack_bool_bits,
    threshold_union_scores_runs,
)
from ..ops.lookup import unpack_reads
from ..ops.pipeline import dict_probe, dict_probe_packed


def make_mesh(devices=None, data: int | None = None, color: int | None = None) -> Mesh:
    devices = devices if devices is not None else jax.local_devices()
    n = len(devices)
    if data is None or color is None:
        color = 2 if n % 2 == 0 and n >= 2 else 1
        data = n // color
    assert data * color == len(devices)
    dev = np.array(devices[: data * color]).reshape(data, color)
    return Mesh(dev, axis_names=("data", "color"))


def pad_bits_for_mesh(dense_bits: np.ndarray, color_shards: int) -> np.ndarray:
    S, C32 = dense_bits.shape
    pad = (-C32) % color_shards
    if pad:
        dense_bits = np.pad(dense_bits, ((0, 0), (0, pad)))
    return dense_bits


def make_sharded_full_intersection(mesh: Mesh, k: int, max_runs: int = 64, dparams=None):
    """Returns a jitted fn(table, u2c, bits, codes) -> (bits_out, mapped, ovf).

    Global shapes: codes (B, L) with B % (D*P) == 0; bits (S, C32) with
    C32 % P == 0. Output bits_out (B, C32) sharded ('data', 'color')."""

    def step(table, bits_shard, codes):
        hit, csid, dovf = dict_probe(table, codes, k, dparams)
        run_csid, _cnt, ovf = compact_runs(hit, csid, max_runs)
        ovf = ovf | jnp.any(dovf, axis=1)
        mapped = jnp.any(hit, axis=1)
        run_all = jax.lax.all_gather(run_csid, "color", axis=0, tiled=True)
        mapped_all = jax.lax.all_gather(mapped, "color", axis=0, tiled=True)
        ovf_all = jax.lax.all_gather(ovf, "color", axis=0, tiled=True)
        out = full_intersection_runs(bits_shard, run_all, mapped_all)
        return out, mapped_all, ovf_all

    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(None, "color"), P(("data", "color"), None)),
        out_specs=(P("data", "color"), P("data"), P("data")),
        check_vma=False,  # outputs become color-replicated via all_gather
    )
    return jax.jit(sm)


def make_sharded_threshold_union(mesh: Mesh, k: int, num_colors_padded: int, max_runs: int = 64, dparams=None):
    """Like above; scores output (B, C_padded) sharded ('data', 'color')."""
    P_ = mesh.shape["color"]
    assert num_colors_padded % (32 * P_) == 0

    def step(table, bits_shard, codes):
        hit, csid, dovf = dict_probe(table, codes, k, dparams)
        run_csid, run_cnt, ovf = compact_runs(hit, csid, max_runs)
        ovf = ovf | jnp.any(dovf, axis=1)
        npos = jnp.sum(hit.astype(jnp.int32), axis=1)
        run_all = jax.lax.all_gather(run_csid, "color", axis=0, tiled=True)
        cnt_all = jax.lax.all_gather(run_cnt, "color", axis=0, tiled=True)
        npos_all = jax.lax.all_gather(npos, "color", axis=0, tiled=True)
        ovf_all = jax.lax.all_gather(ovf, "color", axis=0, tiled=True)
        scores = threshold_union_scores_runs(
            bits_shard, run_all, cnt_all, num_colors_padded // P_
        )
        return scores, npos_all, ovf_all

    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(None, "color"), P(("data", "color"), None)),
        out_specs=(P("data", "color"), P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(sm)


def shard_inputs(mesh: Mesh, table, bits, codes):
    """Place arrays with the shardings the step functions expect."""
    rep = NamedSharding(mesh, P())
    return (
        jax.device_put(table, rep),
        jax.device_put(bits, NamedSharding(mesh, P(None, "color"))),
        jax.device_put(codes, NamedSharding(mesh, P(("data", "color"), None))),
    )


def make_sharded_full_intersection_packed(mesh: Mesh, k: int, width: int, max_runs: int, dparams=None):
    """Packed-read variant of make_sharded_full_intersection (2-bit codes +
    validity bitmask, see ops/lookup.pack_reads_host)."""

    def step(table, bits_shard, codes2, bad):
        hit, csid, dovf = dict_probe_packed(table, codes2, bad, width, k,
                                            dparams)
        run_csid, _cnt, ovf = compact_runs(hit, csid, max_runs)
        ovf = ovf | jnp.any(dovf, axis=1)
        mapped = jnp.any(hit, axis=1)
        run_all = jax.lax.all_gather(run_csid, "color", axis=0, tiled=True)
        mapped_all = jax.lax.all_gather(mapped, "color", axis=0, tiled=True)
        ovf_all = jax.lax.all_gather(ovf, "color", axis=0, tiled=True)
        out = full_intersection_runs(bits_shard, run_all, mapped_all)
        return out, mapped_all, ovf_all

    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(None, "color"), P(("data", "color"), None), P(("data", "color"), None)),
        out_specs=(P("data", "color"), P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(sm)


def make_sharded_threshold_union_packed(
    mesh: Mesh, k: int, width: int, num_colors_padded: int, max_runs: int,
    dparams=None,
):
    P_ = mesh.shape["color"]
    assert num_colors_padded % (32 * P_) == 0

    def step(table, bits_shard, codes2, bad):
        hit, csid, dovf = dict_probe_packed(table, codes2, bad, width, k,
                                            dparams)
        run_csid, run_cnt, ovf = compact_runs(hit, csid, max_runs)
        ovf = ovf | jnp.any(dovf, axis=1)
        npos = jnp.sum(hit.astype(jnp.int32), axis=1)
        run_all = jax.lax.all_gather(run_csid, "color", axis=0, tiled=True)
        cnt_all = jax.lax.all_gather(run_cnt, "color", axis=0, tiled=True)
        npos_all = jax.lax.all_gather(npos, "color", axis=0, tiled=True)
        ovf_all = jax.lax.all_gather(ovf, "color", axis=0, tiled=True)
        scores = threshold_union_scores_runs(
            bits_shard, run_all, cnt_all, num_colors_padded // P_
        )
        return scores, npos_all, ovf_all

    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(None, "color"), P(("data", "color"), None), P(("data", "color"), None)),
        out_specs=(P("data", "color"), P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(sm)


def place_packed(mesh: Mesh, codes2, bad):
    sh = NamedSharding(mesh, P(("data", "color"), None))
    return jax.device_put(codes2, sh), jax.device_put(bad, sh)


# ---------------------------------------------------------------------------
# kmer-conservation / kmer-matches / --deduplicate mesh steps. kc and the
# dedup fetch are embarrassingly data-parallel (no color dimension): reads
# shard over every device, zero collectives. kmer-matches follows the
# threshold-union shape (runs all_gather'd along 'color', score matmul on
# each color shard).
# ---------------------------------------------------------------------------


def make_sharded_conservation_runs(mesh: Mesh, k: int, width: int, R: int,
                                   dparams=None):
    def step(table, codes2, bad):
        hit, csid, dovf = dict_probe_packed(table, codes2, bad, width, k,
                                            dparams)
        rc, rs, rl, rovf = compact_runs_starts(hit, csid, R)
        return (rc, rs.astype(jnp.uint16), rl.astype(jnp.uint16),
                rovf | jnp.any(dovf, axis=1))

    dp = P(("data", "color"), None)
    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), dp, dp),
        out_specs=(dp, dp, dp, P(("data", "color"))),
    )
    return jax.jit(sm)


def make_sharded_distinct_runs(mesh: Mesh, k: int, width: int, R: int,
                               dparams=None):
    """Same 4-tuple contract as ops.pipeline.query_distinct_runs_packed
    (probe_ovf and run_ovf split; full per-window csids stay device-
    resident, sharded over reads, for the run-overflow gather)."""
    def step(table, codes2, bad):
        hit, csid, dovf = dict_probe_packed(table, codes2, bad, width, k,
                                            dparams)
        rc, _cnt, rovf = compact_runs(hit, csid, R)
        return rc, jnp.any(dovf, axis=1), rovf, csid

    dp = P(("data", "color"), None)
    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), dp, dp),
        out_specs=(dp, P(("data", "color")), P(("data", "color")), dp),
    )
    return jax.jit(sm)


def make_sharded_runs_tu(mesh: Mesh, k: int, width: int, R: int,
                         dparams=None):
    """Large-C threshold-union fetch: data-parallel (csid, count) runs +
    npos, NO color data on any device (see pipeline.query_runs_tu_packed;
    the host scores against on-demand decoded sets)."""

    def step(table, codes2, bad):
        hit, csid, dovf = dict_probe_packed(table, codes2, bad, width, k,
                                            dparams)
        rc, cnt, rovf = compact_runs(hit, csid, R)
        npos = jnp.sum(hit.astype(jnp.int32), axis=1)
        return rc, cnt, npos, rovf | jnp.any(dovf, axis=1)

    dp = P(("data", "color"), None)
    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), dp, dp),
        out_specs=(dp, dp, P(("data", "color")), P(("data", "color"))),
    )
    return jax.jit(sm)


def make_sharded_kmer_matches(mesh: Mesh, k: int, width: int,
                              num_colors_padded: int, max_runs: int,
                              dparams=None):
    P_ = mesh.shape["color"]
    assert num_colors_padded % (32 * P_) == 0
    W = width - k + 1
    Wpad = (-W) % 32

    def step(table, bits_shard, codes2, bad):
        hit, csid, dovf = dict_probe_packed(table, codes2, bad, width, k,
                                            dparams)
        run_csid, run_cnt, rovf = compact_runs(hit, csid, max_runs)
        hitp = jnp.pad(hit, ((0, 0), (0, Wpad))) if Wpad else hit
        hitw = pack_bool_bits(hitp)
        ovf = rovf | jnp.any(dovf, axis=1)
        run_all = jax.lax.all_gather(run_csid, "color", axis=0, tiled=True)
        cnt_all = jax.lax.all_gather(run_cnt, "color", axis=0, tiled=True)
        scores = threshold_union_scores_runs(
            bits_shard, run_all, cnt_all, num_colors_padded // P_
        )
        return hitw, scores.astype(jnp.uint16), ovf

    dp = P(("data", "color"), None)
    sm = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(None, "color"), dp, dp),
        out_specs=(dp, P("data", "color"), P(("data", "color"))),
        check_vma=False,
    )
    return jax.jit(sm)
