#!/usr/bin/env python
"""Measure all four color-store tiers on a BLOCK-structured corpus
(gene presence/absence, clade-correlated — the structure the reference's
Salmonella meta/meta-diff ratios reflect, README.md:187-191) vs the
scattered-SNP corpus (pan1k), where the tiers measured meta 1.34x /
diff 2.55x / meta-diff 1.60x (docs/DESIGN-NOTES.md §8).

Host-only (JAX_PLATFORMS=cpu recommended). Caches under bench_cache/blocks.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "bench_cache")

NUM_GENOMES = int(os.environ.get("BLOCKS_GENOMES", "128"))
NUM_GENES = int(os.environ.get("BLOCKS_GENES", "400"))
GENE_LEN = int(os.environ.get("BLOCKS_GENE_LEN", "2500"))


def main():
    from fulgor_tpu.build.builder import build_index
    from fulgor_tpu.build.color_builder import (
        check_conversion,
        diff_color,
        meta_color,
        meta_diff_color,
    )
    from fulgor_tpu.index import Index
    from fulgor_tpu.io.simulate import simulate_pangenome_blocks

    bdir = os.path.join(CACHE, "blocks")
    base_path = os.path.join(CACHE, f"blocks_{NUM_GENOMES}.tfur")
    if not os.path.exists(base_path):
        print(f"[blocks] simulating {NUM_GENOMES} genomes x {NUM_GENES} genes "
              f"x {GENE_LEN} bp ...", file=sys.stderr)
        paths = simulate_pangenome_blocks(
            bdir, NUM_GENOMES, num_genes=NUM_GENES, gene_len=GENE_LEN, seed=11)
        t0 = time.time()
        idx = build_index(paths, k=31, m=19)
        print(f"[blocks] built in {time.time() - t0:.0f}s", file=sys.stderr)
        idx.save(base_path)
    idx = Index.load(base_path)
    hb = idx.color_store.num_bytes()
    ints = sum(len(idx.color_set(i)) for i in range(0, idx.num_color_sets,
                                                    max(1, idx.num_color_sets // 5000)))
    print(f"[blocks] {idx.num_kmers:,} kmers, {idx.num_colors} colors, "
          f"{idx.num_color_sets:,} sets; hybrid color store "
          f"{hb / 1e6:.2f} MB", file=sys.stderr)

    for name, conv in (("meta", meta_color), ("diff", diff_color),
                       ("meta-diff", meta_diff_color)):
        t0 = time.time()
        cidx = conv(idx)
        dt = time.time() - t0
        ok = check_conversion(idx, cidx)
        nb = cidx.color_store.num_bytes()
        print(f"[blocks] {name:9s}: {nb / 1e6:8.2f} MB  ratio {hb / nb:5.2f}x  "
              f"({dt:.0f}s, check={'OK' if ok else 'FAIL'})", file=sys.stderr)
        assert ok


if __name__ == "__main__":
    main()
