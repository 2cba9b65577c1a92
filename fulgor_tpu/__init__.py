"""fulgor-tpu: an accelerator-native colored compacted de Bruijn graph index.

A ground-up re-design of the capabilities of Fulgor (jermp/fulgor, v4.2.0):
map any k-mer to the set of reference genomes ("colors") containing it and
answer pseudoalignment / k-mer conservation / k-mer matches queries over
pangenomes — with the query compute path running on a GPU via JAX/XLA
and the build path running in native C++ on the host.

Layer map (not a port — see SURVEY.md for the reference layout):

  host  C++    ccdBG construction (GGCAT equivalent), cuckoo-table build,
               codec encode/decode hot loops           -> fulgor_tpu/native
  host  numpy  bitstream codecs, Elias-Fano, container -> fulgor_tpu/core
  device JAX   batched k-mer lookup + color algebra    -> fulgor_tpu/ops
  mesh  pjit   reads-DP x color-sharding               -> fulgor_tpu/parallel
  CLI          build/pseudoalign/... subcommand parity -> fulgor_tpu/cli
"""

__version__ = "0.1.0"

INDEX_VERSION = (1, 0, 0)


def _tune_malloc():
    """Keep glibc from returning large buffers to the kernel.

    numpy/XLA constantly allocate >32 MB arrays; glibc serves those via
    mmap and munmaps them on free, so every batch/pass re-faults its pages.
    On virtualized hosts with slow demand faulting (measured here:
    ~170 MB/s to acquire fresh pages vs >10 GB/s to reuse them) that
    dominates entire pipelines. Routing everything through the reusable
    heap (M_MMAP_MAX=0) and disabling trim makes page acquisition a
    one-time cost. Opt out with FULGOR_NO_MALLOC_TUNE=1 (e.g. for
    memory-constrained hosts where peak-RSS retention hurts)."""
    import ctypes
    import os

    if os.environ.get("FULGOR_NO_MALLOC_TUNE"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
        libc.mallopt(M_MMAP_MAX, 0)
        libc.mallopt(M_MMAP_THRESHOLD, 0x7FFFFFFF)
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
    except OSError:  # non-glibc platform: nothing to tune
        pass


_tune_malloc()
