"""Prebuild bench_cache artifacts (host-only; no device needed).

Order: salmonella_10 (minutes) -> pansal4546 (primary) -> pan1k.
Run it ahead of bench.py so the timed run finds its artifacts. Exits
non-zero if any corpus failed to build.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

failed = []


def run(name, fn):
    t0 = time.perf_counter()
    print(f"[prebuild] {name} starting", flush=True)
    try:
        fn()
        print(f"[prebuild] {name} done in {time.perf_counter() - t0:.0f}s", flush=True)
    except Exception as e:  # noqa: BLE001 - report it, build the others
        print(f"[prebuild] {name} FAILED: {e!r}", flush=True)
        failed.append(name)


run("salmonella_10", bench.ensure_salmonella)
run("pansal4546", bench.ensure_pansal)
run("pan1k", bench.ensure_pan1k)
print(f"[prebuild] all done; failed: {failed or 'none'}", flush=True)
sys.exit(1 if failed else 0)
