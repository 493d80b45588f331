"""The thread-block-cluster geometry both kernels share.

A kernel sweeps a node axis of n nodes with one cluster of k CTAs, each
owning a contiguous slice of the axis, one node per thread:
k = ceil(n / 512), at most 16 (the largest cluster an H100 launches; past
8 it is "non-portable" and the launcher asks for it), and slices of
ceil(n / k) nodes. Past 16 x 512 nodes each thread walks its slice with a
stride of the CTA's width. Pure Python, so the CPU tests cover it.

Why 512 nodes per CTA and not 1,024: every iteration's critical path runs
through each CTA's own reduction and, in B1, its redundant control code,
so a CTA of 32 warps waits on its 4 schedulers; 16 warps per CTA with more
CTAs measured faster for both kernels on an H100 (PERF.md, Findings).
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_CLUSTER = 16  # CTAs one cluster launch may group on an H100
CTA_WIDTH = 512  # nodes per CTA (one per thread) before the cluster grows
WARP = 32


@dataclass(frozen=True)
class ClusterShape:
    k: int  # CTAs in the cluster
    slice: int  # nodes per CTA (the last CTA's slice may be shorter)
    threads: int  # threads per CTA

    def bounds(self, n: int) -> list[tuple[int, int]]:
        """[lo, hi) of each CTA's slice of an n-node axis."""
        return [(min(r * self.slice, n), min((r + 1) * self.slice, n)) for r in range(self.k)]


def cluster_shape(n: int, threads: int | None = None) -> ClusterShape:
    """The cluster for an n-node axis (an empty axis counts as one node).
    ``threads`` fixes the CTA's width; by default it is the slice rounded
    up to whole warps, at most ``CTA_WIDTH``."""
    n = max(n, 1)
    k = min(MAX_CLUSTER, -(-n // CTA_WIDTH))
    slice_ = -(-n // k)
    if threads is None:
        threads = min(CTA_WIDTH, -(-slice_ // WARP) * WARP)
    return ClusterShape(k=k, slice=slice_, threads=threads)
